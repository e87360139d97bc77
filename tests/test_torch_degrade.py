"""One step of the degradation mission (``tatt_tpu_torch.train.degrade``)
against ``make_degrade_step`` (CPU, two ``tsrn`` generators at one SRB,
hidden 4, without the STN, batch 8 of 4-channel crops, as
``tests/test_degrade_mission.py`` feeds JAX's).

Weights from ``random_variables`` through ``from_jax``.  Both sides step
with SGD at lr 1, so that an update is the per-model clipped gradient:
the three losses within rtol 1e-5, every gradient leaf within 1e-4 of its
model's largest entry, the BatchNorm running statistics of both models
within rtol 1e-4 / atol 1e-6.  Then once with the trainer's Adam (lr 1e-3,
betas (0.5, 0.999)): every parameter within rtol 1e-4 / atol 1e-6, but for
the entries whose gradient lies within 1e-4 of the model's largest entry
of zero (Adam's first step moves such an entry by about lr in the
direction of its rounding noise), which are held within 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.models.tsrn import TSRN as JTSRN
from tatt_tpu.train.degrade import make_degrade_step
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.state import make_optimizer as jmake_optimizer
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.models.tsrn import TSRN
from tatt_tpu_torch.train.degrade import degrade_step
from tatt_tpu_torch.train.state import make_optimizer

TRUNK = dict(srb_nums=1, hidden_units=4)
LR = 1e-3


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(41)
    model = JTSRN(**TRUNK)
    variables = [random_variables(model, rng, jnp.zeros((2, 4, 16, 64)), train=True) for _ in range(2)]
    ds = JSynthetic(n=8, seed=6)
    arrays = jcollate([ds[i] for i in range(8)]).device_arrays()
    batch = {k: np.asarray(arrays[k]) for k in ("images_hr", "images_lr")}
    return model, variables, batch


def _jax_step(model, variables, batch, tx):
    def apply_fn(v, images, train, mutable=False):
        return model.apply(v, images[:, :4], train=train, mutable=mutable)

    state = TrainState.create(variables, [{"params": {}}], tx)
    new, metrics = jax.jit(make_degrade_step(apply_fn, apply_fn))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    updates = [from_jax({"params": jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                                          state.sr_params[i], new.sr_params[i])})
               for i in range(2)]
    states = [from_jax(_host({"params": new.sr_params[i], "batch_stats": new.sr_batch_stats[i]}))
              for i in range(2)]
    return {k: float(v) for k, v in metrics.items()}, updates, states


def _port_step(variables, batch, make_opt):
    models = []
    for v in variables:
        m = TSRN(**TRUNK)
        m.load_state_dict(from_jax(_host(v)))
        models.append(m.train())
    opt = make_opt([p for m in models for p in m.parameters()])
    metrics = degrade_step(*models, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = [{k: p.grad.clone() for k, p in m.named_parameters()} for m in models]
    return {k: v.item() for k, v in metrics.items()}, grads, [m.state_dict() for m in models]


def test_degrade_step_matches_make_degrade_step(setup):
    model, variables, batch = setup
    m_j, updates, s_j = _jax_step(model, variables, batch, optax.sgd(1.0))
    m_t, grads, s_t = _port_step(variables, batch, lambda p: torch.optim.SGD(p, lr=1.0))
    assert sorted(m_t) == sorted(m_j) == ["loss_deblur", "loss_degrade", "loss_total"]
    for key, value in m_j.items():
        np.testing.assert_allclose(m_t[key], value, rtol=1e-5, err_msg=key)
    for g_t, g_j, st, sj in zip(grads, updates, s_t, s_j):
        assert sorted(g_t) == sorted(g_j)
        scale = max(float(np.abs(v.numpy()).max()) for v in g_j.values())
        for name, want in g_j.items():
            err = np.abs(g_t[name].numpy() - want.numpy()).max()
            assert err <= 1e-4 * scale, (name, err, scale)
        for name, want in sj.items():
            if name not in g_j:  # BN running statistics: both forwards advanced them
                np.testing.assert_allclose(st[name].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=name)


def test_degrade_step_adam_update_matches(setup):
    model, variables, batch = setup
    m_j, _, s_j = _jax_step(model, variables, batch, jmake_optimizer(LR, 0.5))
    m_t, grads, s_t = _port_step(variables, batch, lambda p: make_optimizer(p, LR, 0.5))
    np.testing.assert_allclose(m_t["loss_total"], m_j["loss_total"], rtol=1e-5)
    for g, st, sj in zip(grads, s_t, s_j):
        scale = max(float(v.abs().max()) for v in g.values())
        for name, want in sj.items():
            got, want = st[name].numpy(), want.numpy()
            if name not in g:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)
                continue
            noise = g[name].abs().numpy() <= 1e-4 * scale
            ok = np.isclose(got, want, rtol=1e-4, atol=1e-6) | (
                noise & (np.abs(got - want) <= 2 * LR * (1 + 1e-4)))
            assert ok.all(), (name, np.abs(got - want).max())
