"""The plain train step of the port against ``make_plain_train_step``, and
the TATT step with a TSRN_TL generator against ``make_train_step`` (CPU,
small widths: one SRB, hidden 4, batch 8).

Plain step: ``tsrn`` with ``--tssim_loss --rotate_train=5``; ``tsrn`` with
``--ssim_loss --color_loss --mse_fuse`` (Distorted-SSIM, the mean-colour
term and a second forward, rotated back); ``sem_tsrn``; ``tsrn_c2f`` with
``--ssim_loss --tssim_loss --mse_fuse`` (plain SSIM, three forwards).
Weights come from ``random_variables`` through ``from_jax``, inputs from
the JAX collate of seeded synthetic crops, and the rotation from the JAX
step's own draws at ``PRNGKey(0)``, pinned into the port's batch.  Both
sides step with SGD at lr 1, so that an update is the (per-model
clipped) gradient, and are held by ``test_torch_flags.assert_steps_match``:
every metric within rtol 1e-5, every gradient leaf within 1e-4 of the
model's largest entry, the updated parameters and the BN running
statistics (three forwards' worth under ``--tssim_loss --mse_fuse``)
within rtol 1e-4 / atol 1e-6.  The students carry no loss: their
gradients are zero on both sides.  The STN is off: its head's float32 gap
is held in ``test_torch_flags.py``.

The trainer's Adam (lr 1e-3, betas (0.5, 0.999)) is held once more, for
``tsrn --tssim_loss``: every parameter after its first step within rtol
1e-4 / atol 1e-6, but for the entries whose gradient lies within 1e-4 of
the model's largest entry of zero: Adam's first step moves an entry by
``lr g / (|g| + 1e-8)``, about ``lr`` whatever ``g``'s size, so an entry
whose gradient vanishes analytically (a conv bias ahead of a
training-mode BatchNorm) moves by ``lr`` in the direction of its rounding
noise; each side moves those entries by at most ``lr``, so they are held
within ``2 lr`` of JAX's.

TATT step: the canonical recipe's flags with ``tsrn_tl_cascade``'s
generator, the fused 2B forward through JAX's ``bn_copies=2`` clone as
``loop.py:246-258`` builds it, SGD at lr 1, held by
``test_torch_flags.assert_steps_match``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_flags import TINY_CRNN, assert_steps_match, make_batch, make_variables
from test_torch_models import random_variables
from tatt_tpu.losses.image import image_loss as jimage_loss
from tatt_tpu.models import tsrn as jtsrn
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.state import make_optimizer as jmake_optimizer
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_plain_train_step, make_train_step
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.losses.image import image_loss
from tatt_tpu_torch.models import tsrn as ttsrn
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.train.state import make_optimizer
from tatt_tpu_torch.train.steps import StepConfig, plain_train_step, train_step

TRUNK = dict(srb_nums=1, hidden_units=4)
LR = 1e-3
# (arch, JAX class, port class, step flags on top of the StepConfig defaults)
PLAIN_CASES = {
    "tsrn tssim": ("tsrn", jtsrn.TSRN, ttsrn.TSRN, dict(tssim_loss=True, rotate_train=5.0)),
    "tsrn ssim color mse_fuse": ("tsrn", jtsrn.TSRN, ttsrn.TSRN,
                                 dict(tssim_loss=False, ssim_loss=True, color_loss=True,
                                      mse_fuse=True, rotate_train=5.0)),
    "sem_tsrn": ("sem_tsrn", jtsrn.SEM_TSRN, ttsrn.SEM_TSRN, dict(tssim_loss=True, rotate_train=5.0)),
    # three forwards in training mode: the running statistics advance three times
    "tsrn_c2f": ("tsrn_c2f", jtsrn.TSRN_C2F, ttsrn.TSRN_C2F,
                 dict(tssim_loss=True, ssim_loss=True, mse_fuse=True, rotate_train=5.0)),
}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_rotation(n: int, degrees: float):
    """The plain step's rotation draws at ``PRNGKey(0)`` (``steps.py:444-452``)."""
    rot_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    a_rng, o_rng = jax.random.split(rot_rng)
    angle = (jax.random.uniform(a_rng, (n,)) * 2.0 - 1.0) * degrees
    return np.asarray(angle / 180.0 * np.pi), np.asarray(jax.random.uniform(o_rng, (n,)))


def _jax_plain_step(arch, model, flags, sr_vars, stu_vars, batch, tx):
    """JAX's step under optimizer ``tx``: (metrics, updates = old - new
    parameters, new states) in the port's names."""
    def sr_apply_plain(variables, lr, train, rngs=None, mutable=False):  # loop.py:260-272
        sr, mut = model.apply(variables, lr, train=train, rngs=rngs, mutable=mutable)
        return (sr[0] if isinstance(sr, tuple) else sr), mut

    cfg = JStepConfig(**flags)
    criterion = partial(jimage_loss, gradient=cfg.gradient, loss_weight=(1.0, 1e-4))
    step = jax.jit(make_plain_train_step(sr_apply_plain, criterion, cfg, 4,
                                         ssim_variant="distorted" if arch == "tsrn" else "ssim"))
    state = TrainState.create([sr_vars], [stu_vars], tx)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    updates = {part: [from_jax({"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), getattr(state, f"{part}_params")[0],
        getattr(new, f"{part}_params")[0])})] for part in ("sr", "student")}
    states = {part: [from_jax(_host({"params": getattr(new, f"{part}_params")[0],
                                     "batch_stats": getattr(new, f"{part}_batch_stats")[0]}))]
              for part in ("sr", "student")}
    return {k: float(v) for k, v in metrics.items()}, updates, states


def _port_plain_step(arch, pcls, flags, sr_vars, stu_vars, batch, make_opt):
    """The port's step under ``make_opt(params)``: (metrics, gradients,
    new states), as :func:`_jax_plain_step` gives them."""
    generator = pcls(**TRUNK)
    generator.load_state_dict(from_jax(_host(sr_vars)))
    student = CRNN(**TINY_CRNN)
    student.load_state_dict(from_jax(_host(stu_vars)))
    opt = make_opt(list(generator.parameters()) + list(student.parameters()))
    cfg = StepConfig(**flags)
    metrics = plain_train_step([generator.train()], opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                               cfg, torch.Generator().manual_seed(0),
                               partial(image_loss, gradient=cfg.gradient), 4, distorted=arch == "tsrn")
    grads = {"sr": [{k: p.grad.clone() for k, p in generator.named_parameters()}],
             "student": [{k: p.grad.clone() for k, p in student.named_parameters()}]}
    return ({k: v.item() for k, v in metrics.items()}, grads,
            {"sr": [generator.state_dict()], "student": [student.state_dict()]})


@pytest.fixture(scope="module")
def plain_batch():
    batch = make_batch(3)
    batch = {k: batch[k] for k in ("images_hr", "images_lr")}
    arc, offs = _jax_rotation(8, 5.0)
    return batch, dict(batch, rot_arc=arc.astype(np.float32), rot_offs=offs.astype(np.float32))


def _run_case(case, plain_batch, jax_tx, make_opt):
    arch, jcls, pcls, flags = PLAIN_CASES[case]
    extra = {"word_vec_d": 12} if arch == "sem_tsrn" else {}
    model = jcls(**TRUNK, **extra)
    rng = np.random.default_rng(21)
    sr_vars = random_variables(model, rng, jnp.zeros((2, 4, 16, 64)), train=True)
    stu_vars = random_variables(JCRNN(**TINY_CRNN), rng, jnp.zeros((2, 1, 32, 100)))
    jbatch, tbatch = plain_batch
    want = _jax_plain_step(arch, model, flags, sr_vars, stu_vars, jbatch, jax_tx)
    got = _port_plain_step(arch, partial(pcls, **extra), flags, sr_vars, stu_vars, tbatch, make_opt)
    want_metrics = {"loss_sr", "loss_total"} | {
        name for flag, name in (("color_loss", "loss_color"), ("ssim_loss", "loss_ssim"),
                                ("tssim_loss", "loss_tssim"), ("mse_fuse", "loss_mse_fuse"))
        if flags.get(flag)}
    assert set(got[0]) == set(want[0]) == want_metrics
    # no loss reaches the students
    assert all(float(g.abs().max()) == 0.0 for g in got[1]["student"][0].values())
    return want, got


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_step_matches_make_plain_train_step(plain_batch, case):
    want, got = _run_case(case, plain_batch, optax.sgd(1.0),
                          lambda params: torch.optim.SGD(params, lr=1.0))
    assert_steps_match(want, got)


def test_plain_step_adam_update_matches(plain_batch):
    """The trainer's Adam after the plain step (module docstring)."""
    (m_j, _, s_j), (m_t, grads, s_t) = _run_case(
        "tsrn tssim", plain_batch, jmake_optimizer(LR, 0.5),
        lambda params: make_optimizer(params, LR, 0.5))
    for key, value in m_j.items():
        np.testing.assert_allclose(m_t[key], value, rtol=1e-5, atol=1e-7, err_msg=key)
    for part in ("sr", "student"):
        (g,), (st,), (sj,) = grads[part], s_t[part], s_j[part]
        assert sorted(st) == sorted(sj)
        scale = max(float(v.abs().max()) for v in g.values())
        for name, want in sj.items():
            got, want = st[name].numpy(), want.numpy()
            if name not in g:  # BN running statistics
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=f"{part} {name}")
                continue
            noise = g[name].abs().numpy() <= 1e-4 * scale
            ok = np.isclose(got, want, rtol=1e-4, atol=1e-6) | (
                noise & (np.abs(got - want) <= 2 * LR * (1 + 1e-4)))
            assert ok.all(), (part, name, np.abs(got - want).max())


def test_tsrn_tl_step_matches_make_train_step():
    """``tsrn_tl_cascade`` (in ``ABLATION_SET``) through the TATT step:
    fused tssim with per-copy BatchNorm in InfoGen, the SRBs and post_bn."""
    rng = np.random.default_rng(31)
    extra = dict(out_text_channels=8)
    model, crnn = jtsrn.TSRN_TL(**TRUNK, **extra), JCRNN(**TINY_CRNN)
    sr_vars = random_variables(model, rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)),
                               train=True)
    # the student's gradient (distillation alone) does not depend on the
    # generator: the students, teacher and batch of test_torch_flags.py's
    # steps, at which its students' max-pool tolerance was measured
    _, (stu_vars,), teacher_vars = make_variables(11)
    batch = make_batch(3)
    batch = {k: batch[k] for k in ("images_hr", "images_lr", "rot_arc", "rot_offs")}
    fused = model.clone(bn_copies=2)

    def sr_apply(m):
        return lambda v, lr, prior, train, rngs=None, mutable=False: m.apply(
            v, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def crnn_apply(variables, luma, train, mutable=False):
        return crnn.apply(variables, luma, train=train, mutable=mutable)

    step = jax.jit(make_train_step(sr_apply(model), crnn_apply, crnn_apply, JStepConfig(),
                                   sr_apply_fused=sr_apply(fused)))
    state = TrainState.create([sr_vars], [stu_vars], optax.sgd(1.0))
    new, metrics = step(state, teacher_vars, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    grads = {part: [from_jax({"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), getattr(state, f"{part}_params")[0],
        getattr(new, f"{part}_params")[0])})] for part in ("sr", "student")}
    states = {part: [from_jax(_host({"params": getattr(new, f"{part}_params")[0],
                                     "batch_stats": getattr(new, f"{part}_batch_stats")[0]}))]
              for part in ("sr", "student")}
    want = ({k: float(v) for k, v in metrics.items()}, grads, states)

    generator = ttsrn.TSRN_TL(**TRUNK, **extra)
    generator.load_state_dict(from_jax(_host(sr_vars)))
    student, teacher = CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    student.load_state_dict(from_jax(_host(stu_vars)))
    teacher.load_state_dict(from_jax(_host(teacher_vars)))
    opt = torch.optim.SGD(list(generator.parameters()) + list(student.parameters()), lr=1.0)
    m_t = train_step([generator.train()], [student.train()], teacher.eval(), opt,
                     {k: torch.from_numpy(v) for k, v in batch.items()}, StepConfig(),
                     torch.Generator().manual_seed(0))
    got = ({k: v.item() for k, v in m_t.items()},
           {"sr": [{k: p.grad for k, p in generator.named_parameters()}],
            "student": [{k: p.grad for k, p in student.named_parameters()}]},
           {"sr": [generator.state_dict()], "student": [student.state_dict()]})
    assert "gnorm/infoGen" in got[0]
    assert_steps_match(want, got)
