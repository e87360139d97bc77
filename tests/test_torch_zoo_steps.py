"""The zoo through the port's steps and weight bridge, against the JAX
package on the CPU (small widths, batch 8).

- Plain step: ``pcan`` (EdgeImageLoss, two GruBlocks a PCAB) and ``rdn``
  (L1, 3 channels whatever ``--mask`` says) with ``--tssim_loss
  --rotate_train=5`` against ``make_plain_train_step``: SGD at lr 1 (each
  gradient, held by ``test_torch_flags.assert_steps_match``), then the
  trainer's Adam (each parameter after one step, as
  ``test_torch_plain_step.test_plain_step_adam_update_matches`` holds it).
- TATT step: ``pcan_tl`` and ``tbsrn_tl`` through ``factory.arch_steps``
  (two forwards of B, as JAX chooses for a model without ``bn_copies``)
  against ``make_train_step`` with no ``sr_apply_fused``; dropout off on
  both sides (JAX's TBSRN_TL runs its attention ``deterministic``); the
  ``gnorm/<module>`` metrics within rtol 1e-4 (reason at the test).
- The fused-tssim choice: ``arch_steps`` packs the tssim copy into one 2B
  forward for ``tatt`` and takes two forwards of B for a zoo ``_tl`` arch.
- The bridge: ``import_tbsrn_tl``, ``import_han``, ``import_rdn_tl`` and
  ``import_esrgan_tl`` read the port's weights back bit for bit; every
  arch of the JAX factory is built by the port's at full width with the
  ``state_dict`` that ``from_jax`` gives for the JAX variables.
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
from test_torch_package import _roundtrip_check
from test_torch_plain_step import _jax_rotation
from tatt_tpu.models import factory as jfactory
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.zoo import esrgan as jesrgan
from tatt_tpu.models.zoo import han as jhan
from tatt_tpu.models.zoo import pcan as jpcan
from tatt_tpu.models.zoo import resnets as jresnets
from tatt_tpu.models.zoo import tbsrn as jtbsrn
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.state import make_optimizer as jmake_optimizer
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_plain_train_step, make_train_step
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.models import factory
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.models.zoo import pcan, resnets, tbsrn
from tatt_tpu_torch.train.state import make_optimizer
from tatt_tpu_torch.train.steps import StepConfig

LR = 1e-3
PLAIN_FLAGS = dict(tssim_loss=True, rotate_train=5.0)
# arch -> (JAX module, port module, channels the step cuts the batch to)
PLAIN_CASES = {
    "pcan": (jpcan.PCAN(srb_nums=2, hidden_units=4), partial(pcan.PCAN, srb_nums=2, hidden_units=4),
             4),
    "rdn": (jresnets.RDN(n_feat=8), partial(resnets.RDN, n_feat=8), 3),
}
TL_CASES = {
    "pcan_tl": (jpcan.PCAN_TL(srb_nums=2, hidden_units=4, out_text_channels=8), {},
                partial(pcan.PCAN_TL, srb_nums=2, hidden_units=4, out_text_channels=8)),
    "tbsrn_tl": (jtbsrn.TBSRN_TL(srb_nums=1, hidden_units=4, mask=True, out_text_channels=8),
                 {"deterministic": True},
                 partial(tbsrn.TBSRN_TL, srb_nums=1, hidden_units=4, mask=True,
                         out_text_channels=8, dropout=0.0)),
}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(arch: str, **flags) -> Config:
    return Config(args=Flags(arch=arch, mask=True, gradient=True, **flags))


def _jax_results(state, new, metrics, arch):
    """(metrics, updates = old - new parameters, new states) in the port's names."""
    updates = {part: [from_jax({"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), getattr(state, f"{part}_params")[0],
        getattr(new, f"{part}_params")[0])}, arch if part == "sr" else None)]
        for part in ("sr", "student")}
    states = {part: [from_jax(_host({"params": getattr(new, f"{part}_params")[0],
                                     "batch_stats": getattr(new, f"{part}_batch_stats")[0]}),
                              arch if part == "sr" else None)]
              for part in ("sr", "student")}
    return {k: float(v) for k, v in metrics.items()}, updates, states


def _port_results(metrics, generator, student):
    return ({k: v.item() for k, v in metrics.items()},
            {"sr": [{k: p.grad.clone() for k, p in generator.named_parameters()}],
             "student": [{k: p.grad.clone() for k, p in student.named_parameters()}]},
            {"sr": [generator.state_dict()], "student": [student.state_dict()]})


@pytest.fixture(scope="module")
def plain_batch():
    batch = make_batch(3)
    batch = {k: batch[k] for k in ("images_hr", "images_lr")}
    arc, offs = _jax_rotation(8, 5.0)
    return batch, dict(batch, rot_arc=arc.astype(np.float32), rot_offs=offs.astype(np.float32))


def _plain_case(arch, plain_batch, jax_tx, make_opt):
    jmodel, pcls, channels = PLAIN_CASES[arch]
    rng = np.random.default_rng(41)
    sr_vars = random_variables(jmodel, rng, jnp.zeros((2, channels, 16, 64)), train=True)
    stu_vars = random_variables(JCRNN(**TINY_CRNN), rng, jnp.zeros((2, 1, 32, 100)))
    jbatch, tbatch = plain_batch

    def sr_apply_plain(variables, lr, train, rngs=None, mutable=False):  # loop.py:260-272
        return jmodel.apply(variables, lr, train=train, rngs=rngs, mutable=mutable)

    jcfg = _cfg(arch)
    step = jax.jit(make_plain_train_step(sr_apply_plain, jfactory.build_criterion(arch, jcfg),
                                         JStepConfig(**PLAIN_FLAGS), channels))
    state = TrainState.create([sr_vars], [stu_vars], jax_tx)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in jbatch.items()},
                        jax.random.PRNGKey(0))
    want = _jax_results(state, new, metrics, arch)

    generator, student = pcls(), CRNN(**TINY_CRNN)
    generator.load_state_dict(from_jax(_host(sr_vars), arch))
    student.load_state_dict(from_jax(_host(stu_vars)))
    opt = make_opt(list(generator.parameters()) + list(student.parameters()))
    train_fn, _ = factory.arch_steps(_cfg(arch))
    m = train_fn([generator.train()], [student.train()], None, opt,
                 {k: torch.from_numpy(v) for k, v in tbatch.items()}, StepConfig(**PLAIN_FLAGS),
                 torch.Generator().manual_seed(0))
    got = _port_results(m, generator, student)
    assert set(got[0]) == set(want[0]) == {"loss_sr", "loss_tssim", "loss_total"}
    assert all(float(g.abs().max()) == 0.0 for g in got[1]["student"][0].values())
    return want, got


@pytest.mark.parametrize("arch", list(PLAIN_CASES))
def test_zoo_plain_step_matches_jax(plain_batch, arch):
    assert_steps_match(*_plain_case(arch, plain_batch, optax.sgd(1.0),
                                    lambda params: torch.optim.SGD(params, lr=1.0)))


@pytest.mark.parametrize("arch", list(PLAIN_CASES))
def test_zoo_plain_step_adam_update_matches_jax(plain_batch, arch):
    """The trainer's Adam after one plain step: every parameter within rtol
    1e-4 / atol 1e-6, but for entries whose gradient is rounding noise
    (within 1e-4 of the model's largest entry of zero), which Adam's first
    step moves by about ``lr`` either way: those within ``2 lr``."""
    (m_j, _, s_j), (m_t, grads, s_t) = _plain_case(
        arch, plain_batch, jmake_optimizer(LR, 0.5), lambda params: make_optimizer(params, LR, 0.5))
    for key, value in m_j.items():
        np.testing.assert_allclose(m_t[key], value, rtol=1e-5, atol=1e-7, err_msg=key)
    for part in ("sr", "student"):
        (g,), (st,), (sj,) = grads[part], s_t[part], s_j[part]
        assert sorted(st) == sorted(sj)
        scale = max(float(v.abs().max()) for v in g.values())
        for name, want in sj.items():
            got, want = st[name].numpy(), want.numpy()
            if name not in g:  # BN running statistics
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{part} {name}")
                continue
            noise = g[name].abs().numpy() <= 1e-4 * scale
            ok = np.isclose(got, want, rtol=1e-4, atol=1e-6) | (
                noise & (np.abs(got - want) <= 2 * LR * (1 + 1e-4)))
            assert ok.all(), (part, name, np.abs(got - want).max())


@pytest.mark.parametrize("arch", list(TL_CASES))
def test_zoo_tatt_step_matches_jax(arch):
    """The canonical recipe's flags (fused tssim asked for) through the
    port's ``arch_steps``, which takes two forwards for the zoo, against
    JAX's step built as ``loop.py:240-253`` builds it for a model without
    ``bn_copies``: no ``sr_apply_fused``."""
    jmodel, apply_kwargs, pcls = TL_CASES[arch]
    rng = np.random.default_rng(51)
    sr_vars = random_variables(jmodel, rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)),
                               train=True)
    _, (stu_vars,), teacher_vars = make_variables(11)
    batch = make_batch(3)
    batch = {k: batch[k] for k in ("images_hr", "images_lr", "rot_arc", "rot_offs")}
    crnn = JCRNN(**TINY_CRNN)

    def sr_apply(v, lr, prior, train, rngs=None, mutable=False):
        return jmodel.apply(v, lr, prior, train=train, rngs=rngs, mutable=mutable, **apply_kwargs)

    def crnn_apply(variables, luma, train, mutable=False):
        return crnn.apply(variables, luma, train=train, mutable=mutable)

    step = jax.jit(make_train_step(sr_apply, crnn_apply, crnn_apply, JStepConfig()))
    state = TrainState.create([sr_vars], [stu_vars], optax.sgd(1.0))
    new, metrics = step(state, teacher_vars, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    want = _jax_results(state, new, metrics, arch)

    generator, student, teacher = pcls(), CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    generator.load_state_dict(from_jax(_host(sr_vars), arch))
    student.load_state_dict(from_jax(_host(stu_vars)))
    teacher.load_state_dict(from_jax(_host(teacher_vars)))
    opt = torch.optim.SGD(list(generator.parameters()) + list(student.parameters()), lr=1.0)
    train_fn, _ = factory.arch_steps(_cfg(arch, use_distill=True, tssim_loss=True))
    m = train_fn([generator.train()], [student.train()], teacher.eval(), opt,
                 {k: torch.from_numpy(v) for k, v in batch.items()}, StepConfig(),
                 torch.Generator().manual_seed(0))
    got = _port_results(m, generator, student)
    assert "gnorm/infoGen" in got[0] and "loss_tssim" in got[0]
    # the gnorm/<module> metrics within rtol 1e-4: a module of one scalar
    # leaf (the stem's PReLU slope, a sum over every pixel behind TBSRN's
    # 1,024-token softmax) reads 1.4e-5 apart; every gradient leaf, each
    # module's included, stays held by assert_steps_match
    gnorms = sorted(k for k in want[0] if k.startswith("gnorm/"))
    assert gnorms == sorted(k for k in got[0] if k.startswith("gnorm/"))
    for key in gnorms:
        np.testing.assert_allclose(got[0].pop(key), want[0].pop(key), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    assert_steps_match(want, got)


def _forward_batches(arch, generator, fused_flag=True):
    """The (batch, copies) of each generator forward in one TATT step of
    ``arch`` through ``arch_steps`` under ``--tssim_loss``."""
    calls = []
    forward = generator.forward

    def spy(x, text_emb, copies=1, gen=None):
        calls.append((x.shape[0], copies))
        return forward(x, text_emb, copies=copies, gen=gen)

    generator.forward = spy
    student, teacher = CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    opt = torch.optim.SGD(list(generator.parameters()) + list(student.parameters()), lr=0.0)
    batch = make_batch(3)
    train_fn, _ = factory.arch_steps(_cfg(arch, use_distill=True, tssim_loss=True))
    train_fn([generator.train()], [student.train()], teacher.eval(), opt,
             {k: torch.from_numpy(batch[k]) for k in ("images_hr", "images_lr")},
             StepConfig(fused_tssim=fused_flag), torch.Generator().manual_seed(0))
    return calls


def test_fused_tssim_follows_the_jax_choice():
    """JAX fuses the tssim copy only for a model with ``bn_copies``
    (``loop.py:240-253``): TATT, TSRN_TL and TSRN_TL_SFT.  A zoo ``_tl``
    arch takes two forwards of B even with ``--fused_tssim``; TATT one of
    2B with per-copy statistics, and two without the flag."""
    assert set(factory.FUSED_TSSIM_ARCHS) < set(factory.ABLATION_SET)
    tatt = TATT(srb_nums=1, hidden_units=4, out_text_channels=8)
    assert _forward_batches("tatt", tatt) == [(16, 2)]
    assert _forward_batches("tatt", tatt, fused_flag=False) == [(8, 1), (8, 1)]
    pcan_tl = pcan.PCAN_TL(srb_nums=1, hidden_units=4, out_text_channels=8)
    assert _forward_batches("pcan_tl", pcan_tl) == [(8, 1), (8, 1)]
    with pytest.raises(ValueError, match="one copy"):
        pcan_tl(torch.zeros(4, 4, 16, 64), torch.zeros(4, 37, 1, 26), copies=2)


# ------------------------------------------------------------- the bridge
def test_jax_importers_read_port_zoo_weights_back():
    """Each JAX importer of a zoo family reads the port's ``state_dict``
    back into the JAX variables it came from, bit for bit."""
    from tatt_tpu.core.torch_import import (
        import_esrgan_tl, import_han, import_rdn_tl, import_tbsrn_tl,
    )
    from tatt_tpu_torch.models.zoo import esrgan, han

    x, t = jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26))
    cases = (
        ("tbsrn_tl", jtbsrn.TBSRN_TL(srb_nums=2, hidden_units=8, mask=True, out_text_channels=8),
         tbsrn.TBSRN_TL(srb_nums=2, hidden_units=8, mask=True, out_text_channels=8), (x, t),
         partial(import_tbsrn_tl, srb_nums=2)),
        ("han", jhan.HAN(n_resgroups=2, n_resblocks=3, n_feats=16),
         han.HAN(n_resgroups=2, n_resblocks=3, n_feats=16), (x[:, :3],),
         partial(import_han, n_resgroups=2, n_resblocks=3)),
        ("rdn_tl", jresnets.RDN_TL(n_feat=16), resnets.RDN_TL(n_feat=16), (x, t), import_rdn_tl),
        ("esrgan_tl", jesrgan.RRDBNet_TL(nb=2), esrgan.RRDBNet_TL(nb=2), (x, t),
         partial(import_esrgan_tl, nb=2)),
    )
    for i, (arch, jmodel, port, args, importer) in enumerate(cases):
        variables = _host(random_variables(jmodel, np.random.default_rng(60 + i), *args,
                                           train=True))
        port.load_state_dict(from_jax(variables, arch))
        _roundtrip_check(variables, importer({k: v.numpy() for k, v in port.state_dict().items()}))


def test_from_jax_picks_the_layout_by_arch():
    """A zoo generator's variables map only by arch: without it they raise
    (never fall into the TSRN trunk's layout), an unknown arch raises, and
    every arch of the factory has a layout."""
    from tatt_tpu_torch.core import convert

    variables = _host(random_variables(jpcan.PCAN(srb_nums=1, hidden_units=4),
                                       np.random.default_rng(3), jnp.zeros((2, 4, 16, 64)),
                                       train=True))
    with pytest.raises(KeyError):
        from_jax(variables)
    with pytest.raises(KeyError, match="no weight layout"):
        from_jax(variables, "pcan_xl")
    assert sorted(from_jax(variables, "pcan")) == sorted(
        pcan.PCAN(srb_nums=1, hidden_units=4).state_dict())
    layouts = convert.TSRN_ARCHS + convert.JAX_NAMED_ARCHS + convert.REFERENCE_NAMED_ARCHS
    assert sorted(layouts) == sorted(set(factory.available_archs()) - {"bicubic"})


def test_factory_builds_every_jax_arch_at_full_width():
    """``build_generator`` builds each arch of the JAX factory with its
    constructor arguments: at the default width (hidden 32, 5 blocks,
    scale 2, ``--mask``) the port's ``state_dict`` has exactly the keys and
    shapes that ``from_jax`` gives for the JAX model's variables (shapes
    traced, nothing compiled)."""
    from tatt_tpu.core.config import Config as JConfig
    from tatt_tpu.core.config import Flags as JFlags

    assert factory.available_archs() == jfactory.available_archs()
    for arch in factory.available_archs():
        if arch == "bicubic":
            continue
        cfg, jcfg = Config(args=Flags(arch=arch, mask=True)), JConfig(args=JFlags(arch=arch,
                                                                                  mask=True))
        jmodel, port = jfactory.build_generator(arch, jcfg), factory.build_generator(arch, cfg)
        channels = 3 if arch in factory.THREE_CHANNEL_ARCHS else 4
        args = (jnp.zeros((2, channels, 16, 64)),)
        if arch in factory.ABLATION_SET:
            args += (jnp.zeros((2, 37, 1, 26)),)
        shapes = jax.eval_shape(lambda k: jmodel.init(k, *args, train=True),  # noqa: B023
                                jax.random.PRNGKey(0))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        want = {k: tuple(v.shape) for k, v in from_jax(zeros, arch).items()}
        got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        assert got == want, arch
