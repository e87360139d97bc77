"""``--CHNSR --tpg OPT`` on every text-prior arch of the port (CPU) against
the JAX package (CPU), at small widths: the prior is the TPG's 3965-class
logits over its 129 steps, [B, 3965, 1, 129].

- Each of the ten text-prior archs that are JAX CLI choices: the CLI's
  parser accepts ``--arch=<arch> --CHNSR --tpg OPT``; the factory builds
  it at full width with the ``state_dict`` that ``from_jax`` gives for the
  JAX factory's variables at a 3965-wide prior (shapes traced); one
  eval-mode forward at small widths on converted weights matches JAX's
  (output and every ``aux`` entry within atol 1e-5 / rtol 1e-4, as
  ``tests/test_torch_zoo.py``); and JAX's importer of the family reads
  the port's weights back bit for bit where it has one.
- One whole TATT train step per family at 3965 classes, with tiny TPG
  students and teacher through ``parse_opt_input``, through the port's
  ``factory.arch_steps`` against ``make_train_step(parse_fn=
  parse_opt_input)`` from the same weights, in float32 and in float64:
  ``tsrn_tl_cascade`` (TSRN_TL with the STN, the fused 2B tssim forward
  JAX takes for a model with ``bn_copies``), ``srresnet_tl`` (a zoo
  ``_tl`` arch: TP-Interpreter prior, two forwards of B) and ``pcan_tl``
  (its GruBlocks on the BiGRU recurrence).  Tolerances are
  ``tests/test_torch_chinese.py``'s: metrics rtol 1e-5 (``gnorm/stn_head``
  2e-2 and ``grad_norm_sr`` 1e-4 in float32; ``gnorm/infoGen`` 1e-4 in
  both, as that file's float64 step: TSRN_TL's InfoGen norm reads JAX's
  float32 rounding of a gradient summed over 3965 classes and 129 steps,
  the port's float64 step 2.4e-5 from it and its float32 step 1.4e-5; a
  zoo arch's ``gnorm/<module>`` 1e-4, as ``tests/test_torch_zoo_steps.py``), every
  gradient leaf within 1e-4 of its model's largest entry but the STN
  head's (1e-3) and the student's (the fixed 3e-2 of ROADMAP C.4: the
  distillation margin's sign flips over 3965 near-uniform classes), and
  BatchNorm running statistics rtol 1e-4 / atol 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_chinese import (
    GRAD_TOL, LEAF_TOL, METRIC_RTOL, METRIC_RTOL_F64, N_CLASS, SHRUNK, TINY_TPG, _batch,
    _grad_errors,
)
from test_torch_models import random_variables
from test_torch_package import _roundtrip_check
from test_torch_tsrn import _import_generator
from tatt_tpu.core import torch_import as jimport
from tatt_tpu.models import factory as jfactory
from tatt_tpu.models import stn as jstn
from tatt_tpu.models.recognizers.tpg import TPGModel as JTPG
from tatt_tpu.models.recognizers.tpg import parse_opt_input as jparse_opt
from tatt_tpu.models.tsrn import TSRN_TL as JTSRN_TL
from tatt_tpu.models.tsrn import TSRN_TL_SFT as JTSRN_TL_SFT
from tatt_tpu.models.zoo import esrgan as jesrgan
from tatt_tpu.models.zoo import pcan as jpcan
from tatt_tpu.models.zoo import resnets as jresnets
from tatt_tpu.models.zoo import simple as jsimple
from tatt_tpu.models.zoo import tbsrn as jtbsrn
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_train_step
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax, from_jax_copies
from tatt_tpu_torch.models import factory
from tatt_tpu_torch.models.recognizers.tpg import TPGModel
from tatt_tpu_torch.models.tsrn import TSRN_TL, TSRN_TL_SFT
from tatt_tpu_torch.models.zoo import esrgan, pcan, resnets, simple, tbsrn
from tatt_tpu_torch.train.steps import StepConfig

T_OPT = 129  # the TPG's CTC steps: the prior's length
TOL = dict(atol=1e-5, rtol=1e-4)
# the ten text-prior archs among the JAX CLI's choices: (JAX module, port
# module) at small widths, the port's built for the 3965-wide prior
CHNSR_ARCHS = {
    "tsrn_tl_cascade": (JTSRN_TL(srb_nums=1, hidden_units=4, out_text_channels=8),
                        TSRN_TL(srb_nums=1, hidden_units=4, out_text_channels=8,
                                text_emb=N_CLASS)),
    "tsrn_tl_cascade_sft": (JTSRN_TL_SFT(srb_nums=1, hidden_units=4, out_text_channels=8),
                            TSRN_TL_SFT(srb_nums=1, hidden_units=4, out_text_channels=8,
                                        text_emb=N_CLASS)),
    "srcnn_tl": (jsimple.SRCNN_TL(), simple.SRCNN_TL(text_emb=N_CLASS)),
    "srresnet_tl": (jresnets.SRResNet_TL(mask=True, dropout=0.0),
                    resnets.SRResNet_TL(mask=True, dropout=0.0, text_emb=N_CLASS)),
    "rdn_tl": (jresnets.RDN_TL(n_feat=16), resnets.RDN_TL(n_feat=16, text_emb=N_CLASS)),
    "vdsr_tl": (jsimple.VDSR_TL(num_blocks=2), simple.VDSR_TL(num_blocks=2, text_emb=N_CLASS)),
    "esrgan_tl": (jesrgan.RRDBNet_TL(nb=2), esrgan.RRDBNet_TL(nb=2, text_emb=N_CLASS)),
    "scgan_tl": (jsimple.SCGAN_TL(), simple.SCGAN_TL(text_emb=N_CLASS)),
    "tbsrn_tl": (jtbsrn.TBSRN_TL(srb_nums=1, hidden_units=4, mask=True, out_text_channels=8),
                 tbsrn.TBSRN_TL(srb_nums=1, hidden_units=4, mask=True, out_text_channels=8,
                                dropout=0.0, text_emb=N_CLASS)),
    "pcan_tl": (jpcan.PCAN_TL(srb_nums=2, hidden_units=4, out_text_channels=8),
                pcan.PCAN_TL(srb_nums=2, hidden_units=4, out_text_channels=8, text_emb=N_CLASS)),
}
# the JAX package's importers of a family (tatt_tpu/core/torch_import.py,
# and its helpers as tests/test_torch_tsrn.py composes them for the TSRN
# family), where it has one, at the small widths above: port state_dict ->
# JAX variables
IMPORTERS = {
    "tsrn_tl_cascade": lambda sd: _import_generator(sd, "TSRN_TL", 1),
    "tsrn_tl_cascade_sft": lambda sd: _import_generator(sd, "TSRN_TL_SFT", 1),
    "esrgan_tl": lambda sd: jimport.import_esrgan_tl(_numpy(sd), nb=2),
    "rdn_tl": lambda sd: jimport.import_rdn_tl(_numpy(sd)),
    "tbsrn_tl": lambda sd: jimport.import_tbsrn_tl(_numpy(sd), srb_nums=1),
}


def _numpy(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _chnsr_cfg(arch: str, **flags) -> Config:
    return Config(args=Flags(arch=arch, mask=True, CHNSR=True, tpg="OPT", tiny_tpg=True, **flags))


def _prior(rng, n: int = 2) -> np.ndarray:
    t = rng.random((n, N_CLASS, 1, T_OPT), dtype=np.float32)
    return t / t.sum(axis=1, keepdims=True)  # a softmax over the classes


def _apply_kwargs(jmodel) -> dict:
    return {"deterministic": True} if isinstance(jmodel, jtbsrn.TBSRN_TL) else {}


@pytest.mark.parametrize("arch", list(CHNSR_ARCHS))
def test_chnsr_arch_parses_builds_and_matches_jax_forward(arch):
    cfg, _ = cli.parse_config([f"--arch={arch}", "--CHNSR", "--tpg", "OPT", "--mask"] + SHRUNK)
    assert factory.recognizer_spec(cfg).num_class == N_CLASS

    # the factory at full width: the state_dict of the JAX factory's model
    # at a 3965-wide prior (shapes traced, nothing compiled)
    from tatt_tpu.core.config import Config as JConfig
    from tatt_tpu.core.config import Flags as JFlags

    jfull = jfactory.build_generator(arch, JConfig(args=JFlags(arch=arch, mask=True)))
    shapes = jax.eval_shape(lambda k: jfull.init(k, jnp.zeros((2, 4, 16, 64)),
                                                 jnp.zeros((2, N_CLASS, 1, T_OPT)), train=True),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in from_jax(zeros, arch).items()}
    full = factory.build_generator(arch, _chnsr_cfg(arch, srb=5, hd_u=32))
    assert {k: tuple(v.shape) for k, v in full.state_dict().items()} == want

    # one eval-mode forward at small widths on the same weights
    jmodel, port = CHNSR_ARCHS[arch]
    rng = np.random.default_rng(sum(map(ord, arch)))
    x, t = rng.random((2, 4, 16, 64), dtype=np.float32), _prior(rng)
    variables = _host(random_variables(jmodel, rng, jnp.zeros_like(x), jnp.zeros_like(t),
                                       train=True))
    port.load_state_dict(from_jax(variables, arch))
    port.eval()
    want_out, want_aux = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t), train=False,
                                      **_apply_kwargs(jmodel))
    with torch.no_grad():
        got_out, got_aux = port(torch.from_numpy(x), torch.from_numpy(t))
    assert got_out.shape == (2, 4, 32, 128)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    assert sorted(got_aux) == sorted(want_aux)
    for key, value in want_aux.items():
        np.testing.assert_allclose(got_aux[key].numpy(), np.asarray(value), **TOL, err_msg=key)
    if arch in IMPORTERS:  # the JAX package's importer reads the port's weights back
        _roundtrip_check(variables, IMPORTERS[arch](port.state_dict()))


# ------------------------------------------------- one TATT step per family
def _stn_near_identity(variables, rng):
    """The STN head near its identity border grid, as its init starts it
    (``tests/test_torch_chinese.py``)."""
    stn = variables["params"]["stn_head"]
    stn["fc2_kernel"] = stn["fc2_kernel"] * 0.1
    stn["fc2_bias"] = (jstn.build_output_control_points(20, (0.01, 0.01)).reshape(-1)
                       + rng.normal(0, 0.01, 40)).astype(np.float32)
    return variables


# arch -> (JAX module, port module, JAX's fused tssim copy), small widths
STEP_CASES = {
    "tsrn_tl_cascade": (JTSRN_TL(stn=True, srb_nums=1, hidden_units=4, out_text_channels=8),
                        partial(TSRN_TL, stn=True, srb_nums=1, hidden_units=4,
                                out_text_channels=8, text_emb=N_CLASS), True),
    "srresnet_tl": (jresnets.SRResNet_TL(mask=True, dropout=0.0),
                    partial(resnets.SRResNet_TL, mask=True, dropout=0.0, text_emb=N_CLASS), False),
    "pcan_tl": (jpcan.PCAN_TL(srb_nums=2, hidden_units=4, out_text_channels=8),
                partial(pcan.PCAN_TL, srb_nums=2, hidden_units=4, out_text_channels=8,
                        text_emb=N_CLASS), False),
}


def _jax_step(arch, sr, stu, teacher, batch):
    jmodel, _, fused = STEP_CASES[arch]
    tpg = JTPG(**TINY_TPG)

    def sr_apply(model):
        return lambda v, lr, prior, train, rngs=None, mutable=False: model.apply(
            v, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def tpg_apply(variables, luma, train, mutable=False):
        return tpg.apply(variables, luma, train=train, mutable=mutable)

    # loop.py:240-253: the fused 2B copy only for a model with bn_copies
    extra = {"sr_apply_fused": sr_apply(jmodel.clone(bn_copies=2))} if fused else {}
    step = jax.jit(make_train_step(sr_apply(jmodel), tpg_apply, tpg_apply, JStepConfig(),
                                   parse_fn=jparse_opt, **extra))
    state = TrainState.create([sr], [stu], optax.sgd(1.0))
    new, metrics = step(state, teacher, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    grads = {part: from_jax({"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), getattr(state, f"{part}_params")[0],
        getattr(new, f"{part}_params")[0])}, arch if part == "sr" else None)
        for part in ("sr", "student")}
    stats = {"sr": from_jax(_host({"params": new.sr_params[0],
                                   "batch_stats": new.sr_batch_stats[0]}), arch),
             "student": from_jax_copies(_host(new.student_params),
                                        _host(new.student_batch_stats))[0]}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def _port_step(arch, sr, stu, teacher_vars, batch, dtype):
    generator = STEP_CASES[arch][1]()
    student, teacher = TPGModel(**TINY_TPG), TPGModel(**TINY_TPG)
    generator.load_state_dict(from_jax(sr, arch))
    student.load_state_dict(from_jax(stu))
    teacher.load_state_dict(from_jax(teacher_vars))
    for m in (generator, student, teacher):
        m.to(dtype)
    opt = torch.optim.SGD([*generator.parameters(), *student.parameters()], lr=1.0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in tb.items()}
    cfg = _chnsr_cfg(arch, use_distill=True, tssim_loss=True)
    train_fn, _ = factory.arch_steps(cfg)
    with torch.backends.mkldnn.flags(enabled=False):  # as tests/test_torch_tpg.py
        metrics = train_fn([generator.train()], [student.train()], teacher.eval(), opt, tb,
                           StepConfig(), torch.Generator().manual_seed(0))
    grads = {"sr": {k: p.grad for k, p in generator.named_parameters()},
             "student": {k: p.grad for k, p in student.named_parameters()}}
    stats = {"sr": generator.state_dict(), "student": student.state_dict()}
    return {k: v.item() for k, v in metrics.items()}, grads, stats


@pytest.fixture(scope="module", params=list(STEP_CASES))
def steps(request):
    arch = request.param
    rng = np.random.default_rng(23)
    jmodel = STEP_CASES[arch][0]
    sr = _host(random_variables(jmodel, rng, jnp.zeros((2, 4, 16, 64)),
                                jnp.zeros((2, N_CLASS, 1, T_OPT)), train=True))
    if "stn_head" in sr["params"]:
        sr = _stn_near_identity(sr, rng)
    luma = jnp.zeros((2, 1, 32, 512))
    stu, teacher = (_host(random_variables(JTPG(**TINY_TPG), rng, luma)) for _ in range(2))
    batch = _batch()
    return arch, (_jax_step(arch, sr, stu, teacher, batch),
                  _port_step(arch, sr, stu, teacher, batch, torch.float32),
                  _port_step(arch, sr, stu, teacher, batch, torch.float64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chnsr_tatt_step_matches_make_train_step(steps, dtype):
    arch, ((m_j, g_j, s_j), got32, got64) = steps
    m_t, g_t, s_t = got32 if dtype == "float32" else got64
    rtol = dict(METRIC_RTOL if dtype == "float32" else METRIC_RTOL_F64, **{"gnorm/infoGen": 1e-4})
    if arch != "tsrn_tl_cascade":  # tests/test_torch_zoo_steps.py's gnorm tolerance
        rtol.update({k: 1e-4 for k in m_j if k.startswith("gnorm/")})
    assert "loss_distill" in m_j and "loss_tssim" in m_j
    assert sorted(m_t) == sorted(m_j)
    for key, value in m_j.items():
        np.testing.assert_allclose(m_t[key], value, rtol=rtol.get(key, 1e-5), atol=1e-7,
                                   err_msg=key)
    for part in ("sr", "student"):
        errs = _grad_errors(g_j[part], g_t[part])
        tol = {k: next((t for (p, pre), t in LEAF_TOL.items() if p == part and k.startswith(pre)),
                       GRAD_TOL) for k in errs}
        bad = {k: e for k, e in errs.items() if e > tol[k]}
        assert not bad, (arch, part, bad)
        for name, value in s_j[part].items():  # BatchNorm running statistics after the step
            if "running" in name:
                np.testing.assert_allclose(s_t[part][name].double().numpy(), value.numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=f"{part} {name}")
