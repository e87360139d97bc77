"""bf16 training (``--dtype bfloat16``) beyond ``tatt`` with the CRNN, on the
CPU: ``srresnet_tl``, the TPG recognizer of ``--tpg OPT`` (with and without
``--CHNSR``), and the JAX package's refusal of the InfoGen archs.

- One TATT step per case, the port's (``factory.arch_steps``) against the
  JAX package's ``make_train_step`` in float32 and in bfloat16 from the
  same weights and batch (``random_variables`` through ``from_jax``,
  rotation pinned, dropout off, SGD at lr 1): ``srresnet_tl`` with tiny
  CRNNs (two forwards of B, 8 crops), and ``tatt`` and ``srresnet_tl`` with
  tiny TPGs (``output_channel`` 64, hidden 32; 4 crops) through
  ``parse_opt_input`` at 37 classes and at the 3965 of ``--CHNSR``.  Each
  is held by the two-way criterion of ``tests/test_torch_bf16_step.py``,
  with its tolerances: (a) each loss within JAX's own bf16 error there
  (|JAX bf16 - JAX f32|) plus 2e-3 of its value, and each gradient entry
  within JAX's own bf16 error plus 5e-2 of the model's largest f32
  gradient entry (measured: generator 2.0e-3-9.8e-3, CRNN student
  1.7e-2); (b) the port's bf16-vs-f32 gap (||g_bf16 - g_f32|| / ||g_f32||
  over a model's leaves) not zero, below 5e-2, and no larger than JAX's own
  (measured, port / JAX: generator 3.6e-3 / 7.6e-2 for ``srresnet_tl`` to
  3.9e-2 / 0.38 for ``tatt --CHNSR``; CRNN student 4.2e-2 / 9.2e-2).
- The TPG student's train-mode gradient is not held so: bf16 moves it by
  0.41-0.73 of its norm in the JAX package itself (port 0.44-0.79).  Its
  BatchNorms normalize conv outputs whose batch spread is small beside
  their mean, so the bf16 rounding of the conv output is amplified (the
  same gradient in eval mode moves 3e-3); the f32 step already differs
  from JAX's by 1.3e-2 (ROADMAP C.4).  In the step it must be finite and
  not zero; :func:`test_tpg_bf16_gradient_matches_jax` holds the TPG
  itself by (a) and (b) with its BatchNorms at their running statistics
  (measured gaps, port / JAX: 2.5e-2 / 4.2e-2 at 37 classes, 6.4e-3 /
  1.8e-2 at 3965).
- Forward hooks on every Conv2d, ConvTranspose2d, Dense, BatchNorm, PReLU,
  BiGRU and BiLSTM of the generator, the student and the teacher (the
  TPG's FAN ResNet, its BatchNorms and its CTC ``Prediction`` dense
  included): each takes and returns bf16 in the bf16 step.
- The JAX package's bf16 step still fails on an InfoGen arch
  (``srcnn_tl``) with the ``TypeError`` of its ``ConvTranspose2d``
  (``tatt_tpu/models/common.py:300``), and the port's CLI refuses bf16
  training of each of the nine archs that reach it with that reason.
- The CLI trains each case above under ``--dtype bfloat16`` (one step).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bf16_flags import gap
from test_torch_bf16_step import GAP_MAX, GRAD_TOL, LOSS_RTOL
from test_torch_chinese import N_CLASS, SHRUNK
from test_torch_chinese import _batch as chinese_batch
from test_torch_flags import make_batch
from test_torch_models import random_variables
from tatt_tpu.models import stn as jstn
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.recognizers.tpg import TPGModel as JTPG
from tatt_tpu.models.recognizers.tpg import parse_opt_input as jparse_opt
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.models.zoo import resnets as jresnets
from tatt_tpu.models.zoo import simple as jsimple
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_train_step
from tatt_tpu_torch.cli import main as cli
from tatt_tpu_torch.core.config import Config, Flags
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.kernels.rnn import BiGRU, BiLSTM
from tatt_tpu_torch.models import factory
from tatt_tpu_torch.models.common import (
    BatchNorm1d, BatchNorm2d, Conv2d, ConvTranspose2d, Dense, PReLU,
)
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.recognizers.tpg import TPGModel
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.models.zoo import resnets
from tatt_tpu_torch.train.steps import StepConfig

SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))
TINY_TPG = dict(output_channel=64, hidden_size=32)
T_CRNN, T_OPT = 26, 129
LOSSES = ("loss_total", "loss_sr", "loss_distill", "loss_tssim")
# the layers whose inputs and outputs the hooks read
HOOKED = (Conv2d, ConvTranspose2d, Dense, BatchNorm1d, BatchNorm2d, PReLU, BiGRU, BiLSTM)
# case -> (arch, --tpg, --CHNSR)
CASES = {
    "srresnet_tl": ("srresnet_tl", "CRNN", False),
    "tatt_opt": ("tatt", "OPT", False),
    "tatt_opt_chnsr": ("tatt", "OPT", True),
    "srresnet_tl_opt": ("srresnet_tl", "OPT", False),
    "srresnet_tl_opt_chnsr": ("srresnet_tl", "OPT", True),
}
# JAX's bf16 ConvTranspose2d failure (tatt_tpu/models/common.py:300)
JAX_TYPE_ERROR = ("lax.conv_general_dilated requires arguments to have the same dtypes, "
                  "got bfloat16, float32")
INFOGEN_ARCHS = ("tsrn_tl_cascade", "tsrn_tl_cascade_sft", "srcnn_tl", "vdsr_tl", "scgan_tl",
                 "rdn_tl", "esrgan_tl", "pcan_tl", "tbsrn_tl")


def _models(arch: str, tpg: str, n_class: int):
    """(JAX generator, port generator, JAX recognizer, port recognizer
    factory) at small widths."""
    if arch == "tatt":
        jgen = JTATT(stn=True, dropout=0.0, text_emb=n_class, **SMALL)
        gen = TATT(stn=True, dropout=0.0, text_emb=n_class, **SMALL)
    else:
        jgen = jresnets.SRResNet_TL(mask=True, dropout=0.0, text_emb=n_class)
        gen = resnets.SRResNet_TL(mask=True, dropout=0.0, text_emb=n_class)
    if tpg == "OPT":
        return jgen, gen, JTPG(num_class=n_class, **TINY_TPG), lambda: TPGModel(
            num_class=n_class, **TINY_TPG)
    return jgen, gen, JCRNN(**TINY_CRNN), lambda: CRNN(**TINY_CRNN)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_step(jgen, jrec, arch, tpg, sr, stu, teacher, batch, dtype):
    def sr_apply(model):
        return lambda v, lr, prior, train, rngs=None, mutable=False: model.apply(
            v, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def rec_apply(variables, luma, train, mutable=False):
        return jrec.apply(variables, luma, train=train, mutable=mutable)

    # loop.py:240-253: the fused 2B copy only for a model with bn_copies
    extra = {"sr_apply_fused": sr_apply(jgen.clone(bn_copies=2))} if arch == "tatt" else {}
    if tpg == "OPT":
        extra["parse_fn"] = jparse_opt
    step = jax.jit(make_train_step(sr_apply(jgen), rec_apply, rec_apply,
                                   JStepConfig(compute_dtype=dtype), **extra))
    state = TrainState.create([sr], [stu], optax.sgd(1.0))
    new, metrics = step(state, teacher, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    grads = {part: from_jax({"params": jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), getattr(state, f"{part}_params")[0],
        getattr(new, f"{part}_params")[0])}, arch if part == "sr" else None)
        for part in ("sr", "student")}
    return {k: float(v) for k, v in metrics.items()}, grads


def _port_step(gen, make_rec, arch, tpg, chnsr, sr, stu, teacher_vars, batch, dtype):
    """The port's step; returns (metrics, grads, the hooked layers whose
    input or output was not ``dtype``, the hooked layer types)."""
    student, teacher = make_rec(), make_rec()
    gen.load_state_dict(from_jax(sr, arch))
    student.load_state_dict(from_jax(stu))
    teacher.load_state_dict(from_jax(teacher_vars))
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bad, seen = [], set()

    def hook(module, inputs, output):
        outs = output if isinstance(output, tuple) else (output,)
        for t in [a for a in inputs if torch.is_tensor(a)][:1] + [o for o in outs if torch.is_tensor(o)]:
            seen.add(type(module).__name__)
            if t.dtype != want:
                bad.append((type(module).__name__, t.dtype))

    handles = [m.register_forward_hook(hook) for model in (gen, student, teacher)
               for m in model.modules() if isinstance(m, HOOKED)]
    opt = torch.optim.SGD([*gen.parameters(), *student.parameters()], lr=1.0)
    cfg = Config(args=Flags(arch=arch, mask=True, CHNSR=chnsr, tpg=tpg, tiny_tpg=True,
                            use_distill=True, tssim_loss=True))
    train_fn, _ = factory.arch_steps(cfg)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.backends.mkldnn.flags(enabled=False):  # as tests/test_torch_tpg.py
        metrics = train_fn([gen.train()], [student.train()], teacher.eval(), opt, tb,
                           StepConfig(compute_dtype=dtype), torch.Generator().manual_seed(0))
    for h in handles:
        h.remove()
    grads = {"sr": {k: p.grad.double() for k, p in gen.named_parameters()},
             "student": {k: p.grad.double() for k, p in student.named_parameters()}}
    return {k: v.item() for k, v in metrics.items()}, grads, bad, seen


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request):
    """case -> {(package, dtype): (metrics, grads[, bad layers, seen types])}."""
    arch, tpg, chnsr = CASES[request.param]
    n_class = N_CLASS if chnsr else 37
    rng = np.random.default_rng(17)
    jgen, _, jrec, _ = _models(arch, tpg, n_class)
    t = T_OPT if tpg == "OPT" else T_CRNN
    sr = _host(random_variables(jgen, rng, jnp.zeros((2, 4, 16, 64)),
                                jnp.zeros((2, n_class, 1, t)), train=True))
    if "stn_head" in sr["params"]:  # near its identity border grid, as its init is
        stn = sr["params"]["stn_head"]
        stn["fc2_kernel"] = stn["fc2_kernel"] * 0.1
        stn["fc2_bias"] = (jstn.build_output_control_points(20, (0.01, 0.01)).reshape(-1)
                           + rng.normal(0, 0.01, 40)).astype(np.float32)
    luma = jnp.zeros((2, 1, 32, 512) if tpg == "OPT" else (2, 1, 32, 100))
    stu, teacher = (_host(random_variables(jrec, rng, luma)) for _ in range(2))
    if chnsr:
        batch = chinese_batch()
    else:
        batch = {k: v for k, v in make_batch(6).items()
                 if k in ("images_hr", "images_lr", "rot_arc", "rot_offs")}
    out = {}
    for dt in ("float32", "bfloat16"):
        jgen, gen, jrec, make_rec = _models(arch, tpg, n_class)
        out["jax", dt] = _jax_step(jgen, jrec, arch, tpg, sr, stu, teacher, batch, dt)
        out["port", dt] = _port_step(gen, make_rec, arch, tpg, chnsr, sr, stu, teacher, batch, dt)
    return request.param, out


def _held(name: str, part: str) -> bool:
    """Whether criterion (a) / (b) holds ``part``'s gradient of case
    ``name``: the TPG student's train-mode gradient is not (module
    docstring; :func:`test_tpg_bf16_gradient_matches_jax` holds the TPG)."""
    return not (part == "student" and CASES[name][1] == "OPT")


def test_bf16_step_matches_jax_bf16_step(steps):
    """(a): the losses, and every gradient entry of the generator and the
    CRNN student, beyond JAX's own bf16 error there; the TPG student's
    gradient finite and not zero."""
    name, out = steps
    (m_j, g_j), (m_t, g_t) = out["jax", "bfloat16"], out["port", "bfloat16"][:2]
    m_j32, g_j32 = out["jax", "float32"]
    assert sorted(m_t) == sorted(m_j)
    for key in LOSSES:
        own = abs(m_j[key] - m_j32[key])
        assert math.isfinite(m_t[key]), (name, key)
        assert abs(m_t[key] - m_j[key]) <= own + LOSS_RTOL * abs(m_j[key]), (
            name, key, m_t[key], m_j[key], m_j32[key])
    for part in ("sr", "student"):
        assert sorted(g_t[part]) == sorted(g_j[part])
        if not _held(name, part):
            assert all(torch.isfinite(v).all() for v in g_t[part].values())
            assert any(v.abs().max() > 0 for v in g_t[part].values())
            continue
        scale = max(v.abs().max().item() for v in g_j32[part].values())
        worst = 0.0
        for key, want in g_j[part].items():
            want = want.double()
            own = (want - g_j32[part][key].double()).abs()
            excess = ((g_t[part][key] - want).abs() - own).max().item()
            worst = max(worst, excess / scale)
            assert excess <= GRAD_TOL * scale, (name, part, key, excess, scale)
        print(f"[bf16-opt] {name} {part}: excess {worst:.3e}")


def test_bf16_gap_is_no_larger_than_jax(steps):
    """(b): bf16 moves the port's gradients of the generator and the CRNN
    student from its own f32 step, by less than 5e-2 and no further than
    it moves JAX's."""
    name, out = steps
    for part in ("sr", "student"):
        port = gap(out["port", "bfloat16"][1][part], out["port", "float32"][1][part])
        jax16, jax32 = ({k: v.double() for k, v in out["jax", dt][1][part].items()}
                        for dt in ("bfloat16", "float32"))
        jax_gap = gap(jax16, jax32)
        print(f"[bf16-opt] {name} {part}: port gap {port:.3e}, JAX gap {jax_gap:.3e}")
        if _held(name, part):
            assert 0.0 < port <= min(GAP_MAX, jax_gap), (name, part, port, jax_gap)


def test_every_layer_runs_in_bf16(steps):
    """The hooks: every conv, dense, BatchNorm, PReLU and recurrence of the
    generator, the student and the teacher takes and returns bf16 in the
    bf16 step (float32 in the f32 step)."""
    name, out = steps
    arch, tpg, _ = CASES[name]
    for dt in ("bfloat16", "float32"):
        _, _, bad, seen = out["port", dt]
        assert not bad, (name, dt, bad[:5])
    want = {"Conv2d", "Dense", "BatchNorm2d", "PReLU"}
    want |= {"BiGRU"} if arch == "tatt" else set()
    want |= {"BiLSTM"} if tpg == "CRNN" else set()
    assert want <= seen, (name, seen)


@pytest.mark.parametrize("n_class", [37, N_CLASS])
def test_tpg_bf16_gradient_matches_jax(n_class):
    """The tiny TPG alone, BatchNorms at their running statistics, in bf16
    (luma cast as the step casts it): the f32 logits and the gradient of
    their cross-entropy against fixed random classes (a recognizer's
    loss), the port's against the JAX package's, by criteria (a) (logits
    within JAX's own bf16 error plus 1e-2 of the largest |logit|, gradient
    entries plus 5e-2 of the largest) and (b)."""
    rng = np.random.default_rng(29)
    jtpg, tpg = JTPG(num_class=n_class, **TINY_TPG), TPGModel(num_class=n_class, **TINY_TPG)
    images = chinese_batch()["images_lr"]
    variables = _host(random_variables(jtpg, rng, jnp.zeros((2, 1, 32, 512))))
    tpg.load_state_dict(from_jax(variables))
    tpg.eval()
    target = rng.integers(0, n_class, (T_OPT, images.shape[0]))
    luma = np.asarray(jparse_opt(jnp.asarray(images)[:, :3]))

    def jax_run(dt):
        def f(params):
            logits = jtpg.apply({**variables, "params": params}, jnp.asarray(luma).astype(dt),
                                train=False).astype(jnp.float32)
            nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1), target[..., None], -1)
            return nll.sum(), logits
        (_, logits), g = jax.value_and_grad(f, has_aux=True)(variables["params"])
        return np.asarray(logits), {k: v.double() for k, v in from_jax(_host({"params": g})).items()}

    def port_run(dt):
        tpg.zero_grad(set_to_none=True)
        with torch.backends.mkldnn.flags(enabled=False):  # as tests/test_torch_tpg.py
            logits = tpg(torch.from_numpy(luma).to(dt)).float()
            nll = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(target)[..., None])
            nll.sum().backward()
        return logits.detach().numpy(), {k: p.grad.double() for k, p in tpg.named_parameters()}

    (l_j32, g_j32), (l_j16, g_j16) = jax_run(jnp.float32), jax_run(jnp.bfloat16)
    (_, g_t32), (l_t16, g_t16) = port_run(torch.float32), port_run(torch.bfloat16)
    own = np.abs(l_j16 - l_j32)
    assert (np.abs(l_t16 - l_j16) - own).max() <= 1e-2 * np.abs(l_j32).max()
    scale = max(v.abs().max().item() for v in g_j32.values())
    assert sorted(g_t16) == sorted(g_j16)
    for key, want in g_j16.items():
        excess = ((g_t16[key] - want).abs() - (want - g_j32[key]).abs()).max().item()
        assert excess <= GRAD_TOL * scale, (key, excess, scale)
    port, jax_gap = gap(g_t16, g_t32), gap(g_j16, g_j32)
    print(f"[bf16-opt] TPG at {n_class} classes, eval-mode BatchNorm: port gap {port:.3e}, "
          f"JAX gap {jax_gap:.3e}")
    assert 0.0 < port <= min(GAP_MAX, jax_gap), (port, jax_gap)


def test_jax_bf16_step_still_fails_on_an_infogen_arch():
    """The JAX package's bf16 step on ``srcnn_tl`` (InfoGen's
    ``ConvTranspose2d``) raises the ``TypeError`` that the port's refusal
    quotes: its f32 kernel meets the bf16 input."""
    jgen, crnn = jsimple.SRCNN_TL(), JCRNN(**TINY_CRNN)
    rng = np.random.default_rng(3)
    sr = random_variables(jgen, rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)),
                          train=True)
    rec = random_variables(crnn, rng, jnp.zeros((2, 1, 32, 100)))
    batch = {k: v for k, v in make_batch(6, n=4).items()
             if k in ("images_hr", "images_lr", "rot_arc", "rot_offs")}
    with pytest.raises(TypeError, match=JAX_TYPE_ERROR):
        _jax_step(jgen, crnn, "srcnn_tl", "CRNN", sr, rec, rec, batch, "bfloat16")


RECIPE = ["--STN", "--mask", "--use_distill", "--gradient", "--sr_share", "--rotate_train=5.0",
          "--tssim_loss", "--max_iters", "1", "--synthetic", "8", "--dtype", "bfloat16"] + SHRUNK


@pytest.mark.parametrize("arch", INFOGEN_ARCHS)
def test_cli_refuses_bf16_training_of_the_infogen_archs(arch):
    with pytest.raises(SystemExit) as exc:
        cli.main([f"--arch={arch}"] + RECIPE)
    msg = str(exc.value)
    assert f"--arch={arch}" in msg and "tatt_tpu/models/common.py:300" in msg
    assert JAX_TYPE_ERROR in msg and "not ported yet" not in msg


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_trains_the_case_in_bf16(name):
    arch, tpg, chnsr = CASES[name]
    argv = [f"--arch={arch}", "--tpg", tpg] + (["--CHNSR"] if chnsr else []) + RECIPE
    code, trainer = cli.run(argv)
    assert code == 0 and trainer.step_cfg.compute_dtype == "bfloat16"
