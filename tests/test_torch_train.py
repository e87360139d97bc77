"""The port's training slice (CPU) against the JAX package (CPU).

BatchNorm training statistics with copies, the TPS / STN head, the
rotation augmentation, the losses, Adam, and one whole train step of the
canonical recipe (fused and two-forward) against ``make_train_step``.
Inputs come from a seeded numpy RNG and weights from ``random_variables``
through ``from_jax``.  Module-level tolerance atol 1e-5 / rtol 1e-4 (the
repo's f32 one); each other tolerance is stated where it is used.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import random_variables
from tatt_tpu.data.collate import collate as jcollate
from tatt_tpu.data.synthetic import SyntheticTextDataset as JSynthetic
from tatt_tpu.kernels.grid_sample import rotate_batch as jrotate
from tatt_tpu.losses.distill import semantic_loss as jsemantic
from tatt_tpu.losses.image import image_loss as jimage_loss
from tatt_tpu.losses.ssim import tri_ssim as jtri_ssim
from tatt_tpu.models import common as jcommon
from tatt_tpu.models import stn as jstn
from tatt_tpu.models.recognizers.crnn import CRNN as JCRNN
from tatt_tpu.models.tsrn import TATT as JTATT
from tatt_tpu.train.state import TrainState
from tatt_tpu.train.state import make_optimizer as jmake_optimizer
from tatt_tpu.train.steps import StepConfig as JStepConfig
from tatt_tpu.train.steps import make_train_step
from tatt_tpu_torch.core.convert import from_jax
from tatt_tpu_torch.kernels.grid_sample import rotate_batch
from tatt_tpu_torch.losses.distill import semantic_loss
from tatt_tpu_torch.losses.image import image_loss
from tatt_tpu_torch.losses.ssim import tri_ssim
from tatt_tpu_torch.models import common as tcommon
from tatt_tpu_torch.models import stn as tstn
from tatt_tpu_torch.models.recognizers.crnn import CRNN
from tatt_tpu_torch.models.tsrn import TATT
from tatt_tpu_torch.train.state import make_optimizer
from tatt_tpu_torch.train.steps import StepConfig, train_step

TOL = dict(atol=1e-5, rtol=1e-4)
SMALL = dict(srb_nums=1, hidden_units=4, out_text_channels=8)
TINY_CRNN = dict(nh=16, nm=(8, 8, 16, 16, 32, 32, 32))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("copies", [1, 2])
@pytest.mark.parametrize("dim", [1, 2])
def test_batchnorm_training_statistics_match(copies, dim):
    """Outputs and folded running statistics of one training forward."""
    rng = np.random.default_rng(10 * dim + copies)
    shape = (6, 5) if dim == 1 else (6, 5, 3, 4)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    scale, bias = rng.uniform(0.8, 1.2, 5), rng.normal(0, 0.1, 5)
    mean, var = rng.normal(0, 0.1, 5), rng.uniform(0.5, 1.5, 5)
    jbn = (jcommon.BatchNorm1d if dim == 1 else jcommon.BatchNorm2d)(copies=copies)
    variables = {
        "params": {"scale": jnp.asarray(scale, jnp.float32), "bias": jnp.asarray(bias, jnp.float32)},
        "batch_stats": {"mean": jnp.asarray(mean, jnp.float32), "var": jnp.asarray(var, jnp.float32)},
    }
    want, mut = jbn.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    bn = (tcommon.BatchNorm1d if dim == 1 else tcommon.BatchNorm2d)(5)
    bn.load_state_dict({"weight": _t(scale), "bias": _t(bias), "running_mean": _t(mean), "running_var": _t(var)})
    got = bn.train()(_t(x), copies)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), **TOL)


def test_tps_transform_and_stn_head_match():
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (4, 4, 16, 64)).astype(np.float32)
    ctrl = (tstn.build_output_control_points(20, (0.05, 0.05)) + rng.normal(0, 0.03, (4, 20, 2))).astype(np.float32)
    want = jstn.tps_transform(jnp.asarray(images), jnp.asarray(ctrl), (16, 64))
    got = tstn.tps_transform(_t(images), _t(ctrl), (16, 64))
    # the tolerance of the JAX package's own TPS parity (test_tps_parity.py:98):
    # the solve cancels inverse-kernel entries of +-87 down to [0, 1], and on
    # noise images each sample moves by that f32 grid error times a gradient
    # of up to 1 per pixel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)

    full = random_variables(
        JTATT(stn=True, **SMALL), rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)), train=True
    )
    head_vars = {c: full[c]["stn_head"] for c in full}
    # 16 crops, 8 per copy: BatchNorm1d over 2 samples would normalize a
    # pair to +-1 and magnify rounding without bound
    images = rng.uniform(0, 1, (16, 4, 16, 64)).astype(np.float32)
    want, mut = jstn.STNHead(bn_copies=2).apply(
        head_vars, jnp.asarray(images), True, mutable=["batch_stats"]
    )
    port = TATT(stn=True, **SMALL)
    port.load_state_dict(from_jax(full))
    head = port.stn_head.train()
    got = head(_t(images), copies=2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    new_sd = from_jax({"params": full["params"],
                       "batch_stats": dict(full["batch_stats"], stn_head=mut["batch_stats"])})
    for name, value in head.state_dict().items():
        np.testing.assert_allclose(value.numpy(), new_sd[f"stn_head.{name}"].numpy(), err_msg=name, **TOL)


def test_rotation_and_losses_match():
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (5, 4, 32, 128)).astype(np.float32)
    other = rng.uniform(0, 1, (5, 4, 32, 128)).astype(np.float32)
    third = rng.uniform(0, 1, (5, 4, 32, 128)).astype(np.float32)
    arc = rng.uniform(-1, 1, 5).astype(np.float32) * 5.0 / 180.0 * math.pi
    offs = rng.uniform(0, 1, 5).astype(np.float32)
    want = jrotate(jnp.asarray(images), jnp.asarray(arc), jnp.asarray(offs), method="gather")
    got = rotate_batch(_t(images), _t(arc), _t(offs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    for gradient in (False, True):
        want = jimage_loss(jnp.asarray(images), jnp.asarray(other), gradient=gradient)
        got = image_loss(_t(images), _t(other), gradient=gradient)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jtri_ssim(*(jnp.asarray(a) for a in (images, other, third)))
    got = tri_ssim(_t(images), _t(other), _t(third))
    np.testing.assert_allclose(got.item(), float(want), **TOL)

    logits = rng.standard_normal((2, 26, 5, 37)).astype(np.float32)
    p, q = (np.exp(v) / np.exp(v).sum(-1, keepdims=True) for v in logits)
    want = jsemantic(jnp.asarray(p), jnp.asarray(q))
    np.testing.assert_allclose(semantic_loss(_t(p), _t(q)).item(), float(want), **TOL)


def test_adam_matches_optax():
    """Three Adam steps on fixed gradients; both sides compute the same
    f32 update in another order (rtol 1e-6)."""
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    tx = jmake_optimizer(1e-3, 0.5)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    w = torch.nn.Parameter(_t(p0))
    opt = make_optimizer([w], 1e-3)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        w.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-6, atol=1e-7)


# ---- one whole train step ------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    """Variables of a small TATT(stn=True) and two tiny CRNNs, a batch of
    8 synthetic crops with the rotation pinned, shared by both step tests."""
    rng = np.random.default_rng(7)
    sr_model = JTATT(stn=True, dropout=0.0, **SMALL)
    crnn = JCRNN(**TINY_CRNN)
    sr_vars = random_variables(sr_model, rng, jnp.zeros((2, 4, 16, 64)), jnp.zeros((2, 37, 1, 26)), train=True)
    # the STN head starts near its identity border grid, as its init does
    stn = sr_vars["params"]["stn_head"]
    stn["fc2_kernel"] = stn["fc2_kernel"] * 0.1
    stn["fc2_bias"] = (
        jstn.build_output_control_points(20, (0.01, 0.01)).reshape(-1) + rng.normal(0, 0.01, 40)
    ).astype(np.float32)
    stu_vars = random_variables(crnn, rng, jnp.zeros((2, 1, 32, 100)))
    teacher_vars = random_variables(crnn, rng, jnp.zeros((2, 1, 32, 100)))
    ds = JSynthetic(n=8)
    batch = jcollate([ds[i] for i in range(8)]).device_arrays()
    batch = {k: batch[k] for k in ("images_hr", "images_lr")}
    batch["rot_arc"] = (rng.uniform(-1, 1, 8) * 5.0 / 180.0 * math.pi).astype(np.float32)
    batch["rot_offs"] = rng.uniform(0, 1, 8).astype(np.float32)
    return sr_model, crnn, sr_vars, stu_vars, teacher_vars, batch


def _jax_step(step_setup, fused):
    sr_model, crnn, sr_vars, stu_vars, teacher_vars, batch = step_setup
    fused_model = sr_model.clone(bn_copies=2)

    def sr_apply(variables, lr, prior, train, rngs=None, mutable=False):
        return sr_model.apply(variables, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def sr_apply_fused(variables, lr, prior, train, rngs=None, mutable=False):
        return fused_model.apply(variables, lr, prior, train=train, rngs=rngs, mutable=mutable)

    def crnn_apply(variables, luma, train, mutable=False):
        return crnn.apply(variables, luma, train=train, mutable=mutable)

    cfg = JStepConfig(tssim_loss=True, fused_tssim=fused, rotate_train=5.0, use_distill=True, gradient=True)
    step = jax.jit(make_train_step(
        sr_apply, crnn_apply, crnn_apply, cfg, sr_apply_fused=sr_apply_fused if fused else None
    ))
    # SGD with lr 1: the update is the (clipped) gradient itself
    state = TrainState.create([sr_vars], [stu_vars], optax.sgd(1.0))
    new_state, metrics = step(state, teacher_vars, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(0))
    grads = {}
    for name, old, new in (("sr", state.sr_params[0], new_state.sr_params[0]),
                           ("student", state.student_params[0], new_state.student_params[0])):
        delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), old, new)
        grads[name] = from_jax({"params": delta})
    state = {}  # parameters after the step and BN running statistics
    for name, params, batch_stats in (
        ("sr", new_state.sr_params[0], new_state.sr_batch_stats[0]),
        ("student", new_state.student_params[0], new_state.student_batch_stats[0]),
    ):
        sd = from_jax(jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": batch_stats}))
        state[name] = sd
    return {k: float(v) for k, v in metrics.items()}, grads, state


def _port_step(step_setup, fused):
    _, _, sr_vars, stu_vars, teacher_vars, batch = step_setup
    generator = TATT(stn=True, dropout=0.0, **SMALL)
    generator.load_state_dict(from_jax(sr_vars))
    student, teacher = CRNN(**TINY_CRNN), CRNN(**TINY_CRNN)
    student.load_state_dict(from_jax(stu_vars))
    teacher.load_state_dict(from_jax(teacher_vars))
    opt = torch.optim.SGD(list(generator.parameters()) + list(student.parameters()), lr=1.0)
    metrics = train_step(
        [generator.train()], [student.train()], teacher.eval(), opt,
        {k: _t(v) for k, v in batch.items()}, StepConfig(fused_tssim=fused),
        torch.Generator().manual_seed(0),
    )
    grads = {
        "sr": {k: p.grad for k, p in generator.named_parameters()},
        "student": {k: p.grad for k, p in student.named_parameters()},
    }
    state = {"sr": generator.state_dict(), "student": student.state_dict()}
    return {k: v.item() for k, v in metrics.items()}, grads, state


@pytest.mark.parametrize("fused", [True, False])
def test_train_step_matches_make_train_step(step_setup, fused):
    """Losses within rtol 1e-5.  The updated parameters (SGD, lr 1) and the
    BN running statistics within rtol 1e-4 / atol 1e-6.  The gradients
    themselves (the generator's after clipping) within 1e-4 of the model's
    largest gradient entry: a gradient sums the same f32 terms through ~40
    layers in another order on each side, so entries near zero (a conv bias
    before a training-mode BatchNorm has gradient exactly 0) carry that
    absolute rounding, measured at 6e-8 (generator) and 2.3e-6 (student)."""
    m_j, g_j, s_j = _jax_step(step_setup, fused)
    m_t, g_t, s_t = _port_step(step_setup, fused)
    for key in ("loss_total", "loss_sr", "loss_distill", "loss_tssim", "grad_norm_sr"):
        np.testing.assert_allclose(m_t[key], m_j[key], rtol=1e-5, err_msg=key)
    for part in ("sr", "student"):
        assert sorted(g_t[part]) == sorted(g_j[part])
        scale = max(np.abs(w.numpy()).max() for w in g_j[part].values())
        for name, want in g_j[part].items():
            err = np.abs(g_t[part][name].numpy() - want.numpy()).max()
            assert err <= 1e-4 * scale, (part, name, err, scale)
        assert sorted(s_t[part]) == sorted(s_j[part])
        for name, want in s_j[part].items():  # parameters and running statistics
            np.testing.assert_allclose(s_t[part][name].numpy(), want.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_cli_trains_on_cpu(capsys):
    """The training CLI with the canonical recipe's flags at a shrunk
    width: two steps on the CPU print finite losses."""
    from tatt_tpu_torch.cli import main as cli

    argv = [
        "--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
        "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss", "--srb", "1", "--hd_u", "4",
        "--tiny_tpg", "--batch_size", "4", "--max_iters", "2", "--synthetic", "8", "--device", "cpu",
    ]
    assert cli.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] iters 2 "), line
    words = line.split()[3:]
    values = {k: float(v) for k, v in zip(words[::2], words[1::2])}
    gnorms = {"block1_conv", "block1_act", "srb2", "post_conv", "post_bn", "up0", "final_conv",
              "infoGen", "stn_head"}
    assert set(values) == {"loss_total", "loss_sr", "loss_distill", "loss_distill_each", "loss_tssim",
                           "grad_norm_sr", "sr_mean", "sr_min", "sr_max"} | {f"gnorm/{k}" for k in gnorms}
    assert all(math.isfinite(v) for v in values.values()), values
