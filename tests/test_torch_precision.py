"""The port's counterpart of ``tests/test_precision_audit.py``: the
contractions that the JAX package pins in f32 stay f32 under bf16 inputs.

The JAX audit inspects jaxprs for the precision each dot requests; PyTorch
has no such record, so each probe here computes the function on a bf16
input and checks it against the same bf16 values widened to f32 first
(equal to the bit where the port computes in f32 and rounds once), plus
the audit's cancellation probes for BatchNorm and LayerNorm.  The STN's
sampling grid stays f32 in the port, a deliberate difference (ROADMAP
C.3): JAX's bf16 grid moves each sample, measured here against the f32
grid.  And ``set_cuda_flags`` keeps TF32 and cuBLAS's bf16
reduced-precision reductions off.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tatt_tpu.models import stn as jstn
from tatt_tpu_torch.core.device import set_cuda_flags
from tatt_tpu_torch.kernels import ctc as tctc
from tatt_tpu_torch.kernels.resize import resize_bicubic, resize_bilinear
from tatt_tpu_torch.losses import ssim as tssim
from tatt_tpu_torch.models import stn as tstn
from tatt_tpu_torch.models.common import BatchNorm2d
from tatt_tpu_torch.models.transformer import LayerNorm, attend

BF16 = torch.bfloat16


def _bf16(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy((shift + scale * rng.standard_normal(shape)).astype(np.float32)).to(BF16)


def test_resize_matrices_run_in_f32():
    """The bicubic and bilinear matrices apply in f32 and round once to the
    input's dtype (``kernels/resize.py``; JAX pins them at HIGHEST)."""
    x = _bf16(np.random.default_rng(0), (2, 3, 16, 64))
    for got, want in ((resize_bicubic(x, 32, 100), resize_bicubic(x.float(), 32, 100)),
                      (resize_bilinear(x, 32, 128), resize_bilinear(x.float(), 32, 128))):
        assert got.dtype == BF16
        assert torch.equal(got, want.to(BF16))


def test_ssim_windows_and_ctc_compute_in_f32():
    """SSIM, TRI-SSIM and CTC widen a bf16 input to f32 before their
    windows and their log-semiring scan: the result equals that of the
    widened values to the bit (the audit's ``test_ctc_runs_in_f32`` and SSIM
    pins)."""
    rng = np.random.default_rng(1)
    a, b, c = (torch.rand(2, 4, 32, 128, generator=torch.Generator().manual_seed(i)).to(BF16)
               for i in range(3))
    assert torch.equal(tssim.ssim(a, b), tssim.ssim(a.float(), b.float()))
    assert torch.equal(tssim.tri_ssim(a, b, c), tssim.tri_ssim(a.float(), b.float(), c.float()))
    lp = torch.log_softmax(_bf16(rng, (12, 4, 37)).float(), -1).to(BF16)
    targets = torch.tensor([[1, 2, 3, 4, 5], [7, 7, 2, 0, 0], [3, 1, 0, 0, 0], [0, 0, 0, 0, 0]])
    il, tl = torch.full((4,), 12), torch.tensor([5, 3, 2, 0])
    out = tctc.ctc_loss(lp, targets, il, tl)
    assert out.dtype == torch.float32
    assert torch.equal(out, tctc.ctc_loss(lp.float(), targets, il, tl))


def test_ssim_variance_cancellation_probe():
    """Bright crops (mean ~0.9, variance ~1e-4): SSIM of a bf16 image with
    itself is 1 (f32 variances), where bf16 windows would leave E[x^2] -
    E[x]^2 as rounding noise."""
    g = torch.Generator().manual_seed(2)
    x = (0.9 + 0.01 * torch.rand(2, 3, 32, 128, generator=g)).to(BF16)
    assert abs(tssim.ssim(x, x).item() - 1.0) < 1e-5


def test_tps_solve_and_grid_stay_f32():
    """The TPS solve and the sampling grid are f32 for bf16 images: the warp
    equals the f32 warp of the same values, rounded once, and the grid the
    sampler receives is the f32 one."""
    rng = np.random.default_rng(3)
    images = _bf16(rng, (4, 4, 16, 64))
    ctrl = torch.from_numpy((tstn.build_output_control_points(20, (0.05, 0.05))
                             + rng.normal(0, 0.03, (4, 20, 2))).astype(np.float32)).to(BF16)
    got = tstn.tps_transform(images, ctrl, (16, 64))
    assert got.dtype == BF16
    assert torch.equal(got, tstn.tps_transform(images.float(), ctrl.float(), (16, 64)).to(BF16))


def _grid(module, name, fn):
    """The grid that ``fn`` hands to ``module.<name>`` (patched to record it)."""
    seen = []
    orig = getattr(module, name)

    def record(images, grid, *args, **kwargs):
        seen.append(np.asarray(grid if not torch.is_tensor(grid) else grid.detach(), np.float32))
        return orig(images, grid, *args, **kwargs)

    setattr(module, name, record)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    return seen[0]


def test_stn_grid_positional_error_against_jax_bf16_grid():
    """ROADMAP C.3: the port samples bf16 images at the f32 grid's
    positions (its grid is the f32 one, bit for bit); JAX rounds the grid to
    bf16 (``stn.py:121``), which moves a sample of the 16x64 LR crop by at
    most half a bf16 ulp of the grid coordinate: 2^-8 of the [-1, 1] range
    near |1|, x W/2 = 0.125 px along the width, 0.031 px along the height.
    On these control points (coordinates within |0.5| .. |1|) measured
    0.0625 / 0.0156 px at most, 0.021 / 0.0049 px on average; the two
    packages' f32 grids agree within 1.8e-4 px."""
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((4, 4, 16, 64)).astype(np.float32)
    ctrl = (tstn.build_output_control_points(20, (0.05, 0.05))
            + rng.normal(0, 0.03, (4, 20, 2))).astype(np.float32)
    j_f32, j_bf16 = (_grid(jstn, "grid_sample", lambda dt=dt: jstn.tps_transform(
        jnp.asarray(imgs, dt), jnp.asarray(ctrl), (16, 64))) for dt in (jnp.float32, jnp.bfloat16))
    t_f32, t_bf16 = (_grid(tstn, "grid_sample_bilinear", lambda dt=dt: tstn.tps_transform(
        torch.from_numpy(imgs).to(dt), torch.from_numpy(ctrl), (16, 64)))
        for dt in (torch.float32, BF16))
    half = np.array([64 / 2, 16 / 2])  # px per unit of the [-1, 1] grid (align_corners=False)

    def px(a, b):  # the largest move along the width and the height, in LR px
        return (np.abs(a - b) * half).reshape(-1, 2).max(0)

    assert np.array_equal(t_bf16, t_f32)  # the port: the f32 grid itself
    assert px(t_f32, j_f32).max() < 5e-4  # the two packages' f32 solves
    jax_err = px(j_bf16, j_f32)
    assert 0.03 < jax_err[0] <= 0.125 and 0.008 < jax_err[1] <= 0.03125, jax_err


def test_batchnorm_stats_cancellation_probe():
    """A bf16 activation of mean ~64 and std ~0.1 normalizes to mean ~0,
    std ~1: the batch statistics are f32 and two-pass (the audit's probe,
    ``test_precision_audit.py:159-180``)."""
    rng = np.random.default_rng(2)
    x = _bf16(rng, (8, 16, 4, 8), scale=0.1, shift=64.0)
    bn = BatchNorm2d(16).train()
    with torch.no_grad():
        y = bn(x).float().numpy()
    assert y.dtype == np.float32 and bn(x).dtype == BF16
    assert np.all(x.float().numpy().std(axis=(0, 2, 3)) > 0.01)
    assert np.abs(y.mean(axis=(0, 2, 3))).max() < 0.05
    assert np.abs(y.std(axis=(0, 2, 3)) - 1.0).max() < 0.1


def test_layernorm_stats_cancellation_probe():
    """``test_precision_audit.py:183-195`` for the port's LayerNorm."""
    x = _bf16(np.random.default_rng(3), (4, 26, 64), scale=0.5, shift=8.0)
    ln = LayerNorm(64)
    with torch.no_grad():
        y = ln(x)
    assert y.dtype == BF16
    y = y.float().numpy()
    assert np.abs(y.mean(-1)).max() < 0.05
    assert np.abs(y.std(-1) - 1.0).max() < 0.15


def test_attention_logits_and_softmax_in_f32():
    """Projected q, k, v in bf16: the logits accumulate in f32 and the
    softmax normalizes in f32 (the returned head-averaged weights are f32
    and sum to 1 to f32 rounding); the output meets v in bf16."""
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng, (2, 7, 64)) for _ in range(3))
    out, weights = attend(q, k, v, nhead=4)
    assert out.dtype == BF16 and weights.dtype == torch.float32
    assert torch.allclose(weights.sum(-1), torch.ones(2, 7), atol=1e-6)
    hd = 16
    qh = (q * (1.0 / math.sqrt(hd))).reshape(2, 7, 4, hd).transpose(1, 2).float()
    kh = k.reshape(2, 7, 4, hd).transpose(1, 2).float()
    want = torch.softmax(qh @ kh.transpose(-1, -2), -1).mean(1)
    assert torch.equal(weights, want)


@pytest.mark.parametrize("flag", ["cudnn_tf32", "matmul_tf32", "bf16_reduction"])
def test_set_cuda_flags_keeps_reduced_precision_off(flag, monkeypatch):
    """TF32 in cuDNN and cuBLAS, and cuBLAS's bf16 reduced-precision
    reduction (PyTorch's default lets split-K sum bf16 partials in bf16;
    XLA sums bf16 dots in f32), end up off whatever was set before."""
    attrs = {"cudnn_tf32": (torch.backends.cudnn, "allow_tf32"),
             "matmul_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
             "bf16_reduction": (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction")}
    obj, name = attrs[flag]
    monkeypatch.setattr(obj, name, True)
    set_cuda_flags()
    assert getattr(obj, name) is False
