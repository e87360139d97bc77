"""Shared building blocks (counterpart of ``tatt_tpu/models/common.py``).

NCHW at module boundaries, OIHW conv weights, torch-default
initialization drawn from an explicit ``torch.Generator``
(:func:`init_parameters`).  Parameter names follow the reference PyTorch
modules, so a model's ``state_dict`` has the reference layout.

Every layer follows its input's dtype, as the JAX layers do under
``--dtype bfloat16`` (``common.py:236-271, 547, 562-565``): the float32
parameters are cast to it (their gradients come back in float32), and
BatchNorm takes its statistics and normalizes in float32 and returns the
input's dtype (``:384-536``).  So a bf16 input stays bf16 through every
layer, and no float32 parameter promotes an activation back to float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) — ``tatt_tpu/models/common.py:31``."""
    return x * torch.tanh(F.softplus(x))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW PixelShuffle [N, C*r^2, H, W] -> [N, C, H*r, W*r] with the torch
    channel packing order (c, py, px) — the same map as the JAX package's
    ``pixel_shuffle_nhwc`` (``common.py:56``) in NCHW."""
    n, c, h, w = x.shape
    oc = c // (r * r)
    x = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, oc, h * r, w * r)


def max_pool(
    x: torch.Tensor,
    window: tuple[int, int],
    strides: tuple[int, int],
    padding: tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Torch-style MaxPool2d on NCHW (``max_pool_nhwc``, ``common.py:586``):
    padding counts as -inf."""
    return F.max_pool2d(x, window, strides, padding)


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.uniform_(-bound, bound, generator=gen)


def _torch_bound(fan_in: int) -> float:
    """torch's default U(-b, b) bound, 1 / sqrt(fan_in); 0 for a layer with
    no inputs (a squeeze-excite's zero-width bottleneck at shrunk widths),
    as the JAX package's ``torch_conv_init`` gives it."""
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


class Conv2d(nn.Module):
    """Conv with explicit symmetric padding and a stride, OIHW weight.

    The JAX package computes TATT's final 9x9 conv through a TPU
    lane-packing trick (``common.py:130-188``); it is the same linear map,
    so the port computes that conv directly from the same weights."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: tuple[int, int] = (3, 3),
        padding: tuple[int, int] = (1, 1),
        bias: bool = True,
        stride: tuple[int, int] = (1, 1),
    ):
        super().__init__()
        self.padding, self.stride = padding, stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = _torch_bound(fan_in)
        _uniform(self.weight, bound, gen)
        if self.bias is not None:
            _uniform(self.bias, bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


class ConvTranspose2d(nn.Module):
    """Torch ``nn.ConvTranspose2d`` geometry with an IOHW weight and no
    bias, as InfoGen uses it (``common.py:276-314``, ``model/tsrn.py:284-317``).
    The JAX kernel is stored in this layout, so its weight carries over as
    is."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: tuple[int, int] = (3, 3),
        stride: tuple[int, int] = (2, 2),
        padding: tuple[int, int] = (0, 0),
    ):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, *kernel_size))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # torch's fan_in of a transposed conv: out_channels * kh * kw
        bound = _torch_bound(self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3])
        _uniform(self.weight, bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)


class _BatchNorm(nn.Module):
    """BatchNorm over every axis but 1, torch eps/momentum defaults
    (``common.py:336-536``).  Eval mode normalizes with the running
    statistics.  Training mode takes batch statistics in float32 with a
    two-pass variance; ``copies`` > 1 says the batch packs that many
    equal logical batches (the fused-tssim 2B forward), and the statistics
    are then per copy, each copy normalized as its own forward would be,
    and the running statistics folded copy by copy in concat order with the
    unbiased variance.  Chosen per call, over one set of parameters.
    Per-replica statistics (``set_bn_replicas``) wait for multi-GPU."""

    momentum = 0.1  # torch's; the JAX package's 0.9 is 1 - this

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, copies: int = 1) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.dim() - 2)  # [C] -> broadcastable over x
        red = (0, *range(2, x.dim()))
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.float() - self.running_mean.view(shape)) * inv.view(shape)
            return (y + self.bias.view(shape)).to(x.dtype)
        parts = x.float().chunk(copies)
        if len(parts) != copies or parts[-1].shape[0] != parts[0].shape[0]:
            raise ValueError(f"batch {x.shape[0]} does not split into {copies} equal copies")
        ys = []
        for p in parts:
            mean = p.mean(red)
            var = (p - mean.view(shape)).square().mean(red)
            n = p.numel() // p.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var * (n / max(n - 1, 1)))
            inv = torch.rsqrt(var + self.eps) * self.weight
            ys.append((p - mean.view(shape)) * inv.view(shape) + self.bias.view(shape))
        return torch.cat(ys).to(x.dtype)


class BatchNorm2d(_BatchNorm):
    """BatchNorm over NCHW (statistics over N, H, W)."""


class BatchNorm1d(_BatchNorm):
    """BatchNorm over [N, C] (the STN head's fc, ``model/stn_head.py:51``)."""


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawn from ``gen`` (a generator on ``x``'s device),
    as flax ``nn.Dropout``: keep with probability 1 - rate, scale by
    1 / (1 - rate).  Identity when ``gen`` is None or ``rate`` is 0 (eval)."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class PReLU(nn.Module):
    """Torch PReLU with one learned slope, init 0.25."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class Dense(nn.Module):
    """Linear layer on the last axis, torch layout (weight [out, in])."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = _torch_bound(self.weight.shape[1])
        _uniform(self.weight, bound, gen)
        if self.bias is not None:
            _uniform(self.bias, bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class JaxNamed(nn.Module):
    """A generator whose top-level modules carry the names of its JAX
    counterpart's top-level modules, so that the train step's
    ``gnorm/<module>`` metrics group its parameters by its children."""

    def jax_module_params(self) -> dict[str, list[nn.Parameter]]:
        groups: dict[str, list[nn.Parameter]] = {}
        for name, p in self.named_parameters():
            groups.setdefault(name.split(".")[0], []).append(p)
        return groups


def check_copies(copies: int) -> None:
    """The zoo's generators take the TATT step's ``copies`` argument but
    hold no per-copy BatchNorm: the step never packs copies for them
    (``factory.arch_steps``), and a packed batch is refused here rather
    than normalized as one."""
    if copies != 1:
        raise ValueError(f"this generator runs one copy a forward (copies={copies})")


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``model`` with torch-default ranges from one
    ``torch.Generator`` seeded with ``seed`` (modules in registration
    order).  Returns ``model``."""
    gen = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return model
