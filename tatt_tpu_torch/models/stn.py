"""STN head and thin-plate-spline rectification
(counterpart of ``tatt_tpu/models/stn.py``).

``STNHead`` is ``model/stn_head.py`` (the generator's, 16x64 in) or
``model/recognizer/stn_head.py`` (ASTER's, 32x64 in): six conv-BN-ReLU
blocks pooling down to 1x2, then fc1 + BatchNorm1d + ReLU and fc2 to 20
control points, fc2 starting at the identity border grid.  fc1 reads the
pooled map of the head's ``input_size`` (flax infers it from the input):
512 inputs at 16x64, 2048 at 32x128, none at 8x32, whose map pools to no
rows, as in JAX.  Module names follow the reference (``stn_head.stn_convnet.{0,2,..,10}``,
``stn_fc1``, ``stn_fc2``; ``torch_import.py:264-281``).  ``tps_transform``
solves the TPS mapping from precomputed numpy matrices in f32 (TF32 off,
``core/device.py``) and samples bilinearly at those f32 positions, whatever
the images' dtype (a deliberate difference from the JAX package, which
rounds the grid to the compute dtype: ROADMAP C.3).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.kernels.grid_sample import grid_sample_bilinear
from tatt_tpu_torch.models.common import BatchNorm1d, BatchNorm2d, Conv2d, Dense, max_pool


def build_output_control_points(num_ctrl: int, margins=(0.05, 0.05)) -> np.ndarray:
    """Border control points (``tps_spatial_transformer.py:38-50``)."""
    margin_x, margin_y = margins
    per_side = num_ctrl // 2
    xs = np.linspace(margin_x, 1.0 - margin_x, per_side)
    top = np.stack([xs, np.full(per_side, margin_y)], axis=1)
    bottom = np.stack([xs, np.full(per_side, 1.0 - margin_y)], axis=1)
    return np.concatenate([top, bottom], axis=0).astype(np.float64)


def _partial_repr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """phi(r) = r^2 log(r^2) / 2 with 0 log 0 -> 0."""
    dist = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rep = 0.5 * dist * np.log(dist)
    rep[~np.isfinite(rep)] = 0.0
    return rep


@lru_cache(maxsize=None)
def tps_matrices(
    target_h: int, target_w: int, num_ctrl: int, margins: tuple[float, float]
) -> tuple[np.ndarray, np.ndarray]:
    """(inverse_kernel [K+3, K+3], target_coordinate_repr [HW, K+3]) as
    ``tps_spatial_transformer.py:66-94`` precomputes them."""
    tcp = build_output_control_points(num_ctrl, margins)
    n = num_ctrl
    forward_kernel = np.zeros((n + 3, n + 3))
    forward_kernel[:n, :n] = _partial_repr(tcp, tcp)
    forward_kernel[:n, -3] = 1.0
    forward_kernel[-3, :n] = 1.0
    forward_kernel[:n, -2:] = tcp
    forward_kernel[-2:, :n] = tcp.T
    inverse_kernel = np.linalg.inv(forward_kernel)
    yx = np.array([(y, x) for y in range(target_h) for x in range(target_w)], dtype=np.float64)
    coord = np.stack([yx[:, 1] / (target_w - 1), yx[:, 0] / (target_h - 1)], axis=1)
    repr_mat = np.concatenate(
        [_partial_repr(coord, tcp), np.ones((target_h * target_w, 1)), coord], axis=1
    )
    return inverse_kernel.astype(np.float32), repr_mat.astype(np.float32)


def tps_transform(
    images: torch.Tensor,
    source_ctrl: torch.Tensor,
    output_size: tuple[int, int],
    margins: tuple[float, float] = (0.05, 0.05),
) -> torch.Tensor:
    """Warp ``images`` [N, C, H, W] by the TPS that maps the border control
    points to ``source_ctrl`` [N, K, 2] (``tps_spatial_transformer.py:97-112``).
    The solve stays in full f32: the inverse kernel's entries reach +-87
    and cancel down to coordinates in [0, 1] (``stn.py:94-97``).  The grid
    stays f32 too: bf16 images are sampled in f32 at those positions and
    the result returned in bf16 (JAX's bf16 grid moves a sample by up to
    ~0.19 px, ``ADVICE.md``)."""
    n, k = source_ctrl.shape[:2]
    th, tw = output_size
    inv_k, coord_repr = (
        torch.as_tensor(m, device=images.device) for m in tps_matrices(th, tw, k, tuple(margins))
    )
    padded = torch.cat([source_ctrl.float(), source_ctrl.new_zeros(n, 3, 2, dtype=torch.float32)], 1)
    mapping = torch.einsum("ab,nbc->nac", inv_k, padded)
    source_coord = torch.einsum("ha,nac->nhc", coord_repr, mapping)  # [N, HW, 2] in [0, 1]
    grid = source_coord.reshape(n, th, tw, 2).clamp(0.0, 1.0) * 2.0 - 1.0
    if images.dtype == torch.bfloat16:
        return grid_sample_bilinear(images.float(), grid).to(images.dtype)
    return grid_sample_bilinear(images, grid.to(images.dtype))


class _LayerBN(nn.Module):
    """``.0`` a conv or linear layer, ``.1`` its BatchNorm; ReLU after
    (``stn_convnet.<i>`` and ``stn_fc1`` of the reference)."""

    def __init__(self, layer: nn.Module, bn: nn.Module):
        super().__init__()
        self.add_module("0", layer)
        self.add_module("1", bn)

    def forward(self, x: torch.Tensor, copies: int) -> torch.Tensor:
        return torch.relu(getattr(self, "1")(getattr(self, "0")(x), copies))


class _Pool(nn.Module):
    def __init__(self, window: tuple[int, int]):
        super().__init__()
        self.window = window

    def forward(self, x: torch.Tensor, copies: int) -> torch.Tensor:
        return max_pool(x, self.window, self.window)


class _FC2(nn.Module):
    """``stn_fc2``: Linear 512 -> 2K starting at zero weights and the
    identity border grid as bias (``stn.py:165-176``)."""

    def __init__(self, n_in: int, num_ctrl: int):
        super().__init__()
        self.num_ctrl = num_ctrl
        self.weight = nn.Parameter(torch.zeros(2 * num_ctrl, n_in))
        self.bias = nn.Parameter(torch.zeros(2 * num_ctrl))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.zero_()
        ctrl = build_output_control_points(self.num_ctrl, (0.01, 0.01)).astype(np.float32)
        self.bias.copy_(torch.from_numpy(ctrl.reshape(-1)))


# each head's pools (None: no pool after that block) and input size
_POOLS = {v: ((2, 2), (2, 2), (2, 2), (2, 2), last, None)
          for v, last in (("generator", (1, 2)), ("aster", (2, 2)))}
_INPUT = {"generator": (16, 64), "aster": (32, 64)}


def pooled_map(input_size: tuple[int, int], variant: str = "generator") -> tuple[int, int]:
    """The (H, W) of the head's last map for ``input_size`` images, pooled
    as JAX's VALID windows pool (``common.py:586``): (1, 2) at 16x64, (2,
    4) at 32x128, (0, 1) at 8x32, a map of nothing."""
    h, w = input_size
    for pool in _POOLS[variant]:
        if pool is not None:
            h, w = max((h - pool[0]) // pool[0] + 1, 0), max((w - pool[1]) // pool[1] + 1, 0)
    return h, w


class STNHead(nn.Module):
    """``stn.py:124-178``: [N, C, H, W] -> control points [N, K, 2].
    ``variant='generator'`` pools like the TATT generator's head (16x64
    input -> 1x2), ``variant='aster'`` like the ASTER recognizer's (five
    2x2 pools, 32x64 input -> 1x2, ``model/recognizer/stn_head.py:33-44``).
    ``input_size`` (H, W): the images it reads (None: the variant's), whose
    :func:`pooled_map` fc1 reads; the generator's reads the LR crop.  A
    map pooled to nothing gives fc1 no inputs, as in JAX; it is built (a
    checkpoint holds it) but not run: JAX's BatchNorm over the empty maps
    makes NaN gradients there (ROADMAP C.4), and torch refuses the conv."""

    def __init__(self, in_planes: int, num_ctrlpoints: int = 20, variant: str = "generator",
                 input_size: Optional[tuple[int, int]] = None):
        super().__init__()
        chans = (32, 64, 128, 256, 256, 256)
        layers, cin = [], in_planes
        for c, pool in zip(chans, _POOLS[variant]):
            layers.append(_LayerBN(Conv2d(cin, c), BatchNorm2d(c)))
            if pool is not None:
                layers.append(_Pool(pool))
            cin = c
        h, w = self.pooled = pooled_map(input_size or _INPUT[variant], variant)
        self.num_ctrlpoints = num_ctrlpoints
        self.stn_convnet = nn.ModuleList(layers)
        self.stn_fc1 = _LayerBN(Dense(chans[-1] * h * w, 512), BatchNorm1d(512))
        self.stn_fc2 = _FC2(512, num_ctrlpoints)

    def forward(self, x: torch.Tensor, copies: int = 1) -> torch.Tensor:
        if 0 in self.pooled:
            raise ValueError(f"the STN head pools its {tuple(x.shape[2:])} input to nothing")
        for layer in self.stn_convnet:
            x = layer(x, copies)
        x = self.stn_fc1(x.flatten(1), copies)  # NCHW flatten, as fc1's weight expects
        pts = torch.nn.functional.linear(0.1 * x, self.stn_fc2.weight.to(x.dtype),
                                         self.stn_fc2.bias.to(x.dtype))
        return pts.reshape(x.shape[0], self.num_ctrlpoints, 2)
