"""Separable resize as two float32 matmuls, and BT.601 luma.

Counterpart of ``tatt_tpu/kernels/resize.py``: the same [out, in] weight
matrices (bicubic Keys kernel with a = -0.75 and edge clamping, matching
torch's ``upsample_bicubic2d`` with ``align_corners=False``; bilinear
matching ``F.interpolate(mode='bilinear')``), applied as two f32 matmuls,
and the nearest x``s`` upsampling of ``F.interpolate``'s default.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


@lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int, a: float) -> np.ndarray:
    """[out_size, in_size] cubic interpolation weights, edge-clamped."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (dst.astype(np.int64), idx), _cubic_kernel(frac - tap, a))
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """[out_size, in_size] bilinear weights."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = np.maximum((dst + 0.5) * in_size / out_size - 0.5, 0.0)
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = dst.astype(np.int64)
    np.add.at(mat, (rows, np.clip(base, 0, in_size - 1)), 1.0 - frac)
    np.add.at(mat, (rows, np.clip(base + 1, 0, in_size - 1)), frac)
    return mat.astype(np.float32)


def _apply(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray) -> torch.Tensor:
    th = torch.as_tensor(wh, device=x.device)
    tw = torch.as_tensor(ww, device=x.device)
    y = torch.matmul(torch.matmul(th, x.float()), tw.T)
    return y.to(x.dtype)


def resize_bicubic(
    x: torch.Tensor, out_h: int, out_w: int, a: float = -0.75
) -> torch.Tensor:
    """Bicubic resize of NCHW (or ...HW) images via two matmuls."""
    h, w = x.shape[-2], x.shape[-1]
    return _apply(x, _resize_matrix(h, out_h, a), _resize_matrix(w, out_w, a))


def resize_bilinear(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of ...HW images via two matmuls."""
    h, w = x.shape[-2], x.shape[-1]
    return _apply(
        x,
        _linear_matrix(h, out_h, align_corners),
        _linear_matrix(w, out_w, align_corners),
    )


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Torch ``F.interpolate(scale_factor=s)`` default (nearest) for NCHW:
    each pixel repeated ``scale`` times along H and W
    (``tatt_tpu/kernels/resize.py:114``)."""
    return x.repeat_interleave(scale, dim=-2).repeat_interleave(scale, dim=-1)


def rgb_to_luma(x: torch.Tensor) -> torch.Tensor:
    """BT.601 luma 0.299 R + 0.587 G + 0.114 B: NCHW in, [N, 1, H, W] out."""
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]
