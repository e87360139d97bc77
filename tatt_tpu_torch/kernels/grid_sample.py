"""Bilinear grid sampling, affine grids and the rotation augmentation
(counterpart of ``tatt_tpu/kernels/grid_sample.py``).

The JAX module is plain XLA with no Pallas kernel, so PyTorch's own ops
serve here: ``F.grid_sample`` (bilinear, zero padding) and
``F.affine_grid`` with ``align_corners=False`` are the torch semantics
that the JAX gather form reproduces (``grid_sample.py:19-61,118-139``).
Rotation is that exact affine + bilinear form (``rotate_batch`` with
``method="gather"``, ``grid_sample.py:200-225``), which the JAX package
runs on the CPU.  The JAX package's TPU-only 3-shear approximation
(``rotate_batch_shear``, ``:176-197``, which smooths slightly more than
one bilinear pass) is not ported: on the card the exact form is one
fused sampling kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``x`` [N, C, H, W], ``grid`` [N, Ho, Wo, 2] of (x, y) in [-1, 1]:
    bilinear samples with zero padding, ``align_corners=False``."""
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def affine_grid(theta: torch.Tensor, size: tuple[int, int, int, int]) -> torch.Tensor:
    """Torch ``affine_grid`` (``align_corners=False``): ``theta`` [N, 2, 3]
    -> grid [N, H, W, 2] of sampling locations in [-1, 1]."""
    return F.affine_grid(theta, list(size), align_corners=False)


def rotate_batch(
    images: torch.Tensor, arc: torch.Tensor, rand_offs: torch.Tensor, off_range: float = 0.2
) -> torch.Tensor:
    """Batched rotation with aspect-ratio compensation, the reference's
    ``torch_rotate_img`` (``interfaces/super_resolution.py:126-157``).
    ``arc`` [N] angles in radians, ``rand_offs`` [N] uniforms in [0, 1)."""
    n, c, h, w = images.shape
    ratios = h / float(w) + rand_offs * off_range * 2.0 - off_range
    cos, sin = torch.cos(arc), torch.sin(arc)
    zero = torch.zeros_like(arc)
    theta = torch.stack([cos, sin * ratios, zero, -sin / ratios, cos, zero], dim=1)
    return grid_sample_bilinear(images, affine_grid(theta.reshape(n, 2, 3), (n, c, h, w)))
