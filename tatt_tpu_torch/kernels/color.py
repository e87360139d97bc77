"""YUV <-> RGB conversions (copied from ``tatt_tpu/kernels/color.py``,
kornia coefficients, ``interfaces/super_resolution.py:160-237``).  The
JAX package defines them and calls neither; the ``--y_domain`` path reads
PIL's ``YCbCr`` crops from the collate instead."""

from __future__ import annotations

import torch


def yuv_to_rgb(image: torch.Tensor) -> torch.Tensor:
    """[*, 3, H, W] YUV in [0, 1] -> RGB (``super_resolution.py:160-193``)."""
    y, u, v = image[..., 0, :, :], image[..., 1, :, :], image[..., 2, :, :]
    return torch.stack([y + 1.14 * v, y - 0.396 * u - 0.581 * v, y + 2.029 * u], dim=-3)


def rgb_to_yuv(image: torch.Tensor) -> torch.Tensor:
    """[*, 3, H, W] RGB -> YUV (``super_resolution.py:204-237``)."""
    r, g, b = image[..., 0, :, :], image[..., 1, :, :], image[..., 2, :, :]
    return torch.stack(
        [0.299 * r + 0.587 * g + 0.114 * b, -0.147 * r - 0.289 * g + 0.436 * b,
         0.615 * r - 0.515 * g - 0.100 * b],
        dim=-3,
    )
