"""Image reconstruction loss (counterpart of ``tatt_tpu/losses/image.py``).

``image_loss`` mirrors ``loss/image_loss.py:10-57``: per-sample MSE over
every channel plus 1e-4 x the L1 between central-difference gradient maps
of the RGB channels (``loss_weight=[1, 1e-4]`` for every TL arch).  The
train step multiplies the mean by 100.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gradient_map(x: torch.Tensor) -> torch.Tensor:
    """sqrt(((r-l)/2)^2 + ((t-b)/2)^2 + 1e-6) with zero-padded shifts
    (``loss/image_loss.py:50-58``)."""
    h, w = x.shape[-2:]
    r = F.pad(x, (0, 1))[..., :, 1:]
    l = F.pad(x, (1, 0))[..., :, :w]  # noqa: E741
    t = F.pad(x, (0, 0, 1, 0))[..., :h, :]
    b = F.pad(x, (0, 0, 0, 1))[..., 1:, :]
    return torch.sqrt(((r - l) * 0.5) ** 2 + ((t - b) * 0.5) ** 2 + 1e-6)


def image_loss(
    out_images: torch.Tensor,
    target_images: torch.Tensor,
    gradient: bool = True,
    loss_weight: tuple[float, float] = (1.0, 1e-4),
) -> torch.Tensor:
    """Per-sample loss [N] (the train step takes the mean)."""
    loss = loss_weight[0] * ((out_images - target_images) ** 2).mean(dim=(1, 2, 3))
    if gradient:
        diff = (gradient_map(out_images[:, :3]) - gradient_map(target_images[:, :3])).abs()
        loss = loss + loss_weight[1] * diff.mean(dim=(1, 2, 3))
    return loss
