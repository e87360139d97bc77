"""Image reconstruction losses (counterpart of ``tatt_tpu/losses/image.py``).

``image_loss`` mirrors ``loss/image_loss.py:10-57``: per-sample MSE over
every channel plus 1e-4 x the L1 between central-difference gradient maps
of the RGB channels (``loss_weight=[1, 1e-4]`` for every TL arch).  The
baselines' criteria (``mse_loss``, ``l1_loss``, ``charbonnier_loss``,
``edge_image_loss``) also return per-sample losses [N]; the train step
takes the mean and multiplies it by 100.
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


def mse_loss(out_images: torch.Tensor, target_images: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE [N] (``nn.MSELoss`` with a late mean)."""
    return ((out_images - target_images) ** 2).mean(dim=(1, 2, 3))


def l1_loss(out_images: torch.Tensor, target_images: torch.Tensor) -> torch.Tensor:
    return (out_images - target_images).abs().mean(dim=(1, 2, 3))


def charbonnier_loss(
    out_images: torch.Tensor, target_images: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """L1-Charbonnier (``model/lapsrn.py:126-137``) as per-sample means, as
    the JAX package keeps it (the reference sums)."""
    diff = out_images - target_images
    return torch.sqrt(diff * diff + eps).mean(dim=(1, 2, 3))


def _sobel_map(x: torch.Tensor) -> torch.Tensor:
    """Sobel edge magnitude over RGB (``loss/image_loss.py:88-126``): each
    output channel sums the kernel over every input channel, as the
    reference's [C, C, 3, 3] weight does."""
    kh = torch.tensor([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]],
                      dtype=x.dtype, device=x.device)
    c = x.shape[1]
    h = F.conv2d(x, kh.expand(c, c, 3, 3), padding=1)
    v = F.conv2d(x, kh.T.expand(c, c, 3, 3), padding=1)
    return torch.sqrt((h * 0.5) ** 2 + (v * 0.5) ** 2 + 1e-6)


def edge_image_loss(
    out_images: torch.Tensor,
    target_images: torch.Tensor,
    loss_weight: tuple[float, float] = (20.0, 1e-4),
) -> torch.Tensor:
    """``EdgeImageLoss`` (``loss/image_loss.py:61-80``): w0 MSE + w1 0.1
    L1 of the Sobel maps, per sample."""
    edge = (_sobel_map(out_images[:, :3]) - _sobel_map(target_images[:, :3])).abs()
    return loss_weight[0] * mse_loss(out_images, target_images) + loss_weight[1] * edge.mean(
        dim=(1, 2, 3)) * 0.1


def image_loss(
    out_images: torch.Tensor,
    target_images: torch.Tensor,
    gradient: bool = True,
    loss_weight: tuple[float, float] = (1.0, 1e-4),
) -> torch.Tensor:
    """Per-sample loss [N] (the train step takes the mean)."""
    loss = loss_weight[0] * mse_loss(out_images, target_images)
    if gradient:
        diff = (gradient_map(out_images[:, :3]) - gradient_map(target_images[:, :3])).abs()
        loss = loss + loss_weight[1] * diff.mean(dim=(1, 2, 3))
    return loss
