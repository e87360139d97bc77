"""VGG16 features, the LPIPS-VGG eval metric and the perceptual generator
loss (counterpart of ``tatt_tpu/losses/perceptual.py``).

LPIPS-VGG is reported at eval when its two external checkpoints are given
(``super_resolution.py:41-43, 1409-1420``): torchvision's VGG16 (its
``features`` tower, here :class:`VGG16Features`, whose ``state_dict`` keys
are torchvision's ``features.<i>`` without the prefix) and the lpips
package's five linear heads.  ``GeneratorLoss`` (``percptual_loss.py:7-47``)
is imported by the reference and unused on the TATT path; it is here as
:func:`generator_loss`.  The convolutions are ``F.conv2d`` (cuDNN, full
float32), as JAX computes them in XLA.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.models.common import Conv2d, max_pool

# torchvision VGG16 conv plan: channels per conv, "M" a 2x2 max pool
VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
# torchvision ``features`` indices of the LPIPS taps: relu1_2, relu2_2,
# relu3_3, relu4_3, relu5_3
LPIPS_TAPS = (3, 8, 15, 22, 29)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16's ``features`` tower; ``forward`` returns every ReLU and pool
    output keyed by its torchvision layer index."""

    def __init__(self):
        super().__init__()
        cin, idx = 3, 0
        for spec in VGG16_PLAN:
            if spec == "M":
                idx += 1
                continue
            self.add_module(str(idx), Conv2d(cin, spec))
            cin, idx = spec, idx + 2

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        outs, idx = {}, 0
        for spec in VGG16_PLAN:
            if spec == "M":
                x = max_pool(x, (2, 2), (2, 2))
                outs[idx] = x
                idx += 1
                continue
            x = torch.relu(getattr(self, str(idx))(x))
            outs[idx + 1] = x
            idx += 2
        return outs


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """TV term of ``percptual_loss.py:30-41``."""
    n, _, h, w = x.shape
    count_h = x[:, :, 1:, :].numel() / n
    count_w = x[:, :, :, 1:].numel() / n
    h_tv = (x[:, :, 1:, :] - x[:, :, : h - 1, :]).square().sum()
    w_tv = (x[:, :, :, 1:] - x[:, :, :, : w - 1]).square().sum()
    return 2.0 * (h_tv / count_h + w_tv / count_w) / n


def generator_loss(vgg: VGG16Features, out_images: torch.Tensor, target_images: torch.Tensor,
                   tap: int = 31) -> torch.Tensor:
    """``GeneratorLoss``: image MSE + 0.006 * the MSE of ``features[:tap]``
    (for 31, the last layer is pool5, index 30) + 2e-8 * TV."""
    f_out, f_tgt = vgg(out_images[:, :3]), vgg(target_images[:, :3])
    key = max(k for k in f_out if k < tap)
    perception = (f_out[key] - f_tgt[key]).square().mean()
    return (out_images - target_images).square().mean() + 0.006 * perception + 2e-8 * total_variation(out_images)


def import_lpips(vgg16_path_or_sd, lpips_path_or_sd) -> tuple[VGG16Features, list[torch.Tensor]]:
    """The two checkpoints behind ``lpips.LPIPS(net='vgg')``: torchvision's
    VGG16 (whole, ``features.<i>.*``, or its ``features`` alone) and the
    lpips heads (``lin<i>.model.1.weight``), as paths or state dicts.
    Returns (the loaded :class:`VGG16Features` in eval mode, the five [C]
    head weights) for :func:`lpips_vgg`."""
    from tatt_tpu_torch.core.convert import load_reference_pth

    def read(x):
        return load_reference_pth(x) if isinstance(x, str) else x

    vgg_sd = read(vgg16_path_or_sd)
    feats = {k[len("features."):]: v for k, v in vgg_sd.items() if k.startswith("features.")} or vgg_sd
    vgg = VGG16Features()
    vgg.load_state_dict({k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in feats.items()})
    lp = read(lpips_path_or_sd)
    lin = [torch.as_tensor(np.asarray(lp[f"lin{i}.model.1.weight"]), dtype=torch.float32).reshape(-1)
           for i in range(5)]
    return vgg.eval(), lin


def lpips_vgg(vgg: VGG16Features, lin_weights: Sequence[torch.Tensor], img0: torch.Tensor,
              img1: torch.Tensor) -> torch.Tensor:
    """LPIPS(VGG) distance per sample of two [N, >=3, H, W] batches in
    [0, 1] (lpips's x2-1, shift and scale inside)."""
    shift = img0.new_tensor(_LPIPS_SHIFT)[None, :, None, None]
    scale = img0.new_tensor(_LPIPS_SCALE)[None, :, None, None]
    f0 = vgg(((img0[:, :3] * 2.0 - 1.0) - shift) / scale)
    f1 = vgg(((img1[:, :3] * 2.0 - 1.0) - shift) / scale)
    total = 0.0
    for tap, w in zip(LPIPS_TAPS, lin_weights):
        a = f0[tap] / (f0[tap].square().sum(1, keepdim=True).sqrt() + 1e-10)
        b = f1[tap] / (f1[tap].square().sum(1, keepdim=True).sqrt() + 1e-10)
        diff = (a - b).square()
        total = total + (diff * w.to(diff).reshape(1, -1, 1, 1)).sum(1, keepdim=True).mean(dim=(1, 2, 3))
    return total
