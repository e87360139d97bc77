"""The degradation mission (counterpart of ``tatt_tpu/train/degrade.py``):
one step of the reference's ``TextDegrade`` trainer
(``interfaces/degradation.py:50-244``, which its ``main.py`` does not
wire, nor does either CLI).

A degradation generator maps HR to a realistic LR and a deblur generator
maps that back to HR, trained jointly:
``loss = 100 image_loss(degrade(HR) -> LR size, LR) + 100 image_loss(
deblur(that) -> HR size, HR)``; each output is resized (bicubic) to its
target's size, since an SR arch upscales whatever it is given.  Adam with
each model's gradients clipped at 0.25 on their own; both models' BatchNorm
statistics advance (they run in training mode).
"""

from __future__ import annotations

import torch
from torch import nn

from tatt_tpu_torch.data.device_pipeline import prep_image_batch
from tatt_tpu_torch.kernels.resize import resize_bicubic
from tatt_tpu_torch.losses.image import image_loss
from tatt_tpu_torch.train.state import clip_grads_per_model
from tatt_tpu_torch.train.steps import _backward


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def degrade_step(degrader: nn.Module, deblurrer: nn.Module, optimizer: torch.optim.Optimizer,
                 batch: dict, mask: bool = True) -> dict:
    """``batch``: ``images_hr`` [B, H, W, 3] / ``images_lr`` [B, H/s, W/s, 3]
    uint8 crops of any geometry (normalized here, with the mask channel
    when ``mask``) or float [B, C, H, W]; ``optimizer`` over both models, which are in
    training mode.  Returns ``loss_total``, ``loss_degrade`` and
    ``loss_deblur`` as device scalars."""
    batch = prep_image_batch(batch, mask)
    images_hr, images_lr = batch["images_hr"], batch["images_lr"]
    (lh, lw), (hh, hw) = images_lr.shape[-2:], images_hr.shape[-2:]
    images_dr_lr = resize_bicubic(_first(degrader(images_hr)), lh, lw)
    images_sr = resize_bicubic(_first(deblurrer(images_dr_lr)), hh, hw)
    loss_degrade = image_loss(images_dr_lr, images_lr).mean() * 100.0
    loss_deblur = image_loss(images_sr, images_hr).mean() * 100.0
    total = loss_degrade + loss_deblur
    _backward(optimizer, total)
    clip_grads_per_model([degrader, deblurrer], 0.25)
    optimizer.step()
    return {"loss_total": total.detach(), "loss_degrade": loss_degrade.detach(),
            "loss_deblur": loss_deblur.detach()}
