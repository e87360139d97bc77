"""Text-prior distillation loss (counterpart of ``tatt_tpu/losses/distill.py``).

``semantic_loss`` mirrors ``loss/semantic_loss.py:10-38``: mean |gt - pred|
plus torch ``KLDivLoss`` with its default 'mean' reduction (an elementwise
mean) between log(pred) and the teacher distribution.  The train step
scales it by 100.
"""

from __future__ import annotations

import torch


def semantic_loss(pred_vec: torch.Tensor, gt_vec: torch.Tensor) -> torch.Tensor:
    """``pred_vec`` / ``gt_vec``: softmax distributions of one shape
    ([T, B, C] in the train step)."""
    margin = (gt_vec - pred_vec).abs().mean()
    gt = gt_vec + 1e-20
    return margin + (gt * (torch.log(gt) - torch.log(pred_vec + 1e-20))).mean()
