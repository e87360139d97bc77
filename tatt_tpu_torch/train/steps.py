"""The eval step (counterpart of ``tatt_tpu/train/steps.py:make_eval_step``).

Student CRNN prior -> TATT forward in eval mode, including the
``stu_iter`` cascade of ``model_inference`` (``super_resolution.py:240-449``).
``--for_cascading`` (generator input blended with the previous SR) is not
ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input


@torch.no_grad()
def eval_step(
    generators: Sequence[nn.Module],
    students: Sequence[nn.Module],
    images_lr: torch.Tensor,
    stu_iter: int = 1,
):
    """``images_lr`` [N, 4, 16, 64] -> (SR of the last iteration, aux).

    ``generators`` / ``students`` hold one shared module (``--sr_share`` /
    ``--tpg_share``) or one per iteration.  At iteration i > 0 the student
    reads the previous SR output (``super_resolution.py:316-318,374-376``);
    the generator always reads the LR input."""
    cascade = images_lr
    sr = aux = None
    for i in range(stu_iter):
        lr_luma = parse_crnn_input(cascade[:, :3])
        student = students[i if len(students) > 1 else 0]
        generator = generators[i if len(generators) > 1 else 0]
        logits = student(lr_luma)  # [T, N, 37]
        prior = torch.softmax(logits, dim=-1).permute(1, 2, 0)[:, :, None, :]
        sr, aux = generator(images_lr, prior)
        cascade = sr
    return sr, aux
