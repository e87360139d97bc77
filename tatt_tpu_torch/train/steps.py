"""The train and eval steps (counterpart of ``tatt_tpu/train/steps.py``).

:func:`train_step` is ``make_train_step`` (``steps.py:93-392``) for the
canonical recipe (``scripts/train_TATT.sh``: ``--STN --mask --use_distill
--gradient --sr_share --stu_iter=1 --rotate_train=5 --tssim_loss``):
rotation augmentation, the frozen teacher's prior from HR, the student's
prior from LR (its gradient stopped), the generator forward, then image,
TRI-SSIM and distillation losses, one backward, per-model clipping of the
SR gradients, one Adam step.  With ``fused_tssim`` the counter-rotated
copy runs in the same 2B forward with per-copy BatchNorm statistics
(``steps.py:230-250``).

:func:`eval_step` is ``make_eval_step`` (``steps.py:553-610``) including
the ``stu_iter`` cascade of ``model_inference``.  ``--for_cascading``
(generator input blended with the previous SR) is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from tatt_tpu_torch.kernels.grid_sample import rotate_batch
from tatt_tpu_torch.losses.distill import semantic_loss
from tatt_tpu_torch.losses.image import image_loss
from tatt_tpu_torch.losses.ssim import tri_ssim
from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input
from tatt_tpu_torch.train.state import clip_grads_per_model, grad_norm


GRAD_CLIP = 0.25  # per-model SR gradient clip (super_resolution.py:1083-1084)
ROTATE_DEGREES = 5.0  # --rotate_train of the recipe


@dataclass(frozen=True)
class StepConfig:
    """The recipe's one choice: the JAX ``StepConfig`` (``steps.py:30-59``)
    with ``use_distill``, ``gradient``, ``tssim_loss``, ``rotate_train=5``,
    ``stu_iter`` 1 and ``sr_share``, no ``use_label`` / ``for_cascading``
    / ``y_domain`` / ``learning_STN`` / ``ssim_loss`` / ``mse_fuse`` /
    ``training_stablize``, float32.  ``fused_tssim`` runs sr and the
    counter-rotated sr_ret in one 2B forward (else two forwards)."""

    fused_tssim: bool = True


def _rotation(batch: dict, n: int, gen: torch.Generator):
    """(arc, rand_offs) [N]: the batch's ``rot_arc`` / ``rot_offs`` when it
    pins them (``steps.py:137-140``), else drawn uniformly from ``gen``."""
    if "rot_arc" in batch:
        return batch["rot_arc"], batch["rot_offs"]
    dev = batch["images_lr"].device
    angle = (torch.rand(n, generator=gen, device=dev) * 2.0 - 1.0) * ROTATE_DEGREES
    return angle / 180.0 * math.pi, torch.rand(n, generator=gen, device=dev)


def train_step(
    generator: nn.Module,
    student: nn.Module,
    teacher: nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    cfg: StepConfig,
    gen: torch.Generator,
) -> dict:
    """One optimizer step.  ``batch``: ``images_hr`` [B, 4, 32, 128] and
    ``images_lr`` [B, 4, 16, 64] on the device (optional ``rot_arc`` /
    ``rot_offs``); ``gen``: a generator on the device for the rotation
    and dropout draws.  ``generator`` and ``student`` must be in training
    mode, ``teacher`` in eval mode.  Returns the JAX metric names as
    device scalars: ``loss_total``, ``loss_sr``, ``loss_distill``,
    ``loss_tssim`` and ``grad_norm_sr`` (before clipping)."""
    images_hr, images_lr = batch["images_hr"], batch["images_lr"]
    nb = images_lr.shape[0]
    arc, offs = _rotation(batch, nb, gen)
    images_lr = rotate_batch(images_lr, arc, offs)
    images_hr = rotate_batch(images_hr, arc, offs)
    images_lr_ret = rotate_batch(images_lr, -arc, offs)

    with torch.no_grad():  # the frozen teacher's prior from HR
        label_vecs_hr = torch.softmax(teacher(parse_crnn_input(images_hr[:, :3])), dim=-1)
    label_vecs = torch.softmax(student(parse_crnn_input(images_lr[:, :3])), dim=-1)
    prior = label_vecs.permute(1, 2, 0)[:, :, None, :].detach()  # [B, C, 1, T]

    if cfg.fused_tssim:
        sr_all, _ = generator(
            torch.cat([images_lr, images_lr_ret]), torch.cat([prior, prior]), copies=2, gen=gen
        )
        sr, sr_ret = sr_all[:nb], sr_all[nb:]
    else:
        sr, _ = generator(images_lr, prior, gen=gen)
        sr_ret, _ = generator(images_lr_ret, prior, gen=gen)
    sr_ret = rotate_batch(sr_ret, arc, offs)
    metrics = {
        "loss_sr": image_loss(sr, images_hr, gradient=True).mean() * 100.0,
        "loss_tssim": (1.0 - tri_ssim(sr_ret, sr, images_hr)) * 10.0,
        "loss_distill": semantic_loss(label_vecs, label_vecs_hr) * 100.0,
    }
    total = metrics["loss_sr"] + metrics["loss_tssim"] + metrics["loss_distill"]
    metrics["loss_total"] = total

    optimizer.zero_grad(set_to_none=False)
    total.backward()
    metrics["grad_norm_sr"] = grad_norm(generator.parameters())
    clip_grads_per_model([generator], GRAD_CLIP)
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


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

