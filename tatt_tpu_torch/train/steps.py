"""The train and eval steps (counterpart of ``tatt_tpu/train/steps.py``).

:func:`train_step` is ``make_train_step`` (``steps.py:93-392``) with every
branch of the TATT step: rotation augmentation (``rotate_train`` degrees,
none at 0), the frozen teacher's prior from HR, then ``stu_iter``
iterations, each a student prior (its gradient stopped) and a generator
forward; at ``i > 0`` the student reads the previous iteration's SR, its
gradient stopped, and with ``for_cascading`` the generator reads it too,
resized to LR and averaged with LR.  The losses: image (with
``gradient``, ``training_stablize``'s top-70 % mask and ``learning_STN``'s
rectification term) weighted ``1 + 0.5 i``, SSIM, TRI-SSIM, distillation
and ``use_label``'s CTC of the teacher's HR logits against the spread
labels; then one backward, per-copy clipping of the SR gradients and one
Adam step over every copy.  ``y_domain`` trains the SR losses on the
``YCbCr`` crops and reads the recognizer priors from the raw RGB.  With
``fused_tssim`` the counter-rotated copy runs in the same 2B forward with
per-copy BatchNorm statistics (``steps.py:230-250``).  Under
``compute_dtype="bfloat16"`` the step casts where ``make_train_step``
casts (``steps.py:155-171, 207, 221, 245, 254, 330``): the recognizers'
luma, the prior and the generator's input go in as bf16, so the models
run in bf16 (their layers follow the input's dtype, the parameters stay
float32 masters), and the logits and SR come back to float32 before
every loss; clipping, the gradient norms and Adam stay float32.  The CLI
serves it for ``tatt`` and ``srresnet_tl`` (``factory.BF16_ARCHS``), with
the CRNN or the TPG of ``--tpg OPT`` (``parse_opt_input``'s luma cast as
the CRNN's is) and every flag of the step; the other text-prior archs
fail in the JAX package's bf16 step and are refused.

:func:`eval_step` is ``make_eval_step`` (``steps.py:553-610``) including
the ``stu_iter`` cascade of ``model_inference`` and ``for_cascading``.

:func:`plain_train_step` and :func:`plain_eval_step` serve the archs
without a text prior (``make_plain_train_step``, ``steps.py:424-550``, and
``loop.py:318-329``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn

from tatt_tpu_torch.data.device_pipeline import prep_image_batch
from tatt_tpu_torch.kernels.ctc import ctc_loss
from tatt_tpu_torch.kernels.grid_sample import rotate_batch
from tatt_tpu_torch.kernels.resize import resize_bicubic
from tatt_tpu_torch.losses.distill import semantic_loss
from tatt_tpu_torch.losses.image import image_loss
from tatt_tpu_torch.losses.ssim import distorted_ssim, ssim, tri_ssim
from tatt_tpu_torch.models.recognizers.crnn import parse_crnn_input
from tatt_tpu_torch.train.state import clip_grads_per_model

@dataclass(frozen=True)
class StepConfig:
    """The JAX ``StepConfig`` (``steps.py:30-59``) with its defaults, the
    canonical recipe.  ``compute_dtype`` ("float32" or "bfloat16") acts in
    :func:`train_step` only, as in JAX; ``color_loss`` and ``mse_fuse`` act
    in the plain step only, as in JAX.
    ``fused_tssim`` runs sr and the counter-rotated sr_ret in one 2B
    forward (else two forwards); ``mask`` is the mask channel of the
    uint8 image leaves the step normalizes."""

    stu_iter: int = 1
    sr_share: bool = True
    tpg_share: bool = False
    use_distill: bool = True
    use_label: bool = False
    for_cascading: bool = False
    y_domain: bool = False
    learning_STN: bool = False
    color_loss: bool = False
    gradient: bool = True
    ssim_loss: bool = False
    tssim_loss: bool = True
    fused_tssim: bool = True
    mse_fuse: bool = False
    rotate_train: float = 5.0
    training_stablize: bool = False
    grad_clip: float = 0.25
    compute_dtype: str = "float32"
    mask: bool = True


def _caster(compute_dtype: str) -> Callable:
    """The cast of a model input to ``compute_dtype``: none for "float32"
    (so the CPU float64 step stays float64), bf16 for "bfloat16"."""
    if compute_dtype == "float32":
        return lambda t: t
    if compute_dtype == "bfloat16":
        return lambda t: t.to(torch.bfloat16)
    raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype!r}")


def _widen(t: torch.Tensor) -> torch.Tensor:
    """A model output back to float32 for the losses (a bf16 one only)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def loss_stablize(loss_set: torch.Tensor, keep: float = 0.7) -> torch.Tensor:
    """Zero the per-sample losses above the ``int(keep * B)``-th smallest
    (the intended top-k mask of ``super_resolution.py:84-93``, as
    ``steps.py:82-90``)."""
    k = int(keep * loss_set.shape[0])
    if k == 0:
        return loss_set
    threshold = torch.sort(loss_set).values[k - 1]
    return torch.where(loss_set <= threshold, loss_set, torch.zeros_like(loss_set))


def _rotation(batch: dict, n: int, degrees: float, gen: torch.Generator):
    """(arc, rand_offs) [N]: the batch's ``rot_arc`` / ``rot_offs`` when it
    pins them (``steps.py:137-140``), else drawn uniformly from ``gen``."""
    if "rot_arc" in batch:
        return batch["rot_arc"], batch["rot_offs"]
    dev = batch["images_lr"].device
    angle = (torch.rand(n, generator=gen, device=dev) * 2.0 - 1.0) * degrees
    return angle / 180.0 * math.pi, torch.rand(n, generator=gen, device=dev)


def _backward(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """The gradients of ``loss`` for every parameter of ``optimizer``: a
    parameter no loss reaches (the students without distillation, or in
    the plain step) gets a zero gradient and steps, as optax updates every
    leaf."""
    optimizer.zero_grad(set_to_none=False)
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


@torch.no_grad()
def _grad_metrics(generator: nn.Module) -> dict:
    """``grad_norm_sr`` and ``gnorm/<module>`` of the first generator copy
    (``steps.py:359-371``), before clipping."""
    sq = {k: sum((p.grad.float() ** 2).sum() for p in ps)
          for k, ps in generator.jax_module_params().items()}
    out = {f"gnorm/{k}": torch.sqrt(v) for k, v in sq.items()}
    out["grad_norm_sr"] = torch.sqrt(sum(sq.values()))
    return out


def train_step(
    generators: Sequence[nn.Module],
    students: Sequence[nn.Module],
    teacher: nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    cfg: StepConfig,
    gen: torch.Generator,
    parse_fn: Callable = parse_crnn_input,
) -> dict:
    """One optimizer step.

    ``generators`` / ``students``: one module each, or one per copy
    (``stu_iter`` copies where ``sr_share`` / ``tpg_share`` is off), all in
    training mode;
    ``teacher`` in eval mode; ``optimizer`` over every copy.  ``batch`` on
    the device: ``images_hr`` [B, 4, H, W] and ``images_lr`` [B, 4, H/s,
    W/s] (float, or uint8 NHWC crops normalized here; 32x128 and 16x64 at
    the default geometry), with ``y_domain``
    ``images_hr_y`` / ``images_lr_y``, with ``use_label`` ``ctc_targets``,
    ``ctc_lengths`` and ``weighted_tics``, optionally ``rot_arc`` /
    ``rot_offs``.  ``gen``: a generator on the device for the rotation and
    dropout draws.  ``parse_fn``: the recognizers' input adapter
    (``parse_crnn_input``, or ``parse_opt_input`` for the TPG of ``--tpg
    OPT``, whose [129, B, C] logits make a [B, C, 1, 129] prior).  Returns
    the JAX metric names as device scalars."""
    batch = prep_image_batch(batch, cfg.mask)
    images_hr, images_lr = batch["images_hr"], batch["images_lr"]
    hr_raw, lr_raw = images_hr, images_lr
    if cfg.y_domain:  # luma for the SR losses, raw RGB for the priors
        images_hr = torch.cat([batch["images_hr_y"][:, :3], hr_raw[:, 3:]], dim=1)
        images_lr = torch.cat([batch["images_lr_y"][:, :3], lr_raw[:, 3:]], dim=1)
    nb = images_lr.shape[0]
    if cfg.rotate_train:
        arc, offs = _rotation(batch, nb, cfg.rotate_train, gen)
        images_lr = rotate_batch(images_lr, arc, offs)
        images_hr = rotate_batch(images_hr, arc, offs)
        images_lr_ret = rotate_batch(images_lr, -arc, offs)
    else:
        images_lr_ret = images_lr
    if not cfg.y_domain:
        hr_raw, lr_raw = images_hr, images_lr
    cast = _caster(cfg.compute_dtype)

    with torch.no_grad():  # the frozen teacher's prior from HR
        teacher_logits = teacher(cast(parse_fn(hr_raw[:, :3]))).float()
        label_vecs_hr = torch.softmax(teacher_logits, dim=-1)
    lr_luma = cast(parse_fn(lr_raw[:, :3]))
    fused = cfg.tssim_loss and cfg.fused_tssim

    loss_img = loss_distill = 0.0
    metrics = {}
    cascade = images_lr
    for i in range(cfg.stu_iter):
        student = students[0 if cfg.tpg_share else i]
        generator = generators[0 if cfg.sr_share else i]
        cascade = cascade.detach()
        if cfg.for_cascading and i > 0:
            prev = resize_bicubic(cascade, images_lr.shape[2], images_lr.shape[3])
            cascade = (prev.clamp(0.0, 1.0) + images_lr) / 2.0
        stage_luma = lr_luma if i == 0 or cfg.y_domain else cast(parse_fn(cascade[:, :3]))
        label_vecs = torch.softmax(student(stage_luma).float(), dim=-1)  # [T, B, C]
        prior = cast(label_vecs.permute(1, 2, 0)[:, :, None, :].detach())  # [B, C, 1, T]
        main_input = cascade if cfg.for_cascading else images_lr
        if fused:
            sr_all, aux = generator(cast(torch.cat([main_input, images_lr_ret])),
                                    torch.cat([prior, prior]), copies=2, gen=gen)
            sr_all = _widen(sr_all)
            sr, sr_ret = sr_all[:nb], sr_all[nb:]
            # keep the main copy of the packed aux features (steps.py:263-270)
            aux = {k: v[:nb] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * nb else v
                   for k, v in aux.items()}
        else:
            sr, aux = generator(cast(main_input), prior, gen=gen)
            sr = _widen(sr)
        cascade = sr

        if cfg.use_label:  # CTC of the HR teacher logits on the spread labels
            fsup = ctc_loss(
                torch.log_softmax(teacher_logits, dim=-1), batch["ctc_targets"],
                torch.full((nb,), teacher_logits.shape[0], dtype=torch.long, device=sr.device),
                batch["ctc_lengths"],
            )
            loss_distill = loss_distill + (fsup * batch["weighted_tics"]).mean()
        if cfg.use_distill:
            d = semantic_loss(label_vecs, label_vecs_hr) * 100.0
            loss_distill = loss_distill + d
            metrics["loss_distill_each"] = d

        imq = image_loss(sr, images_hr, gradient=cfg.gradient)
        if cfg.training_stablize:
            imq = loss_stablize(imq)
        each = imq.mean() * 100.0
        if cfg.learning_STN:  # rectification consistency (super_resolution.py:896-901)
            each = each + image_loss(aux["in_feat"].float(), aux["trans_feat"].float(),
                                     gradient=cfg.gradient).mean()
        loss_img = loss_img + each * (1.0 + i * 0.5)
        metrics["loss_sr"] = each
        if cfg.ssim_loss:
            s = (1.0 - ssim(sr, images_hr)) * 10.0
            loss_img = loss_img + s
            metrics["loss_ssim"] = s
        if cfg.tssim_loss:
            if not fused:
                sr_ret = _widen(generator(cast(images_lr_ret), prior, gen=gen)[0])
            if cfg.rotate_train:
                sr_ret = rotate_batch(sr_ret, arc, offs)
            ts = (1.0 - tri_ssim(sr_ret, sr, images_hr)) * 10.0
            loss_img = loss_img + ts
            metrics["loss_tssim"] = ts

    total = loss_img + loss_distill
    if cfg.use_distill or cfg.use_label:
        metrics["loss_distill"] = loss_distill
    metrics["loss_total"] = total
    metrics["sr_mean"], metrics["sr_min"], metrics["sr_max"] = (
        sr[:, :3].mean(), sr[:, :3].min(), sr[:, :3].max())

    _backward(optimizer, total)
    metrics.update(_grad_metrics(generators[0]))
    clip_grads_per_model(generators, cfg.grad_clip)
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def plain_train_step(
    generators: Sequence[nn.Module],
    optimizer: torch.optim.Optimizer,
    batch: dict,
    cfg: StepConfig,
    gen: torch.Generator,
    criterion: Callable,
    channels: int = 4,
    distorted: bool = False,
) -> dict:
    """One optimizer step of an arch without a text prior
    (``make_plain_train_step``, ``steps.py:424-550``; reference
    ``super_resolution.py:664-700, 1037-1063``).

    ``generators``: one module in training mode (its output, or the first
    of its outputs, is the SR image); ``optimizer`` over it and the
    students, which no loss reaches (they step with zero gradients, as
    optax updates every leaf).  ``batch`` as :func:`train_step` reads it
    (``images_hr`` / ``images_lr``, optionally ``rot_arc`` / ``rot_offs``),
    cut to ``channels``; ``gen`` draws the rotation.  Losses: ``criterion``
    (per sample) x100, of the first output of ``generator(x, gen=gen)``
    (``gen`` also draws the dropout of a generator that has it);
    ``color_loss``: the mean-colour L1 x30; ``ssim_loss``:
    (1 - SSIM) x10, ``distorted`` SSIM for ``tsrn``; ``tssim_loss``: a
    second forward of the counter-rotated LR (BatchNorm statistics of its
    own batch, running statistics advanced again), rotated back, TRI-SSIM
    x10; ``mse_fuse``: a third such forward, without autograd (JAX stops
    its gradient), and the criterion of SR against it x100 (JAX compares
    with this rotated-back copy, where the reference reads the unrotated
    one).  Then per-copy clipping and one Adam step.  Returns the JAX
    metric names as device scalars."""
    batch = prep_image_batch(batch, cfg.mask)
    images_hr = batch["images_hr"][:, :channels]
    images_lr = batch["images_lr"][:, :channels]
    generator = generators[0]
    if cfg.rotate_train:
        arc, offs = _rotation(batch, images_lr.shape[0], cfg.rotate_train, gen)
        images_lr = rotate_batch(images_lr, arc, offs)
        images_hr = rotate_batch(images_hr, arc, offs)
        images_lr_ret = rotate_batch(images_lr, -arc, offs)
    else:
        images_lr_ret = images_lr

    def forward(x):
        out = generator(x, gen=gen)
        return out[0] if isinstance(out, tuple) else out

    def rotated_back(x):
        sr_ret = forward(x)
        return rotate_batch(sr_ret, arc, offs) if cfg.rotate_train else sr_ret

    metrics = {}
    sr = forward(images_lr)
    loss = criterion(sr, images_hr).mean() * 100.0
    metrics["loss_sr"] = loss
    if cfg.color_loss:  # mean-colour consistency (super_resolution.py:669-672)
        c = (images_lr.mean(dim=(2, 3)) - sr.mean(dim=(2, 3))).abs().mean() * 30.0
        loss = loss + c
        metrics["loss_color"] = c
    if cfg.ssim_loss:
        s = (1.0 - (distorted_ssim if distorted else ssim)(sr, images_hr)) * 10.0
        loss = loss + s
        metrics["loss_ssim"] = s
    if cfg.tssim_loss:
        ts = (1.0 - tri_ssim(rotated_back(images_lr_ret), sr, images_hr)) * 10.0
        loss = loss + ts
        metrics["loss_tssim"] = ts
    if cfg.mse_fuse:
        with torch.no_grad():  # its output is a constant of the loss
            target = rotated_back(images_lr_ret)
        mf = criterion(sr, target).mean() * 100.0
        loss = loss + mf
        metrics["loss_mse_fuse"] = mf
    metrics["loss_total"] = loss

    _backward(optimizer, loss)
    clip_grads_per_model(generators, cfg.grad_clip)
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def plain_eval_step(generator: nn.Module, images_lr: torch.Tensor, channels: int = 4):
    """``images_lr`` [N, 4, H/s, W/s] -> (SR of ``images_lr[:, :channels]``,
    {}): the plain archs' evaluation (``loop.py:318-329``), no prior, the
    first output of a model that returns several."""
    out = generator(images_lr[:, :channels])
    return (out[0] if isinstance(out, tuple) else out), {}


@torch.no_grad()
def eval_step(
    generators: Sequence[nn.Module],
    students: Sequence[nn.Module],
    images_lr: torch.Tensor,
    stu_iter: int = 1,
    for_cascading: bool = False,
    parse_fn: Callable = parse_crnn_input,
):
    """``images_lr`` [N, 4, H/s, W/s] -> (SR of the last iteration, aux).

    ``generators`` / ``students`` hold one shared module (``--sr_share`` /
    ``--tpg_share``) or one per iteration.  At iteration i > 0 the student
    reads the previous SR output (``super_resolution.py:316-318,374-376``);
    the generator reads the LR input, or with ``for_cascading`` the
    previous SR resized to LR, clamped and averaged with LR.  ``parse_fn``
    as in :func:`train_step`."""
    cascade = images_lr
    sr = aux = None
    for i in range(stu_iter):
        lr_luma = parse_fn(cascade[:, :3])
        sr_input = images_lr
        if for_cascading and i > 0:
            prev = resize_bicubic(cascade, images_lr.shape[2], images_lr.shape[3])
            sr_input = (prev.clamp(0.0, 1.0) + images_lr) / 2.0
        student = students[i if len(students) > 1 else 0]
        generator = generators[i if len(generators) > 1 else 0]
        logits = student(lr_luma)  # [T, N, C]
        prior = torch.softmax(logits, dim=-1).permute(1, 2, 0)[:, :, None, :]
        sr, aux = generator(sr_input, prior)
        cascade = sr
    return sr, aux
