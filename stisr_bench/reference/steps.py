"""The reference's training steps and evaluation, written out in full.

- :func:`tatt_loss`, stepped by :func:`train_step`: TATT's recipe
  (``scripts/train_TATT.sh``: ``--STN --mask --use_distill --gradient
  --sr_share --stu_iter=1 --rotate_train=5 --tssim_loss``): the batch
  rotated, the frozen
  teacher's prior from HR, the student's prior from LR (its gradient
  stopped before the generator), the generator on LR and on the
  counter-rotated LR as one batch of 2B with per-copy BatchNorm, the
  image loss x100, TRI-SSIM x10 of the rotated-back copy, the
  distillation x100; one backward, the generator's gradients clipped at
  0.25, one Adam step (betas 0.5, 0.999) over generator and student.
- :func:`plain_loss`: TSRN's (TextZoom ``--STN --mask --gradient``): the
  image loss x100, clipping and Adam as above.
- :func:`evaluate_batch`: ``--go_test``'s work on one batch: SR, PSNR and
  SSIM against HR, the judge's logits on SR, LR and HR.

Random draws (the rotation, then the TP Interpreter's dropout) come from
``gen`` in the published order: the rotation's angles, its aspect
jitter, then each dropout site of the forward.
"""

from __future__ import annotations

import math

import torch

from . import ops

BETA1, BETA2, EPS = 0.5, 0.999, 1e-8
CLIP = 0.25


class Adam:
    """Adam with bias correction, as ``torch.optim.Adam``'s update."""

    def __init__(self, params: dict, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - BETA1**self.t, 1 - BETA2**self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
            self.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            p.sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + EPS))


def trainable(models: dict) -> dict:
    """The optimizer's leaves: generator and student, by qualified name."""
    return {f"{name}.{k}": p for name in ("generator", "student") if name in models
            for k, p in models[name].named_parameters()}


def _grads(models: dict, loss: torch.Tensor) -> dict:
    """Gradients of ``loss`` for every trainable leaf (zero where no loss
    reaches), the generator's clipped to a global norm of 0.25."""
    params = trainable(models)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), got)}
    gen_keys = [k for k in grads if k.startswith("generator.")]
    norm = torch.sqrt(sum((grads[k] ** 2).sum() for k in gen_keys))
    scale = torch.clamp(CLIP / (norm + 1e-6), max=1.0)
    for k in gen_keys:
        grads[k] = grads[k] * scale
    return grads


def rotation(n: int, degrees: float, gen, device):
    """(angles in radians, aspect jitter) [N]: zeros without a generator."""
    if gen is None:
        z = torch.zeros(n, device=device)
        return z, z
    angle = (torch.rand((n,), generator=gen, device=device) * 2.0 - 1.0) * degrees
    return angle / 180.0 * math.pi, torch.rand((n,), generator=gen, device=device)


def tatt_loss(models: dict, batch: dict, gen, degrees: float = 5.0) -> torch.Tensor:
    hr = ops.normalize_u8(batch["images_hr"], True)
    lr = ops.normalize_u8(batch["images_lr"], True)
    n = lr.shape[0]
    arc, offs = rotation(n, degrees, gen, lr.device)
    lr, hr = ops.rotate(lr, arc, offs), ops.rotate(hr, arc, offs)
    lr_ret = ops.rotate(lr, -arc, offs)
    with torch.no_grad():
        prior_hr = torch.softmax(models["teacher"](ops.crnn_input(hr)), dim=-1)
    prior_lr = torch.softmax(models["student"](ops.crnn_input(lr)), dim=-1)  # [T, B, C]
    prior = prior_lr.permute(1, 2, 0)[:, :, None, :].detach()
    sr_all, _ = models["generator"](torch.cat([lr, lr_ret]), torch.cat([prior, prior]), 2, gen)
    sr, sr_ret = sr_all[:n], sr_all[n:]
    distill = ops.semantic_loss(prior_lr, prior_hr) * 100.0
    img = ops.image_loss(sr, hr).mean() * 100.0
    tssim = (1.0 - ops.tri_ssim(ops.rotate(sr_ret, arc, offs), sr, hr)) * 10.0
    return img + tssim + distill


def plain_loss(models: dict, batch: dict, gen=None, channels: int = 4) -> torch.Tensor:
    hr = ops.normalize_u8(batch["images_hr"], True)[:, :channels]
    lr = ops.normalize_u8(batch["images_lr"], True)[:, :channels]
    return ops.image_loss(models["generator"](lr), hr).mean() * 100.0


LOSSES = {"tatt": tatt_loss, "tsrn": plain_loss}


def train_step(arch: str, models: dict, opt: Adam, batch: dict, gen) -> tuple[float, dict]:
    """One optimizer step; (the loss before it, the gradients Adam got)."""
    for name in ("generator", "student"):
        models[name].train()
    models["teacher"].eval()
    loss = LOSSES[arch](models, batch, gen)
    grads = _grads(models, loss)
    opt.step(grads)
    return float(loss.detach()), grads


@torch.no_grad()
def sr_images(arch: str, models: dict, lr: torch.Tensor) -> torch.Tensor:
    if arch == "tatt":
        prior = torch.softmax(models["student"](ops.crnn_input(lr)), dim=-1)
        return models["generator"](lr, prior.permute(1, 2, 0)[:, :, None, :])[0]
    return models["generator"](lr)


@torch.no_grad()
def evaluate_batch(arch: str, models: dict, batch: dict) -> dict:
    """SR [N, 4, H, W], PSNR and SSIM of SR against HR, and the judge's
    logits [T, N, C] on SR, LR and HR (models in eval mode)."""
    hr = ops.normalize_u8(batch["images_hr"], True)
    lr = ops.normalize_u8(batch["images_lr"], True)
    sr = sr_images(arch, models, lr)
    judge = models["teacher"]
    return {"sr": sr, "psnr": float(ops.psnr(sr, hr)), "ssim": float(ops.ssim(sr, hr)),
            "logits": [judge(ops.crnn_input(x)) for x in (sr, lr, hr)]}
