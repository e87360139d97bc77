"""The reference's training steps and evaluation, written out in full.

- :func:`train_step`: the arch's loss (``archs/<arch>.py``: ``loss``),
  one backward, the generator's gradients clipped at 0.25, one Adam step
  (betas 0.5, 0.999) over generator and student.
- :func:`evaluate_batch`: ``--go_test``'s work on one batch: SR (the
  arch's ``sr``), PSNR and SSIM against HR, the judge's logits on SR, LR
  and HR.
"""

from __future__ import annotations

import math

import torch

from . import archs, ops

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


def train_step(arch: str, models: dict, opt: Adam, batch: dict, gen) -> tuple[float, dict]:
    """One optimizer step; (the loss before it, the gradients Adam got)."""
    for name in ("generator", "student"):
        models[name].train()
    models["teacher"].eval()
    loss = archs.load(arch).loss(models, batch, gen)
    grads = _grads(models, loss)
    opt.step(grads)
    return float(loss.detach()), grads


@torch.no_grad()
def sr_images(arch: str, models: dict, lr: torch.Tensor) -> torch.Tensor:
    return archs.load(arch).sr(models, lr)


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
