"""TATT (arXiv:2203.09388), trained by ``scripts/train_TATT.sh``:
``--STN --mask --use_distill --gradient --sr_share --stu_iter=1
--rotate_train=5 --tssim_loss``.

:func:`loss`: the batch rotated, the frozen teacher's prior from HR, the
student's prior from LR (its gradient stopped before the generator), the
generator on LR and on the counter-rotated LR as one batch of 2B with
per-copy BatchNorm, the image loss x100, TRI-SSIM x10 of the
rotated-back copy, the distillation x100.  Random draws come from ``gen``
in the published order: the rotation's angles, its aspect jitter, then
each dropout site of the TP Interpreter's forward.
"""

from __future__ import annotations

import math

import torch

from .. import ops
from ..nets import CRNN, TPInterpreter, _Trunk, trunk_args


class TATT(_Trunk):
    """The TATT generator: [N, 4, H/s, W/s] and a prior [N, C, 1, T] ->
    ([N, 4, H, W], the TP Interpreter's attention weights)."""

    def __init__(self, width: int, height: int, scale: int, srb: int, hidden: int,
                 text_emb: int, stn: bool, mask: bool = True, dropout: float = 0.1):
        super().__init__()
        ch, lr = 2 * hidden, (height // scale, width // scale)
        self.rate = dropout
        self._build(4 if mask else 3, ch, srb, stn, ch, scale, lr)
        self.infoGen = TPInterpreter(text_emb, ch, lr)

    def forward(self, x, prior, copies: int = 1, gen=None):
        x = self.rectify(x, copies)
        b1 = self.stem(x)
        rate, gen = (self.rate, gen) if self.training else (0.0, None)
        tp_map, weights = self.infoGen(b1, prior, rate, gen)
        return self.trunk(b1, tp_map, copies), weights


def build(config: dict) -> dict:
    """The generator, the prior's ``student`` CRNN and the frozen
    ``teacher`` CRNN, which is also the judge."""
    crnn = config["recognizer"]
    return {"generator": TATT(text_emb=crnn["nclass"], **trunk_args(config)),
            "student": CRNN(**crnn), "teacher": CRNN(**crnn)}


def rotation(n: int, degrees: float, gen, device):
    """(angles in radians, aspect jitter) [N]: zeros without a generator."""
    if gen is None:
        z = torch.zeros(n, device=device)
        return z, z
    angle = (torch.rand((n,), generator=gen, device=device) * 2.0 - 1.0) * degrees
    return angle / 180.0 * math.pi, torch.rand((n,), generator=gen, device=device)


def loss(models: dict, batch: dict, gen, degrees: float = 5.0) -> torch.Tensor:
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


def sr(models: dict, lr: torch.Tensor) -> torch.Tensor:
    """The student's prior from LR, then the generator."""
    prior = torch.softmax(models["student"](ops.crnn_input(lr)), dim=-1)
    return models["generator"](lr, prior.permute(1, 2, 0)[:, :, None, :])[0]
