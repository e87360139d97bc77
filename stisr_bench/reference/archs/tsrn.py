"""TSRN, the TextZoom baseline (arXiv:2005.03341), trained with the
TextZoom README's ``--STN --mask --gradient``: :func:`loss` is the image
loss x100 (``plain_train_step``); it draws nothing.  The port's one Adam
also holds a student CRNN, which no loss reaches.
"""

from __future__ import annotations

import torch

from .. import ops
from ..nets import CRNN, _Trunk, trunk_args


class TSRN(_Trunk):
    """The TextZoom baseline: [N, 4, H/s, W/s] -> [N, 4, H, W]."""

    def __init__(self, width: int, height: int, scale: int, srb: int, hidden: int,
                 stn: bool, mask: bool = True):
        super().__init__()
        self._build(4 if mask else 3, 2 * hidden, srb, stn, 0, scale,
                    (height // scale, width // scale))

    def forward(self, x):
        return self.trunk(self.stem(self.rectify(x)))


def build(config: dict) -> dict:
    """The generator, the ``student`` CRNN (trained with zero gradients,
    as the program's one Adam does) and the frozen ``teacher`` CRNN, which
    is also the judge."""
    crnn = config["recognizer"]
    return {"generator": TSRN(**trunk_args(config)), "student": CRNN(**crnn),
            "teacher": CRNN(**crnn)}


def loss(models: dict, batch: dict, gen=None, channels: int = 4) -> torch.Tensor:
    hr = ops.normalize_u8(batch["images_hr"], True)[:, :channels]
    lr = ops.normalize_u8(batch["images_lr"], True)[:, :channels]
    return ops.image_loss(models["generator"](lr), hr).mean() * 100.0


def sr(models: dict, lr: torch.Tensor) -> torch.Tensor:
    return models["generator"](lr)
