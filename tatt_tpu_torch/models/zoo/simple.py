"""The small baselines SRCNN, VDSR, SCGAN and BICUBIC, and the ``_TL``
variants of the first three (counterpart of
``tatt_tpu/models/zoo/simple.py``; reference ``model/srcnn.py``,
``model/vdsr.py``, ``model/scgan.py``, ``model/bicubic.py``).

All of them work in HR space after a nearest upsampling (torch's
``F.interpolate(scale_factor=2)`` default); the ``_TL`` variants
concatenate the InfoGen prior, resized bilinearly (``align_corners=True``)
to the HR ``height`` x ``width`` (SRCNN_TL, VDSR_TL) or to the upsampled
input's size (SCGAN_TL).  Module names are the JAX package's.  The
reference draws VDSR's convs from N(0, sqrt(2 / n)); the JAX package's
``_kaiming_conv`` (``simple.py:20-31``) computes that std but applies it
nowhere, and no model calls it: every conv in both packages takes torch's
default init.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bicubic, resize_bilinear, upsample_nearest
from tatt_tpu_torch.models.common import Conv2d, JaxNamed, check_copies
from tatt_tpu_torch.models.tsrn import InfoGen


class _Prior(JaxNamed):
    """The ``_TL`` archs' InfoGen prior: ``infoGen`` and its map resized to
    a size each arch picks."""

    def prior(self, text_emb: torch.Tensor, like: torch.Tensor, size: tuple[int, int],
              copies: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(InfoGen's map, that map resized to ``size`` in ``like``'s dtype)."""
        check_copies(copies)
        tp_raw = self.infoGen(text_emb.to(like.dtype))
        return tp_raw, resize_bilinear(tp_raw, *size, align_corners=True).to(like.dtype)


class SRCNN(JaxNamed):
    """``simple.py:34-45``: nearest x2, then the 9-1-5 conv stack."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 3):
        super().__init__()
        self.scale_factor, self.in_planes = scale_factor, in_planes
        self.conv1 = Conv2d(in_planes, 64, (9, 9), (4, 4))
        self.conv2 = Conv2d(64, 32, (1, 1), (0, 0))
        self.conv3 = Conv2d(32, in_planes, (5, 5), (2, 2))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = upsample_nearest(x[:, : self.in_planes], self.scale_factor)
        return self.conv3(torch.relu(self.conv2(torch.relu(self.conv1(x)))))


class SRCNN_TL(_Prior):
    """``simple.py:48-71``: the prior concatenated before every conv."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 4, height: int = 32,
                 width: int = 128, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__()
        self.scale_factor, self.size = scale_factor, (height, width)
        t = out_text_channels
        self.infoGen = InfoGen(text_emb, t)
        self.conv1 = Conv2d(in_planes + t, 64, (9, 9), (4, 4))
        self.conv2 = Conv2d(64 + t, 32, (1, 1), (0, 0))
        self.conv3 = Conv2d(32 + t, in_planes, (5, 5), (2, 2))

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        tp_raw, tp = self.prior(text_emb, x, self.size, copies)
        x = upsample_nearest(x, self.scale_factor)
        out = torch.relu(self.conv1(torch.cat([x, tp], dim=1)))
        out = torch.relu(self.conv2(torch.cat([out, tp], dim=1)))
        return self.conv3(torch.cat([out, tp], dim=1)), {"spatial_t_emb": tp_raw}


class VDSR(JaxNamed):
    """``simple.py:74-102``: nearest x2, ``num_blocks`` residual conv-ReLU
    blocks (the reference trims VDSR's 18 to 6), a global residual."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 3, num_blocks: int = 6,
                 text_channels: int = 0):
        super().__init__()
        self.scale_factor, self.in_planes, self.num_blocks = scale_factor, in_planes, num_blocks
        self.input = Conv2d(in_planes, 64, bias=False)
        for i in range(num_blocks):
            setattr(self, f"block{i + 1}", Conv2d(64 + text_channels, 64, bias=False))
        self.output = Conv2d(64, in_planes, bias=False)

    def body(self, x: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = torch.relu(self.input(x))
        for i in range(self.num_blocks):
            inp = out if tp is None else torch.cat([out, tp], dim=1)
            out = torch.relu(getattr(self, f"block{i + 1}")(inp)) + out
        return self.output(out) + x

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.body(upsample_nearest(x[:, : self.in_planes], self.scale_factor))


class VDSR_TL(VDSR, _Prior):
    """``simple.py:105-139``: each block's conv reads the features and the
    prior."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 4, height: int = 32,
                 width: int = 128, text_emb: int = 37, out_text_channels: int = 32,
                 num_blocks: int = 6):
        super().__init__(scale_factor, in_planes, num_blocks, out_text_channels)
        self.size = (height, width)
        self.infoGen = InfoGen(text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        x = upsample_nearest(x, self.scale_factor)
        tp_raw, tp = self.prior(text_emb, x, self.size, copies)
        return self.body(x, tp), {"spatial_t_emb": tp_raw}


class SCGAN(JaxNamed):
    """``simple.py:142-158``: a 9x9 conv, nearest x2, seven 5x5 convs and a
    1x1 conv, each with ReLU."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 4, text_channels: int = 0):
        super().__init__()
        self.scale_factor = scale_factor
        t = text_channels
        self.conv1 = Conv2d(in_planes, 64, (9, 9), (4, 4))
        for tag in "abcdefg":
            # SCGAN_TL concatenates the prior before convc and convg
            setattr(self, f"conv{tag}", Conv2d(64 + (t if tag in "cg" else 0), 64, (5, 5), (2, 2)))
        self.convh = Conv2d(64, in_planes, (1, 1), (0, 0))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        out = upsample_nearest(torch.relu(self.conv1(x)), self.scale_factor)
        for tag in "abcdefg":
            out = torch.relu(getattr(self, f"conv{tag}")(out))
        return torch.relu(self.convh(out))


class SCGAN_TL(SCGAN, _Prior):
    """``simple.py:161-191``: nearest x2 first; the prior, resized to that
    size, joins before the third and the seventh 5x5 conv."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 4, height: int = 32,
                 width: int = 128, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(scale_factor, in_planes, out_text_channels)
        self.infoGen = InfoGen(text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        x = upsample_nearest(x, self.scale_factor)
        tp_raw, tp = self.prior(text_emb, x, tuple(x.shape[2:]), copies)
        out = torch.relu(self.conv1(x))
        for tag in "abcdefg":
            if tag in "cg":
                out = torch.cat([out, tp], dim=1)
            out = torch.relu(getattr(self, f"conv{tag}")(out))
        return torch.relu(self.convh(out)), {"spatial_t_emb": tp_raw}


class BICUBIC(nn.Module):
    """Bicubic interpolation for test-only runs (``simple.py:194-202``).  It
    has no parameters, so nothing can train it: the port's CLI and
    ``Trainer`` refuse the arch (ROADMAP C.4)."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return resize_bicubic(x, x.shape[-2] * self.scale_factor, x.shape[-1] * self.scale_factor)
