"""ESRGAN's RRDBNet and RRDBNet_TL (counterpart of
``tatt_tpu/models/zoo/esrgan.py``, reference ``model/esrgan.py``).

Both keep the reference names that ``import_esrgan_tl`` reads: the trunk's
blocks are ``RRDB_trunk.<i>`` (the JAX package's ``RRDB<i>``).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bilinear, upsample_nearest
from tatt_tpu_torch.models.common import BatchNorm2d, Conv2d, JaxNamed, check_copies
from tatt_tpu_torch.models.tsrn import InfoGen


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock5C(nn.Module):
    """``esrgan.py:19-34``: five 3x3 convs, each reading every earlier
    output; the fifth's output scaled by 0.2 plus the input."""

    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"conv{k}", Conv2d(nf + (k - 1) * gc, gc))
        self.conv5 = Conv2d(nf + 4 * gc, nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(lrelu(getattr(self, f"conv{k}")(torch.cat(feats, dim=1))))
        return self.conv5(torch.cat(feats, dim=1)) * 0.2 + x


class RRDB(nn.Module):
    """Three dense blocks, scaled by 0.2, plus the input (``esrgan.py:37-46``);
    with ``text_channels`` the prior is fused after them by a 1x1 conv and
    BatchNorm (RRDB_TL, ``:49-66``)."""

    def __init__(self, nf: int = 64, gc: int = 32, text_channels: int = 0):
        super().__init__()
        for j in (1, 2, 3):
            setattr(self, f"RDB{j}", ResidualDenseBlock5C(nf, gc))
        if text_channels:
            self.proj = Conv2d(nf + text_channels, nf, (1, 1), (0, 0))
            self.bn2 = BatchNorm2d(nf)

    def forward(self, x: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.RDB3(self.RDB2(self.RDB1(x)))
        feat = out * 0.2 + x
        if tp is None:
            return feat
        return self.bn2(self.proj(torch.cat([feat, tp.to(feat.dtype)], dim=1))) + feat


class RRDBNet(JaxNamed):
    """``esrgan.py:69-93``: ``nb`` RRDBs, nearest x2 upsampling convs."""

    def __init__(self, scale_factor: int = 2, in_nc: int = 4, out_nc: int = 4, nf: int = 64,
                 nb: int = 23, gc: int = 32, text_channels: int = 0):
        super().__init__()
        self.n_up = int(math.log2(scale_factor))
        self.conv_first = Conv2d(in_nc, nf)
        self.RRDB_trunk = nn.ModuleList(RRDB(nf, gc, text_channels) for _ in range(nb))
        self.trunk_conv = Conv2d(nf, nf)
        for i in range(self.n_up):
            setattr(self, f"upconv{i + 1}", Conv2d(nf, nf))
        self.HRconv = Conv2d(nf, nf)
        self.conv_last = Conv2d(nf, out_nc)

    def jax_module_params(self) -> dict[str, list[nn.Parameter]]:
        """The trunk's blocks under the JAX names ``RRDB<i>``."""
        groups = super().jax_module_params()
        groups.pop("RRDB_trunk", None)
        for i, block in enumerate(self.RRDB_trunk):
            groups[f"RRDB{i}"] = list(block.parameters())
        return groups

    def body(self, x: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        fea = self.conv_first(x)
        trunk = fea
        for block in self.RRDB_trunk:
            trunk = block(trunk, tp)
        fea = fea + self.trunk_conv(trunk)
        for i in range(self.n_up):
            fea = lrelu(getattr(self, f"upconv{i + 1}")(upsample_nearest(fea, 2)))
        return self.conv_last(lrelu(self.HRconv(fea)))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.body(x)


class RRDBNet_TL(RRDBNet):
    """``esrgan.py:96-125``: the InfoGen prior, resized to the input's
    size, joins every RRDB."""

    def __init__(self, scale_factor: int = 2, in_nc: int = 4, out_nc: int = 4, nf: int = 64,
                 nb: int = 23, gc: int = 32, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(scale_factor, in_nc, out_nc, nf, nb, gc, out_text_channels)
        self.infoGen = InfoGen(text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        check_copies(copies)
        tp_raw = self.infoGen(text_emb.to(x.dtype))
        tp = resize_bilinear(tp_raw, x.shape[2], x.shape[3], align_corners=True)
        return self.body(x, tp), {"spatial_t_emb": tp_raw}
