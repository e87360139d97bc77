"""PCAN, the parallel context attention network (counterpart of
``tatt_tpu/models/zoo/pcan.py``, reference ``model/pcan.py``).

Dense PCAB blocks (a width BiGRU branch and a height BiGRU branch fused by
squeeze-excite), HOTA high-order spatial attention over the concatenated
block outputs, and the TSRN upsampling tail.  ``PCAN_TL`` feeds the
InfoGen prior into both GRU branches.  Each PCAB runs two
:class:`~tatt_tpu_torch.models.tsrn.GruBlock` s, so the zoo's PCANs are
the archs that reach the BiGRU kernels: ``gru1`` scans W (L=64, rows
N*16) and ``gru2`` scans H on the H<->W transposed map (L=16, rows N*64).
Module names are the JAX package's (no JAX importer names them).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bilinear
from tatt_tpu_torch.models.common import (
    BatchNorm2d, Conv2d, Dense, JaxNamed, PReLU, check_copies, max_pool, mish,
)
from tatt_tpu_torch.models.tsrn import GruBlock, InfoGen, UpsampleBlock


class FeatureSelection(nn.Module):
    """Squeeze-excite (``pcan.py:23-37``)."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Dense(channel, channel // reduction)
        self.fc2 = Dense(channel // reduction, channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.fc1(x.mean(dim=(2, 3))))
        return x * torch.sigmoid(self.fc2(y))[:, :, None, None]


def hota_pooled(lr_size: tuple[int, int]) -> tuple[int, int]:
    """The (H, W) of HOTA's pooled map over an LR crop: its stride-2 convs
    halve the crop (rounding up), then the 8x8 / 4 pool takes VALID
    windows.  (1, 7) at 16x64; (0, 3) at 8x32, a map of nothing, whose
    bilinear resize back fails in JAX (``tatt_tpu/kernels/resize.py:89``)
    and whose pool torch refuses."""
    return tuple(max((-(-n // 2) - 8) // 4 + 1, 0) for n in lr_size)


class HOTA(nn.Module):
    """High-order attention (``pcan.py:40-83``): six stride-2 separable
    convolutions (vertical 3x1 and horizontal 1x3 kernels, dilations 1, 2,
    3) -> squeeze-excite -> an 8x8 / 4 max pool and a conv stack -> a
    bilinear resize back (``align_corners=False``) -> a sigmoid mask on
    the input."""

    def __init__(self, n_feats: int):
        super().__init__()
        f = n_feats // 4
        self.conv1 = Conv2d(n_feats, f, (1, 1), (0, 0))
        self.horizontal_w = nn.Parameter(torch.empty(f, f, 1, 3))
        self.horizontal_b = nn.Parameter(torch.empty(f))
        self.vertical_w = nn.Parameter(torch.empty(f, f, 3, 1))
        self.vertical_b = nn.Parameter(torch.empty(f))
        self.se = FeatureSelection(f * 6)
        self.conv_reduce = Conv2d(f * 6, f)
        self.conv_max = Conv2d(f, f)
        self.conv3 = Conv2d(f, f)
        self.conv3_ = Conv2d(f, f)
        self.conv_f = Conv2d(f, f, (1, 1), (0, 0))
        self.conv4 = Conv2d(f, n_feats, (1, 1), (0, 0))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # N(0, 1), as the JAX package draws them
        for p in (self.horizontal_w, self.horizontal_b, self.vertical_w, self.vertical_b):
            p.normal_(0.0, 1.0, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.conv1(x)
        branches = [F.conv2d(c1, self.vertical_w, self.vertical_b, 2, (d, 0), (d, 1))
                    for d in (1, 2, 3)]
        branches += [F.conv2d(c1, self.horizontal_w, self.horizontal_b, 2, (0, d), (1, d))
                     for d in (1, 2, 3)]
        sel = self.conv_reduce(self.se(torch.cat(branches, dim=1)))
        v = torch.relu(self.conv_max(max_pool(sel, (8, 8), (4, 4))))
        c3 = self.conv3_(torch.relu(self.conv3(v)))
        c3 = resize_bilinear(c3, x.shape[2], x.shape[3], align_corners=False)
        return x * torch.sigmoid(self.conv4(self.conv_f(c1) + c3))


class PCAB(nn.Module):
    """The dense block (``pcan.py:86-125``); with ``text_channels`` it is
    PCAB_TP, which feeds ``x + rw`` (the width branch's residual) with the
    prior to BOTH GRUs, a reference quirk kept (``pcan.py:107-112``)."""

    def __init__(self, in_channels: int, channels: int, text_channels: int = 0):
        super().__init__()
        self.conv_reduce = Conv2d(in_channels, channels, (1, 1), (0, 0))
        self.conv1 = Conv2d(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.conv2_w = Conv2d(channels, channels)
        self.bn2_w = BatchNorm2d(channels)
        self.conv2_h = Conv2d(channels, channels)
        self.bn2_h = BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.gru2 = GruBlock(channels + text_channels, channels)
        self.fs = FeatureSelection(channels * 2)
        self.conv3 = Conv2d(channels * 2, channels)
        self.bn3 = BatchNorm2d(channels)

    def forward(self, inputs: list[torch.Tensor],
                tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.conv_reduce(torch.cat(inputs, dim=1))
        r = mish(self.bn1(self.conv1(x)))
        rw = self.bn2_w(self.conv2_w(r))
        # computed with a prior too, where nothing reads it: its BatchNorm's
        # running statistics advance, as in JAX
        rh = self.bn2_h(self.conv2_h(r))
        if tp is not None:
            in_w = in_h = torch.cat([x + rw, tp.to(x.dtype)], dim=1)
        else:
            in_w, in_h = x + rw, x + rh
        w_feat = self.gru1(in_w)
        h_feat = self.gru2(in_h.transpose(2, 3)).transpose(2, 3)
        fusion = self.fs(torch.cat([h_feat, w_feat], dim=1))
        return mish(self.bn3(self.conv3(fusion)))


class PCAN(JaxNamed):
    """``pcan.py:128-153``: [N, 4, 16, 64] -> [N, 4, 32, 128] (3 channels
    without ``mask``)."""

    def __init__(self, scale_factor: int = 2, srb_nums: int = 5, mask: bool = True,
                 hidden_units: int = 32, text_channels: int = 0):
        super().__init__()
        ch, in_planes = 2 * hidden_units, 4 if mask else 3
        self.srb_nums = srb_nums
        self.block1_conv = Conv2d(in_planes, ch, (9, 9), (4, 4))
        self.block1_act = PReLU()
        for i in range(srb_nums):
            setattr(self, f"block{i + 2}", PCAB(ch * (i + 1), ch, text_channels))
        self.spatial_attention = HOTA(ch * srb_nums)
        self.post_conv = Conv2d(ch * srb_nums, ch)
        self.post_bn = BatchNorm2d(ch)
        self.n_up = int(math.log2(scale_factor))
        for i in range(self.n_up):
            setattr(self, f"up{i}", UpsampleBlock(ch, 2))
        self.final = Conv2d(ch, in_planes, (9, 9), (4, 4))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.block1_act(self.block1_conv(x))

    def body(self, b1: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = [b1]
        for i in range(self.srb_nums):
            feats.append(getattr(self, f"block{i + 2}")(feats, tp))
        h = self.post_bn(self.post_conv(self.spatial_attention(torch.cat(feats[1:], dim=1))))
        h = h + b1
        for i in range(self.n_up):
            h = getattr(self, f"up{i}")(h)
        return torch.tanh(self.final(h))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen`` is accepted for the plain step's convention (no dropout)."""
        return self.body(self.stem(x))


class PCAN_TL(PCAN):
    """``pcan.py:156-193``: the InfoGen prior, resized to the stem's size
    (``align_corners=True``), joins both GRU branches of every PCAB.
    ``aux``: ``spatial_t_emb`` and ``trans_feat`` (the resized map) and
    ``in_feat`` (the stem)."""

    def __init__(self, scale_factor: int = 2, srb_nums: int = 5, mask: bool = True,
                 hidden_units: int = 32, text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(scale_factor, srb_nums, mask, hidden_units, out_text_channels)
        self.infoGen = InfoGen(text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        """The TATT step's convention; one copy a forward, no dropout."""
        check_copies(copies)
        b1 = self.stem(x)
        tp_raw = self.infoGen(text_emb.to(b1.dtype))
        tp = resize_bilinear(tp_raw, b1.shape[2], b1.shape[3], align_corners=True)
        return self.body(b1, tp), {"spatial_t_emb": tp, "in_feat": b1, "trans_feat": tp}
