"""SRResNet, EDSR, LapSRN and RDN, with ``SRResNet_TL`` and ``RDN_TL``
(counterpart of ``tatt_tpu/models/zoo/resnets.py``; reference
``model/srresnet.py``, ``model/edsr.py``, ``model/lapsrn.py``,
``model/rdn.py``).

SRResNet_TL's prior is a TP Interpreter (the reference's InfoGenTrans)
resized to the LR size; RDN_TL's is InfoGen's map resized to the input's
size.  RDN and RDN_TL keep the reference names that ``import_rdn_tl``
reads (``RDB<k>.dense_layers.<i>.conv``); the rest keep the JAX names.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bilinear
from tatt_tpu_torch.models.common import (
    BatchNorm2d, Conv2d, ConvTranspose2d, JaxNamed, PReLU, check_copies, pixel_shuffle,
)
from tatt_tpu_torch.models.tp_interpreter import TPInterpreter
from tatt_tpu_torch.models.tsrn import InfoGen


# ---------------------------------------------------------------- SRResNet
class SRResidualBlock(nn.Module):
    """conv-BN-PReLU-conv-BN plus the skip (``resnets.py:32-44``); with
    ``text_channels`` the prior joins before conv2 (SRResidualBlockTL,
    ``:47-63``)."""

    def __init__(self, channels: int = 64, text_channels: int = 0):
        super().__init__()
        self.conv1 = Conv2d(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.prelu = PReLU()
        self.conv2 = Conv2d(channels + text_channels, channels)
        self.bn2 = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        r = self.prelu(self.bn1(self.conv1(x)))
        if tp is not None:
            r = torch.cat([r, tp.to(r.dtype)], dim=1)
        return x + self.bn2(self.conv2(r))


class _SRUp(nn.Module):
    """conv 3x3 (C -> 4C) -> PixelShuffle(2) -> PReLU."""

    def __init__(self, channels: int = 64):
        super().__init__()
        self.conv = Conv2d(channels, channels * 4)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(pixel_shuffle(self.conv(x), 2))


class SRResNet(JaxNamed):
    """``resnets.py:75-95``: 64 channels, five residual blocks."""

    def __init__(self, scale_factor: int = 2, mask: bool = False, text_channels: int = 0):
        super().__init__()
        in_planes = 4 if mask else 3
        self.block1_conv = Conv2d(in_planes, 64, (9, 9), (4, 4))
        self.block1_act = PReLU()
        for i in range(5):
            setattr(self, f"block{i + 2}", SRResidualBlock(64, text_channels))
        self.block7_conv = Conv2d(64, 64)
        self.block7_bn = BatchNorm2d(64)
        self.n_up = int(math.log2(scale_factor))
        for i in range(self.n_up):
            setattr(self, f"up{i}", _SRUp(64))
        self.final = Conv2d(64, in_planes, (9, 9), (4, 4))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.block1_act(self.block1_conv(x))

    def body(self, b1: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = b1
        for i in range(5):
            h = getattr(self, f"block{i + 2}")(h, tp)
        h = b1 + self.block7_bn(self.block7_conv(h))
        for i in range(self.n_up):
            h = getattr(self, f"up{i}")(h)
        return torch.tanh(self.final(h))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.body(self.stem(x))


class SRResNet_TL(SRResNet):
    """``resnets.py:98-144``: a TP Interpreter (queries: the stem) gives a
    prior map at the LR size, ``height // scale`` x ``width // scale``,
    that joins every block.  Dropout (``dropout``) in its transformer
    draws from the ``gen`` of a training forward.  ``aux``: ``pr_weights``
    and ``spatial_t_emb``."""

    def __init__(self, scale_factor: int = 2, mask: bool = False, height: int = 32,
                 width: int = 128, text_emb: int = 37, out_text_channels: int = 64,
                 dropout: float = 0.1):
        super().__init__(scale_factor, mask, out_text_channels)
        self.lr_size = (height // scale_factor, width // scale_factor)
        self.dropout = dropout
        self.infoGen = TPInterpreter(text_emb=text_emb, d_model=out_text_channels,
                                     output_size=self.lr_size)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        check_copies(copies)
        b1 = self.stem(x)
        drop = (self.dropout, gen) if self.training else (0.0, None)
        tp_raw, pr_weights = self.infoGen(b1, text_emb, *drop)
        tp = resize_bilinear(tp_raw, *self.lr_size, align_corners=True)
        return self.body(b1, tp), {"pr_weights": pr_weights, "spatial_t_emb": tp_raw}


# ------------------------------------------------------------------- EDSR
class EDSR(JaxNamed):
    """``resnets.py:148-175``: the RGB mean subtracted, 32 residual blocks
    at 256 channels, each residual scaled by 0.1, pixel-shuffle
    upsampling, the mean added back.  Reads the first 3 channels."""

    RGB_MEAN = (0.4488, 0.4371, 0.4040)

    def __init__(self, scale_factor: int = 2, num_blocks: int = 32):
        super().__init__()
        self.num_blocks, self.n_up = num_blocks, int(math.log2(scale_factor))
        self.conv_input = Conv2d(3, 256, bias=False)
        for i in range(num_blocks):
            setattr(self, f"res{i}_conv1", Conv2d(256, 256, bias=False))
            setattr(self, f"res{i}_conv2", Conv2d(256, 256, bias=False))
        self.conv_mid = Conv2d(256, 256, bias=False)
        for i in range(self.n_up):
            setattr(self, f"up{i}", Conv2d(256, 256 * 4, bias=False))
        self.conv_output = Conv2d(256, 3, bias=False)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        mean = torch.tensor(self.RGB_MEAN, dtype=x.dtype, device=x.device)[None, :, None, None]
        residual = self.conv_input(x[:, :3] - mean)
        h = residual
        for i in range(self.num_blocks):
            r = torch.relu(getattr(self, f"res{i}_conv1")(h))
            h = h + 0.1 * getattr(self, f"res{i}_conv2")(r)
        h = self.conv_mid(h) + residual
        for i in range(self.n_up):
            h = pixel_shuffle(getattr(self, f"up{i}")(h), 2)
        return self.conv_output(h) + mean


# ------------------------------------------------------------------ LapSRN
class LapSRN(JaxNamed):
    """``resnets.py:179-221``: a feature branch of ten conv-LeakyReLU(0.2)
    and a 4x4 / 2 transposed conv, and an image branch of a transposed
    conv, summed per x2 level."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 3):
        super().__init__()
        self.scale_factor, self.in_planes = scale_factor, in_planes
        self.conv_input = Conv2d(in_planes, 64, bias=False)
        levels = (1,) if scale_factor == 2 else (1, 2)
        for k in levels:
            for i in range(10):
                setattr(self, f"F{k}_conv{i}", Conv2d(64, 64, bias=False))
            setattr(self, f"F{k}_deconv", ConvTranspose2d(64, 64, (4, 4), (2, 2), (1, 1)))
            setattr(self, f"convt_I{k}",
                    ConvTranspose2d(in_planes, in_planes, (4, 4), (2, 2), (1, 1)))
            setattr(self, f"convt_R{k}", Conv2d(64, in_planes, bias=False))

    def _features(self, h: torch.Tensor, k: int) -> torch.Tensor:
        for i in range(10):
            h = F.leaky_relu(getattr(self, f"F{k}_conv{i}")(h), 0.2)
        return F.leaky_relu(getattr(self, f"F{k}_deconv")(h), 0.2)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x[:, : self.in_planes]
        f1 = self._features(F.leaky_relu(self.conv_input(x), 0.2), 1)
        hr2x = self.convt_I1(x) + self.convt_R1(f1)
        if self.scale_factor == 2:
            return hr2x
        f2 = self._features(f1, 2)
        return self.convt_I2(hr2x) + self.convt_R2(f2)


# -------------------------------------------------------------------- RDN
class _DenseLayer(nn.Module):
    """One bias-free 3x3 conv of a residual dense block, under the
    reference's ``dense_layers.<i>.conv``."""

    def __init__(self, in_ch: int, growth: int):
        super().__init__()
        self.conv = Conv2d(in_ch, growth, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x))


class RDB(nn.Module):
    """Residual dense block (``resnets.py:225-241``): ``n_dense`` 3x3 convs,
    each reading every earlier output; a 1x1 fuse and the skip.  With
    ``text_channels`` the prior joins before the fuse (RDB_TL,
    ``:244-261``)."""

    def __init__(self, channels: int = 64, n_dense: int = 6, growth: int = 32,
                 text_channels: int = 0):
        super().__init__()
        self.dense_layers = nn.ModuleList(
            _DenseLayer(channels + i * growth, growth) for i in range(n_dense))
        self.conv_1x1 = Conv2d(channels + n_dense * growth + text_channels, channels, (1, 1),
                               (0, 0), bias=False)

    def forward(self, x: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x
        for layer in self.dense_layers:
            h = torch.cat([h, layer(h)], dim=1)
        if tp is not None:
            h = torch.cat([h, tp.to(h.dtype)], dim=1)
        return self.conv_1x1(h) + x


class RDN(JaxNamed):
    """``resnets.py:264-285``: three RDBs, global feature fusion, a
    sub-pixel upsampling.  Reads the first ``in_planes`` channels."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 3, n_feat: int = 64,
                 text_channels: int = 0):
        super().__init__()
        self.in_planes, self.scale_factor = in_planes, scale_factor
        self.conv1 = Conv2d(in_planes, n_feat)
        self.conv2 = Conv2d(n_feat, n_feat)
        for k in (1, 2, 3):
            setattr(self, f"RDB{k}", RDB(n_feat, text_channels=text_channels))
        self.GFF_1x1 = Conv2d(3 * n_feat, n_feat, (1, 1), (0, 0))
        self.GFF_3x3 = Conv2d(n_feat, n_feat)
        self.conv_up = Conv2d(n_feat, n_feat * scale_factor**2)
        self.conv3 = Conv2d(n_feat, in_planes)

    def body(self, x: torch.Tensor, tp: Optional[torch.Tensor] = None) -> torch.Tensor:
        f_m1 = self.conv1(x)
        f1 = self.RDB1(self.conv2(f_m1), tp)
        f2 = self.RDB2(f1, tp)
        f3 = self.RDB3(f2, tp)
        h = self.GFF_3x3(self.GFF_1x1(torch.cat([f1, f2, f3], dim=1))) + f_m1
        return self.conv3(pixel_shuffle(self.conv_up(h), self.scale_factor))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.body(x[:, : self.in_planes])


class RDN_TL(RDN):
    """``resnets.py:288-314``: the InfoGen prior, resized to the input's
    size (the reference's hard-coded (8, 32) cannot join its 16x64
    features: the JAX package takes the evident intent), joins every RDB
    before its fuse."""

    def __init__(self, scale_factor: int = 2, in_planes: int = 4, n_feat: int = 64,
                 text_emb: int = 37, out_text_channels: int = 32):
        super().__init__(scale_factor, in_planes, n_feat, out_text_channels)
        self.infoGen = InfoGen(text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        check_copies(copies)
        tp_raw = self.infoGen(text_emb.to(x.dtype))
        tp = resize_bilinear(tp_raw, x.shape[2], x.shape[3], align_corners=True)
        return self.body(x, tp), {"spatial_t_emb": tp_raw}
