"""TBSRN, the position-aware transformer SR net, and TBSRN_TL (counterpart
of ``tatt_tpu/models/zoo/tbsrn.py``, reference ``model/tbsrn.py``).

TSRN's trunk with a FeatureEnhancer in each block: the H*W positions are
tokens of the 64 features and a 2-D sinusoidal encoding (64 more), one
self-attention layer (4 heads, f32 logits and softmax) and an FFN, and a
linear map back to 64 channels.  At H*W = 1,024 tokens the scores of one
block are [N, 4, 1024, 1024] f32 (1 GiB at batch 64); they are written out
in plain ops, as the JAX package computes them.  Dropout (``dropout``,
0.1 in the JAX package) acts on the attention weights in training and
draws from the forward's ``gen``.

The module names are the reference's, which ``import_tbsrn_tl`` reads:
the TSRN trunk (``block1``, ``block2 ..``, ``block{srb+2}``,
``block{srb+3}``), and in each FeatureEnhancer ``multihead.linears.0-3``
(q, k, v, out), ``mul_layernorm1`` / ``3`` and ``pff.w_1`` / ``w_2``.
TBSRN_TL's prior is a 128-wide InfoGen, resized to the input's size.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bilinear
from tatt_tpu_torch.models.common import BatchNorm2d, Conv2d, Dense, check_copies, mish
from tatt_tpu_torch.models.transformer import TorchLayerNorm, attend
from tatt_tpu_torch.models.tsrn import InfoGen, _Trunk


@lru_cache(maxsize=None)
def positional_encoding_2d(d_model: int, height: int, width: int) -> np.ndarray:
    """``tbsrn.py:38-50``: the first half of the channels encodes x, the
    second half y.  The reference hard-codes a 16x256 map, which does not
    fit its own 16x64 features; the JAX package builds it at the features'
    size, and so does the port."""
    pe = np.zeros((d_model, height, width), dtype=np.float32)
    half = d_model // 2
    div = np.exp(np.arange(0.0, half, 2) * -(math.log(10000.0) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    pe[0:half:2] = np.sin(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[half::2] = np.sin(pos_h * div).T[:, :, None].repeat(width, axis=2)
    pe[half + 1 :: 2] = np.cos(pos_h * div).T[:, :, None].repeat(width, axis=2)
    return pe


class MultiHeadedAttention(nn.Module):
    """The reference's attention with four Linears (reference ``model/tbsrn.py:96-131``):
    ``linears.0-2`` project q, k, v and ``linears.3`` the output; the maths
    of :class:`~tatt_tpu_torch.models.transformer.MultiheadAttention`."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.linears = nn.ModuleList(Dense(d_model, d_model) for _ in range(4))

    def forward(self, x: torch.Tensor, rate: float = 0.0, gen=None) -> torch.Tensor:
        q, k, v = (lin(x) for lin in self.linears[:3])
        out, _ = attend(q, k, v, self.nhead, rate, gen, need_weights=False)
        return self.linears[3](out)


class _FeedForward(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.w_1 = Dense(d, d)
        self.w_2 = Dense(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(torch.relu(self.w_1(x)))


class FeatureEnhancer(nn.Module):
    """``tbsrn.py:69-101``: self-attention over the spatial tokens with the
    2-D encoding, then the FFN, each followed by the reference's
    LayerNorm, and a linear map back to ``d_feat``."""

    def __init__(self, d_feat: int = 64, nhead: int = 4):
        super().__init__()
        self.d_feat = d_feat
        self.multihead = MultiHeadedAttention(2 * d_feat, nhead)
        self.mul_layernorm1 = TorchLayerNorm(2 * d_feat)
        self.pff = _FeedForward(2 * d_feat)
        self.mul_layernorm3 = TorchLayerNorm(2 * d_feat)
        self.linear = Dense(2 * d_feat, d_feat)

    def forward(self, x: torch.Tensor, rate: float = 0.0, gen=None) -> torch.Tensor:
        """[N, C, H, W] -> [N, C, H, W]."""
        n, c, h, w = x.shape
        pe = torch.as_tensor(positional_encoding_2d(self.d_feat, h, w), device=x.device)
        tokens = torch.cat([x.reshape(n, c, h * w),
                            pe.reshape(1, c, h * w).expand(n, c, h * w).to(x.dtype)], dim=1)
        tokens = tokens.transpose(1, 2)  # [N, HW, 2C]
        tokens = self.mul_layernorm1(tokens + self.multihead(tokens, rate, gen))
        tokens = self.mul_layernorm3(tokens + self.pff(tokens))
        return self.linear(tokens).transpose(1, 2).reshape(n, c, h, w)


class TBSRNBlock(nn.Module):
    """``tbsrn.py:104-134``: conv-BN-mish-conv-BN, the FeatureEnhancer, + x;
    with ``text_channels`` the prior joins through a 1x1 conv and mish
    before the skip."""

    def __init__(self, channels: int, text_channels: int = 0):
        super().__init__()
        self.conv1 = Conv2d(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = Conv2d(channels, channels)
        self.bn2 = BatchNorm2d(channels)
        self.feature_enhancer = FeatureEnhancer(channels)
        if text_channels:
            self.conv_proj = Conv2d(channels + text_channels, channels, (1, 1), (0, 0))

    def forward(self, x: torch.Tensor, tp: Optional[torch.Tensor] = None, rate: float = 0.0,
                gen=None) -> torch.Tensor:
        r = self.bn2(self.conv2(mish(self.bn1(self.conv1(x)))))
        r = self.feature_enhancer(r, rate, gen)
        if tp is not None:
            r = mish(self.conv_proj(torch.cat([r, tp.to(r.dtype)], dim=1)))
        return x + r


class InfoGenTBSRN(InfoGen):
    """TBSRN's InfoGen with 128-wide deconvs (``tbsrn.py:137-157``)."""

    SPECS = ((128, (2, 2), (0, 0)), (128, (2, 2), (0, 0)), (64, (2, 2), (1, 1)))


class TBSRN(_Trunk):
    """``tbsrn.py:160-187``: [N, 3, 16, 64] -> [N, 3, 32, 128] (4 channels
    with ``mask``)."""

    JAX_BLOCK, JAX_FINAL = "block", "final"

    def __init__(self, scale_factor: int = 2, srb_nums: int = 5, mask: bool = False,
                 hidden_units: int = 32, dropout: float = 0.1, text_channels: int = 0):
        super().__init__()
        ch = 2 * hidden_units
        self.dropout = dropout
        self._build_trunk(4 if mask else 3, ch, srb_nums, False,
                          lambda: TBSRNBlock(ch, text_channels), scale_factor)

    def body(self, b1: torch.Tensor, tp: Optional[torch.Tensor], gen) -> torch.Tensor:
        drop = (self.dropout, gen) if self.training else (0.0, None)
        h = b1
        for block in self.blocks():
            h = block(h, tp, *drop)
        return self.tail(b1 + self.post(h))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen``: the dropout generator of a training forward."""
        return self.body(self.block1(x), None, gen)


class TBSRN_TL(TBSRN):
    """``tbsrn.py:190-228``: the 128-wide InfoGen prior, resized to the
    input's size, joins every block."""

    def __init__(self, scale_factor: int = 2, srb_nums: int = 5, mask: bool = False,
                 hidden_units: int = 32, text_emb: int = 37, out_text_channels: int = 32,
                 dropout: float = 0.1):
        super().__init__(scale_factor, srb_nums, mask, hidden_units, dropout, out_text_channels)
        self.infoGen = InfoGenTBSRN(text_emb, out_text_channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1,
                gen: Optional[torch.Generator] = None) -> tuple[torch.Tensor, dict[str, Any]]:
        check_copies(copies)
        b1 = self.block1(x)
        tp_raw = self.infoGen(text_emb.to(x.dtype))
        tp = resize_bilinear(tp_raw, x.shape[2], x.shape[3], align_corners=True)
        return self.body(b1, tp, gen), {"spatial_t_emb": tp_raw}
