"""The TATT generator (counterpart of ``tatt_tpu/models/tsrn.py``).

Module names follow the reference ``TSRN_TL_TRANS`` (``model/tsrn.py:576-692``)
so the ``state_dict`` has the reference layout: ``block1`` (9x9 conv +
PReLU), ``block2 .. block{srb+1}`` (recurrent residual blocks),
``block{srb+2}`` (conv + BN), ``block{srb+3}`` (upsampling + final 9x9
conv), ``infoGen`` (the TP Interpreter), ``stn_head`` (with ``stn=True``).

Axis conventions: inside a block, ``gru1`` scans HEIGHT, batched over
N*W rows (its input is the H<->W transposed map, rows ordered (n, w) as
the JAX ``reshape(n*w, h, c)`` after the swap), and ``gru2`` scans WIDTH,
batched over N*H rows.

Training mode (``module.train()``): BatchNorm takes batch statistics,
``copies`` per forward (2 for the fused-tssim 2B batch, one set of
parameters: JAX clones the module with ``bn_copies=2``, ``loop.py:253``),
the STN rectifies the input (``tsrn.py:607-610``), and dropout draws from
the generator passed to the forward.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch import nn

from tatt_tpu_torch.kernels.rnn import BiGRU
from tatt_tpu_torch.models.common import (
    BatchNorm2d,
    Conv2d,
    PReLU,
    mish,
    pixel_shuffle,
)
from tatt_tpu_torch.models.stn import STNHead, tps_transform
from tatt_tpu_torch.models.tp_interpreter import TPInterpreter


class GruBlock(nn.Module):
    """1x1 conv then BiGRU along W, batched over N*H rows
    (``tsrn.py:41-90``).  The 1x1 conv folds exactly into the GRU input
    projection, so it is never run as a conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        assert out_channels % 2 == 0
        self.out_channels = out_channels
        self.conv1 = Conv2d(in_channels, out_channels, (1, 1), padding=(0, 0))
        self.gru = BiGRU(out_channels, out_channels // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW [N, C, H, W] -> [N, out, H, W], scanning W."""
        n, c, h, w = x.shape
        seq = x.permute(0, 2, 3, 1).reshape(n * h, w, c)
        seq = self.gru(seq, self.conv1.weight[:, :, 0, 0], self.conv1.bias)
        return seq.reshape(n, h, w, self.out_channels).permute(0, 3, 1, 2)


class RecurrentResidualBlockTL(nn.Module):
    """SRB fused with the text-prior map (``tsrn.py:120-149``): conv-BN-
    mish-conv-BN, concat the prior, height-GRU (via H<->W transposes),
    +x, width-GRU."""

    def __init__(self, channels: int, text_channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = Conv2d(channels, channels)
        self.bn2 = BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.gru2 = GruBlock(channels, channels)

    def forward(self, x: torch.Tensor, text_emb: torch.Tensor, copies: int = 1) -> torch.Tensor:
        r = mish(self.bn1(self.conv1(x), copies))
        r = self.bn2(self.conv2(r), copies)
        cat = torch.cat([r, text_emb.to(r.dtype)], dim=1)
        r = self.gru1(cat.transpose(2, 3)).transpose(2, 3)
        return self.gru2(x + r)


class UpsampleBlock(nn.Module):
    """conv3x3 (C -> C*r^2) -> PixelShuffle(r) -> mish."""

    def __init__(self, channels: int, up_scale: int = 2):
        super().__init__()
        self.up_scale = up_scale
        self.conv = Conv2d(channels, channels * up_scale**2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(pixel_shuffle(self.conv(x), self.up_scale))


class TATT(nn.Module):
    """The TATT generator (``tsrn.py:563-675``).

    Input [N, 4, 16, 64] (RGB + mask) and the text prior [N, 37, 1, 26];
    output [N, 4, 32, 128] in tanh range plus an aux dict."""

    def __init__(
        self,
        scale_factor: int = 2,
        width: int = 128,
        height: int = 32,
        srb_nums: int = 5,
        mask: bool = True,
        hidden_units: int = 32,
        text_emb: int = 37,
        out_text_channels: int = 64,
        query_gru_mode: str = "width",
        stn: bool = False,
        dropout: float = 0.1,
    ):
        super().__init__()
        ch = 2 * hidden_units
        if ch != out_text_channels:
            raise ValueError(
                "TATT requires 2*hidden_units == out_text_channels "
                f"({ch} != {out_text_channels})"
            )
        in_planes = 4 if mask else 3
        self.srb_nums = srb_nums
        self.text_emb = text_emb
        self.dropout = dropout
        self.lr_size = (height // scale_factor, width // scale_factor)
        if stn:
            self.stn_head = STNHead(in_planes)
        self.block1 = nn.Sequential(Conv2d(in_planes, ch, (9, 9), (4, 4)), PReLU())
        for i in range(srb_nums):
            setattr(self, f"block{i + 2}", RecurrentResidualBlockTL(ch, out_text_channels))
        setattr(
            self, f"block{srb_nums + 2}", nn.Sequential(Conv2d(ch, ch), BatchNorm2d(ch))
        )
        ups = [UpsampleBlock(ch, 2) for _ in range(int(math.log2(scale_factor)))]
        setattr(
            self,
            f"block{srb_nums + 3}",
            nn.Sequential(*ups, Conv2d(ch, in_planes, (9, 9), (4, 4))),
        )
        self.infoGen = TPInterpreter(
            text_emb=text_emb,
            d_model=out_text_channels,
            output_size=self.lr_size,
            query_gru_mode=query_gru_mode,
        )

    def forward(
        self,
        x: torch.Tensor,
        text_emb: Optional[torch.Tensor] = None,
        copies: int = 1,
        gen: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, dict[str, Any]]:
        """``copies``: logical batches packed in ``x`` (per-copy BatchNorm
        statistics in training); ``gen``: the dropout generator (training
        only; no dropout without one)."""
        if self.training and hasattr(self, "stn_head"):
            x = tps_transform(x, self.stn_head(x, copies), self.lr_size)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        b1 = self.block1(x)
        drop = (self.dropout, gen) if self.training else (0.0, None)
        tp_map, pr_weights = self.infoGen(b1, text_emb, *drop)
        h = b1
        for i in range(self.srb_nums):
            h = getattr(self, f"block{i + 2}")(h, tp_map, copies)
        conv, bn = getattr(self, f"block{self.srb_nums + 2}")
        h = b1 + bn(conv(h), copies)
        out = torch.tanh(getattr(self, f"block{self.srb_nums + 3}")(h))
        aux = {
            "pr_weights": pr_weights,
            "spatial_t_emb": tp_map,
            "in_feat": b1,
            "trans_feat": tp_map,
        }
        return out, aux
