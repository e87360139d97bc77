"""The TSRN family and the TATT generator (counterpart of
``tatt_tpu/models/tsrn.py``).

Every generator shares one trunk, under the module names of the reference
``TSRN`` / ``TSRN_TL_TRANS`` (``model/tsrn.py:88-150, 576-692``), so the
``state_dict`` has the reference layout: ``block1`` (9x9 conv + PReLU),
``block2 .. block{srb+1}`` (residual blocks), ``block{srb+2}`` (conv +
BN), ``block{srb+3}`` (upsampling + final 9x9 conv), ``stn_head`` (with
``stn=True``), and per model ``infoGen`` (TATT's TP Interpreter, or the
TL archs' deconv :class:`InfoGen`), ``sft_layer``, ``coarse_proj`` or
``w2v_proj``.

- :class:`TSRN`: the plain baseline (arch ``tsrn``).
- :class:`TSRN_TL`: TSRN with the InfoGen text prior (``tsrn_tl_cascade``,
  TPGSR).
- :class:`TSRN_TL_SFT`: the prior modulated by an :class:`SFTLayer`
  (``tsrn_tl_cascade_sft``).
- :class:`TSRN_C2F`: a coarse projection concatenated before the tail
  (``tsrn_c2f``); returns ``(out, coarse)``.
- :class:`SEM_TSRN`: self-attention :class:`ReasoningResidualBlock` s and a
  word-vector head (``sem_tsrn``); returns ``(out, pred_vecs)``.
- :class:`TSRNEncoder`: the trunk without its tail (no arch builds it).
- :class:`TATT`: the paper's generator (``tatt``).

The generators with a text prior (TATT, TSRN_TL, TSRN_TL_SFT) take the
TATT step's convention ``forward(x, text_emb, copies=1, gen=None) -> (sr,
aux)``; the plain ones the plain step's ``forward(x, gen=None)`` (``gen``:
the dropout generator of a training forward; none of this family has
dropout).

Axis conventions: inside a block, ``gru1`` scans HEIGHT, batched over
N*W rows (its input is the H<->W transposed map, rows ordered (n, w) as
the JAX ``reshape(n*w, h, c)`` after the swap), and ``gru2`` scans WIDTH,
batched over N*H rows.  The JAX trunks of TSRN, TSRN_TL, TSRN_TL_SFT and
TSRN_C2F run NHWC with a lane-packed final conv, TPU layout devices of the
same maps; the port stays NCHW.

Training mode (``module.train()``): BatchNorm takes batch statistics,
``copies`` per forward (2 for the fused-tssim 2B batch, one set of
parameters: JAX clones the module with ``bn_copies=2``, ``loop.py:253``),
the STN rectifies the input (``tsrn.py:607-610``), and dropout draws from
the generator passed to the forward.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bilinear
from tatt_tpu_torch.kernels.rnn import BiGRU
from tatt_tpu_torch.models.common import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Dense,
    PReLU,
    mish,
    pixel_shuffle,
)
from tatt_tpu_torch.models.stn import STNHead, tps_transform
from tatt_tpu_torch.models.tp_interpreter import TPInterpreter
from tatt_tpu_torch.models.transformer import MultiheadAttention, TorchLayerNorm


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


class RecurrentResidualBlock(nn.Module):
    """The SRB: conv-BN-mish-conv-BN, height-GRU (via H<->W transposes),
    +x, width-GRU (``tsrn.py:93-117``).  With ``text_channels`` it is the
    SRB fused with a text-prior map (``RecurrentResidualBlockTL``,
    ``tsrn.py:120-149``): the prior is concatenated onto the residual
    before the height-GRU."""

    def __init__(self, channels: int, text_channels: int = 0):
        super().__init__()
        self.conv1 = Conv2d(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = Conv2d(channels, channels)
        self.bn2 = BatchNorm2d(channels)
        self.gru1 = GruBlock(channels + text_channels, channels)
        self.gru2 = GruBlock(channels, channels)

    def forward(
        self, x: torch.Tensor, text_emb: Optional[torch.Tensor] = None, copies: int = 1
    ) -> torch.Tensor:
        r = mish(self.bn1(self.conv1(x), copies))
        r = self.bn2(self.conv2(r), copies)
        if text_emb is not None:
            r = torch.cat([r, text_emb.to(r.dtype)], dim=1)
        r = self.gru1(r.transpose(2, 3)).transpose(2, 3)
        return self.gru2(x + r)


class UpsampleBlock(nn.Module):
    """conv3x3 (C -> C*r^2) -> PixelShuffle(r) -> mish."""

    def __init__(self, channels: int, up_scale: int = 2):
        super().__init__()
        self.up_scale = up_scale
        self.conv = Conv2d(channels, channels * up_scale**2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(pixel_shuffle(self.conv(x), self.up_scale))


class InfoGen(nn.Module):
    """TPGSR's prior deconv (``tsrn.py:171-193``, reference
    ``model/tsrn.py:284-317``): four bias-free transposed convs, each with
    BatchNorm (``copies``) and ReLU, lift [N, text_emb, 1, 26] to a map
    that the caller resizes."""

    SPECS = ((512, (2, 2), (0, 0)), (128, (2, 2), (0, 0)), (64, (2, 2), (1, 1)))

    def __init__(self, text_emb: int, out_channels: int):
        super().__init__()
        cin = text_emb
        specs = self.SPECS + ((out_channels, (2, 1), (1, 1)),)
        for i, (c, stride, pad) in enumerate(specs, start=1):
            setattr(self, f"tconv{i}", ConvTranspose2d(cin, c, (3, 3), stride, pad))
            setattr(self, f"bn{i}", BatchNorm2d(c))
            cin = c

    def forward(self, t: torch.Tensor, copies: int = 1) -> torch.Tensor:
        for i in range(1, 5):
            t = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"tconv{i}")(t), copies))
        return t


class SFTLayer(nn.Module):
    """Scale / shift feature transform (``tsrn.py:312-336``, reference
    ``model/tsrn.py:227-242``): ``fea * (scale(cond) + 1) + shift(cond)``,
    each branch a 1x1 conv to half the feature width, leaky ReLU 0.1 and a
    1x1 conv to the feature width."""

    def __init__(self, channels: int, cond_channels: int):
        super().__init__()
        mid = max(channels // 2, 1)
        for branch in ("SFT_scale_conv", "SFT_shift_conv"):
            setattr(self, f"{branch}0", Conv2d(cond_channels, mid, (1, 1), (0, 0)))
            setattr(self, f"{branch}1", Conv2d(mid, channels, (1, 1), (0, 0)))

    def _branch(self, name: str, cond: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(getattr(self, f"{name}0")(cond), 0.1)
        return getattr(self, f"{name}1")(h)

    def forward(self, fea: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return fea * (self._branch("SFT_scale_conv", cond) + 1.0) + self._branch("SFT_shift_conv", cond)


class ReasoningResidualBlock(nn.Module):
    """SEM_TSRN's block (``tsrn.py:487-519``): conv-BN-mish-conv-BN, then
    self-attention over the h*w tokens (4 heads) with the reference's
    LayerNorm (:class:`TorchLayerNorm`) and a position-wise FFN, + x.  The
    reference's enhancer ignores its word vector, so the block takes none.
    No dropout: JAX's plain step, the one caller, runs its attention
    deterministic in training too (``loop.py:260-264``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv2d(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = Conv2d(channels, channels)
        self.bn2 = BatchNorm2d(channels)
        self.mask_multihead = MultiheadAttention(channels, 4)
        self.norm1 = TorchLayerNorm(channels)
        self.pff_w1 = Dense(channels, channels)
        self.pff_w2 = Dense(channels, channels)
        self.norm3 = TorchLayerNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = mish(self.bn1(self.conv1(x)))
        r = self.bn2(self.conv2(r))
        n, c, h, w = r.shape
        tokens = r.reshape(n, c, h * w).transpose(1, 2)  # [N, T, C]
        attn, _ = self.mask_multihead(tokens, tokens, tokens)
        tokens = self.norm1(tokens + attn)
        ff = self.pff_w2(torch.relu(self.pff_w1(tokens)))
        tokens = self.norm3(tokens + ff)
        return x + tokens.transpose(1, 2).reshape(n, c, h, w)


class _Trunk(nn.Module):
    """The family's shared layout and the pieces of its forward: the STN
    head, the stem ``block1``, the residual blocks, ``block{srb+2}`` and
    the upsampling tail ``block{srb+3}``, registered in that order.  The
    JAX model names the blocks ``<JAX_BLOCK><i>`` and the final conv
    ``JAX_FINAL`` (the zoo's TBSRN: ``block<i>`` and ``final``)."""

    JAX_BLOCK, JAX_FINAL = "srb", "final_conv"

    def _build_trunk(
        self,
        in_planes: int,
        ch: int,
        srb_nums: int,
        stn: bool,
        make_block: Callable[[], nn.Module],
        scale_factor: Optional[int] = 2,
        tail_channels: Optional[int] = None,
        lr_size: Optional[tuple[int, int]] = None,
    ) -> None:
        """``scale_factor`` None: no tail (the encoder).  ``lr_size``: the
        LR crop, the STN's input and output size (None: 16x64 in, the
        input's size out)."""
        self.srb_nums, self.lr_size = srb_nums, lr_size
        if stn:
            self.stn_head = STNHead(in_planes, input_size=lr_size)
        self.block1 = nn.Sequential(Conv2d(in_planes, ch, (9, 9), (4, 4)), PReLU())
        for i in range(srb_nums):
            setattr(self, f"block{i + 2}", make_block())
        setattr(self, f"block{srb_nums + 2}", nn.Sequential(Conv2d(ch, ch), BatchNorm2d(ch)))
        if scale_factor is not None:
            tail = tail_channels or ch
            ups = [UpsampleBlock(tail, 2) for _ in range(int(math.log2(scale_factor)))]
            setattr(self, f"block{srb_nums + 3}",
                    nn.Sequential(*ups, Conv2d(tail, in_planes, (9, 9), (4, 4))))

    def blocks(self) -> list[nn.Module]:
        return [getattr(self, f"block{i + 2}") for i in range(self.srb_nums)]

    def rectify(self, x: torch.Tensor, copies: int = 1) -> torch.Tensor:
        """The STN's rectification, in training mode only."""
        if self.training and hasattr(self, "stn_head"):
            return tps_transform(x, self.stn_head(x, copies), self.lr_size or tuple(x.shape[-2:]))
        return x

    def post(self, h: torch.Tensor, copies: int = 1) -> torch.Tensor:
        conv, bn = getattr(self, f"block{self.srb_nums + 2}")
        return bn(conv(h), copies)

    def tail(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(getattr(self, f"block{self.srb_nums + 3}")(h))

    def jax_module_params(self) -> dict[str, list[nn.Parameter]]:
        """The parameters grouped under the JAX model's top-level module
        names (``block1_conv``, ``block1_act``, ``srb2`` .., ``post_conv``,
        ``post_bn``, ``up0`` .., ``final_conv``, and ``infoGen``,
        ``stn_head``, ``sft_layer``, ... as they are): the train step's
        ``gnorm/<module>`` metrics."""
        srb = self.srb_nums
        tail = getattr(self, f"block{srb + 3}", ())
        indexed = {
            "block1": ("block1_conv", "block1_act"),
            f"block{srb + 2}": ("post_conv", "post_bn"),
            f"block{srb + 3}": tuple(f"up{j}" for j in range(len(tail) - 1)) + (self.JAX_FINAL,),
        }
        groups: dict[str, list[nn.Parameter]] = {}
        for name, p in self.named_parameters():
            head, sub = name.split(".")[:2]
            if head in indexed:
                key = indexed[head][int(sub)]
            else:  # block2 .. block{srb+1} are the JAX srb2 .., the rest keep their names
                key = self.JAX_BLOCK + head[len("block"):] if head.startswith("block") else head
            groups.setdefault(key, []).append(p)
        return groups


class TSRN(_Trunk):
    """The plain TSRN baseline (``tsrn.py:196-237``, reference
    ``model/tsrn.py:88-150``): [N, 4, 16, 64] -> [N, 4, 32, 128]."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32,
                 stn: bool = False, srb_nums: int = 5, mask: bool = True, hidden_units: int = 32):
        super().__init__()
        ch = 2 * hidden_units
        self._build_trunk(4 if mask else 3, ch, srb_nums, stn, lambda: RecurrentResidualBlock(ch),
                          scale_factor, lr_size=(height // scale_factor, width // scale_factor))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen`` is accepted for the plain step's convention (no dropout)."""
        b1 = self.block1(self.rectify(x))
        h = b1
        for block in self.blocks():
            h = block(h)
        return self.tail(b1 + self.post(h))


class TSRN_TL(_Trunk):
    """TSRN with the InfoGen text prior (``tsrn.py:240-309``, reference
    ``model/tsrn.py:321-442``; arch ``tsrn_tl_cascade``): the prior map,
    resized to the LR size, joins every SRB.  ``aux``: ``spatial_t_emb``
    (InfoGen's map), ``in_feat`` (the stem) and ``trans_feat`` (the
    resized map)."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32,
                 stn: bool = False, srb_nums: int = 5, mask: bool = True, hidden_units: int = 32,
                 text_emb: int = 37, out_text_channels: int = 64):
        super().__init__()
        ch = 2 * hidden_units
        self._build_trunk(4 if mask else 3, ch, srb_nums, stn,
                          lambda: RecurrentResidualBlock(ch, self.prior_channels(out_text_channels, ch)),
                          scale_factor, lr_size=(height // scale_factor, width // scale_factor))
        self.infoGen = InfoGen(text_emb, out_text_channels)

    @staticmethod
    def prior_channels(out_text_channels: int, ch: int) -> int:
        """Channels of the prior map that joins each SRB."""
        return out_text_channels

    def prior(self, b1: torch.Tensor, text_emb: torch.Tensor, copies: int):
        """(InfoGen's map, the map each SRB reads) for the stem ``b1``."""
        tp_raw = self.infoGen(text_emb.to(b1.dtype), copies)
        return tp_raw, resize_bilinear(tp_raw, b1.shape[2], b1.shape[3], align_corners=True)

    def forward(
        self,
        x: torch.Tensor,
        text_emb: torch.Tensor,
        copies: int = 1,
        gen: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, dict[str, Any]]:
        """``copies``: logical batches packed in ``x`` (per-copy BatchNorm
        statistics in training); ``gen`` is accepted for the TATT step's
        convention (the model has no dropout)."""
        b1 = self.block1(self.rectify(x, copies))
        tp_raw, tp = self.prior(b1, text_emb, copies)
        h = b1
        for block in self.blocks():
            h = block(h, tp, copies)
        out = self.tail(b1 + self.post(h, copies))
        return out, {"spatial_t_emb": tp_raw, "in_feat": b1, "trans_feat": tp}


class TSRN_TL_SFT(TSRN_TL):
    """TSRN_TL whose prior map an :class:`SFTLayer` modulates, conditioned
    on the stem (``tsrn.py:339-407``, reference ``model/tsrn.py:446-572``;
    arch ``tsrn_tl_cascade_sft``).  The SFT output has the stem's width,
    so each SRB reads a prior of 2 * hidden_units channels."""

    def __init__(self, scale_factor: int = 2, width: int = 128, height: int = 32,
                 stn: bool = False, srb_nums: int = 5, mask: bool = True, hidden_units: int = 32,
                 text_emb: int = 37, out_text_channels: int = 64):
        super().__init__(scale_factor, width, height, stn, srb_nums, mask, hidden_units, text_emb,
                         out_text_channels)
        # the reference hard-codes 64 channels; the JAX package follows the
        # feature width
        self.sft_layer = SFTLayer(2 * hidden_units, out_text_channels)

    @staticmethod
    def prior_channels(out_text_channels: int, ch: int) -> int:
        return ch

    def prior(self, b1, text_emb, copies):
        tp_raw, tp = super().prior(b1, text_emb, copies)
        return tp_raw, self.sft_layer(b1, tp)


class TSRN_C2F(_Trunk):
    """Coarse-to-fine TSRN (``tsrn.py:410-458``, reference
    ``model/tsrn.py:696-761``; arch ``tsrn_c2f``): a coarse 9x9 projection
    of the trunk (``coarse_proj``) is concatenated onto it before the tail,
    whose blocks are ``2 * hidden_units + in_planes`` wide.  Returns
    ``(out, coarse)``.  ``width`` / ``height`` (the HR crop) size the STN
    head's fc1, which flax infers from the input."""

    def __init__(self, scale_factor: int = 2, stn: bool = False, srb_nums: int = 5,
                 mask: bool = True, hidden_units: int = 32, width: int = 128, height: int = 32):
        super().__init__()
        ch, in_planes = 2 * hidden_units, 4 if mask else 3
        self._build_trunk(in_planes, ch, srb_nums, stn, lambda: RecurrentResidualBlock(ch),
                          scale_factor, tail_channels=ch + in_planes,
                          lr_size=(height // scale_factor, width // scale_factor))
        self.coarse_proj = Conv2d(ch, in_planes, (9, 9), (4, 4))

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b1 = self.block1(self.rectify(x))
        h = b1
        for block in self.blocks():
            h = block(h)
        h = self.post(h)
        coarse = self.coarse_proj(h)
        return self.tail(torch.cat([b1 + h, coarse], dim=1)), coarse


class TSRNEncoder(_Trunk):
    """The TSRN trunk without its tail (``tsrn.py:461-484``, reference
    ``model/tsrn.py:24-85``): [N, C, H, W] -> features [N, 2 * hidden_units,
    H, W].  No arch builds it."""

    def __init__(self, stn: bool = False, srb_nums: int = 5, mask: bool = True,
                 hidden_units: int = 32):
        super().__init__()
        ch = 2 * hidden_units
        self._build_trunk(4 if mask else 3, ch, srb_nums, stn, lambda: RecurrentResidualBlock(ch),
                          scale_factor=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.block1(self.rectify(x))
        h = b1
        for block in self.blocks():
            h = block(h)
        return b1 + self.post(h)


class SEM_TSRN(_Trunk):
    """The word2vec-semantic TSRN ablation (``tsrn.py:522-560``, reference
    ``model/tsrn.py:764-848``; arch ``sem_tsrn``): before each
    :class:`ReasoningResidualBlock` a linear head (``w2v_proj``) predicts a
    word vector from the pooled features.  Returns ``(out, pred_vecs)``;
    the plain step reads ``out`` alone.  ``width`` / ``height``: as
    :class:`TSRN_C2F`'s."""

    def __init__(self, scale_factor: int = 2, stn: bool = False, srb_nums: int = 5,
                 mask: bool = True, hidden_units: int = 32, word_vec_d: int = 300,
                 width: int = 128, height: int = 32):
        super().__init__()
        ch = 2 * hidden_units
        self._build_trunk(4 if mask else 3, ch, srb_nums, stn,
                          lambda: ReasoningResidualBlock(ch), scale_factor,
                          lr_size=(height // scale_factor, width // scale_factor))
        self.w2v_proj = Dense(ch, word_vec_d)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        b1 = self.block1(self.rectify(x))
        h, pred_vecs = b1, []
        for block in self.blocks():
            pred_vecs.append(self.w2v_proj(h.mean(dim=(2, 3))))
            h = block(h)
        return self.tail(b1 + self.post(h)), pred_vecs


class TATT(_Trunk):
    """The TATT generator (``tsrn.py:563-675``).

    Input [N, 4, height / scale, width / scale] (RGB + mask; 16x64 by
    default) and the text prior [N, text_emb, 1, T] (37 x 26 with the
    CRNN); output [N, 4, height, width] in tanh range plus an aux dict."""

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
        self.text_emb = text_emb
        self.dropout = dropout
        lr_size = (height // scale_factor, width // scale_factor)
        self._build_trunk(4 if mask else 3, ch, srb_nums, stn,
                          lambda: RecurrentResidualBlock(ch, out_text_channels),
                          scale_factor, lr_size=lr_size)
        self.infoGen = TPInterpreter(
            text_emb=text_emb,
            d_model=out_text_channels,
            output_size=lr_size,
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
        x = self.rectify(x, copies)
        if text_emb is None:
            text_emb = x.new_zeros(x.shape[0], self.text_emb, 1, 26)
        b1 = self.block1(x)
        drop = (self.dropout, gen) if self.training else (0.0, None)
        tp_map, pr_weights = self.infoGen(b1, text_emb, *drop)
        h = b1
        for block in self.blocks():
            h = block(h, tp_map, copies)
        out = self.tail(b1 + self.post(h, copies))
        aux = {
            "pr_weights": pr_weights,
            "spatial_t_emb": tp_map,
            "in_feat": b1,
            "trans_feat": tp_map,
        }
        return out, aux
