"""Transformer pieces of the TP Interpreter and of the zoo's
``SRTransformerV4`` and TBSRN (counterpart of
``tatt_tpu/models/transformer.py``).

Batch-first [B, L, C].  Attention keeps torch ``nn.MultiheadAttention``'s
packed ``in_proj`` [3C, C] layout and is written out in plain ops: the
caller needs the head-averaged weights (``aux["pr_weights"]``), which a
fused attention call does not return.  The projections run in the input's
dtype; logits accumulate and softmax normalizes in f32, and the weights
meet ``v`` in its dtype (``transformer.py:93-109``); LayerNorm computes in
f32 and returns the input's dtype.
Dropout runs at the JAX sites (attention weights, ``transformer.py:107``;
the residual branches and the FFN, ``:153,185,233``) when the caller
passes a rate and a generator, and is the identity otherwise (eval).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tatt_tpu_torch.models.common import Dense, dropout


@lru_cache(maxsize=None)
def positional_encoding_table(max_len: int, d_model: int) -> np.ndarray:
    """Sin/cos table (``transformer_v2.py:22-42``): pe[:, 0::2] = sin,
    pe[:, 1::2] = cos with the log-space frequency schedule."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def positional_encoding(length: int, d_model: int, device=None) -> torch.Tensor:
    """The first ``length`` rows of :func:`positional_encoding_table` as a
    float32 tensor on ``device`` (``transformer.py:43``)."""
    return torch.as_tensor(positional_encoding_table(length, d_model), device=device)


def attend(q, k, v, nhead: int, rate: float = 0.0, gen=None, need_weights: bool = True):
    """Scaled dot-product attention of projected ``q`` [B, Lq, C] against
    ``k`` / ``v`` [B, Lk, C] in ``nhead`` heads, logits and softmax in f32,
    dropout on the weights -> (output [B, Lq, C], weights averaged over
    heads [B, Lq, Lk], or None without ``need_weights``)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    hd = c // nhead
    q = q.reshape(b, lq, nhead, hd).transpose(1, 2)
    k = k.reshape(b, lk, nhead, hd).transpose(1, 2)
    v = v.reshape(b, lk, nhead, hd).transpose(1, 2)
    # the scaled q in its own dtype, the products accumulated in f32
    logits = torch.matmul((q * (1.0 / math.sqrt(hd))).float(), k.float().transpose(-1, -2))
    weights = dropout(torch.softmax(logits, dim=-1), rate, gen)
    out = torch.matmul(weights.to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, lq, c), weights.mean(dim=1) if need_weights else None


class MultiheadAttention(nn.Module):
    """Torch-parity MHA returning (output, weights averaged over heads)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model)

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = math.sqrt(6.0 / (self.d_model + 3 * self.d_model))  # xavier
        self.in_proj_weight.uniform_(-bound, bound, generator=gen)
        self.in_proj_bias.zero_()

    def forward(self, query, key, value, rate: float = 0.0, gen=None):
        c, dt = self.d_model, query.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).split(c)
        bq, bk, bv = self.in_proj_bias.to(dt).split(c)
        out, weights = attend(F.linear(query, wq, bq), F.linear(key, wk, bk),
                              F.linear(value, wv, bv), self.nhead, rate, gen)
        return self.out_proj(out), weights


class LayerNorm(nn.Module):
    """LayerNorm with eps 1e-5 and f32 statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        return (y * self.weight + self.bias).to(x.dtype)


class TorchLayerNorm(nn.Module):
    """The reference's hand-rolled LayerNorm (``model/tbsrn.py:23-36``; the
    JAX package's ``zoo/tbsrn.py:53-66``): ``a_2 (x - mean) / (std + 1e-6)
    + b_2`` with the unbiased std, f32 statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(channels))
        self.b_2 = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.a_2.fill_(1.0)
        self.b_2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        std = x32.var(-1, keepdim=True, unbiased=x.shape[-1] > 1).sqrt()
        y = self.a_2 * (x32 - x32.mean(-1, keepdim=True)) / (std + 1e-6) + self.b_2
        return y.to(x.dtype)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer (``transformer_v2.py:470-484``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(
        self, src: torch.Tensor, pos: Optional[torch.Tensor], rate: float = 0.0, gen=None
    ) -> torch.Tensor:
        q = src if pos is None else src + pos
        attn, _ = self.self_attn(q, q, src, rate, gen)
        src = self.norm1(src + dropout(attn, rate, gen))
        ff = self.linear2(dropout(torch.relu(self.linear1(src)), rate, gen))
        return self.norm2(src + dropout(ff, rate, gen))


class DecoderLayer(nn.Module):
    """Full post-norm decoder layer with self-attention (JAX
    ``transformer.py:164-204``, reference ``transformer_v2.py:707-734``):
    self-attn (q = k = tgt + query_pos, v = tgt) -> add&norm -> cross-attn
    (q = tgt + query_pos, k = memory + pos, v = memory) -> add&norm -> FFN
    -> add&norm.  Returns (tgt, cross-attention weights)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, memory, pos, query_pos, rate: float = 0.0, gen=None):
        q = tgt if query_pos is None else tgt + query_pos
        sa, _ = self.self_attn(q, q, tgt, rate, gen)
        tgt = self.norm1(tgt + dropout(sa, rate, gen))
        qc = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        ca, weights = self.multihead_attn(qc, k, memory, rate, gen)
        tgt = self.norm2(tgt + dropout(ca, rate, gen))
        ff = self.linear2(dropout(torch.relu(self.linear1(tgt)), rate, gen))
        return self.norm3(tgt + dropout(ff, rate, gen)), weights


class TPDecoderLayer(nn.Module):
    """``TransformerDecoderLayer_TP.forward_post`` (:806-833): cross-attn
    (q = tgt + query_pos, k = memory + pos, v = memory) -> add&norm -> FFN
    -> add&norm.  The reference's self-attention block is disabled."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt, memory, pos, query_pos, rate: float = 0.0, gen=None):
        q = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        attn, weights = self.multihead_attn(q, k, memory, rate, gen)
        tgt = self.norm2(tgt + dropout(attn, rate, gen))
        ff = self.linear2(dropout(torch.relu(self.linear1(tgt)), rate, gen))
        return self.norm3(tgt + dropout(ff, rate, gen)), weights
