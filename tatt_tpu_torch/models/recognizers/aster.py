"""ASTER recognizer, the judge of ``--test_model=ASTER``
(counterpart of ``tatt_tpu/models/recognizers/aster.py``).

The reference's ASTER (``model/recognizer/``):
an STN head on a 32x64 resize predicts 20 control points, a TPS warp
rectifies the input to 32x100, ``ResNet_ASTER`` (five stages of 1x1 -> 3x3
residual blocks, 3/4/6/6/3 deep) and a two-layer BiLSTM give [N, 25, 512]
features, and an attention-GRU decoder reads them: greedily for
``max_len`` steps, or by beam search (:meth:`AsterRecognizer.beam_tensors`
with the host-side :func:`beam_backtrack`).  Module names follow the
reference checkpoint (``stn_head.*``, ``encoder.layer<i>.<j>.*``,
``encoder.rnn``, ``decoder.decoder.{attention_unit,tgt_embedding,gru,fc}``),
so its ``state_dict`` loads as it is and the JAX package's
``import_aster`` reads the port's back.  The decode is a Python loop of
``max_len`` dependent steps, all of them run, as JAX's ``lax.scan`` runs
them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tatt_tpu_torch.kernels.resize import resize_bilinear
from tatt_tpu_torch.kernels.rnn import BiLSTM, GRUCellWeights
from tatt_tpu_torch.models.common import BatchNorm2d, Conv2d, Dense
from tatt_tpu_torch.models.stn import STNHead, tps_transform


def parse_aster_input(images: torch.Tensor) -> torch.Tensor:
    """``parse_aster_data`` (``interfaces/base.py:850-859``): RGB * 2 - 1."""
    return images[:, :3] * 2.0 - 1.0


class AsterBlock(nn.Module):
    """1x1 conv (strided) -> BN -> ReLU -> 3x3 conv -> BN, plus the
    (downsampled) input, then ReLU."""

    def __init__(self, inplanes: int, planes: int, stride=(1, 1), downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, (1, 1), (0, 0), bias=False, stride=stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, planes, (1, 1), (0, 0), bias=False, stride=stride),
                          BatchNorm2d(planes))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNetAster(nn.Module):
    """[N, 3, 32, 100] -> [N, 25, 512] sequence features (``resnet_aster.py:64-135``)."""

    def __init__(self, planes=(32, 64, 128, 256, 512), blocks=(3, 4, 6, 6, 3)):
        super().__init__()
        self.layer0 = nn.Sequential(Conv2d(3, planes[0], bias=False), BatchNorm2d(planes[0]))
        strides = ((2, 2), (2, 2), (2, 1), (2, 1), (2, 1))
        inplanes = planes[0]
        for li, (p, n, stride) in enumerate(zip(planes, blocks, strides), start=1):
            layer = []
            for bi in range(n):
                s = stride if bi == 0 else (1, 1)
                layer.append(AsterBlock(inplanes, p, s, bi == 0 and (s != (1, 1) or inplanes != p)))
                inplanes = p
            setattr(self, f"layer{li}", nn.Sequential(*layer))
        self.n_layers = len(planes)
        self.rnn = BiLSTM(planes[-1], 256, num_layers=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.layer0(x))
        for li in range(1, self.n_layers + 1):
            x = getattr(self, f"layer{li}")(x)
        return self.rnn(x[:, :, 0].transpose(1, 2))  # [N, C, 1, W] -> [N, W, C]


class _AttentionUnit(nn.Module):
    def __init__(self, s_dim: int, x_dim: int, att_dim: int):
        super().__init__()
        self.sEmbed = Dense(s_dim, att_dim)
        self.xEmbed = Dense(x_dim, att_dim)
        self.wEmbed = Dense(att_dim, 1)


class _Embedding(nn.Module):
    """``nn.Embedding`` weight, drawn from N(0, 1) as torch and flax do."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=gen)


class DecoderUnit(nn.Module):
    """Additive attention over the features, a GRU cell fed the previous
    symbol's embedding and the context, a linear head
    (``attention_recognition_head.py:190-260``)."""

    def __init__(self, num_classes: int, in_planes: int = 512, s_dim: int = 512, att_dim: int = 512):
        super().__init__()
        self.num_classes, self.s_dim = num_classes, s_dim
        self.attention_unit = _AttentionUnit(s_dim, in_planes, att_dim)
        self.tgt_embedding = _Embedding(num_classes + 1, att_dim)  # the last id is <BOS>
        self.gru = GRUCellWeights(in_planes + att_dim, s_dim, suffix="_l0")  # an nn.GRU
        self.fc = Dense(s_dim, num_classes)

    def step(self, x_proj, x, state, y_prev):
        """``x`` [B, T, C], ``x_proj`` its xEmbed [B, T, A], ``state`` [B, S],
        ``y_prev`` [B] ids -> (logits [B, classes], new state)."""
        att = self.attention_unit
        v = att.wEmbed(torch.tanh(att.sEmbed(state)[:, None] + x_proj))[..., 0]  # [B, T]
        context = torch.bmm(torch.softmax(v, dim=1)[:, None], x)[:, 0]
        state = self.gru.step(torch.cat([self.tgt_embedding.weight[y_prev], context], 1), state)
        return self.fc(state), state


class AttentionRecognitionHead(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.decoder = DecoderUnit(num_classes)

    def forward(self, x: torch.Tensor, max_len: int):
        """Greedy decode of ``max_len`` steps: (ids [B, T], scores [B, T],
        each step's softmax maximum)."""
        dec = self.decoder
        x_proj = dec.attention_unit.xEmbed(x)
        state = x.new_zeros(x.shape[0], dec.s_dim)
        y = torch.full((x.shape[0],), dec.num_classes, dtype=torch.long, device=x.device)
        preds, scores = [], []
        for _ in range(max_len):
            logits, state = dec.step(x_proj, x, state, y)
            scores.append(torch.softmax(logits, dim=1).amax(dim=1))
            y = logits.argmax(dim=1)
            preds.append(y)
        return torch.stack(preds, 1), torch.stack(scores, 1)

    def beam_tensors(self, x: torch.Tensor, beam_width: int, max_len: int):
        """Beam search forward pass (``attention_recognition_head.py:68-187``):
        per step the symbols, predecessors and sequence scores, each
        [max_len, B * K], for :func:`beam_backtrack` on the host."""
        dec = self.decoder
        b, k, nc = x.shape[0], beam_width, dec.num_classes
        x_inf = x.repeat_interleave(k, dim=0)  # AABBCC
        x_proj = dec.attention_unit.xEmbed(x_inf)
        state = x.new_zeros(b * k, dec.s_dim)
        y = torch.full((b * k,), nc, dtype=torch.long, device=x.device)
        seq = x.new_full((b, k), -math.inf)
        seq[:, 0] = 0.0
        seq = seq.reshape(b * k, 1)
        pos_index = (torch.arange(b, device=x.device) * k)[:, None]
        out = []
        for _ in range(max_len):
            logits, state = dec.step(x_proj, x_inf, state, y)
            scores, cands = (seq + torch.log_softmax(logits, dim=1)).reshape(b, k * nc).topk(k, dim=1)
            y = (cands % nc).reshape(b * k)
            seq = scores.reshape(b * k, 1)
            pred = (cands // nc + pos_index).reshape(b * k)
            state = state[pred]
            out.append((y, pred, seq[:, 0]))
        return tuple(torch.stack(t) for t in zip(*out))


class AsterRecognizer(nn.Module):
    """STN rectification, encoder and decoder; ``forward`` decodes greedily."""

    def __init__(self, num_classes: int, max_len: int = 100, stn_on: bool = True):
        super().__init__()
        self.max_len, self.stn_on = max_len, stn_on
        self.stn_head = STNHead(3, 20, variant="aster")
        self.encoder = ResNetAster()
        self.decoder = AttentionRecognitionHead(num_classes)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        x = images
        if self.stn_on:
            ctrl = self.stn_head(resize_bilinear(x, 32, 64, align_corners=True))
            x = tps_transform(x, ctrl, (32, 100))
        return self.encoder(x)

    def forward(self, images: torch.Tensor):
        """(ids [N, max_len], scores [N, max_len])."""
        return self.decoder(self.encode(images), self.max_len)

    def beam_tensors(self, images: torch.Tensor, beam_width: int = 5):
        return self.decoder.beam_tensors(self.encode(images), beam_width, self.max_len)


def beam_backtrack(symbols, predecessors, scores, batch_size: int, beam_width: int,
                   eos: int) -> np.ndarray:
    """The best sequence [B, T] from :meth:`AttentionRecognitionHead.beam_tensors`'
    outputs (numpy), followed back from the best final score (``aster.py:243-270``;
    decoding stops at EOS downstream)."""
    t_max, k = symbols.shape[0], beam_width
    out = np.zeros((batch_size, t_max), dtype=np.int64)
    ptr = np.argmax(scores[-1].reshape(batch_size, k), axis=1) + np.arange(batch_size) * k
    for t in range(t_max - 1, -1, -1):
        out[:, t] = symbols[t][ptr]
        ptr = predecessors[t][ptr]
    return out
