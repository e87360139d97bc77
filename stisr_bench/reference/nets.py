"""The reference's layers that more than one arch uses: convolutions,
BatchNorm, the BiGRU and BiLSTM loops, the STN head, the TP Interpreter,
the trunk of SRBs (``_Trunk``) and the CRNN that is the text prior and
the judge.  Each arch's generator, loss and SR are in ``archs/<arch>.py``
(:func:`build`).

Layouts and names are those of the published PyTorch code
(``model/tsrn.py``, ``model/stn_head.py``, ``model/transformer_v2.py``,
``model/crnn/crnn.py``): NCHW, OIHW convolution weights, torch's GRU /
LSTM parameter names.  Departures, each shared with the measured port:
BatchNorm in training mode may normalise ``copies`` equal parts of a
batch by their own statistics (TATT's rotated and counter-rotated copies
run as one batch of 2B); the TP Interpreter's query GRU scans the query
table along its width, shared by the batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import archs, ops


class Conv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k=(3, 3), pad=(1, 1)):
        super().__init__()
        self.pad = pad
        self.weight = nn.Parameter(torch.zeros(cout, cin, *k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, 1, self.pad)


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but 1, eps 1e-5, momentum 0.1; in
    training the biased batch statistics of each of ``copies`` equal
    parts, the running averages folded part by part with the unbiased
    variance."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, copies: int = 1):
        shape = (-1,) + (1,) * (x.dim() - 2)
        red = (0, *range(2, x.dim()))
        if not self.training:
            inv = torch.rsqrt(self.running_var + 1e-5) * self.weight
            return (x - self.running_mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        ys = []
        for part in x.chunk(copies):
            mean = part.mean(red)
            var = (part - mean.view(shape)).square().mean(red)
            n = part.numel() // part.shape[1]
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var * (n / max(n - 1, 1)))
            inv = torch.rsqrt(var + 1e-5) * self.weight
            ys.append((part - mean.view(shape)) * inv.view(shape) + self.bias.view(shape))
        return torch.cat(ys)


class _BiRNN(nn.Module):
    gates = 0

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        g = self.gates * hidden
        for sfx in ("l0", "l0_reverse"):
            setattr(self, f"weight_ih_{sfx}", nn.Parameter(torch.zeros(g, n_in)))
            setattr(self, f"weight_hh_{sfx}", nn.Parameter(torch.zeros(g, hidden)))
            setattr(self, f"bias_ih_{sfx}", nn.Parameter(torch.zeros(g)))
            setattr(self, f"bias_hh_{sfx}", nn.Parameter(torch.zeros(g)))

    def stacked(self):
        return tuple(torch.stack([getattr(self, f"{n}_l0"), getattr(self, f"{n}_l0_reverse")])
                     for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


class BiGRU(_BiRNN):
    """``nn.GRU(bidirectional=True)``'s output on [R, L, In]; a 1x1 conv
    before it (``pre``: weight [Cmid, Cin], bias) is folded into the input
    weights, the same linear map."""

    gates = 3

    def forward(self, x, pre_w=None, pre_b=None):
        w_ih, w_hh, b_ih, b_hh = self.stacked()
        if pre_w is not None:
            b_ih = b_ih + torch.einsum("dgm,m->dg", w_ih, pre_b)
            w_ih = torch.einsum("dgm,mi->dgi", w_ih, pre_w)
        return ops.bigru(x, w_ih, w_hh, b_ih, b_hh)


class BiLSTM(_BiRNN):
    gates = 4

    def forward(self, x):
        return ops.bilstm(x, *self.stacked())


# --- STN head ---------------------------------------------------------------

class _ConvBN(nn.Module):
    def __init__(self, layer, bn):
        super().__init__()
        self.add_module("0", layer)
        self.add_module("1", bn)

    def forward(self, x, copies):
        return torch.relu(getattr(self, "1")(getattr(self, "0")(x), copies))


class _Pool(nn.Module):
    def __init__(self, window):
        super().__init__()
        self.window = window

    def forward(self, x, copies):
        return F.max_pool2d(x, self.window, self.window)


class _FC2(nn.Module):
    def __init__(self, n_in: int, num_ctrl: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(2 * num_ctrl, n_in))
        self.bias = nn.Parameter(torch.zeros(2 * num_ctrl))


def stn_pooled(size: tuple[int, int]) -> tuple[int, int]:
    h, w = size
    for ph, pw in ((2, 2), (2, 2), (2, 2), (2, 2), (1, 2)):
        h, w = (h - ph) // ph + 1, (w - pw) // pw + 1
    return h, w


class STNHead(nn.Module):
    """``model/stn_head.py``: six conv-BN-ReLU blocks pooled to the LR
    crop over 16 x 32, fc1 + BN1d + ReLU, fc2 to 20 control points."""

    def __init__(self, cin: int, lr_size: tuple[int, int], num_ctrl: int = 20):
        super().__init__()
        layers = []
        for c, pool in zip((32, 64, 128, 256, 256, 256),
                           ((2, 2), (2, 2), (2, 2), (2, 2), (1, 2), None)):
            layers.append(_ConvBN(Conv2d(cin, c), BatchNorm(c)))
            if pool is not None:
                layers.append(_Pool(pool))
            cin = c
        h, w = stn_pooled(lr_size)
        self.num_ctrl = num_ctrl
        self.stn_convnet = nn.ModuleList(layers)
        self.stn_fc1 = _ConvBN(Dense(256 * h * w, 512), BatchNorm(512))
        self.stn_fc2 = _FC2(512, num_ctrl)

    def forward(self, x, copies: int = 1):
        for layer in self.stn_convnet:
            x = layer(x, copies)
        x = self.stn_fc1(x.flatten(1), copies)
        pts = F.linear(0.1 * x, self.stn_fc2.weight, self.stn_fc2.bias)
        return pts.reshape(x.shape[0], self.num_ctrl, 2)


# --- the TP Interpreter -----------------------------------------------------

class MultiheadAttention(nn.Module):
    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.d, self.nhead = d, nhead
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Dense(d, d)

    def forward(self, q, k, v, rate: float = 0.0, gen=None):
        wq, wk, wv = self.in_proj_weight.split(self.d)
        bq, bk, bv = self.in_proj_bias.split(self.d)
        q, k, v = F.linear(q, wq, bq), F.linear(k, wk, bk), F.linear(v, wv, bv)
        b, lq, c = q.shape
        lk, hd = k.shape[1], c // self.nhead
        q = q.reshape(b, lq, self.nhead, hd).transpose(1, 2)
        k = k.reshape(b, lk, self.nhead, hd).transpose(1, 2)
        v = v.reshape(b, lk, self.nhead, hd).transpose(1, 2)
        w = ops.dropout(torch.softmax(torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2)), -1),
                        rate, gen)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, lq, c)
        return self.out_proj(out), w.mean(dim=1)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class EncoderLayer(nn.Module):
    """Post-norm self-attention layer, positions added to q and k."""

    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d, nhead)
        self.linear1, self.linear2 = Dense(d, d), Dense(d, d)
        self.norm1, self.norm2 = LayerNorm(d), LayerNorm(d)

    def forward(self, src, pos, rate, gen):
        q = src + pos
        attn, _ = self.self_attn(q, q, src, rate, gen)
        src = self.norm1(src + ops.dropout(attn, rate, gen))
        ff = self.linear2(ops.dropout(torch.relu(self.linear1(src)), rate, gen))
        return self.norm2(src + ops.dropout(ff, rate, gen))


class TPDecoderLayer(nn.Module):
    """``TransformerDecoderLayer_TP.forward_post``: cross-attention of the
    image features (plus the query positions) on the text tokens (plus
    theirs), then the FFN, each post-norm."""

    def __init__(self, d: int, nhead: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d, nhead)
        self.linear1, self.linear2 = Dense(d, d), Dense(d, d)
        self.norm2, self.norm3 = LayerNorm(d), LayerNorm(d)

    def forward(self, tgt, memory, pos, query_pos, rate, gen):
        attn, w = self.multihead_attn(tgt + query_pos, memory + pos, memory, rate, gen)
        tgt = self.norm2(tgt + ops.dropout(attn, rate, gen))
        ff = self.linear2(ops.dropout(torch.relu(self.linear1(tgt)), rate, gen))
        return self.norm3(tgt + ops.dropout(ff, rate, gen)), w


class _Stack(nn.Module):
    def __init__(self, layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class _InfoTransformer(nn.Module):
    def __init__(self, d: int, nhead: int, rows: int):
        super().__init__()
        self.encoder = _Stack([EncoderLayer(d, nhead)])
        self.decoder = _Stack([TPDecoderLayer(d, nhead) for _ in range(2)], LayerNorm(d))
        self.gru_encoding = BiGRU(rows * d, rows * d // 2)


class _Table(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, d))


class TPInterpreter(nn.Module):
    """The text prior [N, C, 1, T] as T tokens (fc_in + PReLU), one
    encoder layer, the learned query table smoothed by a BiGRU along its
    width as query positions, two decoder layers over the image
    features; the mean of their normed outputs is the prior map."""

    def __init__(self, text_emb: int, d: int, size: tuple[int, int], nhead: int = 4):
        super().__init__()
        self.d, self.size = d, size
        self.fc_in = Dense(text_emb, d)
        self.activation = PReLU()
        self.init_factor = _Table(size[0] * size[1], d)
        self.transformer = _InfoTransformer(d, nhead, size[0])

    def forward(self, feat, prior, rate: float = 0.0, gen=None):
        n, c, h, w = feat.shape
        fh, fw = self.size
        x = self.activation(self.fc_in(prior[:, :, 0, :].transpose(1, 2)))
        pos = torch.as_tensor(ops.sinusoid_table(x.shape[1], self.d), device=x.device)[None]
        pos = ops.dropout(pos, rate, gen)
        memory = x
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, pos, rate, gen)
        cols = self.init_factor.weight.reshape(fh, fw, self.d).permute(1, 0, 2).reshape(1, fw, fh * self.d)
        cols = self.transformer.gru_encoding(cols)
        query_pos = cols.reshape(fw, fh, self.d).permute(1, 0, 2).reshape(1, fh * fw, self.d)
        query_pos = query_pos.expand(n, fh * fw, self.d)
        out = feat.reshape(n, c, h * w).transpose(1, 2)
        total, weights = 0.0, None
        for layer in self.transformer.decoder.layers:
            out, weights = layer(out, memory, pos, query_pos, rate, gen)
            total = total + self.transformer.decoder.norm(out)
        prior_map = total / len(self.transformer.decoder.layers)
        return prior_map.transpose(1, 2).reshape(n, self.d, h, w), weights


# --- the trunk ----------------------------------------------------------------

class GruBlock(nn.Module):
    """A 1x1 conv then a BiGRU along W over the N*H rows."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cout = cout
        self.conv1 = Conv2d(cin, cout, (1, 1), (0, 0))
        self.gru = BiGRU(cout, cout // 2)

    def forward(self, x):
        n, c, h, w = x.shape
        seq = x.permute(0, 2, 3, 1).reshape(n * h, w, c)
        seq = self.gru(seq, self.conv1.weight[:, :, 0, 0], self.conv1.bias)
        return seq.reshape(n, h, w, self.cout).permute(0, 3, 1, 2)


class SRB(nn.Module):
    """The sequential residual block; with ``text`` channels the prior
    map joins the residual before the height GRU."""

    def __init__(self, ch: int, text: int = 0):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(ch, ch), BatchNorm(ch)
        self.conv2, self.bn2 = Conv2d(ch, ch), BatchNorm(ch)
        self.gru1 = GruBlock(ch + text, ch)
        self.gru2 = GruBlock(ch, ch)

    def forward(self, x, prior=None, copies: int = 1):
        r = ops.mish(self.bn1(self.conv1(x), copies))
        r = self.bn2(self.conv2(r), copies)
        if prior is not None:
            r = torch.cat([r, prior], dim=1)
        r = self.gru1(r.transpose(2, 3)).transpose(2, 3)
        return self.gru2(x + r)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch * 4)

    def forward(self, x):
        return ops.mish(ops.pixel_shuffle(self.conv(x), 2))


class _Seq(nn.Module):
    """Children named ``0``, ``1``, ... called in turn."""

    def __init__(self, *mods):
        super().__init__()
        for i, m in enumerate(mods):
            self.add_module(str(i), m)

    def __getitem__(self, i):
        return getattr(self, str(i))

    def __len__(self):
        return len(self._modules)


class _Trunk(nn.Module):
    def _build(self, cin: int, ch: int, srb: int, stn: bool, text: int, scale: int,
               lr_size: tuple[int, int]):
        self.srb, self.lr_size = srb, lr_size
        if stn:
            self.stn_head = STNHead(cin, lr_size)
        self.block1 = _Seq(Conv2d(cin, ch, (9, 9), (4, 4)), PReLU())
        for i in range(srb):
            setattr(self, f"block{i + 2}", SRB(ch, text))
        setattr(self, f"block{srb + 2}", _Seq(Conv2d(ch, ch), BatchNorm(ch)))
        ups = [Upsample(ch) for _ in range(int(math.log2(scale)))]
        setattr(self, f"block{srb + 3}", _Seq(*ups, Conv2d(ch, cin, (9, 9), (4, 4))))

    def rectify(self, x, copies: int = 1):
        if self.training and hasattr(self, "stn_head"):
            return ops.tps_warp(x, self.stn_head(x, copies), self.lr_size)
        return x

    def stem(self, x):
        conv, act = self.block1[0], self.block1[1]
        return act(conv(x))

    def trunk(self, b1, prior=None, copies: int = 1):
        h = b1
        for i in range(self.srb):
            h = getattr(self, f"block{i + 2}")(h, prior, copies)
        post = getattr(self, f"block{self.srb + 2}")
        h = post[1](post[0](h), copies)
        tail = getattr(self, f"block{self.srb + 3}")
        x = b1 + h
        for i in range(len(tail)):
            x = tail[i](x)
        return torch.tanh(x)


# --- the CRNN -----------------------------------------------------------------

class _CNN(nn.Module):
    def __init__(self, nm):
        super().__init__()
        ins = (1,) + tuple(nm[:-1])
        for i in range(7):
            k, p = ((2, 2), (0, 0)) if i == 6 else ((3, 3), (1, 1))
            setattr(self, f"conv{i}", Conv2d(ins[i], nm[i], k, p))
        for i in (2, 4, 6):
            setattr(self, f"batchnorm{i}", BatchNorm(nm[i]))

    def forward(self, x):
        relu, pool = torch.relu, F.max_pool2d
        x = pool(relu(self.conv0(x)), (2, 2), (2, 2))
        x = pool(relu(self.conv1(x)), (2, 2), (2, 2))
        x = relu(self.batchnorm2(self.conv2(x)))
        x = pool(relu(self.conv3(x)), (2, 2), (2, 1), (0, 1))
        x = relu(self.batchnorm4(self.conv4(x)))
        x = pool(relu(self.conv5(x)), (2, 2), (2, 1), (0, 1))
        return relu(self.batchnorm6(self.conv6(x)))


class _BiLSTMHead(nn.Module):
    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.rnn = BiLSTM(n_in, hidden)
        self.embedding = Dense(2 * hidden, n_out)

    def forward(self, x):
        return self.embedding(self.rnn(x))


class CRNN(nn.Module):
    """32 x 100 luma -> [T=26, B, nclass] CTC logits."""

    def __init__(self, nclass: int = 37, nh: int = 256, nm=(64, 128, 256, 256, 512, 512, 512)):
        super().__init__()
        nm = tuple(nm)
        self.cnn = _CNN(nm)
        self.rnn = nn.ModuleList([_BiLSTMHead(nm[6], nh, nh), _BiLSTMHead(nh, nh, nclass)])

    def forward(self, x):
        seq = self.cnn(x)[:, :, 0].transpose(1, 2)
        for layer in self.rnn:
            seq = layer(seq)
        return seq.transpose(0, 1)


def trunk_args(config: dict) -> dict:
    """The keyword arguments of a ``_Trunk`` generator from a
    configuration file: geometry, SRBs, hidden units, ``--STN`` and
    ``--mask``."""
    g, flags = config["geometry"], config["flags"]
    return dict(width=g["width"], height=g["height"], scale=g["down_sample_scale"],
                srb=config["srb"], hidden=config["hd_u"], stn="--STN" in flags,
                mask="--mask" in flags)


def build(config: dict) -> dict:
    """The reference's models of a configuration file, as its arch's file
    (``archs/<arch>.py``) builds them: the ``generator``, the ``student``
    and the frozen ``teacher``, which is also the judge."""
    return archs.load(config["arch"]).build(config)


def control_points(num_ctrl: int = 20) -> np.ndarray:
    """fc2's bias at its start: the border grid at margin 0.01."""
    return ops.border_points(num_ctrl, 0.01).astype(np.float32).reshape(-1)
