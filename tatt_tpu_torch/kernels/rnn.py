"""Bidirectional GRU / LSTM layers (counterpart of ``tatt_tpu/kernels/rnn.py``).

Parameters keep torch's ``nn.GRU``/``nn.LSTM`` names and layout
(``weight_ih_l0`` [G, In], ``..._reverse`` for direction 1; gate order
r, z, n for the GRU and i, f, g, o for the LSTM), so reference checkpoints
load as they are.  The input projection of all timesteps is one matmul;
the recurrence goes to the hand-written kernels (:mod:`.gru`, :mod:`.lstm`)
for every BiGRU with hidden <= 128 and every BiLSTM with hidden <= 256, at
any row count (the JAX row thresholds are TPU padding concerns).  When a
gradient is wanted, the recurrence runs through the kernels'
``autograd.Function`` (forward and backward kernels), and the projection
stays ordinary differentiable torch ops outside it, as the JAX VJP keeps
its projection GEMMs (``pallas_gru.py:360-375``).  Wider recurrences — the
TP-Interpreter's query GRU, hidden 512 — run :func:`bigru_apply`, a plain
loop under autograd, as JAX keeps it on ``lax.scan`` (``rnn.py:211-218``).
:func:`gru_cell` is one plain GRU step, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tatt_tpu_torch.kernels import gru as gru_kernel
from tatt_tpu_torch.kernels import lstm as lstm_kernel


def _stack_bidir(x: torch.Tensor) -> torch.Tensor:
    """[R, L, C] -> [2, R, L, C] with the second copy time-reversed."""
    return torch.stack([x, x.flip(1)])


def _unstack_bidir(y: torch.Tensor) -> torch.Tensor:
    """[2, R, L, H] -> [R, L, 2H]: forward cat reversed-back backward."""
    return torch.cat([y[0], y[1].flip(1)], dim=-1)


def bigru_apply(x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """Plain bidirectional GRU, both directions batched per step.

    ``x`` [R, L, In]; ``w_ih`` [2, 3H, In], ``w_hh`` [2, 3H, H], biases
    [2, 3H].  Returns [R, L, 2H]."""
    rows, length, _ = x.shape
    hid = w_hh.shape[-1]
    gx = torch.einsum("drli,dgi->drlg", _stack_bidir(x), w_ih) + b_ih[:, None, None]
    w_t = w_hh.transpose(1, 2)
    h = x.new_zeros(2, rows, hid)
    ys = []
    for t in range(length):
        gh = torch.baddbmm(b_hh[:, None], h, w_t)
        g = gx[:, :, t]
        r = torch.sigmoid(g[..., :hid] + gh[..., :hid])
        z = torch.sigmoid(g[..., hid : 2 * hid] + gh[..., hid : 2 * hid])
        n = torch.tanh(g[..., 2 * hid :] + r * gh[..., 2 * hid :])
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return _unstack_bidir(torch.stack(ys, dim=2))


def bilstm_apply(x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """Plain bidirectional LSTM; conventions of :func:`bigru_apply` with 4H
    gate rows in torch order (i, f, g, o)."""
    rows, length, _ = x.shape
    hid = w_hh.shape[-1]
    gx = torch.einsum("drli,dgi->drlg", _stack_bidir(x), w_ih) + b_ih[:, None, None]
    w_t = w_hh.transpose(1, 2)
    h = x.new_zeros(2, rows, hid)
    c = x.new_zeros(2, rows, hid)
    ys = []
    for t in range(length):
        a = gx[:, :, t] + torch.baddbmm(b_hh[:, None], h, w_t)
        i = torch.sigmoid(a[..., :hid])
        f = torch.sigmoid(a[..., hid : 2 * hid])
        g = torch.tanh(a[..., 2 * hid : 3 * hid])
        o = torch.sigmoid(a[..., 3 * hid :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return _unstack_bidir(torch.stack(ys, dim=2))


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def compose_input_projection(w_ih, b_ih, pre_kernel=None, pre_bias=None):
    """Fold a preceding linear map ``y = x @ P^T + pb`` (a 1x1 conv with OI
    matrix ``P`` [Cmid, Cin]) into the input projections
    (``pallas_gru.py:47``): ``(x P^T + pb) W^T = x (W P)^T + W pb``.
    Returns ``(w [2, G, Cin], b [2, G])``."""
    if pre_kernel is None:
        return w_ih, b_ih
    w_eff = torch.einsum("dgm,mi->dgi", w_ih, pre_kernel)
    b_eff = b_ih
    if pre_bias is not None:
        b_eff = b_eff + torch.einsum("dgm,m->dg", w_ih, pre_bias)
    return w_eff, b_eff


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
    """One torch-semantics GRU step (``rnn.py:133-151``): ``x`` [B, In],
    ``h`` [B, H], ``w_ih`` [3H, In], ``w_hh`` [3H, H].  The attention
    decoders of ASTER and MORAN take one such step per decoded symbol."""
    hid = h.shape[-1]
    gx = torch.addmm(b_ih, x, w_ih.T)
    gh = torch.addmm(b_hh, h, w_hh.T)
    r = torch.sigmoid(gx[:, :hid] + gh[:, :hid])
    z = torch.sigmoid(gx[:, hid : 2 * hid] + gh[:, hid : 2 * hid])
    n = torch.tanh(gx[:, 2 * hid :] + r * gh[:, 2 * hid :])
    return (1.0 - z) * n + z * h


class GRUCellWeights(nn.Module):
    """The parameters of a one-direction, one-layer GRU under torch's
    names plus ``suffix`` (``nn.GRUCell``: none; ``nn.GRU``: ``_l0``), and
    one :func:`gru_cell` step over them."""

    def __init__(self, in_features: int, hidden: int, suffix: str = ""):
        super().__init__()
        self.hidden, self.suffix = hidden, suffix
        for name, shape in (("weight_ih", (3 * hidden, in_features)), ("weight_hh", (3 * hidden, hidden)),
                            ("bias_ih", (3 * hidden,)), ("bias_hh", (3 * hidden,))):
            self.register_parameter(name + suffix, nn.Parameter(torch.empty(shape)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters(recurse=False):
            p.uniform_(-bound, bound, generator=gen)

    def step(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return gru_cell(x, h, *(getattr(self, n + self.suffix)
                                for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))


class _BiRNN(nn.Module):
    """Parameters of a bidirectional torch RNN of ``num_layers`` layers with
    ``gates`` gate blocks, under torch's names (layer k > 0 reads the 2H
    outputs of layer k - 1)."""

    gates = 0

    def __init__(self, in_features: int, hidden: int, num_layers: int = 1):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        g = self.gates * hidden
        for layer in range(num_layers):
            n_in = in_features if layer == 0 else 2 * hidden
            for sfx in (f"l{layer}", f"l{layer}_reverse"):
                self.register_parameter(f"weight_ih_{sfx}", nn.Parameter(torch.empty(g, n_in)))
                self.register_parameter(f"weight_hh_{sfx}", nn.Parameter(torch.empty(g, hidden)))
                self.register_parameter(f"bias_ih_{sfx}", nn.Parameter(torch.empty(g)))
                self.register_parameter(f"bias_hh_{sfx}", nn.Parameter(torch.empty(g)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters(recurse=False):
            p.uniform_(-bound, bound, generator=gen)

    def stacked(self, layer: int = 0):
        """Layer ``layer``'s ``(w_ih [2, G, In], w_hh [2, G, H], b_ih [2, G],
        b_hh [2, G])``."""
        return tuple(
            torch.stack([getattr(self, f"{n}_l{layer}"), getattr(self, f"{n}_l{layer}_reverse")])
            for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
        )


class BiGRU(_BiRNN):
    """``nn.GRU(in, hidden, bidirectional=True)`` output[0] on [R, L, In].

    ``pre_kernel`` / ``pre_bias`` fold a preceding 1x1 conv into the input
    projection (GruBlock's ``conv1``); ``weight_ih`` keeps its checkpoint
    shape [3H, Cmid]."""

    gates = 3

    def forward(
        self,
        x: torch.Tensor,
        pre_kernel: Optional[torch.Tensor] = None,
        pre_bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        w_ih, w_hh, b_ih, b_hh = self.stacked()
        w_eff, b_eff = compose_input_projection(w_ih, b_ih, pre_kernel, pre_bias)
        if self.hidden > gru_kernel.MAX_HIDDEN:
            return bigru_apply(x, w_eff, w_hh, b_eff, b_hh)
        # one matmul for all timesteps of both directions, emitted in the
        # kernel's [2, L, 3H, R] layout (rows minor)
        xw = torch.einsum("rli,dgi->dlgr", x, w_eff)
        if _wants_grad(xw, b_eff, w_hh, b_hh):
            y = gru_kernel.BiGRURecurrence.apply(xw, b_eff, w_hh, b_hh)
        else:
            gates = (xw + b_eff[:, None, :, None]).contiguous()
            y = gru_kernel.bigru_recurrence(gates, w_hh, b_hh)
        return y.permute(2, 0, 1)  # [L, 2H, R] -> [R, L, 2H]


class BiLSTM(_BiRNN):
    """``nn.LSTM(in, hidden, num_layers, bidirectional=True)`` output[0] on
    [R, L, In]; each layer's recurrence is one kernel launch."""

    gates = 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = self._layer(x, *self.stacked(layer))
        return x

    def _layer(self, x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
        if self.hidden > lstm_kernel.MAX_HIDDEN:
            return bilstm_apply(x, w_ih, w_hh, b_ih, b_hh)
        # one matmul for all timesteps of both directions, emitted in the
        # kernel's [2, R, L, 4H] layout (gates minor)
        gates = torch.matmul(x, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None]
        if _wants_grad(gates, w_hh, b_hh):
            return lstm_kernel.BiLSTMRecurrence.apply(gates, w_hh, b_hh)
        return lstm_kernel.bilstm_recurrence(gates, w_hh, b_hh)
