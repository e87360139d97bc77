"""Bidirectional GRU / LSTM layers (counterpart of ``tatt_tpu/kernels/rnn.py``).

Parameters keep torch's ``nn.GRU``/``nn.LSTM`` names and layout
(``weight_ih_l0`` [G, In], ``..._reverse`` for direction 1; gate order
r, z, n for the GRU and i, f, g, o for the LSTM), so reference checkpoints
load as they are.  The input projection of all timesteps is one matmul;
the recurrence goes to the hand-written kernels (:mod:`.gru`, :mod:`.lstm`)
for every BiGRU with hidden <= 128 and every BiLSTM with hidden <= 256, at
any row count (the JAX row thresholds are TPU padding concerns).  A BiLSTM
hidden size that the LSTM kernels' launch plans refuse on the card (99 of
113..255, :func:`.lstm.served_hidden`) runs them at the next size they
serve, its weights zero-padded: the padded units stay exactly 0 and feed
nothing back, so outputs and gradients are those of the true size
(``BiLSTM.padded_layers`` counts these layers).  When a
gradient is wanted, the recurrence runs through the kernels'
``autograd.Function`` (forward and backward kernels), and the projection
stays ordinary differentiable torch ops outside it, as the JAX VJP keeps
its projection GEMMs (``pallas_gru.py:360-375``).  Wider BiGRUs — the
TP-Interpreter's query GRU, hidden 512 over one row — run the chains of
:mod:`.query_gru` on the card where their plan serves the float32 row
(JAX keeps this GRU on ``lax.scan``, ``rnn.py:211-218``), and
:func:`bigru_apply`, a plain loop under autograd, everywhere else: on the
CPU, in bf16, over several rows, at a hidden size the plan refuses.
:func:`gru_cell` is one plain GRU step, as in JAX.

Every layer follows its input's dtype, as JAX's do under ``--dtype
bfloat16``: the float32 parameters are cast to it, the projection runs in
it, and a bf16 input reaches the kernels' bf16 instantiations (f32 carries
inside); the plain loops carry h in the input's dtype, as ``lax.scan``
does (``rnn.py:85, 128``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from tatt_tpu_torch.kernels import gru as gru_kernel
from tatt_tpu_torch.kernels import lstm as lstm_kernel
from tatt_tpu_torch.kernels import query_gru


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
    w_ih, w_hh, b_ih, b_hh = (t.to(x.dtype) for t in (w_ih, w_hh, b_ih, b_hh))
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
    w_ih, w_hh, b_ih, b_hh = (t.to(x.dtype) for t in (w_ih, w_hh, b_ih, b_hh))
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
    w_ih, w_hh, b_ih, b_hh = (t.to(x.dtype) for t in (w_ih, w_hh, b_ih, b_hh))
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
        if self.hidden <= gru_kernel.MAX_HIDDEN:
            function, recurrence = gru_kernel.BiGRURecurrence, gru_kernel.bigru_recurrence
        elif query_gru.serves(x, self.hidden):
            function, recurrence = query_gru.QueryGRURecurrence, query_gru.query_gru_recurrence
        else:
            return bigru_apply(x, w_eff, w_hh, b_eff, b_hh)
        # one matmul for all timesteps of both directions, emitted in the
        # kernel's [2, L, 3H, R] layout (rows minor), in x's dtype; the
        # recurrence casts the biases and W_hh to it
        xw = torch.einsum("rli,dgi->dlgr", x, w_eff.to(x.dtype))
        if _wants_grad(xw, b_eff, w_hh, b_hh):
            y = function.apply(xw, b_eff, w_hh, b_hh)
        else:
            dt = x.dtype
            gates = (xw + b_eff.to(dt)[:, None, :, None]).contiguous()
            y = recurrence(gates, w_hh.to(dt), b_hh.to(dt))
        return y.permute(2, 0, 1)  # [L, 2H, R] -> [R, L, 2H]


class BiLSTM(_BiRNN):
    """``nn.LSTM(in, hidden, num_layers, bidirectional=True)`` output[0] on
    [R, L, In]; each layer's recurrence is one kernel launch."""

    gates = 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = self._layer(x, *self.stacked(layer))
        return x

    # layers run at a wider hidden size that the kernels serve on the card
    padded_layers = 0

    def _layer(self, x, w_ih, w_hh, b_ih, b_hh) -> torch.Tensor:
        hid = self.hidden
        if hid > lstm_kernel.MAX_HIDDEN:
            return bilstm_apply(x, w_ih, w_hh, b_ih, b_hh)
        wide = lstm_kernel.served_hidden(hid, x.device)
        if wide != hid:
            BiLSTM.padded_layers += 1
            w_ih, w_hh, b_ih, b_hh = _pad_lstm_hidden(wide, w_ih, w_hh, b_ih, b_hh)
        # every weight in x's dtype (``bilstm_pallas``, ``pallas_lstm.py:205-210``)
        w_ih, w_hh, b_ih, b_hh = (t.to(x.dtype) for t in (w_ih, w_hh, b_ih, b_hh))
        # one matmul for all timesteps of both directions, emitted in the
        # kernel's [2, R, L, 4H] layout (gates minor)
        gates = torch.matmul(x, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None]
        if _wants_grad(gates, w_hh, b_hh):
            y = lstm_kernel.BiLSTMRecurrence.apply(gates, w_hh, b_hh)
        else:
            y = lstm_kernel.bilstm_recurrence(gates, w_hh, b_hh)
        if wide != hid:
            y = torch.cat([y[..., :hid], y[..., wide : wide + hid]], dim=-1)
        return y


def _pad_lstm_hidden(wide: int, w_ih, w_hh, b_ih, b_hh):
    """A BiLSTM layer's stacked weights (``BiLSTM.stacked``) at hidden size
    ``wide``: each gate block's rows, and W_hh's columns, padded with
    zeros.  A padded unit's gates are sigmoid(0), sigmoid(0), tanh(0),
    sigmoid(0), so its cell stays 0.5 * 0 + 0.5 * 0 = 0 and its output 0;
    its zero W_hh column adds nothing to the true units, and no gradient
    reaches it, so the true units' outputs and gradients are unchanged."""
    hid = w_hh.shape[-1]
    extra = wide - hid

    def rows(t, *pad):  # [2, 4H, ...] -> [2, 4, H, ...] padded -> [2, 4W, ...]
        t = F.pad(t.reshape(2, 4, hid, *t.shape[2:]), (*pad, 0, extra))
        return t.reshape(2, 4 * wide, *t.shape[3:])

    return rows(w_ih, 0, 0), rows(w_hh, 0, extra), rows(b_ih), rows(b_hh)
