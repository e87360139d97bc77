"""Gradients of the port's recurrences against the JAX package's kernels.

On the CPU the port's ``BiGRU`` / ``BiLSTM`` run their
``autograd.Function``s, whose backward is the plain twin of the backward
kernel (``bigru_recurrence_bwd_ref`` / ``bilstm_recurrence_bwd_ref``), not
autograd through the plain forward.  JAX differentiates ``bigru_pallas`` /
``bilstm_pallas`` through their custom VJPs, the Pallas backward kernels
run in interpret mode (as ``tests/test_pallas_gru.py`` does).  Same numpy
inputs from a seed.  Tolerance atol 1e-5 / rtol 1e-4: both sides are f32
with the same per-step arithmetic and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tatt_tpu.kernels.pallas_gru import bigru_pallas
from tatt_tpu.kernels.pallas_lstm import bilstm_pallas
from tatt_tpu_torch.kernels import gru as tgru
from tatt_tpu_torch.kernels import lstm as tlstm
from tatt_tpu_torch.kernels import rnn as trnn

TOL = dict(atol=1e-5, rtol=1e-4)


def _params(rng, in_f, hidden, gates):
    g = gates * hidden
    return [
        rng.standard_normal(s).astype(np.float32) * sc
        for s, sc in (((2, g, in_f), 0.3), ((2, g, hidden), 0.3), ((2, g), 0.1), ((2, g), 0.1))
    ]


def _module(cls, in_f, hidden, w_ih, w_hh, b_ih, b_hh):
    module = cls(in_f, hidden)
    sd = {}
    for name, v in (("weight_ih", w_ih), ("weight_hh", w_hh), ("bias_ih", b_ih), ("bias_hh", b_hh)):
        sd[f"{name}_l0"] = torch.from_numpy(v[0])
        sd[f"{name}_l0_reverse"] = torch.from_numpy(v[1])
    module.load_state_dict(sd)
    return module


def _stacked_grads(module):
    return [
        np.stack([getattr(module, f"{n}_l0").grad.numpy(), getattr(module, f"{n}_l0_reverse").grad.numpy()])
        for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    ]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("length", [1, 7])
def test_bigru_grads_match_pallas_vjp(fold, length):
    rng = np.random.default_rng(200 + length + 10 * fold)
    rows, in_f, mid, hidden = 6, 5, 9, 8
    x = rng.standard_normal((rows, length, in_f)).astype(np.float32)
    pre_k = rng.standard_normal((mid, in_f)).astype(np.float32) * 0.3 if fold else None
    pre_b = rng.standard_normal((mid,)).astype(np.float32) * 0.1 if fold else None
    params = _params(rng, mid if fold else in_f, hidden, 3)
    weight = rng.standard_normal((rows, length, 2 * hidden)).astype(np.float32)

    def loss_j(x_, w_ih, w_hh, b_ih, b_hh, pk, pb):
        kw = dict(pre_kernel=pk, pre_bias=pb) if fold else {}
        y = bigru_pallas(x_, w_ih, w_hh, b_ih, b_hh, interpret=True, **kw)
        return (y * weight).sum()

    jargs = [jnp.asarray(a) for a in (x, *params)]
    jargs += [jnp.asarray(pre_k), jnp.asarray(pre_b)] if fold else [None, None]
    argnums = (0, 1, 2, 3, 4, 5, 6) if fold else (0, 1, 2, 3, 4)
    want = [np.asarray(g) for g in jax.grad(loss_j, argnums=argnums)(*jargs)]

    gru = _module(trnn.BiGRU, mid if fold else in_f, hidden, *params)
    xt = torch.from_numpy(x).requires_grad_()
    pk = torch.from_numpy(pre_k).requires_grad_() if fold else None
    pb = torch.from_numpy(pre_b).requires_grad_() if fold else None
    before = tgru.bigru_recurrence_bwd.launches
    y = gru(xt, pk, pb)
    assert "BiGRURecurrence" in type(y.grad_fn.next_functions[0][0]).__name__
    (y * torch.from_numpy(weight)).sum().backward()
    assert tgru.bigru_recurrence_bwd.launches == before  # CPU: the plain twin
    got = [xt.grad.numpy(), *_stacked_grads(gru)]
    if fold:
        got += [pk.grad.numpy(), pb.grad.numpy()]
    names = ("dx", "dw_ih", "dw_hh", "db_ih", "db_hh", "dpre_kernel", "dpre_bias")
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _bilstm_case(length, hidden):
    """(x, params, weight) from a seed and JAX's gradients of
    sum(bilstm_pallas * weight) with respect to x and the params."""
    rng = np.random.default_rng(300 + length)
    rows, in_f = 5, 7
    x = rng.standard_normal((rows, length, in_f)).astype(np.float32)
    params = _params(rng, in_f, hidden, 4)
    weight = rng.standard_normal((rows, length, 2 * hidden)).astype(np.float32)

    def loss_j(*args):
        return (bilstm_pallas(*args, interpret=True) * weight).sum()

    want = [
        np.asarray(g)
        for g in jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, *params)))
    ]
    return x, params, weight, want


def _check_bilstm_grads(x, params, weight, want):
    lstm = _module(trnn.BiLSTM, x.shape[-1], weight.shape[-1] // 2, *params)
    xt = torch.from_numpy(x).requires_grad_()
    y = lstm(xt)
    (y * torch.from_numpy(weight)).sum().backward()
    got = [xt.grad.numpy(), *_stacked_grads(lstm)]
    for g, w, name in zip(got, want, ("dx", "dw_ih", "dw_hh", "db_ih", "db_hh")):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    return y.grad_fn


@pytest.mark.parametrize("hidden", [8, 5])
@pytest.mark.parametrize("length", [1, 9])
def test_bilstm_grads_match_pallas_vjp(length, hidden):
    """At an odd H too: the plain twin, which the CUDA kernel is held
    against on the card, against the Pallas VJP."""
    assert "BiLSTMRecurrence" in type(_check_bilstm_grads(*_bilstm_case(length, hidden))).__name__


@pytest.mark.parametrize("wide", [6, 8])
def test_bilstm_at_a_padded_hidden_matches_pallas_vjp(monkeypatch, wide):
    """On the card ``BiLSTM`` runs an H that the kernels refuse at the next
    H they serve (``lstm.served_hidden``), its weights zero-padded.  Forced
    here on the CPU, H=5 run at ``wide``: the output and every gradient are
    still H=5's, against the Pallas VJP, and the layer is counted."""
    monkeypatch.setattr(tlstm, "served_hidden", lambda hid, device: wide)
    padded = trnn.BiLSTM.padded_layers
    grad_fn = _check_bilstm_grads(*_bilstm_case(9, 5))
    assert trnn.BiLSTM.padded_layers == padded + 1
    # the output slices the padded recurrence's two directions back to H
    assert [type(f).__name__ for f, _ in grad_fn.next_functions] == ["SliceBackward0"] * 2
    recurrence = grad_fn.next_functions[0][0].next_functions[0][0]
    assert "BiLSTMRecurrence" in type(recurrence).__name__


def test_recurrences_refuse_other_devices_and_shapes():
    """The wrappers take the plain twins only for CPU tensors; anything
    else must be a CUDA tensor of the kernel's shape, or they raise."""
    gates = torch.zeros(2, 3, 96, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgru.bigru_recurrence(gates, torch.zeros(2, 96, 32, device="meta"), torch.zeros(2, 96, device="meta"))
    gates = torch.zeros(2, 3, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tlstm.bilstm_recurrence_bwd(gates, *(torch.zeros(s, device="meta") for s in ((2, 8, 2), (2, 8), (3, 4, 4), (3, 4, 4), (3, 4, 4))))


def test_forward_with_cs_matches_the_plain_cell_states():
    """``with_cs`` returns the cell states the backward reads: on the CPU
    the plain forward, checked against a step-by-step LSTM cell."""
    rng = np.random.default_rng(5)
    rows, length, hidden = 3, 4, 6
    gates = torch.tensor(rng.standard_normal((2, rows, length, 4 * hidden)), dtype=torch.float32)
    w_hh = torch.tensor(rng.standard_normal((2, 4 * hidden, hidden)) * 0.3, dtype=torch.float32)
    b_hh = torch.tensor(rng.standard_normal((2, 4 * hidden)) * 0.1, dtype=torch.float32)
    out, cs = tlstm.bilstm_recurrence(gates, w_hh, b_hh, with_cs=True)
    assert torch.equal(out, tlstm.bilstm_recurrence(gates, w_hh, b_hh))
    h = c = torch.zeros(rows, hidden)
    for t in range(length):  # direction 0 by hand
        a = gates[0, :, t] + h @ w_hh[0].T + b_hh[0]
        i, f, g, o = a.split(hidden, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        torch.testing.assert_close(cs[:, t, :hidden], c)
        torch.testing.assert_close(out[:, t, :hidden], h)
