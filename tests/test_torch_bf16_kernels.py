"""The bf16 plain twins of the four recurrence kernels against the JAX
package's Pallas kernels on bf16 inputs.

Under ``--dtype bfloat16`` the TPU kernels read bf16 gates, ``W_hh`` and
``b_hh``, keep every carry and sum in f32, and store h (and the LSTM's cell
states) and d(gates) in bf16, the weight and bias gradients in f32
(``pallas_gru.py:241-316``, ``pallas_lstm.py:110-164``).  The CUDA kernels'
bf16 instantiations compute the same and are held against the plain twins
on the card (``chip_smoke.py`` phase 18, ``tests/test_torch_cuda.py``); here
the plain twins meet the Pallas kernels, run in interpret mode as
``tests/test_pallas_gru.py`` runs them, on the same bf16 inputs made from a
seed with numpy.

Tolerances.  Both sides do f32 arithmetic on the same bf16 values and
differ only in the order of f32 sums (~1e-7 relative), so every bf16
output (h, c, d(gates)) is within one bf16 ulp of the Pallas one: the f32
values may fall either side of a rounding boundary.  The f32 weight and
bias gradients sum the same f32 d(gates) over every (row, step) in another
order: within 1e-4 of the largest entry.  Through the modules (``BiGRU`` /
``BiLSTM`` against ``bigru_pallas`` / ``bilstm_pallas``) the bf16 input
projection runs in two libraries' bf16 GEMMs, so a gate may differ by an
ulp, which the recurrence carries on: outputs and gradients within 2^-6
of the largest entry there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tatt_tpu.kernels import pallas_gru, pallas_lstm
from tatt_tpu_torch.kernels import gru as tgru
from tatt_tpu_torch.kernels import lstm as tlstm
from tatt_tpu_torch.kernels import rnn as trnn

BF16 = torch.bfloat16
GRAD_TOL = 1e-4  # f32 weight and bias gradients, over the largest entry
MODULE_TOL = 2.0**-6  # through the modules' bf16 projections, over the largest entry


def _f32(a) -> np.ndarray:
    """A JAX or torch array (bf16 or f32) as float32 numpy."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def assert_within_ulp(got, want, what: str, ulps: int = 1) -> None:
    """Each entry of ``got`` within ``ulps`` bf16 ulps of ``want``'s, the
    ulp taken at the larger magnitude of the two."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    bad = np.abs(g - w) > ulps * ulp
    assert not bad.any(), (what, int(bad.sum()), g[bad][:5], w[bad][:5])


def assert_scaled(got, want, tol: float, what: str) -> None:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, (what, err, tol)


def _bf16_pair(a: np.ndarray):
    """The same bf16 values for both packages (round to nearest even)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _gru_case(seed, length, hid, rows):
    rng = np.random.default_rng(seed)
    g3 = 3 * hid
    gates = rng.standard_normal((2, length, g3, rows)).astype(np.float32)
    w_hh = rng.standard_normal((2, g3, hid)).astype(np.float32) * hid**-0.5
    b_hh = rng.standard_normal((2, g3)).astype(np.float32) * 0.3
    return [_bf16_pair(a) for a in (gates, w_hh, b_hh)], rng


@pytest.mark.parametrize("length,hid,rows", [(1, 8, 4), (6, 5, 16), (8, 32, 8)])
def test_bigru_bf16_twins_match_pallas(length, hid, rows):
    """Forward (h in bf16) and backward (d(gates) in bf16; dW_hh, db_hh and
    the input-bias gradient in f32) of the BiGRU recurrence."""
    ((g_t, g_j), (w_t, w_j), (b_t, b_j)), rng = _gru_case(10 + length, length, hid, rows)
    ysf, ysb = pallas_gru._fwd_call(g_j, w_j, b_j, interpret=True)
    assert ysf.dtype == jnp.bfloat16
    out = tgru.bigru_recurrence(g_t, w_t, b_t)  # CPU: the plain twin
    assert out.dtype == BF16
    assert_within_ulp(out[:, :hid], ysf, "h direction 0")
    assert_within_ulp(out[:, hid:], ysb, "h direction 1")

    # the backward from the same saved h (Pallas's) and a bf16 dL/dout
    saved = torch.cat([torch.from_numpy(_f32(ysf)), torch.from_numpy(_f32(ysb))], 1).to(BF16)
    dy_t, dy_j = _bf16_pair(rng.standard_normal((length, 2 * hid, rows)))
    dgxf, dgxb, dw, db, dbx = pallas_gru._bwd_call(
        w_j, b_j, g_j, ysf, ysb, dy_j[:, :hid], dy_j[:, hid:], interpret=True)
    dgates, dw_t, db_t, dbx_t = tgru.bigru_recurrence_bwd(g_t, w_t, b_t, saved, dy_t)
    assert dgates.dtype == BF16 and {dw_t.dtype, db_t.dtype, dbx_t.dtype} == {torch.float32}
    assert_within_ulp(dgates[0], dgxf, "d(gates) direction 0")
    assert_within_ulp(dgates[1], dgxb, "d(gates) direction 1")
    for got, want, what in ((dw_t, dw, "dW_hh"), (db_t, db, "db_hh"), (dbx_t, dbx, "dbx")):
        assert_scaled(got, want, GRAD_TOL, what)


def _lstm_to_jax(p: np.ndarray) -> np.ndarray:
    """The port's [2, R, L, C] (both directions in forward time) as the JAX
    kernel's [L, 2, C, R] (direction 1 time-flipped)."""
    return np.stack([p[0].transpose(1, 2, 0), p[1][:, ::-1].transpose(1, 2, 0)], axis=1)


def _lstm_from_jax(a) -> torch.Tensor:
    """The JAX kernel's [L, 2, H, R] as the port's [R, L, 2H]."""
    a = _f32(a)
    return torch.from_numpy(np.concatenate(
        [a[:, 0].transpose(2, 0, 1), a[::-1, 1].transpose(2, 0, 1)], axis=-1).copy())


@pytest.mark.parametrize("length,hid,rows", [(1, 8, 4), (7, 5, 16), (8, 32, 6)])
def test_bilstm_bf16_twins_match_pallas(length, hid, rows):
    """Forward (h and the saved cell states in bf16) and backward (d(gates)
    in bf16 from the bf16 h and c; dW_hh and db_hh in f32) of the BiLSTM
    recurrence."""
    rng = np.random.default_rng(40 + length)
    g4 = 4 * hid
    gates = rng.standard_normal((2, rows, length, g4)).astype(np.float32)
    (g_t, _), (w_t, w_j), (b_t, b_j) = (_bf16_pair(a) for a in (
        gates, rng.standard_normal((2, g4, hid)) * hid**-0.5, rng.standard_normal((2, g4)) * 0.3))
    g_j = jnp.asarray(_lstm_to_jax(g_t.float().numpy())).astype(jnp.bfloat16)
    hs, cs = pallas_lstm._fwd_call(g_j, w_j, b_j, interpret=True)
    assert hs.dtype == cs.dtype == jnp.bfloat16
    out, c_t = tlstm.bilstm_recurrence(g_t, w_t, b_t, with_cs=True)
    assert out.dtype == c_t.dtype == BF16
    assert_within_ulp(out, _lstm_from_jax(hs), "h")
    assert_within_ulp(c_t, _lstm_from_jax(cs), "c")

    dy = rng.standard_normal((rows, length, 2 * hid)).astype(np.float32)
    dy_t, _ = _bf16_pair(dy)
    dy_j = jnp.asarray(_lstm_to_jax(
        dy_t.float().numpy().reshape(rows, length, 2, hid).transpose(2, 0, 1, 3))).astype(jnp.bfloat16)
    dgx, dw, db = pallas_lstm._bwd_call(w_j, b_j, g_j, hs, cs, dy_j, interpret=True)
    dgates, dw_t, db_t = tlstm.bilstm_recurrence_bwd(
        g_t, w_t, b_t, _lstm_from_jax(hs).to(BF16), _lstm_from_jax(cs).to(BF16), dy_t)
    assert dgates.dtype == BF16 and dw_t.dtype == db_t.dtype == torch.float32
    want = _f32(dgx)  # [L, 2, 4H, R] -> the port's [2, R, L, 4H]
    want = np.stack([want[:, 0].transpose(2, 0, 1), want[::-1, 1].transpose(2, 0, 1)])
    assert_within_ulp(dgates, want, "d(gates)")
    assert_scaled(dw_t, dw, GRAD_TOL, "dW_hh")
    assert_scaled(db_t, db, GRAD_TOL, "db_hh")


def _module(cls, in_f, hidden, params):
    module = cls(in_f, hidden)
    sd = {}
    for name, v in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"), params):
        sd[f"{name}_l0"], sd[f"{name}_l0_reverse"] = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    module.load_state_dict(sd)
    return module


def _module_case(seed, gates, rows, length, in_f, hidden):
    rng = np.random.default_rng(seed)
    g = gates * hidden
    x = rng.standard_normal((rows, length, in_f)).astype(np.float32)
    params = [rng.standard_normal(s).astype(np.float32) * sc
              for s, sc in (((2, g, in_f), 0.3), ((2, g, hidden), 0.3), ((2, g), 0.1), ((2, g), 0.1))]
    weight = rng.standard_normal((rows, length, 2 * hidden)).astype(np.float32)
    return x, params, weight


def _check_module(cls, pallas_fn, x, params, weight):
    """The module on bf16 input (f32 parameters) against the Pallas entry's
    value and VJP: output bf16, the parameter gradients f32."""
    x_t, x_j = _bf16_pair(x)
    w_t, w_j = _bf16_pair(weight)

    def loss_j(xj, *ps):
        y = pallas_fn(xj, *ps, interpret=True)
        return (y.astype(jnp.float32) * w_j.astype(jnp.float32)).sum(), y

    (_, y_j), grads = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        x_j, *(jnp.asarray(p) for p in params))
    module = _module(cls, x.shape[-1], weight.shape[-1] // 2, params)
    xt = x_t.clone().requires_grad_()
    y = module(xt)
    assert y.dtype == BF16 and y_j.dtype == jnp.bfloat16
    (y.float() * w_t.float()).sum().backward()
    assert_scaled(y, y_j, MODULE_TOL, "output")
    got = [xt.grad] + [torch.stack([getattr(module, f"{n}_l0").grad,
                                    getattr(module, f"{n}_l0_reverse").grad])
                       for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    assert got[0].dtype == BF16 and all(g.dtype == torch.float32 for g in got[1:])
    for g, w, what in zip(got, grads, ("dx", "dw_ih", "dw_hh", "db_ih", "db_hh")):
        assert_scaled(g, w, MODULE_TOL, what)
    return y


def test_bigru_module_bf16_matches_bigru_pallas():
    """``BiGRU`` on a bf16 input runs the recurrence's autograd Function in
    bf16 (the twin of the bf16 kernels on the CPU, no launch)."""
    launches = tgru.bigru_recurrence_bwd.launches, tgru.bigru_recurrence.launches
    y = _check_module(trnn.BiGRU, pallas_gru.bigru_pallas, *_module_case(7, 3, 6, 5, 9, 8))
    assert "BiGRURecurrence" in type(y.grad_fn.next_functions[0][0]).__name__
    assert (tgru.bigru_recurrence_bwd.launches, tgru.bigru_recurrence.launches) == launches


@pytest.mark.parametrize("wide", [None, 8])
def test_bilstm_module_bf16_matches_bilstm_pallas(monkeypatch, wide):
    """``BiLSTM`` on a bf16 input; with ``wide``, H=5 run at a padded H as
    the card runs an H that its kernels refuse (ROADMAP C.1), forced here
    as ``tests/test_torch_grad.py`` forces it: the padded units stay 0 in
    bf16 too, and the output and gradients are still H=5's."""
    if wide is not None:
        monkeypatch.setattr(tlstm, "served_hidden", lambda hid, device: wide)
    padded = trnn.BiLSTM.padded_layers
    y = _check_module(trnn.BiLSTM, pallas_lstm.bilstm_pallas, *_module_case(8, 4, 5, 9, 7, 5))
    assert trnn.BiLSTM.padded_layers == padded + (wide is not None)
    fn = y.grad_fn if wide is None else y.grad_fn.next_functions[0][0].next_functions[0][0]
    assert "BiLSTMRecurrence" in type(fn).__name__


def test_float32_twins_are_unchanged_by_the_bf16_path():
    """The f32 twins compute exactly as before (no widening), and the CPU
    float64 step's recurrences stay float64."""
    ((g, _), (w, _), (b, _)), _ = _gru_case(3, 4, 6, 5)
    g32, w32, b32 = g.float(), w.float(), b.float()
    assert tgru.bigru_recurrence(g32, w32, b32).dtype == torch.float32
    out64 = tgru.bigru_recurrence(g32.double(), w32.double(), b32.double())
    assert out64.dtype == torch.float64
    torch.testing.assert_close(out64.float(), tgru.bigru_recurrence(g32, w32, b32))
