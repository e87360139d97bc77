"""The port's recurrences (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode and its lax.scan RNNs.

Same inputs, made with numpy from a seed, go through both packages;
tolerances are those of tests/test_pallas_gru.py (atol 1e-5, rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tatt_tpu.kernels import rnn as jrnn
from tatt_tpu.kernels.pallas_gru import bigru_pallas
from tatt_tpu.kernels.pallas_lstm import bilstm_pallas
from tatt_tpu_torch.kernels import rnn as trnn

TOL = dict(atol=1e-5, rtol=1e-4)


def _params(rng, in_f, hidden, gates):
    g = gates * hidden
    return [
        rng.standard_normal(s).astype(np.float32) * sc
        for s, sc in (((2, g, in_f), 0.2), ((2, g, hidden), 0.2), ((2, g), 0.1), ((2, g), 0.1))
    ]


def _load(module, w_ih, w_hh, b_ih, b_hh):
    sd = {}
    for name, v in (("weight_ih", w_ih), ("weight_hh", w_hh), ("bias_ih", b_ih), ("bias_hh", b_hh)):
        sd[f"{name}_l0"] = torch.from_numpy(v[0])
        sd[f"{name}_l0_reverse"] = torch.from_numpy(v[1])
    module.load_state_dict(sd)
    return module


# hidden 8; 32, the width every GruBlock runs on the main path; 5, not a
# multiple of 4 (the CUDA kernel pads the hidden axis to a float4 multiple)
@pytest.mark.parametrize("hidden", [8, 32, 5])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("length", [1, 7, 12])
def test_bigru_matches_pallas_interpret_and_scan(fold, length, hidden):
    rng = np.random.default_rng(length + 10 * fold)
    rows, in_f, mid = 9, 6, 10
    x = rng.standard_normal((rows, length, in_f)).astype(np.float32)
    pre_k = rng.standard_normal((mid, in_f)).astype(np.float32) * 0.3 if fold else None
    pre_b = rng.standard_normal((mid,)).astype(np.float32) * 0.1 if fold else None
    w_ih, w_hh, b_ih, b_hh = _params(rng, mid if fold else in_f, hidden, 3)
    jx = [jnp.asarray(a) for a in (x, w_ih, w_hh, b_ih, b_hh)]
    kw = dict(pre_kernel=jnp.asarray(pre_k), pre_bias=jnp.asarray(pre_b)) if fold else {}
    want_pallas = np.asarray(bigru_pallas(*jx, interpret=True, **kw))
    from tatt_tpu.kernels.pallas_gru import compose_input_projection

    w_eff, b_eff = compose_input_projection(jx[1], jx[3], kw.get("pre_kernel"), kw.get("pre_bias"))
    want_scan = np.asarray(jrnn.bigru_apply(jx[0], w_eff, jx[2], b_eff, jx[4]))

    gru = _load(trnn.BiGRU(mid if fold else in_f, hidden), w_ih, w_hh, b_ih, b_hh)
    with torch.no_grad():
        got = gru(
            torch.from_numpy(x),
            None if pre_k is None else torch.from_numpy(pre_k),
            None if pre_b is None else torch.from_numpy(pre_b),
        ).numpy()
        w_eff_t, b_eff_t = trnn.compose_input_projection(
            *(torch.from_numpy(a) for a in (w_ih, b_ih)),
            None if pre_k is None else torch.from_numpy(pre_k),
            None if pre_b is None else torch.from_numpy(pre_b),
        )
        got_plain = trnn.bigru_apply(
            torch.from_numpy(x), w_eff_t, torch.from_numpy(w_hh), b_eff_t, torch.from_numpy(b_hh)
        ).numpy()
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_scan, **TOL)
    np.testing.assert_allclose(got_plain, want_scan, **TOL)


@pytest.mark.parametrize("length", [1, 9])
def test_bilstm_matches_pallas_interpret_and_scan(length):
    rng = np.random.default_rng(100 + length)
    rows, in_f, hidden = 5, 12, 8
    x = rng.standard_normal((rows, length, in_f)).astype(np.float32)
    params = _params(rng, in_f, hidden, 4)
    jx = [jnp.asarray(a) for a in (x, *params)]
    want_pallas = np.asarray(bilstm_pallas(*jx, interpret=True))
    want_scan = np.asarray(jrnn.bilstm_apply(*jx))
    lstm = _load(trnn.BiLSTM(in_f, hidden), *params)
    with torch.no_grad():
        got = lstm(torch.from_numpy(x)).numpy()
        got_plain = trnn.bilstm_apply(*(torch.from_numpy(a) for a in (x, *params))).numpy()
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_scan, **TOL)
    np.testing.assert_allclose(got_plain, want_scan, **TOL)


def test_wide_bigru_takes_the_plain_path():
    """Hidden above the narrow kernels' 128 (the query GRU's 512 at full
    width): on the card a float32 row now runs the chains of
    ``kernels/query_gru.py``; on the CPU it runs bigru_apply, as JAX keeps
    it on lax.scan.  At hidden 130 on the CPU the module's forward and
    gradients match JAX's bigru_apply and no launch counter moves, narrow
    or wide; the chains' autograd.Function over their plain twins matches
    too."""
    import jax

    from tatt_tpu_torch.kernels import gru, query_gru

    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 3, 4)).astype(np.float32)
    params = _params(rng, 4, 130, 3)
    dy = rng.standard_normal((1, 3, 260)).astype(np.float32)

    def loss(*args):  # one jitted forward and backward: eager JAX dispatches op by op
        y = jrnn.bigru_apply(*args, unroll=1)
        return (y * dy).sum(), y

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True))(
        *(jnp.asarray(a) for a in (x, *params)))
    want, want_grads = np.asarray(want), [np.asarray(g) for g in want_grads]

    counters = (gru.bigru_recurrence, gru.bigru_recurrence_bwd,
                query_gru.query_gru_recurrence, query_gru.query_gru_recurrence_bwd)
    before = [c.launches for c in counters]
    gru_mod = _load(trnn.BiGRU(4, 130), *params)
    xt = torch.from_numpy(x).requires_grad_()
    assert not query_gru.serves(xt, 130)
    got = gru_mod(xt)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_grads[0], **TOL)
    for name, g in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"), want_grads[1:]):
        for d, sfx in enumerate(("_l0", "_l0_reverse")):
            np.testing.assert_allclose(getattr(gru_mod, name + sfx).grad.numpy(), g[d], **TOL)
    assert [c.launches for c in counters] == before

    xt2 = torch.from_numpy(x).requires_grad_()
    w_ih, w_hh, b_ih, b_hh = (torch.from_numpy(a).requires_grad_() for a in params)
    xw = torch.einsum("rli,dgi->dlgr", xt2, w_ih)
    y = query_gru.QueryGRURecurrence.apply(xw, b_ih, w_hh, b_hh).permute(2, 0, 1)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), want, **TOL)
    for t, g in zip((xt2, w_ih, w_hh, b_ih, b_hh), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), g, **TOL)
    assert [c.launches for c in counters] == before


def test_query_gru_kernel_names_stay_out_of_the_rooflines():
    """The benchmark's roofline readers sum the device time of every kernel
    whose name contains one listed in ``stisr_bench/metrics/*_roofline.json``
    and hold it against the narrow kernels' launches; no ``__global__`` of
    ``csrc/query_gru.cu`` may contain such a name."""
    import glob
    import json
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    listed = set()
    for path in glob.glob(os.path.join(root, "stisr_bench", "metrics", "*_roofline.json")):
        with open(path) as f:
            listed.update(json.load(f)["kernels"])
    with open(os.path.join(root, "tatt_tpu_torch", "csrc", "query_gru.cu")) as f:
        src = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert len(names) == 2 and listed
    assert not [(n, k) for n in names for k in listed if k in n]
