"""CUDA kernels of tatt_tpu_torch against their plain PyTorch versions.

Needs a CUDA card (the kernels are built with nvcc for sm_90a at first
use); skipped elsewhere.  Imports no JAX, so it also runs where JAX is
not installed:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

# f32 kernel vs the same maths in plain PyTorch on the same card: only the
# summation order of the hidden-state matvec differs (~1e-7 relative per
# step, contracted by the gates over the sequence)
ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from tatt_tpu_torch.core.device import set_cuda_flags

    set_cuda_flags()
    return torch.device("cuda")


def _recurrence_inputs(shape_gates, gdim, hid, dev, seed=0):
    rng = np.random.default_rng(seed)
    b = 1.0 / math.sqrt(hid)
    mk = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return (
        mk(rng.standard_normal(shape_gates)),
        mk(rng.uniform(-b, b, (2, gdim, hid))),
        mk(rng.uniform(-b, b, (2, gdim))),
    )


# (L, R, H): gru1 and gru2 of the full-width generator at batch 64 and of
# the fused 2B=128 training batch, ragged row counts, L=1, L=2 (both h
# buffers once), odd L, and the hidden sizes at the dispatch edges
@pytest.mark.parametrize(
    "length,rows,hid",
    [(16, 4096, 32), (64, 1024, 32), (16, 4099, 32), (1, 37, 32), (7, 45, 32),
     (5, 70, 128), (9, 33, 4), (3, 10, 5), (16, 8192, 32), (64, 2048, 32),
     (64, 2049, 32), (2, 64, 32), (4, 130, 33), (3, 77, 6)],
)
def test_bigru_kernel_matches_plain(cuda, length, rows, hid):
    from tatt_tpu_torch.kernels.gru import bigru_recurrence, bigru_recurrence_ref

    gates, w_hh, b_hh = _recurrence_inputs((2, length, 3 * hid, rows), 3 * hid, hid, cuda)
    before = bigru_recurrence.launches
    with torch.no_grad():
        out = bigru_recurrence(gates, w_hh, b_hh)
        ref = bigru_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    assert bigru_recurrence.launches == before + 1
    assert out.shape == (length, 2 * hid, rows)
    assert (out - ref).abs().max().item() <= ATOL


def test_bigru_fwd_serves_every_hidden(cuda):
    """Every H from 1 to 128 (what ``rnn.BiGRU`` sends to the kernel, and
    what the backward serves) runs on the card and matches the plain
    version, at a row count inside one tile and at a ragged one over many
    tiles: the plan shrinks the rows of a block where W_hh fills shared
    memory, and never refuses."""
    from tatt_tpu_torch.kernels.gru import bigru_recurrence, bigru_recurrence_ref

    for hid in range(1, 129):
        for rows in (37, 1029):
            gates, w_hh, b_hh = _recurrence_inputs(
                (2, 3, 3 * hid, rows), 3 * hid, hid, cuda, seed=hid)
            with torch.no_grad():
                out = bigru_recurrence(gates, w_hh, b_hh)
                ref = bigru_recurrence_ref(gates, w_hh, b_hh)
            torch.cuda.synchronize()
            assert (out - ref).abs().max().item() <= ATOL, (hid, rows)


def test_bigru_fwd_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give bitwise-equal results at both
    training shapes: each row's sums run in one fixed order."""
    from tatt_tpu_torch.kernels.gru import bigru_recurrence

    for length, rows in ((16, 8192), (64, 2048)):
        gates, w_hh, b_hh = _recurrence_inputs((2, length, 96, rows), 96, 32, cuda, seed=5)
        with torch.no_grad():
            first = bigru_recurrence(gates, w_hh, b_hh)
            second = bigru_recurrence(gates, w_hh, b_hh)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_bigru_fwd_plan_fills_the_card(cuda):
    """At gru2 of the fused 2B=128 training batch (R=2048) and of the eval
    batch (R=1024), H=32, the first wave gives each of the four schedulers
    of every SM a warp: at least one block an SM, of at least four warps,
    and the grid in one wave.  H=128 has a plan too, within the card's
    shared memory a block."""
    from tatt_tpu_torch.kernels.gru import bigru_fwd_plan

    props = torch.cuda.get_device_properties(cuda)
    for rows in (2048, 1024):
        plan = bigru_fwd_plan(32, rows)
        assert plan["blocks"] == 2 * math.ceil(rows / plan["rows"])
        assert plan["blocks"] <= plan["resident_blocks"]
        assert plan["blocks"] >= props.multi_processor_count
        assert math.ceil(plan["threads"] / 32) >= 4
    big = bigru_fwd_plan(128, 1024)
    assert big["rows"] >= 1 and big["smem_bytes"] <= 232448


# (L, R, H, with_cs): the CRNN head (R = batch 64, H = 256, 8-block
# clusters), the fixture judge (H = 64, one block), ragged rows and the
# row-tile edges (R = 8, 9, 61), L=1, odd L, one block at H not a
# multiple of 32 (48, 100, 16), clusters of 2 (H = 128) and 4 (H = 200),
# and the cell states of both main-path sizes
@pytest.mark.parametrize(
    "length,rows,hid,with_cs",
    [(26, 64, 256, False), (26, 64, 64, False), (26, 61, 256, False), (1, 9, 256, False),
     (5, 8, 256, False), (5, 9, 256, False), (7, 13, 64, False), (1, 7, 64, False),
     (5, 17, 48, False), (6, 11, 100, False), (4, 21, 128, False), (3, 10, 200, False),
     (4, 3, 16, False), (26, 64, 64, True), (26, 64, 256, True)],
)
def test_bilstm_kernel_matches_plain(cuda, length, rows, hid, with_cs):
    from tatt_tpu_torch.kernels.lstm import bilstm_recurrence, bilstm_recurrence_ref

    gates, w_hh, b_hh = _recurrence_inputs((2, rows, length, 4 * hid), 4 * hid, hid, cuda)
    before = bilstm_recurrence.launches
    with torch.no_grad():
        got = bilstm_recurrence(gates, w_hh, b_hh, with_cs=with_cs)
        want = bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=with_cs)
    torch.cuda.synchronize()
    assert bilstm_recurrence.launches == before + 1
    if not with_cs:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == (rows, length, 2 * hid)
        assert (g - w).abs().max().item() <= ATOL


def test_bilstm_kernel_refuses_unfitting_hidden(cuda):
    """H = 250 = 2 x 125: a cluster of 1 or 2 blocks would hold 1 MB or
    500 KB of W_hh per block, and 4 and 8 do not divide H.  The wrapper
    raises before any launch, and so does the plan query; the main path's
    H=256 plan keeps all its clusters resident at once."""
    from tatt_tpu_torch.kernels.lstm import bilstm_fwd_plan, bilstm_recurrence

    gates, w_hh, b_hh = _recurrence_inputs((2, 4, 3, 1000), 1000, 250, cuda)
    before = bilstm_recurrence.launches
    with pytest.raises((RuntimeError, ValueError), match="H=250"):
        bilstm_recurrence(gates, w_hh, b_hh)
    with pytest.raises(ValueError, match="H=250"):
        bilstm_fwd_plan(250, 4)
    torch.cuda.synchronize()
    assert bilstm_recurrence.launches == before
    plan = bilstm_fwd_plan(256, 64)
    assert plan["cluster"] == 8
    assert 2 * math.ceil(64 / plan["rows"]) <= plan["resident_clusters"]


def _scaled_err(got, want):
    """max |got - want| over the scale of want (at least 1)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


# the backward kernels against their plain twins on the same card: the
# per-step arithmetic is the same f32 maths, so d(gates) differ only in
# summation order (1e-5 of the largest value); the weight and bias
# gradients are sums over every (row, step) pair, up to 131,072 of them,
# taken in another order (1e-4 of the largest value)
DGATES_TOL, DW_TOL = 1e-5, 1e-4


def test_modules_run_both_kernels_under_autograd(cuda):
    """A BiGRU and a BiLSTM that want gradients run their forward and
    backward kernels on the card, once each per call, and match autograd
    through the plain loops (bigru_apply / bilstm_apply) on the same card."""
    from tatt_tpu_torch.kernels import gru, lstm, rnn
    from tatt_tpu_torch.models.common import init_parameters

    torch.manual_seed(0)
    for cls, plain, fwd, bwd, in_f, hid in (
        (rnn.BiGRU, rnn.bigru_apply, gru.bigru_recurrence, gru.bigru_recurrence_bwd, 12, 32),
        (rnn.BiGRU, rnn.bigru_apply, gru.bigru_recurrence, gru.bigru_recurrence_bwd, 12, 128),
        (rnn.BiLSTM, rnn.bilstm_apply, lstm.bilstm_recurrence, lstm.bilstm_recurrence_bwd, 24, 64),
    ):
        module = init_parameters(cls(in_f, hid), 1).to(cuda)
        x = torch.randn(37, 9, in_f, device=cuda, requires_grad=True)
        w = torch.randn(37, 9, 2 * hid, device=cuda)
        f0, b0 = fwd.launches, bwd.launches
        (module(x) * w).sum().backward()
        torch.cuda.synchronize()
        assert (fwd.launches - f0, bwd.launches - b0) == (1, 1)
        got = [x.grad] + [p.grad for p in module.parameters()]
        x.grad = None
        module.zero_grad()
        (plain(x, *module.stacked()) * w).sum().backward()
        want = [x.grad] + [p.grad for p in module.parameters()]
        for g, r in zip(got, want):
            assert _scaled_err(g, r) <= DW_TOL


def _bilstm_module_run(module, x, w):
    """Output, d(input) and the weight gradients of one forward and
    backward of ``module`` on ``x`` against the weights ``w``."""
    xg = x.detach().clone().requires_grad_()
    module.zero_grad()
    out = module(xg)
    (out * w).sum().backward()
    return out.detach(), xg.grad, [p.grad.clone() for p in module.parameters()]


@pytest.mark.parametrize("hid", [113, 250])
def test_bilstm_module_serves_hidden_the_kernels_refuse(cuda, hid):
    """H = 113 and 250, which the kernels refuse (the two tests above):
    the module finds, from the kernels' plan queries and before any
    launch, the next H they serve, counts the layer in
    ``BiLSTM.padded_layers`` and launches one forward and one backward
    kernel at that H on zero-padded weights.  Forward and backward against
    the plain twin on the CPU at the true H: outputs within 1e-5,
    d(input) within 1e-5 and the weight gradients within 1e-4 of their
    largest entry (at least 1)."""
    from tatt_tpu_torch.kernels import lstm
    from tatt_tpu_torch.kernels.rnn import BiLSTM
    from tatt_tpu_torch.models.common import init_parameters

    assert not lstm.kernels_serve(hid, cuda)
    wide = lstm.served_hidden(hid, cuda)
    assert hid < wide <= lstm.MAX_HIDDEN and lstm.kernels_serve(wide, cuda)
    gen = torch.Generator().manual_seed(hid)
    layer = init_parameters(BiLSTM(48, hid), 3)
    x = torch.randn(64, 26, 48, generator=gen)
    w = torch.randn(64, 26, 2 * hid, generator=gen)
    want = _bilstm_module_run(layer, x, w)
    card = copy.deepcopy(layer).to(cuda)
    launches = (lstm.bilstm_recurrence.launches, lstm.bilstm_recurrence_bwd.launches)
    padded = BiLSTM.padded_layers
    got = _bilstm_module_run(card, x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert BiLSTM.padded_layers == padded + 1
    assert (lstm.bilstm_recurrence.launches - launches[0],
            lstm.bilstm_recurrence_bwd.launches - launches[1]) == (1, 1)
    assert (got[0].cpu() - want[0]).abs().max().item() <= ATOL
    assert _scaled_err(got[1].cpu(), want[1]) <= ATOL
    for g, r in zip(got[2], want[2]):
        assert _scaled_err(g.cpu(), r) <= DW_TOL


def test_bilstm_module_launches_the_kernels_at_h256(cuda):
    """H = 256, which the kernels serve: one forward and one backward
    launch at H itself, and the padded-layer counter stays."""
    from tatt_tpu_torch.kernels import lstm
    from tatt_tpu_torch.kernels.rnn import BiLSTM
    from tatt_tpu_torch.models.common import init_parameters

    assert lstm.kernels_serve(256, cuda) and lstm.served_hidden(256, cuda) == 256
    module = init_parameters(BiLSTM(64, 256), 4).to(cuda)
    x = torch.randn(32, 26, 64, device=cuda)
    launches = (lstm.bilstm_recurrence.launches, lstm.bilstm_recurrence_bwd.launches)
    padded = BiLSTM.padded_layers
    _bilstm_module_run(module, x, torch.randn(32, 26, 512, device=cuda))
    torch.cuda.synchronize()
    assert BiLSTM.padded_layers == padded
    assert (lstm.bilstm_recurrence.launches - launches[0],
            lstm.bilstm_recurrence_bwd.launches - launches[1]) == (1, 1)


# (L, R, H): gru1 and gru2 of the fused 2B=128 training batch, ragged row
# counts (a last tile cut short at both: 4099, 2049), L=1 and L=2, odd L;
# the hidden sizes where the recurrence's unit groups stop covering H
# exactly (33, 36, 65, 118, 120) or its tiles shrink to fit shared memory
# (118, 120, 128), and where the weight-gradient pass takes more rows a
# thread and shorter chunks (33, 65, 97); rows a multiple of 4 (its 16-byte
# copies) or not, at H=128 too; H below one float4 (4, 5)
@pytest.mark.parametrize(
    "length,rows,hid",
    [(16, 8192, 32), (64, 2048, 32), (16, 4099, 32), (64, 2049, 32), (1, 37, 32), (2, 64, 32),
     (7, 45, 32), (5, 70, 128), (3, 72, 128), (6, 41, 118), (6, 41, 120), (4, 130, 33),
     (4, 64, 36), (3, 77, 64), (3, 52, 65), (3, 40, 97), (9, 33, 4), (3, 10, 5)],
)
def test_bigru_bwd_kernel_matches_plain(cuda, length, rows, hid):
    from tatt_tpu_torch.kernels.gru import (
        bigru_recurrence_bwd, bigru_recurrence_bwd_ref, bigru_recurrence_ref,
    )

    gates, w_hh, b_hh = _recurrence_inputs((2, length, 3 * hid, rows), 3 * hid, hid, cuda, seed=1)
    out = bigru_recurrence_ref(gates, w_hh, b_hh)
    dout = torch.randn_like(out)
    before = bigru_recurrence_bwd.launches
    got = bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout)
    want = bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout)
    torch.cuda.synchronize()
    assert bigru_recurrence_bwd.launches == before + 1
    for g, w, tol in zip(got, want, (DGATES_TOL, DW_TOL, DW_TOL, DW_TOL)):
        assert g.shape == w.shape
        assert _scaled_err(g, w) <= tol


def test_bigru_bwd_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give bitwise-equal results at both
    training shapes: every sum (the recurrence's, the weight-gradient
    pass's partials and their sum over slices) runs in a fixed order, with
    no atomics."""
    from tatt_tpu_torch.kernels.gru import bigru_recurrence_bwd, bigru_recurrence_ref

    for length, rows in ((16, 8192), (64, 2048)):
        gates, w_hh, b_hh = _recurrence_inputs((2, length, 96, rows), 96, 32, cuda, seed=3)
        out = bigru_recurrence_ref(gates, w_hh, b_hh)
        dout = torch.randn_like(out)
        first = bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout)
        second = bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_bigru_bwd_plan_fills_the_card(cuda):
    """At gru1 and gru2 of the fused 2B=128 training batch (H=32) the
    recurrence's first wave gives the card's schedulers (four an SM) at
    least one warp each; gru2's grid is resident at once.  gru1's
    16,384 rows take two waves: one wave needs 16 (unit, row) pairs a
    thread, which spill at 255 registers.  H=128 has a plan too."""
    from tatt_tpu_torch.kernels.gru import bigru_bwd_plan

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for rows in (8192, 2048):
        plan = bigru_bwd_plan(32, rows)
        assert plan["blocks"] == 2 * math.ceil(rows / plan["rows"])
        first_wave = min(plan["blocks"], plan["resident_blocks"])
        assert first_wave * math.ceil(plan["threads"] / 32) >= 4 * sms
    gru2 = bigru_bwd_plan(32, 2048)
    assert gru2["blocks"] <= gru2["resident_blocks"]
    assert bigru_bwd_plan(128, 2048)["rows"] >= 1


# (L, R, H): the student CRNN's heads (R = batch 64, H = 256), ragged rows,
# L=1, odd L, and H not a multiple of 32; and hidden sizes the forward
# serves that an earlier design of the backward refused: odd H
# (65, 111), H = 2 mod 4 (130, 158) and H that need a cluster of 4 (212,
# 220, 228)
@pytest.mark.parametrize(
    "length,rows,hid",
    [(26, 64, 256), (26, 61, 256), (1, 9, 256), (7, 13, 64), (5, 17, 48), (4, 3, 16), (3, 5, 5),
     (5, 7, 65), (5, 7, 111), (5, 7, 130), (5, 7, 158), (5, 7, 212), (5, 7, 220), (5, 7, 228)],
)
def test_bilstm_bwd_kernel_matches_plain(cuda, length, rows, hid):
    from tatt_tpu_torch.kernels.lstm import (
        bilstm_recurrence, bilstm_recurrence_bwd, bilstm_recurrence_bwd_ref, bilstm_recurrence_ref,
    )

    gates, w_hh, b_hh = _recurrence_inputs((2, rows, length, 4 * hid), 4 * hid, hid, cuda, seed=2)
    out, cs = bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=True)
    # the forward kernel's cell states, as the backward will read them
    k_out, k_cs = bilstm_recurrence(gates, w_hh, b_hh, with_cs=True)
    assert (k_out - out).abs().max().item() <= ATOL
    assert (k_cs - cs).abs().max().item() <= ATOL
    dout = torch.randn_like(out)
    before = bilstm_recurrence_bwd.launches
    got = bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout)
    want = bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout)
    torch.cuda.synchronize()
    assert bilstm_recurrence_bwd.launches == before + 1
    for g, w, tol in zip(got, want, (DGATES_TOL, DW_TOL, DW_TOL)):
        assert g.shape == w.shape
        assert _scaled_err(g, w) <= tol


def test_bilstm_bwd_refuses_what_the_forward_refuses(cuda):
    """H = 113 (one block would hold 204 KB of W_hh and the forward's
    partials do not fit beside it) and H = 250 (no cluster of 4 or 8
    divides it): the backward serves exactly the H the forward serves, so
    it raises before any launch, and so does its plan query."""
    from tatt_tpu_torch.kernels.lstm import bilstm_bwd_plan, bilstm_recurrence_bwd

    for hid in (113, 250):
        gates, w_hh, b_hh = _recurrence_inputs((2, 4, 3, 4 * hid), 4 * hid, hid, cuda)
        seq = torch.zeros(4, 3, 2 * hid, device=cuda)
        before = bilstm_recurrence_bwd.launches
        with pytest.raises(ValueError, match=f"H={hid}"):
            bilstm_recurrence_bwd(gates, w_hh, b_hh, seq, seq, seq)
        with pytest.raises(ValueError, match=f"H={hid}"):
            bilstm_bwd_plan(hid, 4)
        torch.cuda.synchronize()
        assert bilstm_recurrence_bwd.launches == before


def test_bilstm_bwd_serves_every_hidden_the_forward_serves(cuda):
    """For every H up to 256 the backward has a launch plan exactly when
    the forward has one, so a BiLSTM that runs its forward on the card
    also runs its backward (35 of them once did not)."""
    from tatt_tpu_torch.kernels.lstm import bilstm_bwd_plan, bilstm_fwd_plan

    def serves(plan, hid):
        try:
            plan(hid, 64)
        except ValueError:
            return False
        return True

    for hid in range(1, 257):
        assert serves(bilstm_bwd_plan, hid) == serves(bilstm_fwd_plan, hid), hid


def test_bilstm_bwd_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give bitwise-equal results at the
    student's shape and the judge's H: every sum (the dh partials of the
    cluster, the weight and bias gradients) runs in a fixed order, with no
    atomics."""
    from tatt_tpu_torch.kernels.lstm import bilstm_recurrence_bwd, bilstm_recurrence_ref

    for hid in (256, 64):
        gates, w_hh, b_hh = _recurrence_inputs((2, 64, 26, 4 * hid), 4 * hid, hid, cuda, seed=4)
        out, cs = bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=True)
        dout = torch.randn_like(out)
        first = bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout)
        second = bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_bilstm_bwd_plan_fills_the_card(cuda):
    """At the student's shape (H=256, R=64) every cluster of the recurrence
    is resident at once, each block gives its SM's four schedulers a warp
    each, and the first wave holds at least four warps an SM of the card."""
    from tatt_tpu_torch.kernels.lstm import bilstm_bwd_plan

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = bilstm_bwd_plan(256, 64)
    assert plan["clusters"] == 2 * math.ceil(64 / plan["rows"])
    assert plan["clusters"] <= plan["resident_clusters"]
    warps = math.ceil(plan["threads"] / 32)
    assert warps >= 4
    assert plan["clusters"] * plan["cluster"] * warps >= 4 * sms


# pretraining's batch of 128 rows: the full-width CRNN's two BiLSTMs (H=256,
# In 512 / 256) and the fixture judge's (H=64, In 128 / 64)
@pytest.mark.parametrize("cin,hid", [(512, 256), (256, 256), (128, 64), (64, 64)])
def test_bilstm_kernels_at_pretraining_rows(cuda, cin, hid):
    """Forward (with and without the cell states) and backward at R=128
    against the plain twins, through the module under autograd too."""
    from tatt_tpu_torch.kernels.lstm import (
        bilstm_recurrence, bilstm_recurrence_bwd, bilstm_recurrence_bwd_ref, bilstm_recurrence_ref,
    )
    from tatt_tpu_torch.kernels.rnn import BiLSTM
    from tatt_tpu_torch.models.common import init_parameters

    gates, w_hh, b_hh = _recurrence_inputs((2, 128, 26, 4 * hid), 4 * hid, hid, cuda, seed=hid)
    out, cs = bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=True)
    with torch.no_grad():
        assert (bilstm_recurrence(gates, w_hh, b_hh) - out).abs().max().item() <= ATOL
    k_out, k_cs = bilstm_recurrence(gates, w_hh, b_hh, with_cs=True)
    assert (k_out - out).abs().max().item() <= ATOL and (k_cs - cs).abs().max().item() <= ATOL
    dout = torch.randn_like(out)
    got = bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout)
    want = bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout)
    for g, w, tol in zip(got, want, (DGATES_TOL, DW_TOL, DW_TOL)):
        assert _scaled_err(g, w) <= tol
    layer = init_parameters(BiLSTM(cin, hid), 1)
    x = torch.randn(128, 26, cin, generator=torch.Generator().manual_seed(2))
    grads = []
    for dev in ("cpu", cuda):
        m = copy.deepcopy(layer).to(dev)
        xd = x.to(dev, copy=True).requires_grad_()
        m(xd).square().sum().backward()
        grads.append([xd.grad.cpu()] + [p.grad.cpu() for p in m.parameters()])
    for c, g in zip(*grads):
        assert (g - c).norm() <= 1e-4 * c.norm()


def test_ctc_loss_card_matches_cpu(cuda):
    """The CTC loss at pretraining's [26, 128, 37] on spread targets (blanks
    inside, many at 1e30) and on plain ones: values and gradients."""
    from tatt_tpu_torch.data.collate import collate
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
    from tatt_tpu_torch.kernels.ctc import ctc_loss
    from tatt_tpu_torch.train.pretrain import encode_ctc_targets

    ds = SyntheticTextDataset(n=128, seed=3)
    samples = [ds[i] for i in range(128)]
    spread = collate(samples)
    logits = torch.randn(26, 128, 37, generator=torch.Generator().manual_seed(4)) * 2
    for tg, tl in ((spread.ctc_targets, spread.ctc_lengths),
                   encode_ctc_targets([s[2] for s in samples])):
        res = []
        for dev in ("cpu", cuda):
            x = logits.to(dev, copy=True).requires_grad_()
            loss = ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(tg), torch.full((128,), 26),
                            torch.from_numpy(tl))
            loss.sum().backward()
            res.append((loss.detach().cpu(), x.grad.cpu()))
        (v_cpu, g_cpu), (v_gpu, g_gpu) = res
        assert torch.equal(v_cpu >= 1e29, v_gpu >= 1e29)
        assert ((v_gpu - v_cpu).abs() / v_cpu.abs()).max().item() <= 1e-5
        scale = g_cpu.abs().amax(dim=(0, 2), keepdim=True)
        assert ((g_gpu - g_cpu).abs() / (g_cpu.abs() + scale)).max().item() <= 1e-4


def test_small_eval_path_card_matches_cpu(cuda):
    """A small TATT + CRNN eval step through both kernels on the card
    against the plain versions on the CPU."""
    from tatt_tpu_torch.kernels.gru import bigru_recurrence
    from tatt_tpu_torch.kernels.lstm import bilstm_recurrence
    from tatt_tpu_torch.models.common import init_parameters
    from tatt_tpu_torch.models.recognizers.crnn import CRNN
    from tatt_tpu_torch.models.tsrn import TATT
    from tatt_tpu_torch.train.steps import eval_step

    gen = init_parameters(TATT(srb_nums=1, hidden_units=4, out_text_channels=8), 0).eval()
    stu = init_parameters(CRNN(nh=32, nm=(8, 8, 16, 16, 32, 32, 32)), 1).eval()
    lr = torch.tensor(np.random.default_rng(3).uniform(0, 1, (5, 4, 16, 64)), dtype=torch.float32)
    sr_cpu, _ = eval_step([gen], [stu], lr)
    g0, l0 = bigru_recurrence.launches, bilstm_recurrence.launches
    sr_gpu, _ = eval_step([gen.to(cuda)], [stu.to(cuda)], lr.to(cuda))
    torch.cuda.synchronize()
    # gru1 + gru2 of the one block, and the query GRU (hidden 16*8/2 = 64)
    assert bigru_recurrence.launches - g0 == 3
    assert bilstm_recurrence.launches - l0 == 2
    assert (sr_gpu.cpu() - sr_cpu).abs().max().item() <= 1e-4


def test_small_train_step_card_matches_cpu(cuda):
    """One train step of a small TATT(stn=True) + tiny CRNNs, fused tssim,
    rotation pinned, dropout off: the card (all four kernels) against the
    CPU (the plain twins), leaf by leaf: ||card - CPU|| / ||CPU||, the norm
    floored at 1e-2 of the model's largest leaf norm (leaves whose gradient
    vanishes analytically hold only rounding noise).  The BiGRU and BiLSTM
    leaves within 1e-4, the rest within 1e-3 (cuDNN and oneDNN
    convolutions and the kernels sum in other orders through ~40 layers,
    and a max pool may route a gradient to the other of two near-equal
    inputs)."""
    import copy

    from tatt_tpu_torch.data.collate import collate
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
    from tatt_tpu_torch.kernels import gru, lstm
    from tatt_tpu_torch.kernels.rnn import BiGRU, BiLSTM
    from tatt_tpu_torch.models.common import init_parameters
    from tatt_tpu_torch.models.recognizers.crnn import CRNN
    from tatt_tpu_torch.models.tsrn import TATT
    from tatt_tpu_torch.train.loop import to_device
    from tatt_tpu_torch.train.steps import StepConfig, train_step

    tatt = TATT(srb_nums=1, hidden_units=4, out_text_channels=8, stn=True, dropout=0.0)
    models_cpu = [init_parameters(tatt, 7)] + [
        init_parameters(CRNN(nh=16, nm=(8, 8, 16, 16, 32, 32, 32)), s) for s in (8, 9)
    ]
    models_gpu = [copy.deepcopy(m).to(cuda) for m in models_cpu]
    ds = SyntheticTextDataset(n=8, seed=5)
    b = collate([ds[i] for i in range(8)])
    rot = {"rot_arc": torch.linspace(-0.08, 0.08, 8), "rot_offs": torch.linspace(0.1, 0.9, 8)}
    counters = (gru.bigru_recurrence, gru.bigru_recurrence_bwd,
                lstm.bilstm_recurrence, lstm.bilstm_recurrence_bwd)
    results = []
    for dev, models in ((torch.device("cpu"), models_cpu), (cuda, models_gpu)):
        hr, lr = to_device(b, dev, True)
        batch = {"images_hr": hr, "images_lr": lr, **{k: v.to(dev) for k, v in rot.items()}}
        opt = torch.optim.SGD([p for m in models[:2] for p in m.parameters()], lr=1.0)
        before = [f.launches for f in counters]
        metrics = train_step([models[0].train()], [models[1].train()], models[2].eval(), opt, batch,
                             StepConfig(), torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        launches = [f.launches - n for f, n in zip(counters, before)]
        results.append((metrics, [{k: p.grad.cpu() for k, p in m.named_parameters()} for m in models[:2]]))
    # gru1 + gru2 of the one block and the query GRU (hidden 8*8/2 = 32),
    # forward and backward; student forward with c and backward, teacher forward
    assert launches == [3, 3, 4, 2]
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results
    for key, value in m_cpu.items():
        assert abs(m_gpu[key].item() - value.item()) <= 1e-4 * max(1.0, abs(value.item())), key
    for model, cpu_g, gpu_g in zip(models_cpu, g_cpu, g_gpu):
        rnn = {f"{m_name}.{p_name}" for m_name, m in model.named_modules()
               if isinstance(m, (BiGRU, BiLSTM)) for p_name, _ in m.named_parameters()}
        floor = 1e-2 * max(g.norm().item() for g in cpu_g.values())
        for name, g in cpu_g.items():
            tol = 1e-4 if name in rnn else 1e-3
            assert (gpu_g[name] - g).norm().item() <= tol * max(g.norm().item(), floor), name


def test_cli_trains_on_the_card_by_default(cuda, capsys):
    """The canonical recipe through the CLI at full width, without
    --device: two steps on the card, finite losses."""
    from tatt_tpu_torch.cli import main as cli

    argv = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
            "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss", "--synthetic", "128",
            "--max_iters", "2"]
    assert cli.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[train] iters 2 "), line


def _bf16_close(got, want, atol: float) -> bool:
    """Each bf16 entry within one bf16 ulp of the plain twin's (the ulp at
    the larger magnitude), or within ``atol`` (an entry near 0 that a sum in
    another order moves by more than its own ulp)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-126))) - 7)
    return bool(((diff <= ulp) | (diff <= atol)).all())


# the bf16 instantiations (--dtype bfloat16) at the recipe's shapes, ragged
# rows and odd H: bf16 in and out, f32 inside, counted like the f32 ones
@pytest.mark.parametrize("length,rows,hid", [(16, 8192, 32), (64, 2048, 32), (7, 45, 33), (3, 10, 5)])
def test_bigru_bf16_kernels_match_plain(cuda, length, rows, hid):
    from tatt_tpu_torch.kernels.gru import (
        bigru_recurrence, bigru_recurrence_bwd, bigru_recurrence_bwd_ref, bigru_recurrence_ref,
    )

    ins = [t.to(torch.bfloat16) for t in
           _recurrence_inputs((2, length, 3 * hid, rows), 3 * hid, hid, cuda, seed=5)]
    before = bigru_recurrence.bf16_launches, bigru_recurrence_bwd.bf16_launches
    out, ref = bigru_recurrence(*ins), bigru_recurrence_ref(*ins)
    assert out.dtype == torch.bfloat16 and _bf16_close(out, ref, ATOL)
    dout = torch.randn_like(ref)
    got = bigru_recurrence_bwd(*ins, ref, dout)
    want = bigru_recurrence_bwd_ref(*ins, ref, dout)
    torch.cuda.synchronize()
    assert (bigru_recurrence.bf16_launches, bigru_recurrence_bwd.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    assert _bf16_close(got[0], want[0], DGATES_TOL * max(1.0, want[0].float().abs().max().item()))
    assert all(_scaled_err(g, w) <= DW_TOL for g, w in zip(got[1:], want[1:]))


@pytest.mark.parametrize("length,rows,hid", [(26, 64, 256), (26, 61, 256), (7, 13, 64), (5, 7, 111)])
def test_bilstm_bf16_kernels_match_plain(cuda, length, rows, hid):
    from tatt_tpu_torch.kernels.lstm import (
        bilstm_recurrence, bilstm_recurrence_bwd, bilstm_recurrence_bwd_ref, bilstm_recurrence_ref,
    )

    ins = [t.to(torch.bfloat16) for t in
           _recurrence_inputs((2, rows, length, 4 * hid), 4 * hid, hid, cuda, seed=6)]
    before = bilstm_recurrence.bf16_launches, bilstm_recurrence_bwd.bf16_launches
    (out, cs), (ref, ref_cs) = (f(*ins, with_cs=True) for f in (bilstm_recurrence, bilstm_recurrence_ref))
    assert out.dtype == cs.dtype == torch.bfloat16
    assert _bf16_close(out, ref, ATOL) and _bf16_close(cs, ref_cs, ATOL)
    dout = torch.randn_like(ref)
    got = bilstm_recurrence_bwd(*ins, ref, ref_cs, dout)
    want = bilstm_recurrence_bwd_ref(*ins, ref, ref_cs, dout)
    torch.cuda.synchronize()
    assert (bilstm_recurrence.bf16_launches, bilstm_recurrence_bwd.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    assert _bf16_close(got[0], want[0], DGATES_TOL * max(1.0, want[0].float().abs().max().item()))
    assert all(_scaled_err(g, w) <= DW_TOL for g, w in zip(got[1:], want[1:]))


def test_bf16_modules_train_through_the_bf16_kernels(cuda):
    """BiGRU and BiLSTM on a bf16 input under autograd launch the bf16
    instantiations forward and backward (no cast around the f32 kernels),
    and the parameters' gradients come back float32."""
    from tatt_tpu_torch.kernels import gru, lstm
    from tatt_tpu_torch.kernels.rnn import BiGRU, BiLSTM
    from tatt_tpu_torch.models.common import init_parameters

    for cls, fwd, bwd in ((BiGRU, gru.bigru_recurrence, gru.bigru_recurrence_bwd),
                          (BiLSTM, lstm.bilstm_recurrence, lstm.bilstm_recurrence_bwd)):
        layer = init_parameters(cls(24, 32), 3).to(cuda)
        x = torch.randn(40, 9, 24, device=cuda, dtype=torch.bfloat16, requires_grad=True)
        before = fwd.bf16_launches, bwd.bf16_launches, fwd.launches
        y = layer(x)
        y.float().square().sum().backward()
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
        assert (fwd.bf16_launches, bwd.bf16_launches, fwd.launches) == (
            before[0] + 1, before[1] + 1, before[2] + 1)
        assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
                   for p in layer.parameters())


# (L, H) of the query GRU's chains (kernels/query_gru.py, one row): the TP
# Interpreter's full width (64 steps, hidden 512), an odd hidden size the
# plan serves (a last block with fewer units, W_hh's rows padded to a
# float4 multiple), and one step
@pytest.mark.parametrize("length,hid", [(64, 512), (64, 333), (1, 512)])
def test_query_gru_kernels_match_plain(cuda, length, hid):
    """Forward and backward chains against the plain twins on the same
    card: h, d(gates), dW_hh, db_hh and the input-bias gradient each within
    ATOL of their largest entry (at least 1); one launch each."""
    from tatt_tpu_torch.kernels.gru import bigru_recurrence_bwd_ref, bigru_recurrence_ref
    from tatt_tpu_torch.kernels.query_gru import query_gru_recurrence, query_gru_recurrence_bwd

    ins = _recurrence_inputs((2, length, 3 * hid, 1), 3 * hid, hid, cuda, seed=hid)
    before = query_gru_recurrence.launches, query_gru_recurrence_bwd.launches
    out, ref = query_gru_recurrence(*ins), bigru_recurrence_ref(*ins)
    dout = torch.tensor(np.random.default_rng(length).standard_normal((length, 2 * hid, 1)),
                        dtype=torch.float32, device=cuda)
    got = query_gru_recurrence_bwd(*ins, ref, dout)
    want = bigru_recurrence_bwd_ref(*ins, ref, dout)
    torch.cuda.synchronize()
    assert (query_gru_recurrence.launches, query_gru_recurrence_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert _scaled_err(out, ref) <= ATOL
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(_scaled_err(g, w) <= ATOL for g, w in zip(got, want))


def test_query_gru_kernels_are_deterministic(cuda):
    """Two launches of each chain at the query GRU's shape are bitwise
    equal (every sum in a fixed order, no atomics)."""
    from tatt_tpu_torch.kernels.query_gru import query_gru_recurrence, query_gru_recurrence_bwd

    ins = _recurrence_inputs((2, 64, 1536, 1), 1536, 512, cuda, seed=9)
    first, second = query_gru_recurrence(*ins), query_gru_recurrence(*ins)
    dout = torch.randn_like(first)
    bwd = [query_gru_recurrence_bwd(*ins, first, dout) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert all(torch.equal(a, b) for a, b in zip(*bwd))


def test_query_gru_refusals_take_the_plain_loop(cuda):
    """A BiGRU of hidden 512 over several rows (reference mode's R = N) or
    on a bf16 input runs bigru_apply: the module's output is bigru_apply's
    and no launch counter moves, the chains' or the narrow kernels'.  The
    plan gives its reason for those rows and for hidden 1024 (the query GRU
    at 256x64), and serves hidden 512 over one row."""
    from tatt_tpu_torch.kernels import gru, query_gru
    from tatt_tpu_torch.kernels.rnn import BiGRU, bigru_apply
    from tatt_tpu_torch.models.common import init_parameters

    module = init_parameters(BiGRU(1024, 512), 2).to(cuda)
    counters = (gru.bigru_recurrence, gru.bigru_recurrence_bwd,
                query_gru.query_gru_recurrence, query_gru.query_gru_recurrence_bwd)
    for x in (torch.randn(3, 8, 1024, device=cuda),
              torch.randn(1, 8, 1024, device=cuda, dtype=torch.bfloat16)):
        before = [c.launches for c in counters]
        with torch.no_grad():
            got, want = module(x), bigru_apply(x, *module.stacked())
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert [c.launches for c in counters] == before
    assert isinstance(query_gru.query_gru_plan(512, 3), str)
    assert isinstance(query_gru.query_gru_plan(1024, 1), str)
    plan = query_gru.query_gru_plan(512, 1)
    assert plan["cluster"] * plan["units"] >= 512 and plan["fwd_clusters"] >= 1


def test_tatt_step_launches_the_query_gru_chains_once(cuda):
    """One recipe train step of the full-width TATT (five SRBs; the query
    GRU at hidden 512) with full-width CRNNs on the card launches the
    query GRU's chains once forward and once backward, and the narrow
    kernels 10/10/4/2 as before (gru1 + gru2 of five blocks forward and
    backward; the student's forward with c and backward, the teacher's
    forward)."""
    from tatt_tpu_torch.data.collate import collate
    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset
    from tatt_tpu_torch.kernels import gru, lstm, query_gru
    from tatt_tpu_torch.models.common import init_parameters
    from tatt_tpu_torch.models.recognizers.crnn import CRNN
    from tatt_tpu_torch.models.tsrn import TATT
    from tatt_tpu_torch.train.loop import to_device
    from tatt_tpu_torch.train.steps import StepConfig, train_step

    models = [init_parameters(TATT(stn=True), 7).to(cuda)] + [
        init_parameters(CRNN(), s).to(cuda) for s in (8, 9)]
    ds = SyntheticTextDataset(n=4, seed=5)
    hr, lr = to_device(collate([ds[i] for i in range(4)]), cuda, True)
    batch = {"images_hr": hr, "images_lr": lr,
             "rot_arc": torch.linspace(-0.08, 0.08, 4, device=cuda),
             "rot_offs": torch.linspace(0.1, 0.9, 4, device=cuda)}
    opt = torch.optim.SGD([p for m in models[:2] for p in m.parameters()], lr=1e-3)
    counters = (gru.bigru_recurrence, gru.bigru_recurrence_bwd, lstm.bilstm_recurrence,
                lstm.bilstm_recurrence_bwd, query_gru.query_gru_recurrence,
                query_gru.query_gru_recurrence_bwd)
    before = [c.launches for c in counters]
    metrics = train_step([models[0].train()], [models[1].train()], models[2].eval(), opt, batch,
                         StepConfig(), torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [10, 10, 4, 2, 1, 1]
    assert all(math.isfinite(v.item()) for v in metrics.values())
