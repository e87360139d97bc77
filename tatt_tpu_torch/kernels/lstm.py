"""Fused bidirectional-LSTM recurrence, forward and backward: CUDA kernels,
plain twins and the ``autograd.Function`` that joins them.

Counterparts of ``tatt_tpu/kernels/pallas_lstm.py``: ``_lstm_fwd_kernel``
(``csrc/bilstm_fwd.cu``) and ``_lstm_bwd_kernel`` (``csrc/bilstm_bwd.cu``).
Both kernels run both directions in one launch and walk direction 1
backwards in time through mirrored indices; each source says what bounds
it on the card and how the design answers that.

:func:`bilstm_recurrence` and :func:`bilstm_recurrence_bwd` launch the
kernels for CUDA tensors and use the plain :func:`bilstm_recurrence_ref` /
:func:`bilstm_recurrence_bwd_ref` only for CPU tensors.

Each kernel has a float32 and a bfloat16 instantiation, chosen by the
tensors' dtype.  The bf16 one is what the TPU kernel computes under
``--dtype bfloat16`` (``pallas_lstm.py:110-142``): bf16 gates, ``W_hh``
and ``b_hh`` in, the h and c carries and every sum in f32, h, the saved
cell states and d(gates) out in bf16, the weight and bias gradients in
f32.  The plain twins compute the same way.  Launch plans are per
instantiation; which hidden sizes they serve depends on H alone.
"""

from __future__ import annotations

import ctypes

import torch

from tatt_tpu_torch.kernels import _build
from tatt_tpu_torch.kernels.gru import SUFFIX, wide

_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# the bf16 backward also takes the float32 scratch of its activations and d(gates)
_BWD_BF16_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_HIDDEN = 256
# what csrc/bilstm_fwd.cu and csrc/bilstm_bwd.cu return, before any
# launch, for an H that no cluster size serves
_NO_FIT = -1
_PLAN_KEYS = ("cluster", "rows", "k_groups", "threads", "smem_bytes", "resident_clusters")
_BWD_PLAN_KEYS = ("cluster", "rows", "k_groups", "threads", "smem_bytes", "clusters",
                  "resident_clusters")


def _lstm_cell(a, hid):
    return (
        torch.sigmoid(a[:, :hid]),
        torch.sigmoid(a[:, hid : 2 * hid]),
        torch.tanh(a[:, 2 * hid : 3 * hid]),
        torch.sigmoid(a[:, 3 * hid :]),
    )


def bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs: bool = False):
    """Plain PyTorch version of the forward kernel, a Python loop over time.

    ``gates`` [2, R, L, 4H] (input projections in forward time for both
    directions, torch gate order i, f, g, o), ``w_hh`` [2, 4H, H],
    ``b_hh`` [2, 4H].  Returns the hidden states [R, L, 2H] with direction 1
    scanned t = L-1 .. 0 and stored at its forward-time slots, and with
    ``with_cs`` also the cell states in the same layout, both in ``gates``'
    dtype.  bf16 inputs: f32 arithmetic and carries, h and c rounded to bf16
    as they are stored."""
    _, rows, length, g4 = gates.shape
    hid = g4 // 4
    out = gates.new_empty(rows, length, 2 * hid)
    cs = gates.new_empty(rows, length, 2 * hid)
    gates, w_hh, b_hh = wide(gates), wide(w_hh), wide(b_hh)
    for d in range(2):
        h = gates.new_zeros(rows, hid)
        c = gates.new_zeros(rows, hid)
        steps = range(length) if d == 0 else range(length - 1, -1, -1)
        for t in steps:
            i, f, g, o = _lstm_cell(gates[d, :, t] + h @ w_hh[d].T + b_hh[d], hid)
            c = f * c + i * g
            h = o * torch.tanh(c)
            out[:, t, d * hid : (d + 1) * hid] = h
            cs[:, t, d * hid : (d + 1) * hid] = c
    return (out, cs) if with_cs else out


def bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout):
    """Plain PyTorch version of the backward kernel (``_lstm_bwd_kernel``,
    ``pallas_lstm.py:53-103``): each direction walks its processing order
    in reverse, recomputing the gates from h_prev / c_prev.  ``out``,
    ``cs`` and ``dout`` [R, L, 2H].  Returns ``(dgates [2, R, L, 4H],
    dw_hh [2, 4H, H], db_hh [2, 4H])``.  bf16 inputs: f32 arithmetic from
    the bf16 saved h and c, d(gates) rounded to bf16, the weight and bias
    gradients f32 sums of the unrounded d(gates)."""
    _, rows, length, g4 = gates.shape
    hid = g4 // 4
    dgates = torch.empty_like(gates)
    gates, w_hh, b_hh, out, cs, dout = (wide(t) for t in (gates, w_hh, b_hh, out, cs, dout))
    dw, db = gates.new_zeros(2, g4, hid), gates.new_zeros(2, g4)
    zeros = gates.new_zeros(rows, hid)
    for d in range(2):
        own = slice(d * hid, (d + 1) * hid)
        dh_carry, dc_carry = zeros, zeros
        steps = range(length - 1, -1, -1) if d == 0 else range(length)
        for t in steps:
            tp = t - 1 if d == 0 else t + 1
            first = not 0 <= tp < length
            h_prev = zeros if first else out[:, tp, own]
            c_prev = zeros if first else cs[:, tp, own]
            i, f, g, o = _lstm_cell(gates[d, :, t] + h_prev @ w_hh[d].T + b_hh[d], hid)
            tc = torch.tanh(cs[:, t, own])
            dh = dh_carry + dout[:, t, own]
            do = dh * tc * o * (1.0 - o)
            dc = dc_carry + dh * o * (1.0 - tc * tc)
            d_g = torch.cat(
                [dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                 dc * i * (1.0 - g * g), do],
                dim=1,
            )
            dgates[d, :, t] = d_g
            dw[d] += d_g.T @ h_prev
            db[d] += d_g.sum(0)
            dh_carry = d_g @ w_hh[d]
            dc_carry = dc * f
    return dgates, dw, db


def _check(name, gates, w_hh, b_hh, *more):
    two, rows, length, g4 = gates.shape
    hid = g4 // 4
    if gates.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {gates.device}")
    if two != 2 or g4 != 4 * hid or not 0 < hid <= MAX_HIDDEN:
        raise ValueError(
            f"{name}: gates {tuple(gates.shape)} must be [2, R, L, 4H] with H <= {MAX_HIDDEN}"
        )
    if tuple(w_hh.shape) != (2, g4, hid) or tuple(b_hh.shape) != (2, g4):
        raise ValueError(
            f"{name}: w_hh {tuple(w_hh.shape)} / b_hh {tuple(b_hh.shape)} do not match H={hid}"
        )
    if gates.dtype not in SUFFIX:
        raise ValueError(f"{name}: gates must be float32 or bfloat16, not {gates.dtype}")
    for what, t in (("gates", gates), ("w_hh", w_hh), ("b_hh", b_hh), *more):
        if t.device != gates.device or t.dtype != gates.dtype:
            raise ValueError(f"{name}: {what} must be {gates.dtype} on {gates.device}")
    for what, t in more:
        if tuple(t.shape) != (rows, length, 2 * hid):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} must be [R, L, 2H]")
    return length, hid, rows


def bilstm_recurrence(gates, w_hh, b_hh, with_cs: bool = False):
    """The BiLSTM forward recurrence: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Arguments and results as
    :func:`bilstm_recurrence_ref` (all float32, or all bfloat16: the bf16
    instantiation); without ``with_cs`` the kernel stores no cell states.
    Raises ``ValueError``, before any launch, for a hidden size that no
    cluster of 1, 2, 4 or 8 blocks can hold (H=250; how the kernel picks
    its launch: :func:`bilstm_fwd_plan`).
    ``bilstm_recurrence.launches`` counts kernel launches of either
    instantiation, ``bilstm_recurrence.bf16_launches`` those of the bf16 one."""
    if gates.device.type == "cpu":
        return bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs)
    length, hid, rows = _check("bilstm_recurrence", gates, w_hh, b_hh)
    gates, w_hh, b_hh = gates.contiguous(), w_hh.contiguous(), b_hh.contiguous()
    out = torch.empty(rows, length, 2 * hid, device=gates.device, dtype=gates.dtype)
    cs = torch.empty_like(out) if with_cs else None
    if length > 0 and rows > 0:
        launch = _build.entry("bilstm_fwd", "bilstm_fwd" + SUFFIX[gates.dtype], _FWD_ARGTYPES)
        with torch.cuda.device(gates.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
                None if cs is None else cs.data_ptr(), length, hid, rows, stream,
            )
        _check_launch(err, "bilstm_fwd", hid)
        bilstm_recurrence.launches += 1
        bilstm_recurrence.bf16_launches += gates.dtype == torch.bfloat16
    return (out, cs) if with_cs else out


bilstm_recurrence.launches = bilstm_recurrence.bf16_launches = 0


def _check_launch(err: int, what: str, hid: int) -> None:
    if err == _NO_FIT:
        raise ValueError(
            f"{what}: H={hid}: no cluster of 1, 2, 4 or 8 blocks divides H "
            "with a block whose slice of W_hh fits shared memory"
        )
    _build.check(err, what)


def _query_plan(kernel: str, keys: tuple, hid: int, rows: int,
                dtype: torch.dtype = torch.float32):
    """``(error code, plan)`` of the plan query of ``kernel``'s ``dtype``
    instantiation at hidden size ``hid`` over ``rows`` rows on the current
    card (launches nothing)."""
    fn = _build.entry(kernel, f"{kernel}{SUFFIX[dtype]}_plan",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    plan = (ctypes.c_int * len(keys))()
    return fn(hid, rows, plan), dict(zip(keys, plan))


def bilstm_fwd_plan(hid: int, rows: int, dtype: torch.dtype = torch.float32) -> dict:
    """How the forward kernel's ``dtype`` instantiation launches at hidden
    size ``hid`` over ``rows`` rows on the current card, for logs (launches
    nothing): cluster size, rows per cluster, k groups, threads and
    shared-memory bytes of a block, and the clusters the card runs at once."""
    err, plan = _query_plan("bilstm_fwd", _PLAN_KEYS, hid, rows, dtype)
    _check_launch(err, "bilstm_fwd_plan", hid)
    return plan


def bilstm_bwd_plan(hid: int, rows: int, dtype: torch.dtype = torch.float32) -> dict:
    """How the backward kernel's recurrence (its ``dtype`` instantiation)
    launches at hidden size ``hid`` over ``rows`` rows on the current card,
    for logs (launches nothing): cluster size, rows per cluster, k groups,
    threads and shared-memory bytes of a block, clusters of the grid and
    clusters the card runs at once.  Raises ``ValueError`` for an H the
    forward does not serve."""
    if not 0 < hid <= MAX_HIDDEN:
        raise ValueError(f"bilstm_bwd_plan: H={hid} must be in 1..{MAX_HIDDEN}")
    err, plan = _query_plan("bilstm_bwd", _BWD_PLAN_KEYS, hid, rows, dtype)
    _check_launch(err, "bilstm_bwd_plan", hid)
    return plan


_SERVES: dict = {}


def kernels_serve(hid: int, device: torch.device) -> bool:
    """Whether both the forward and the backward kernel serve hidden size
    ``hid`` on CUDA ``device``, from their plan queries (which launch
    nothing; a plan's fit depends on H alone, not on the row count).
    Cached per (device, H)."""
    index = torch.device(device).index
    key = (torch.cuda.current_device() if index is None else index, hid)
    if key not in _SERVES:

        def fits(kernel, keys) -> bool:
            err, _ = _query_plan(kernel, keys, hid, 1)
            if err != _NO_FIT:
                _build.check(err, f"{kernel}_plan")
            return err != _NO_FIT

        with torch.cuda.device(key[0]):
            _SERVES[key] = 0 < hid <= MAX_HIDDEN and all(
                fits(*q) for q in (("bilstm_fwd", _PLAN_KEYS), ("bilstm_bwd", _BWD_PLAN_KEYS)))
    return _SERVES[key]


def served_hidden(hid: int, device: torch.device) -> int:
    """The hidden size at which ``BiLSTM`` runs the kernels for a layer of
    hidden size ``hid`` <= ``MAX_HIDDEN`` on ``device``: ``hid`` itself on
    the CPU (the plain twins serve any H) and where the kernels serve it,
    else the next size they serve (H=256 always fits), decided from the
    plan queries before any launch."""
    if torch.device(device).type == "cpu":
        return hid
    return next(h for h in range(hid, MAX_HIDDEN + 1) if kernels_serve(h, device))


def bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout):
    """The BiLSTM backward recurrence: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Arguments and results as
    :func:`bilstm_recurrence_bwd_ref` (inputs all float32 or all bfloat16;
    the weight and bias gradients float32).  Raises ``ValueError``, before any
    launch, for an H the forward kernel does not serve (how the recurrence
    launches: :func:`bilstm_bwd_plan`).  ``bilstm_recurrence_bwd.launches``
    counts kernel launches (``bf16_launches`` those of the bf16
    instantiation; one per call: the recurrence and its weight reduction
    are one entry point)."""
    if gates.device.type == "cpu":
        return bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout)
    length, hid, rows = _check(
        "bilstm_recurrence_bwd", gates, w_hh, b_hh, ("out", out), ("cs", cs), ("dout", dout)
    )
    gates, w_hh, b_hh, out, cs, dout = (
        t.contiguous() for t in (gates, w_hh, b_hh, out, cs, dout)
    )
    dgates = torch.empty_like(gates)
    launch = length > 0 and rows > 0
    # the kernel writes every weight and bias gradient; no pairs sum to 0
    f32 = torch.float32
    make = torch.empty if launch else torch.zeros
    dw = make(w_hh.shape, device=gates.device, dtype=f32)
    db = make(b_hh.shape, device=gates.device, dtype=f32)
    if launch:
        # bf16: the activations and unrounded d(gates) the passes share
        scratch = [] if gates.dtype == f32 else [torch.empty(gates.shape, device=gates.device,
                                                             dtype=f32)]
        fn = _build.entry("bilstm_bwd", "bilstm_bwd" + SUFFIX[gates.dtype],
                          _BWD_ARGTYPES if gates.dtype == f32 else _BWD_BF16_ARGTYPES)
        with torch.cuda.device(gates.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(
                gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
                cs.data_ptr(), dout.data_ptr(), dgates.data_ptr(),
                *(s.data_ptr() for s in scratch), dw.data_ptr(), db.data_ptr(),
                length, hid, rows, stream,
            )
        _check_launch(err, "bilstm_bwd", hid)
        bilstm_recurrence_bwd.launches += 1
        bilstm_recurrence_bwd.bf16_launches += gates.dtype == torch.bfloat16
    return dgates, dw, db


bilstm_recurrence_bwd.launches = bilstm_recurrence_bwd.bf16_launches = 0


class BiLSTMRecurrence(torch.autograd.Function):
    """``out = recurrence(gates, w_hh, b_hh)`` with the hand-written
    backward; the forward stores the cell states for it, as the JAX
    forward emits them (``pallas_lstm.py:176-182``).  Returns [R, L, 2H].
    The weight and bias gradients come back in ``w_hh``'s and ``b_hh``'s
    dtype, as the JAX VJP casts them (``pallas_lstm.py:188``)."""

    @staticmethod
    def forward(ctx, gates, w_hh, b_hh):
        gates = gates.contiguous()
        out, cs = bilstm_recurrence(gates, w_hh, b_hh, with_cs=True)
        ctx.save_for_backward(gates, w_hh, b_hh, out, cs)
        return out

    @staticmethod
    def backward(ctx, dout):
        gates, w_hh, b_hh, out, cs = ctx.saved_tensors
        dgates, dw, db = bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout.contiguous())
        return dgates, dw.to(w_hh.dtype), db.to(b_hh.dtype)
