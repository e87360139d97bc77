"""Fused bidirectional-GRU recurrence, forward and backward: CUDA kernels,
plain twins and the ``autograd.Function`` that joins them.

Counterparts of ``tatt_tpu/kernels/pallas_gru.py``: ``_gru_fwd_kernel``
(``csrc/bigru_fwd.cu``) and ``_gru_bwd_kernel`` / ``_gru_bwd_step``
(``csrc/bigru_bwd.cu``).  Each kernel runs both directions in one launch;
its source says what bounds it on the card and how the design answers
that.  The input projection stays ordinary torch ops outside, as JAX keeps
it outside its custom VJP (``pallas_gru.py:360-375``).

:func:`bigru_recurrence` and :func:`bigru_recurrence_bwd` launch the
kernels for CUDA tensors and use the plain :func:`bigru_recurrence_ref` /
:func:`bigru_recurrence_bwd_ref` only for CPU tensors.

Each kernel has a float32 and a bfloat16 instantiation, chosen by the
tensors' dtype.  The bf16 one is what the TPU kernel computes under
``--dtype bfloat16`` (``pallas_gru.py:241-282``): bf16 gates, ``W_hh`` and
``b_hh`` in, every carry and sum in f32, h and d(gates) out in bf16, the
weight and bias gradients in f32.  The plain twins compute the same way:
f32 arithmetic on the widened inputs, outputs rounded to the inputs' dtype.
"""

from __future__ import annotations

import ctypes

import torch

from tatt_tpu_torch.kernels import _build

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the bf16 backward also takes the float32 d(gates) scratch of its weight gradient
_BWD_BF16_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# each instantiation's entry-point suffix
SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
MAX_HIDDEN = 128
# a launch plan's values, in the order csrc/bigru_fwd.cu and bigru_bwd.cu write them
_PLAN_KEYS = ("units_per_thread", "rows_per_thread", "rows", "threads", "smem_bytes",
              "blocks", "resident_blocks")


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype the plain twins compute in: float32 for bfloat16,
    else its own (the CPU float64 step stays float64)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _gru_cell(gx, gh, hid):
    r = torch.sigmoid(gx[:hid] + gh[:hid])
    z = torch.sigmoid(gx[hid : 2 * hid] + gh[hid : 2 * hid])
    n = torch.tanh(gx[2 * hid :] + r * gh[2 * hid :])
    return r, z, n


def bigru_recurrence_ref(
    gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, a Python loop over time.

    ``gates`` [2, L, 3H, R] (input projections in forward time for both
    directions, gate order r, z, n), ``w_hh`` [2, 3H, H], ``b_hh`` [2, 3H].
    Returns [L, 2H, R] in ``gates``' dtype: direction 1 scans t = L-1 .. 0
    and each output sits at its forward-time slot.  bf16 inputs: f32
    arithmetic and carry, h rounded to bf16 as it is stored."""
    _, length, g3, rows = gates.shape
    hid = g3 // 3
    out = gates.new_empty(length, 2 * hid, rows)
    gates, w_hh, b_hh = wide(gates), wide(w_hh), wide(b_hh)
    for d in range(2):
        h = gates.new_zeros(hid, rows)
        steps = range(length) if d == 0 else range(length - 1, -1, -1)
        for t in steps:
            _, z, n = _gru_cell(gates[d, t], w_hh[d] @ h + b_hh[d][:, None], hid)
            h = (1.0 - z) * n + z * h
            out[t, d * hid : (d + 1) * hid] = h
    return out


def bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout):
    """Plain PyTorch version of the backward kernel (``_gru_bwd_kernel``
    and ``_gru_bwd_step``, ``pallas_gru.py:109-209``): each direction walks
    its processing order in reverse, recomputing the gates from the saved
    hidden states.  ``out`` and ``dout`` [L, 2H, R].  Returns
    ``(dgates [2, L, 3H, R], dw_hh [2, 3H, H], db_hh [2, 3H], dbx [2, 3H])``;
    ``dbx`` is the gradient of a bias added to ``gates``.  bf16 inputs: f32
    arithmetic from the bf16 saved h, d(gates) rounded to bf16, the weight
    and bias gradients f32 sums of the unrounded d(gates)."""
    _, length, g3, rows = gates.shape
    hid = g3 // 3
    dgates = torch.empty_like(gates)
    gates, w_hh, b_hh, out, dout = (wide(t) for t in (gates, w_hh, b_hh, out, dout))
    dw, db, dbx = gates.new_zeros(2, g3, hid), gates.new_zeros(2, g3), gates.new_zeros(2, g3)
    zeros = gates.new_zeros(hid, rows)
    for d in range(2):
        own = slice(d * hid, (d + 1) * hid)
        dh_carry = zeros
        steps = range(length - 1, -1, -1) if d == 0 else range(length)
        for t in steps:
            tp = t - 1 if d == 0 else t + 1
            h_prev = out[tp, own] if 0 <= tp < length else zeros
            gh = w_hh[d] @ h_prev + b_hh[d][:, None]
            r, z, n = _gru_cell(gates[d, t], gh, hid)
            dh = dh_carry + dout[t, own]
            dz = dh * (h_prev - n) * z * (1.0 - z)
            dn = dh * (1.0 - z) * (1.0 - n * n)
            dr = dn * gh[2 * hid :] * r * (1.0 - r)
            d_gh = torch.cat([dr, dz, dn * r])
            d_gx = torch.cat([dr, dz, dn])
            dgates[d, t] = d_gx
            dw[d] += d_gh @ h_prev.T
            db[d] += d_gh.sum(1)
            dbx[d] += d_gx.sum(1)
            dh_carry = dh * z + w_hh[d].T @ d_gh
    return dgates, dw, db, dbx


def _check(name, limit, gates, w_hh, b_hh, *more):
    two, length, g3, rows = gates.shape
    hid = g3 // 3
    if gates.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {gates.device}")
    if two != 2 or g3 != 3 * hid or not 0 < hid <= limit:
        raise ValueError(
            f"{name}: gates {tuple(gates.shape)} must be [2, L, 3H, R] with H <= {limit}"
        )
    if tuple(w_hh.shape) != (2, g3, hid) or tuple(b_hh.shape) != (2, g3):
        raise ValueError(
            f"{name}: w_hh {tuple(w_hh.shape)} / b_hh {tuple(b_hh.shape)} do not match H={hid}"
        )
    if gates.dtype not in SUFFIX:
        raise ValueError(f"{name}: gates must be float32 or bfloat16, not {gates.dtype}")
    for what, t in (("gates", gates), ("w_hh", w_hh), ("b_hh", b_hh), *more):
        if t.device != gates.device or t.dtype != gates.dtype:
            raise ValueError(f"{name}: {what} must be {gates.dtype} on {gates.device}")
    for what, t in more:
        if tuple(t.shape) != (length, 2 * hid, rows):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} must be [L, 2H, R]")
    return length, hid, rows


def bigru_recurrence(
    gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The BiGRU forward recurrence: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Shapes as :func:`bigru_recurrence_ref`;
    all three float32, or all bfloat16 (the bf16 instantiation).
    ``bigru_recurrence.launches`` counts kernel launches of either,
    ``bigru_recurrence.bf16_launches`` those of the bf16 instantiation."""
    if gates.device.type == "cpu":
        return bigru_recurrence_ref(gates, w_hh, b_hh)
    length, hid, rows = _check("bigru_recurrence", MAX_HIDDEN, gates, w_hh, b_hh)
    gates, w_hh, b_hh = gates.contiguous(), w_hh.contiguous(), b_hh.contiguous()
    out = torch.empty(length, 2 * hid, rows, device=gates.device, dtype=gates.dtype)
    if length == 0 or rows == 0:
        return out
    launch = _build.entry("bigru_fwd", "bigru_fwd" + SUFFIX[gates.dtype], _FWD_ARGTYPES)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            length, hid, rows, stream,
        )
    _build.check(err, "bigru_fwd")
    bigru_recurrence.launches += 1
    bigru_recurrence.bf16_launches += gates.dtype == torch.bfloat16
    return out


bigru_recurrence.launches = bigru_recurrence.bf16_launches = 0


def _plan(kernel: str, hid: int, rows: int, dtype: torch.dtype) -> dict:
    if not 0 < hid <= MAX_HIDDEN:
        raise ValueError(f"{kernel}_plan: H={hid} must be in 1..{MAX_HIDDEN}")
    name = f"{kernel}{SUFFIX[dtype]}_plan"
    fn = _build.entry(kernel, name, [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    _build.check(fn(hid, rows, plan), name)
    return dict(zip(_PLAN_KEYS, plan))


def bigru_fwd_plan(hid: int, rows: int, dtype: torch.dtype = torch.float32) -> dict:
    """How the forward kernel's ``dtype`` instantiation launches at hidden
    size ``hid`` over ``rows`` rows on the current card, for logs (launches
    nothing); the keys of :func:`bigru_bwd_plan`."""
    return _plan("bigru_fwd", hid, rows, dtype)


def bigru_bwd_plan(hid: int, rows: int, dtype: torch.dtype = torch.float32) -> dict:
    """How the backward kernel's recurrence (its ``dtype`` instantiation)
    launches at hidden size ``hid`` over ``rows`` rows on the current card,
    for logs (launches nothing): hidden units and rows a thread, rows,
    threads and shared-memory bytes of a block, blocks of the grid and
    blocks the card runs at once."""
    return _plan("bigru_bwd", hid, rows, dtype)


def bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout):
    """The BiGRU backward recurrence: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  Arguments and results as
    :func:`bigru_recurrence_bwd_ref` (inputs all float32 or all bfloat16;
    the weight and bias gradients float32).  ``bigru_recurrence_bwd.launches``
    counts kernel launches (``bf16_launches`` those of the bf16
    instantiation; one per call: the recurrence and its weight
    reduction are one entry point; how the recurrence launches:
    :func:`bigru_bwd_plan`)."""
    if gates.device.type == "cpu":
        return bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout)
    length, hid, rows = _check(
        "bigru_recurrence_bwd", MAX_HIDDEN, gates, w_hh, b_hh, ("out", out), ("dout", dout)
    )
    gates, w_hh, b_hh, out, dout = (
        t.contiguous() for t in (gates, w_hh, b_hh, out, dout)
    )
    dev, f32 = gates.device, torch.float32
    g3 = 3 * hid
    dgates = torch.empty_like(gates)
    dw = torch.zeros(2, g3, hid, device=dev, dtype=f32)
    bias4 = torch.zeros(2, 4 * hid, device=dev, dtype=f32)
    if length > 0 and rows > 0:
        # K slices of the weight-gradient pass, one partial each: two for
        # each SM (two blocks of that pass fit one), at most one per chunk
        # of 64 rows of a step
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slices = max(1, min(2 * sms, length * -(-rows // 64)))
        dghn = torch.empty(2, length, hid, rows, device=dev, dtype=f32)
        bias_part = torch.empty(2, slices, 4 * hid, device=dev, dtype=f32)
        dw_part = torch.empty(2, slices, g3, hid, device=dev, dtype=f32)
        # bf16: the unrounded d(gates) that the weight-gradient pass reads
        scratch = [] if gates.dtype == f32 else [torch.empty(gates.shape, device=dev, dtype=f32)]
        launch = _build.entry("bigru_bwd", "bigru_bwd" + SUFFIX[gates.dtype],
                              _BWD_ARGTYPES if gates.dtype == f32 else _BWD_BF16_ARGTYPES)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
                dout.data_ptr(), dgates.data_ptr(), *(s.data_ptr() for s in scratch),
                dghn.data_ptr(), bias_part.data_ptr(), dw_part.data_ptr(), dw.data_ptr(),
                bias4.data_ptr(), length, hid, rows, slices, stream,
            )
        _build.check(err, "bigru_bwd")
        bigru_recurrence_bwd.launches += 1
        bigru_recurrence_bwd.bf16_launches += gates.dtype == torch.bfloat16
    db_hh = bias4[:, :g3]
    dbx = torch.cat([bias4[:, : 2 * hid], bias4[:, g3:]], dim=1)
    return dgates, dw, db_hh, dbx


bigru_recurrence_bwd.launches = bigru_recurrence_bwd.bf16_launches = 0


class BiGRURecurrence(torch.autograd.Function):
    """``out = recurrence(xw + b_x, w_hh, b_hh)`` with the hand-written
    backward: ``xw`` [2, L, 3H, R] is the bias-free input projection and
    ``b_x`` [2, 3H] its bias, whose gradient the backward kernel sums (the
    JAX VJP's ``dbx``).  Returns [L, 2H, R] in ``xw``'s dtype.  ``b_x``,
    ``w_hh`` and ``b_hh`` are cast to that dtype inside, and their
    gradients come back in their own, unrounded, as the JAX VJP casts
    inside ``bigru_core`` (``pallas_gru.py:332-339, 376-382``)."""

    @staticmethod
    def forward(ctx, xw, b_x, w_hh, b_hh):
        dt = xw.dtype
        gates = (xw + b_x.to(dt)[:, None, :, None]).contiguous()
        w_k, b_k = w_hh.to(dt), b_hh.to(dt)
        out = bigru_recurrence(gates, w_k, b_k)
        ctx.save_for_backward(gates, w_k, b_k, out)
        ctx.dtypes = (b_x.dtype, w_hh.dtype, b_hh.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        gates, w_hh, b_hh, out = ctx.saved_tensors
        dgates, dw_hh, db_hh, dbx = bigru_recurrence_bwd(
            gates, w_hh, b_hh, out, dout.contiguous()
        )
        dt_bx, dt_w, dt_b = ctx.dtypes
        return dgates, dbx.to(dt_bx), dw_hh.to(dt_w), db_hh.to(dt_b)
