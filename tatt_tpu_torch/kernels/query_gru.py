"""Bidirectional-GRU recurrence over one row at hidden sizes above the
narrow kernels' 128 (:data:`.gru.MAX_HIDDEN`): CUDA chains, their launch
plan and the ``autograd.Function`` that joins them.

The TP Interpreter's query GRU (``models/tp_interpreter.py:query_pos``, in
width mode) runs a BiGRU of hidden 512 over the 64 columns of its query
table, one row.  No TPU kernel stands behind it: the JAX package keeps it
on ``lax.scan`` (``tatt_tpu/kernels/rnn.py:bigru_apply``), and the port ran
it as a plain loop of 64 steps of about ten launches each, with autograd
replaying them in the backward: ~50-100 ms of host time a TATT step, while
the card needs microseconds for the work.  ``csrc/query_gru.cu`` walks each
direction's whole chain in one launch, both directions at once, on two
thread-block clusters that keep W_hh in shared memory (its header says what
bounds it and how the design answers).

:func:`query_gru_recurrence` and :func:`query_gru_recurrence_bwd` take the
narrow kernels' layouts (``gates`` [2, L, 3H, 1], ``out`` [L, 2H, 1]) and
launch the chains for CUDA tensors; for CPU tensors they are
:func:`.gru.bigru_recurrence_ref` and :func:`.gru.bigru_recurrence_bwd_ref`,
which take any hidden size.  float32 only: a bf16 query GRU keeps
``bigru_apply``, which carries h in bf16 as ``lax.scan`` does.
:func:`serves` decides, from the input's device, dtype and rows and the
card's plan, before any launch.
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from tatt_tpu_torch.kernels import _build
from tatt_tpu_torch.kernels.gru import _check, bigru_recurrence_bwd_ref, bigru_recurrence_ref

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
# a launch plan's values, in the order csrc/query_gru.cu writes them
_PLAN_KEYS = ("cluster", "units", "threads", "fwd_smem_bytes", "bwd_smem_bytes",
              "fwd_clusters", "bwd_clusters")
_NO_FIT = -1


def query_gru_plan(hid: int, rows: int, device=None) -> dict | str:
    """How the chains launch at hidden size ``hid`` over ``rows`` rows on
    ``device`` (the current card by default), for logs and for
    :func:`serves`: blocks of a cluster, hidden units and threads of a
    block, each chain's shared-memory bytes, and clusters of each the card
    holds at once.  The reason as a string where the chains refuse the
    shape.  Launches nothing; the plan is made once per (card, H) and kept
    by the library."""
    if rows != 1:
        return f"rows={rows}: the chains take one row (width mode's query table)"
    fn = _build.entry("query_gru", "query_gru_plan", [ctypes.c_int, ctypes.c_void_p])
    values = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(device):
        err = fn(hid, values)
    if err == _NO_FIT:
        return (f"H={hid}: blocks of 3*ceil(H/16) rows of W_hh do not fit shared memory, "
                "or the card holds no cluster of 16 of them")
    _build.check(err, "query_gru_plan")
    return dict(zip(_PLAN_KEYS, values))


def serves(x: torch.Tensor, hid: int) -> bool:
    """Whether a BiGRU of hidden ``hid`` on ``x`` [R, L, In] runs the
    chains: a float32 CUDA tensor of one row, at a hidden size the card's
    plan serves."""
    return (x.device.type == "cuda" and x.dtype == torch.float32 and x.shape[0] == 1
            and isinstance(query_gru_plan(hid, 1, x.device), dict))


def _checked(name, gates, w_hh, b_hh, *more):
    # the narrow kernels' shape checks at any H; the plan bounds H
    length, hid, rows = _check(name, gates.shape[2] // 3, gates, w_hh, b_hh, *more)
    if gates.dtype != torch.float32:
        raise ValueError(f"{name}: float32 only, not {gates.dtype}")
    plan = query_gru_plan(hid, rows, gates.device)
    if isinstance(plan, str):
        raise ValueError(f"{name}: {plan}")
    return length, hid


def query_gru_recurrence(
    gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The forward recurrence: the CUDA chain for a CUDA tensor, the plain
    version for a CPU tensor.  Shapes as :func:`.gru.bigru_recurrence_ref`
    with R = 1.  ``query_gru_recurrence.launches`` counts launches."""
    if gates.device.type == "cpu":
        return bigru_recurrence_ref(gates, w_hh, b_hh)
    length, hid = _checked("query_gru_recurrence", gates, w_hh, b_hh)
    gates, w_hh, b_hh = gates.contiguous(), w_hh.contiguous(), b_hh.contiguous()
    out = torch.empty(length, 2 * hid, 1, device=gates.device, dtype=gates.dtype)
    if length == 0:
        return out
    launch = _build.entry("query_gru", "query_gru_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
                     length, hid, stream)
    _build.check(err, "query_gru_fwd")
    query_gru_recurrence.launches += 1
    return out


query_gru_recurrence.launches = 0


def query_gru_recurrence_bwd(gates, w_hh, b_hh, out, dout):
    """The backward recurrence: the CUDA chain for a CUDA tensor, the plain
    version for a CPU tensor.  Arguments and results as
    :func:`.gru.bigru_recurrence_bwd_ref` with R = 1.  Around the chain, in
    torch: the h each step read (``out`` shifted) and the recomputed
    ``W_hh h_prev + b_hh`` before it, the weight gradient (one batched
    matmul) and the bias sums after it.  ``query_gru_recurrence_bwd.launches``
    counts launches of the chain."""
    if gates.device.type == "cpu":
        return bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout)
    length, hid = _checked("query_gru_recurrence_bwd", gates, w_hh, b_hh, ("out", out),
                           ("dout", dout))
    gates, w_hh, b_hh, dout = (t.contiguous() for t in (gates, w_hh, b_hh, dout))
    h = out[..., 0]
    # direction 0 read h[t-1] at step t, direction 1 read h[t+1]; zeros at the ends
    hprev = torch.stack([F.pad(h[:-1, :hid], (0, 0, 1, 0)), F.pad(h[1:, hid:], (0, 0, 0, 1))])
    gh = torch.baddbmm(b_hh[:, None, :], hprev, w_hh.transpose(1, 2))
    dgates = torch.empty_like(gates)
    dgh = torch.empty_like(gh)
    if length > 0:
        launch = _build.entry("query_gru", "query_gru_bwd", _BWD_ARGTYPES)
        with torch.cuda.device(gates.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(gates.data_ptr(), w_hh.data_ptr(), gh.data_ptr(), hprev.data_ptr(),
                         dout.data_ptr(), dgates.data_ptr(), dgh.data_ptr(), length, hid, stream)
        _build.check(err, "query_gru_bwd")
        query_gru_recurrence_bwd.launches += 1
    dw_hh = torch.bmm(dgh.transpose(1, 2), hprev)
    return dgates, dw_hh, dgh.sum(1), dgates.sum((1, 3))


query_gru_recurrence_bwd.launches = 0


class QueryGRURecurrence(torch.autograd.Function):
    """``out = recurrence(xw + b_x, w_hh, b_hh)`` with the chains' backward,
    float32: ``xw`` [2, L, 3H, 1] is the bias-free input projection and
    ``b_x`` [2, 3H] its bias (``.gru.BiGRURecurrence``'s arguments).
    Returns [L, 2H, 1]."""

    @staticmethod
    def forward(ctx, xw, b_x, w_hh, b_hh):
        gates = (xw + b_x[:, None, :, None]).contiguous()
        out = query_gru_recurrence(gates, w_hh, b_hh)
        ctx.save_for_backward(gates, w_hh, b_hh, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        dgates, dw_hh, db_hh, dbx = query_gru_recurrence_bwd(*ctx.saved_tensors, dout.contiguous())
        return dgates, dbx, dw_hh, db_hh
