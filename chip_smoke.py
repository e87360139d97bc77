"""Smoke run of tatt_tpu_torch on one CUDA card: the port's eval and
training paths at full width, with all four hand-written kernels held
against their plain PyTorch versions.

  python3 chip_smoke.py
  python3 chip_smoke.py --forward-kernels-only   # phases 1-2 alone
  python3 chip_smoke.py --kernels-only           # phases 1, 2 and 6 alone
  python3 chip_smoke.py --lstm-bwd-only          # phase 1 and the LSTM backward of phase 6
  python3 chip_smoke.py --gru-fwd-only           # phase 1 and the BiGRU forward of phase 2

Phases (any failure exits non-zero; no phase carries on after its own):
  1. card name and power limit; build the CUDA kernels from csrc/
  2. each forward kernel against its plain version at the main paths'
     shapes, with timings of kernel (the smaller of CUDA events and its own
     device time in a profiler window), plain version and cuDNN, a launch at
     L=1 and so the time of a step, and the launch plan; the LSTM kernel
     also with its cell states, beside the input projection (cuDNN's time
     includes it)
  3. the full-width eval path (Evaluator over 256 synthetic images at
     batch 64), launch counts, and one batch on the card against the CPU
  4. the trained fixture judge reads HR through the LSTM kernel
  5. a profiler window over one eval batch: device time by kernel
  6. each backward kernel against its plain twin at the training path's
     shapes (and the LSTM forward's cell states), with timings of kernel,
     plain twin and a cuDNN forward+backward; for both backward kernels
     also the device time of each of their entries (recurrence,
     weight-gradient pass, ...), a launch at L=1 and so the time of a step,
     and the launch plan
  7. the full-width training path: Trainer.train with the canonical recipe
     at batch 64, images/s, launches per step, finite and falling losses
  8. one full-width train step at batch 8 on the card (kernels) against
     the same step on the CPU (plain twins): each parameter's gradient
  9. a profiler window over a few train steps: device time by kernel
The last line is the JSON object the chip check reads.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from tatt_tpu_torch.core.charset import ctc_greedy_decode, str_filt  # noqa: E402
from tatt_tpu_torch.core.convert import from_jax, load_npz  # noqa: E402
from tatt_tpu_torch.core.device import set_cuda_flags  # noqa: E402
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset  # noqa: E402
from tatt_tpu_torch.kernels import _build  # noqa: E402
from tatt_tpu_torch.data.collate import collate  # noqa: E402
from tatt_tpu_torch.kernels.gru import (  # noqa: E402
    bigru_bwd_plan, bigru_fwd_plan, bigru_recurrence, bigru_recurrence_bwd,
    bigru_recurrence_bwd_ref, bigru_recurrence_ref,
)
from tatt_tpu_torch.kernels.lstm import (  # noqa: E402
    bilstm_bwd_plan, bilstm_fwd_plan, bilstm_recurrence, bilstm_recurrence_bwd,
    bilstm_recurrence_bwd_ref, bilstm_recurrence_ref,
)
from tatt_tpu_torch.kernels.rnn import BiGRU, BiLSTM, compose_input_projection  # noqa: E402
from tatt_tpu_torch.models.common import init_parameters  # noqa: E402
from tatt_tpu_torch.models.recognizers.crnn import CRNN, parse_crnn_input  # noqa: E402
from tatt_tpu_torch.models.tsrn import TATT  # noqa: E402
from tatt_tpu_torch.train.loop import Evaluator, Trainer, to_device  # noqa: E402
from tatt_tpu_torch.train.steps import StepConfig, eval_step, train_step  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(HERE, "tests", "assets", "fixture_crnn.npz")
DEV = torch.device("cuda")
BATCH = 64
# f32 kernel vs plain f32 on the same card: the two differ only in the
# summation order of each step's matvec (~1e-7 relative), which the gates
# contract over the sequence
KERNEL_ATOL = 1e-5
# the whole generator, card (cuDNN convs in full f32, the kernels) vs CPU
# (oneDNN convs, the plain recurrences): ~40 layers of f32 arithmetic in
# different orders, each ~1e-6 relative on activations of order 1-10
SR_ATOL = 2e-4
# backward kernel vs plain twin, each error over the largest |value| of its
# output (at least 1): d(gates) repeat the per-step f32 maths (1e-5); the
# weight and bias gradients sum over every (row, step) pair, up to 131,072
# of them, in another order (1e-4)
DGATES_TOL, DW_TOL = 1e-5, 1e-4
# one full-width train step at batch 8, card vs CPU, leaf by leaf:
# ||card - CPU|| / ||CPU|| of each parameter's gradient, the CPU norm
# floored at LEAF_FLOOR of the model's largest leaf norm (a leaf whose
# gradient vanishes analytically, a conv bias before train-mode BatchNorm,
# holds only rounding noise).  The leaves of the BiGRUs and BiLSTMs, where
# a kernel fault shows first, within RNN_LEAF_TOL; the rest within
# LEAF_TOL: the CRNN's max pools with overlapping windows (stride 1 along
# the width) route a gradient to the other of two near-equal inputs when
# rounding flips their order, and one such flip moves ~2e-3 of the norm of
# the first convs' gradients (printed beside the float32-vs-float64
# readings of the CPU step itself)
LEAF_FLOOR, RNN_LEAF_TOL, LEAF_TOL = 1e-2, 1e-4, 1e-2
STEP_BATCH = 8
PROFILE_STEPS = 5
TRAIN_WARM, TRAIN_STEPS = 5, 30
# per train step, fused tssim: 5 GruBlocks x (gru1, gru2) forward and
# backward; the student's two BiLSTMs forward (with c) and backward, the
# frozen teacher's two forward only
STEP_LAUNCHES = {"bigru_fwd": 10, "bigru_bwd": 10, "bilstm_fwd": 4, "bilstm_bwd": 2}
COUNTERS = {
    "bigru_fwd": bigru_recurrence, "bigru_bwd": bigru_recurrence_bwd,
    "bilstm_fwd": bilstm_recurrence, "bilstm_bwd": bilstm_recurrence_bwd,
}
# the GRU backward's device entries (csrc/bigru_bwd.cu), by what each does
GRU_BWD_ENTRIES = {"recurrence": "bigru_bwd_rec", "dw": "bigru_bwd_dw", "sums": "sum_partials"}
# the LSTM backward's device entries (csrc/bilstm_bwd.cu)
LSTM_BWD_ENTRIES = {"gates": "bilstm_bwd_gates", "recurrence": "bilstm_bwd_rec",
                    "dw": "bilstm_bwd_dw"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def fail(msg: str) -> None:
    """Stop the run: a failed phase ends it, with no result line."""
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call, CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(kind: str, length: int, rows: int, hid: int, backward: bool = False):
    """Least time (ms) for one launch, and what sets it: each input read
    once and each output written once at the HBM rate, or the float32
    operations (matvec multiply-adds as 2, each gate nonlinearity and
    elementwise op as 1) at the f32 peak.  Forward: gates in, h out (and
    weights).  Backward: gates, h, dy (and the LSTM's c) in, d(gates) out,
    weights in and their gradients out; per row-step three matvec-sized
    products (the gate recompute, W^T d(gates), d(gates) h_prev^T)."""
    g = (3 if kind == "gru" else 4) * hid
    seq = length * rows * 2 * hid  # one [.., 2H] sequence
    weights = 2 * g * hid + 2 * g
    if backward:
        n_seq = 2 if kind == "gru" else 3  # h, dy (, c)
        nbytes = 4 * (2 * 2 * length * rows * g + n_seq * seq + 2 * weights
                      + (2 * g if kind == "gru" else 0))  # the GRU's input-bias grad
        per_row_step = 3 * 2 * g * hid + (30 if kind == "gru" else 24) * hid
    else:
        nbytes = 4 * (2 * length * rows * g + seq + weights)
        per_row_step = 2 * g * hid + (14 if kind == "gru" else 12) * hid
    flops = 2 * length * rows * per_row_step
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def scaled_err(got, want) -> float:
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def _gru_weights(length, rows, cin, cmid, hid, gen):
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=gen).mul_(sc).to(DEV)  # noqa: E731
    x = rnd(rows, length, cin)
    pre_k, pre_b = rnd(cmid, cin, sc=cin**-0.5), rnd(cmid, sc=0.1)
    b = hid**-0.5
    w_ih, w_hh = rnd(2, 3 * hid, cmid, sc=b), rnd(2, 3 * hid, hid, sc=b)
    b_ih, b_hh = rnd(2, 3 * hid, sc=b), rnd(2, 3 * hid, sc=b)
    w_eff, b_eff = compose_input_projection(w_ih, b_ih, pre_k, pre_b)
    gates = (torch.einsum("rli,dgi->dlgr", x, w_eff) + b_eff[:, None, :, None]).contiguous()
    return x, w_eff, b_eff, w_hh, b_hh, gates


def _library_rnn(cls, cin, hid, w_ih, w_hh, b_ih, b_hh):
    lib = cls(cin, hid, bidirectional=True, batch_first=True).to(DEV)
    with torch.no_grad():
        for d, sfx in enumerate(("l0", "l0_reverse")):
            getattr(lib, f"weight_ih_{sfx}").copy_(w_ih[d])
            getattr(lib, f"weight_hh_{sfx}").copy_(w_hh[d])
            getattr(lib, f"bias_ih_{sfx}").copy_(b_ih[d])
            getattr(lib, f"bias_hh_{sfx}").copy_(b_hh[d])
    return lib


def _library_fwd_bwd(lib, x, dy):
    """One cuDNN forward + backward of the same function (a yardstick)."""
    xg = x.detach().requires_grad_()
    torch.autograd.grad(lib(xg)[0], [xg, *lib.parameters()], dy)


def check_gru(name, length, rows, cin, cmid, hid, gen):
    """gates as GruBlock makes them: x [R, L, Cin] through the folded 1x1
    conv into the input projection."""
    x, w_eff, b_eff, w_hh, b_hh, gates = _gru_weights(length, rows, cin, cmid, hid, gen)
    out = bigru_recurrence(gates, w_hh, b_hh)
    ref = bigru_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lib = _library_rnn(torch.nn.GRU, cin, hid, w_eff, w_hh, b_eff, b_hh)
    lib_err = (lib(x)[0] - ref.permute(2, 0, 1)).abs().max().item()
    kernel = kernel_time(lambda: bigru_recurrence(gates, w_hh, b_hh), "bigru_fwd")
    # one step alone: set-up (W_hh into shared memory) plus one step
    first = gates[:, :1].contiguous()
    one_step = kernel_time(lambda: bigru_recurrence(first, w_hh, b_hh), "bigru_fwd")
    # the two passes before the kernel on the module's path (rnn.BiGRU): the
    # input projection, then its bias into a contiguous gates tensor
    xw = torch.einsum("rli,dgi->dlgr", x, w_eff)
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin, max_abs_err=err, tol=KERNEL_ATOL,
        kernel_ms=kernel["ms"], kernel_event_ms=kernel["event_ms"],
        kernel_profiler_ms=kernel["profiler_ms"], one_step_ms=one_step["ms"],
        projection_ms=timed_ms(lambda: torch.einsum("rli,dgi->dlgr", x, w_eff), 50),
        bias_ms=timed_ms(lambda: (xw + b_eff[:, None, :, None]).contiguous(), 50),
        plain_ms=timed_ms(lambda: bigru_recurrence_ref(gates, w_hh, b_hh), 5),
        library_ms=timed_ms(lambda: lib(x), 50), library_err=lib_err,
        plan=bigru_fwd_plan(hid, rows),
    )
    row["bound_ms"], row["bound_by"] = bound("gru", length, rows, hid)
    return row


def print_gru(row) -> None:
    """A forward BiGRU shape's launch, its time a step ((launch - launch at
    L=1) / (L - 1)), the passes before it, and its plan."""
    step_us = (row["kernel_ms"] - row["one_step_ms"]) / (row["L"] - 1) * 1e3
    print(f"[gru] {row['shape']}: kernel {row['kernel_ms']:.4f} ms (events "
          f"{row['kernel_event_ms']:.4f}, profiler {row['kernel_profiler_ms']}); at L=1 "
          f"{row['one_step_ms']:.4f} ms; {step_us:.2f} us a step; bound {row['bound_ms']:.4f} ms; "
          f"before it: projection {row['projection_ms']:.4f} + bias {row['bias_ms']:.4f} ms; "
          f"nn.GRU {row['library_ms']:.4f} ms; plan {json.dumps(row['plan'])}")


def _lstm_weights(length, rows, cin, hid, gen):
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=gen).mul_(sc).to(DEV)  # noqa: E731
    b = hid**-0.5
    x = rnd(rows, length, cin)
    w_ih, w_hh = rnd(2, 4 * hid, cin, sc=b), rnd(2, 4 * hid, hid, sc=b)
    b_ih, b_hh = rnd(2, 4 * hid, sc=b), rnd(2, 4 * hid, sc=b)
    gates = torch.matmul(x, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None]
    return x, w_ih, w_hh, b_ih, b_hh, gates


def self_ms_by_name(fn, kernels, iters: int) -> dict:
    """For each name in ``kernels``, the mean self device time (ms) per call
    of the device kernels whose name holds it, from one profiler window over
    ``iters`` calls of ``fn`` (after warm-up); None when the profiler
    records no device time for it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    totals = {k: sum(e.self_device_time_total for e in events if k in e.key) for k in kernels}
    return {k: v / 1e3 / iters if v > 0 else None for k, v in totals.items()}


def kernel_self_ms(fn, kernel: str, iters: int):
    """Mean self device time (ms) per call of the device kernels whose name
    holds ``kernel`` (see :func:`self_ms_by_name`)."""
    return self_ms_by_name(fn, (kernel,), iters)[kernel]


def kernel_time(fn, kernel: str) -> dict:
    """A kernel's time per launch two ways: CUDA events around 50
    back-to-back calls (which, at tens of us a launch, may time the Python
    wrapper rather than the card) and the kernel's own device time in a
    profiler window; ``ms`` is the smaller."""
    event_ms = timed_ms(fn, 50)
    prof_ms = kernel_self_ms(fn, kernel, 20)
    return {"ms": event_ms if prof_ms is None else min(event_ms, prof_ms),
            "event_ms": event_ms, "profiler_ms": prof_ms}


def check_lstm(name, length, rows, cin, hid, gen):
    """The forward kernel against its plain version, timed without and
    with the cell states (training asks for them in half its launches),
    beside the input projection that runs before it and cuDNN's
    ``nn.LSTM``, which includes that projection."""
    x, w_ih, w_hh, b_ih, b_hh, gates = _lstm_weights(length, rows, cin, hid, gen)
    out = bilstm_recurrence(gates, w_hh, b_hh)
    ref = bilstm_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lib = _library_rnn(torch.nn.LSTM, cin, hid, w_ih, w_hh, b_ih, b_hh)
    lib_err = (lib(x)[0] - ref).abs().max().item()
    no_cs = kernel_time(lambda: bilstm_recurrence(gates, w_hh, b_hh), "bilstm_fwd")
    with_cs = kernel_time(lambda: bilstm_recurrence(gates, w_hh, b_hh, with_cs=True), "bilstm_fwd")
    # one step alone: set-up (W_hh into shared memory) plus one step, so that
    # (kernel_ms - one_step_ms) / (L - 1) is the time of a step
    first = gates[:, :, :1].contiguous()
    one_step = kernel_time(lambda: bilstm_recurrence(first, w_hh, b_hh), "bilstm_fwd")
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin, max_abs_err=err, tol=KERNEL_ATOL,
        kernel_ms=no_cs["ms"], kernel_event_ms=no_cs["event_ms"],
        kernel_profiler_ms=no_cs["profiler_ms"], kernel_cs_ms=with_cs["ms"],
        one_step_ms=one_step["ms"],
        projection_ms=timed_ms(
            lambda: torch.matmul(x, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None], 50),
        plain_ms=timed_ms(lambda: bilstm_recurrence_ref(gates, w_hh, b_hh), 5),
        library_ms=timed_ms(lambda: lib(x), 50), library_err=lib_err,
    )
    row["bound_ms"], row["bound_by"] = bound("lstm", length, rows, hid)
    return row


def check_gru_bwd(name, length, rows, cin, cmid, hid, gen):
    """The backward kernel against its plain twin on the forward's saved
    h and a random dL/dout; every output: d(gates), dW_hh, db_hh and the
    input-bias gradient."""
    x, w_eff, b_eff, w_hh, b_hh, gates = _gru_weights(length, rows, cin, cmid, hid, gen)
    out = bigru_recurrence_ref(gates, w_hh, b_hh)
    dout = torch.randn(out.shape, generator=gen).to(DEV)
    got = bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout)
    want = bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout)
    torch.cuda.synchronize()
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    lib = _library_rnn(torch.nn.GRU, cin, hid, w_eff, w_hh, b_eff, b_hh)
    dy = dout.permute(2, 0, 1).contiguous()
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin,
        max_abs_err=max((g - w).abs().max().item() for g, w in zip(got, want)),
        scaled_err={k: e for k, e in zip(("dgates", "dw_hh", "db_hh", "dbx"), errs)},
        ok=errs[0] <= DGATES_TOL and max(errs[1:]) <= DW_TOL,
        kernel_ms=timed_ms(lambda: bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout), 20),
        plain_ms=timed_ms(lambda: bigru_recurrence_bwd_ref(gates, w_hh, b_hh, out, dout), 2),
        library_ms=timed_ms(lambda: _library_fwd_bwd(lib, x, dy), 20),
    )
    row["bound_ms"], row["bound_by"] = bound("gru", length, rows, hid, backward=True)
    # device time by entry, and of a launch at L=1 (set-up, one step, and the
    # weight-gradient pass over one step's rows)
    row["split_ms"] = self_ms_by_name(
        lambda: bigru_recurrence_bwd(gates, w_hh, b_hh, out, dout), GRU_BWD_ENTRIES.values(), 20)
    g1, o1, d1 = gates[:, :1].contiguous(), out[:1].contiguous(), dout[:1].contiguous()
    row["one_step_split_ms"] = self_ms_by_name(
        lambda: bigru_recurrence_bwd(g1, w_hh, b_hh, o1, d1), GRU_BWD_ENTRIES.values(), 20)
    row["plan"] = bigru_bwd_plan(hid, rows)
    return row


def print_bwd_split(tag: str, row, entries: dict) -> None:
    """A backward kernel's launch by entry, and its time a step: (device
    time of the recurrence - the same at L=1) / (L - 1)."""
    split = {k: row["split_ms"][v] for k, v in entries.items()}
    one = {k: row["one_step_split_ms"][v] for k, v in entries.items()}
    if None in split.values() or None in one.values():
        print(f"[{tag}] {row['shape']}: the profiler recorded no device time for an entry: "
              f"{split} / L=1 {one}")
        return
    step_us = (split["recurrence"] - one["recurrence"]) / (row["L"] - 1) * 1e3
    parts = " + ".join(f"{k} {v:.4f}" for k, v in split.items())
    print(f"[{tag}] {row['shape']}: launch {row['kernel_ms']:.4f} ms (events), device "
          f"{sum(split.values()):.4f} ms = {parts}; at L=1 device "
          f"{sum(one.values()):.4f} ms (recurrence {one['recurrence']:.4f}); "
          f"{step_us:.2f} us a step; plan {json.dumps(row['plan'])}")


def check_lstm_bwd(name, length, rows, cin, hid, gen):
    """The backward kernel against its plain twin (d(gates), dW_hh,
    db_hh), and the forward kernel's cell states against the plain c."""
    x, w_ih, w_hh, b_ih, b_hh, gates = _lstm_weights(length, rows, cin, hid, gen)
    out, cs = bilstm_recurrence_ref(gates, w_hh, b_hh, with_cs=True)
    k_out, k_cs = bilstm_recurrence(gates, w_hh, b_hh, with_cs=True)
    dout = torch.randn(out.shape, generator=gen).to(DEV)
    got = bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout)
    want = bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout)
    torch.cuda.synchronize()
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    cs_err = max((k_out - out).abs().max().item(), (k_cs - cs).abs().max().item())
    lib = _library_rnn(torch.nn.LSTM, cin, hid, w_ih, w_hh, b_ih, b_hh)
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin,
        max_abs_err=max((g - w).abs().max().item() for g, w in zip(got, want)),
        scaled_err={k: e for k, e in zip(("dgates", "dw_hh", "db_hh"), errs)},
        fwd_with_cs_err=cs_err,
        ok=errs[0] <= DGATES_TOL and max(errs[1:]) <= DW_TOL and cs_err <= KERNEL_ATOL,
        kernel_ms=timed_ms(lambda: bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout), 20),
        plain_ms=timed_ms(lambda: bilstm_recurrence_bwd_ref(gates, w_hh, b_hh, out, cs, dout), 2),
        library_ms=timed_ms(lambda: _library_fwd_bwd(lib, x, dout), 20),
    )
    row["bound_ms"], row["bound_by"] = bound("lstm", length, rows, hid, backward=True)
    # device time by entry, and of a launch at L=1 (set-up, one step, and the
    # weight-gradient pass over one step's rows)
    row["split_ms"] = self_ms_by_name(
        lambda: bilstm_recurrence_bwd(gates, w_hh, b_hh, out, cs, dout),
        LSTM_BWD_ENTRIES.values(), 20)
    g1 = gates[:, :, :1].contiguous()
    o1, c1, d1 = (t[:, :1].contiguous() for t in (out, cs, dout))
    row["one_step_split_ms"] = self_ms_by_name(
        lambda: bilstm_recurrence_bwd(g1, w_hh, b_hh, o1, c1, d1), LSTM_BWD_ENTRIES.values(), 20)
    row["plan"] = bilstm_bwd_plan(hid, rows)
    return row


def profile_window(fn, label: str) -> None:
    """Device busy time, idle share and the top kernels of one call of
    ``fn`` under the profiler (device kernels only: an operator's device
    time repeats its kernels')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)  # ranges such as Optimizer.step
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        print(f"[profile] {label}: the profiler recorded no device time: not measured")
        return
    print(f"[profile] {label}: wall {window * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {max(0.0, 1 - busy / (window * 1e3)):.3f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def leaf_errors(ref: dict, got: dict) -> dict:
    """name -> ||got - ref|| / max(||ref||, floor) per leaf."""
    floor = LEAF_FLOOR * max(g.norm().item() for g in ref.values())
    return {k: (got[k] - g).norm().item() / max(g.norm().item(), floor) for k, g in ref.items()}


def rnn_leaves(model) -> set:
    """Names of the parameters of the model's BiGRU and BiLSTM layers."""
    return {f"{m_name}.{p_name}" for m_name, m in model.named_modules()
            if isinstance(m, (BiGRU, BiLSTM)) for p_name, _ in m.named_parameters()}


def load_judge():
    variables, meta = load_npz(ASSET)
    judge = CRNN(nh=int(meta["nh"]), nm=tuple(int(v) for v in meta["nm"]))
    judge.load_state_dict(from_jax(variables))
    return judge.eval()


def backward_kernels(gen, lstm_only: bool = False):
    """Phase 6: each backward kernel against its plain twin at the training
    path's shapes (and the LSTM's at the judge's H=64 and an odd H); fails
    the run on a disagreement.  ``lstm_only``: the LSTM backward alone."""
    gru_bwd_rows = [] if lstm_only else [
        check_gru_bwd("gru1, fused train batch 2B", 16, 2 * BATCH * 64, 128, 64, 32, gen),
        check_gru_bwd("gru2, fused train batch 2B", 64, 2 * BATCH * 16, 64, 64, 32, gen),
        check_gru_bwd("gru1 ragged rows", 16, 2 * BATCH * 64 + 3, 128, 64, 32, gen),
    ]
    lstm_bwd_rows = [
        check_lstm_bwd("student rnn0", 26, BATCH, 512, 256, gen),
        check_lstm_bwd("student rnn1", 26, BATCH, 256, 256, gen),
        check_lstm_bwd("student rnn0 ragged rows", 26, BATCH - 3, 512, 256, gen),
        check_lstm_bwd("judge rnn0 (H=64)", 26, BATCH, 128, 64, gen),
        check_lstm_bwd("odd H=63", 26, BATCH, 128, 63, gen),
        # an odd H that an earlier design of the backward refused, though the
        # forward served it: held on every run
        check_lstm_bwd("odd H=111", 26, BATCH, 256, 111, gen),
    ]
    for row in gru_bwd_rows + lstm_bwd_rows:
        print("[kernel-bwd] " + json.dumps(row))
        if not row["ok"]:
            fail(f"backward kernel {row['shape']}: {row}")
    for row in gru_bwd_rows:
        print_bwd_split("gru-bwd", row, GRU_BWD_ENTRIES)
    for row in lstm_bwd_rows:
        print_bwd_split("lstm-bwd", row, LSTM_BWD_ENTRIES)
    return gru_bwd_rows, lstm_bwd_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forward-kernels-only", action="store_true",
                    help="stop after phase 2 (a quick look at the forward kernels' "
                         "accuracy and times); prints no result line")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1, 2 and 6 alone (every kernel against its plain "
                         "version, with times); prints no result line")
    ap.add_argument("--lstm-bwd-only", action="store_true",
                    help="run phase 1 and the LSTM backward of phase 6 alone (to time "
                         "versions of that kernel in turns); prints no result line")
    ap.add_argument("--gru-fwd-only", action="store_true",
                    help="run phase 1 and the BiGRU forward rows of phase 2 alone (to time "
                         "versions of that kernel in turns); prints no result line")
    args = ap.parse_args(argv)
    set_cuda_flags()  # full f32 (no TF32) and cuDNN autotuning
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] nvcc of {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, report in _build.ptxas_report.items():
        # per entry function (its mangled name, template arguments included):
        # registers and spills
        regs = [ln.split("'")[1] if "Compiling entry function" in ln else ln.strip()
                for ln in report.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry function" in ln]
        print(f"[build] {name}: {' | '.join(regs)}")
    for hid, rows in ((256, BATCH), (256, BATCH - 3), (64, BATCH)):
        print(f"[build] bilstm_fwd plan at H={hid} R={rows}: {json.dumps(bilstm_fwd_plan(hid, rows))}")
    for hid, rows in ((256, BATCH), (256, BATCH - 3), (64, BATCH), (111, BATCH)):
        print(f"[build] bilstm_bwd plan at H={hid} R={rows}: {json.dumps(bilstm_bwd_plan(hid, rows))}")
    for hid, rows in ((32, 2 * BATCH * 64), (32, 2 * BATCH * 16), (128, 2 * BATCH * 16)):
        print(f"[build] bigru_bwd plan at H={hid} R={rows}: {json.dumps(bigru_bwd_plan(hid, rows))}")
    for hid, rows in ((32, 2 * BATCH * 64), (32, 2 * BATCH * 16), (32, BATCH * 64),
                      (32, BATCH * 16), (128, BATCH * 16)):
        print(f"[build] bigru_fwd plan at H={hid} R={rows}: {json.dumps(bigru_fwd_plan(hid, rows))}")

    if args.lstm_bwd_only:
        backward_kernels(torch.Generator().manual_seed(0), lstm_only=True)
        return 0

    # ---- 2. forward kernels against their plain versions at the main paths' shapes
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        # the kernels line reads the training pair, rows 2 and 3
        gru_rows = [
            check_gru("gru1 (height scan), eval batch", 16, BATCH * 64, 128, 64, 32, gen),
            check_gru("gru2 (width scan), eval batch", 64, BATCH * 16, 64, 64, 32, gen),
            check_gru("gru1, fused train batch 2B", 16, 2 * BATCH * 64, 128, 64, 32, gen),
            check_gru("gru2, fused train batch 2B", 64, 2 * BATCH * 16, 64, 64, 32, gen),
            check_gru("gru1 ragged rows", 16, BATCH * 64 + 3, 128, 64, 32, gen),
            check_gru("gru2 odd H=45, ragged rows", 64, BATCH * 16 + 5, 64, 64, 45, gen),
            check_gru("gru2 H=128", 64, BATCH * 16, 64, 64, 128, gen),
        ]
        lstm_rows = [] if args.gru_fwd_only else [
            check_lstm("student/teacher rnn0", 26, BATCH, 512, 256, gen),
            check_lstm("student/teacher rnn1", 26, BATCH, 256, 256, gen),
            check_lstm("judge rnn0 (H=64)", 26, BATCH, 128, 64, gen),
            check_lstm("judge rnn1 (H=64)", 26, BATCH, 64, 64, gen),
            check_lstm("student rnn0 ragged rows", 26, BATCH - 3, 512, 256, gen),
        ]
    for row in gru_rows + lstm_rows:
        print("[kernel] " + json.dumps(row))
        if not row["max_abs_err"] <= KERNEL_ATOL:
            fail(f"kernel {row['shape']}: err {row['max_abs_err']} > {KERNEL_ATOL}")
    for row in gru_rows:
        print_gru(row)
    for row in lstm_rows:
        step_us = (row["kernel_ms"] - row["one_step_ms"]) / (row["L"] - 1) * 1e3
        print(f"[lstm] {row['shape']}: kernel {row['kernel_ms']:.4f} ms "
              f"({step_us:.2f} us a step after {row['one_step_ms']:.4f} ms for set-up and "
              f"step 1; events {row['kernel_event_ms']:.4f}, profiler "
              f"{row['kernel_profiler_ms']}), "
              f"with c {row['kernel_cs_ms']:.4f}; + projection "
              f"{row['kernel_ms'] + row['projection_ms']:.4f} vs nn.LSTM {row['library_ms']:.4f}")
    if args.forward_kernels_only or args.gru_fwd_only:
        return 0
    if args.kernels_only:
        backward_kernels(gen)
        return 0

    # ---- 3. the eval path at full width
    generator = init_parameters(TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True), 1234)
    student = init_parameters(CRNN(), 1235)
    judge = load_judge()
    generator, student, judge = (m.to(DEV).eval() for m in (generator, student, judge))
    evaluator = Evaluator([generator], [student], judge, DEV, batch_size=BATCH, mask=True)
    ds = SyntheticTextDataset(n=256, seed=2)
    warm = SyntheticTextDataset(n=BATCH, seed=3)
    for d in (ds, warm):  # render (and cache) every sample up front
        for i in range(len(d)):
            d[i]
    evaluator.evaluate(warm)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    summary = evaluator.evaluate(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_launches = read_counts()
    n_batches = math.ceil(len(ds) / BATCH)
    print(
        f"[eval] images {summary['images']} psnr {summary['psnr_avg']:.4f} ssim "
        f"{summary['ssim_avg']:.5f} (bicubic LR: psnr {summary['psnr_avg_lr']:.4f} ssim "
        f"{summary['ssim_avg_lr']:.5f}) acc SR {summary['accuracy']:.4f} LR "
        f"{summary['accuracy_lr']:.4f} HR {summary['accuracy_hr']:.4f} "
        f"images/s {summary['images'] / wall:.1f}"
    )
    print(f"[eval] launches {json.dumps(eval_launches)} over {n_batches} batches of {BATCH}")
    # 10 GruBlocks per generator forward; 2 BiLSTMs per CRNN forward, 4
    # CRNN forwards per batch (student, then the judge on SR, LR, HR); no
    # backward kernel under no_grad
    if eval_launches != {"bigru_fwd": 10 * n_batches, "bigru_bwd": 0,
                         "bilstm_fwd": 8 * n_batches, "bilstm_bwd": 0}:
        fail(f"eval launches {eval_launches} (want 10 and 8 per batch, no backward)")
    for key in ("psnr_avg", "ssim_avg"):
        if not math.isfinite(summary[key]):
            fail(f"eval {key} = {summary[key]}")

    hr, lr, _ = next(evaluator.batches(ds))
    sr_gpu, aux = eval_step([generator], [student], lr)
    if sr_gpu.shape != (BATCH, 4, 32, 128) or not torch.isfinite(sr_gpu).all():
        fail(f"SR shape {tuple(sr_gpu.shape)} or non-finite values")
    gen_cpu, stu_cpu = generator.to("cpu"), student.to("cpu")
    t0 = time.perf_counter()
    sr_cpu, _ = eval_step([gen_cpu], [stu_cpu], lr.cpu())
    cpu_s = time.perf_counter() - t0
    generator, student = gen_cpu.to(DEV), stu_cpu.to(DEV)
    sr_err = (sr_gpu.cpu() - sr_cpu).abs().max().item()
    print(f"[eval] SR card vs CPU (plain recurrences): max abs diff {sr_err:.3e} tol {SR_ATOL} "
          f"(CPU batch took {cpu_s:.1f} s)")
    if not sr_err <= SR_ATOL:
        fail(f"SR card vs CPU {sr_err} > {SR_ATOL}")

    # ---- 4. the trained judge reads HR through the LSTM kernel
    jds = SyntheticTextDataset(n=64, seed=20260818)
    labels = [jds[i][2] for i in range(64)]
    before = bilstm_recurrence.launches

    def word_acc(k):
        imgs = np.stack([np.asarray(jds[i][k].convert("RGB"), np.float32) / 255.0 for i in range(64)])
        with torch.no_grad():
            logits = judge(parse_crnn_input(torch.from_numpy(imgs.transpose(0, 3, 1, 2)).to(DEV)))
        preds = ctc_greedy_decode(logits.cpu().numpy())
        return float(np.mean([str_filt(p, "lower") == str_filt(t, "lower") for p, t in zip(preds, labels)]))

    acc_hr, acc_lr = word_acc(0), word_acc(1)
    print(f"[judge] fixture judge word accuracy HR {acc_hr:.4f} LR {acc_lr:.4f} "
          f"(LSTM launches {bilstm_recurrence.launches - before})")
    if not (acc_hr > 0.85 and acc_hr > acc_lr + 0.2 and bilstm_recurrence.launches - before == 4):
        fail(f"judge HR {acc_hr} LR {acc_lr}")

    # ---- 5. where the device time goes in one eval batch
    with torch.no_grad():
        profile_window(lambda: evaluator.evaluate(warm), "one eval batch")
    del generator, student, judge, evaluator

    # ---- 6. backward kernels against their plain twins at the training path's shapes
    gru_bwd_rows, lstm_bwd_rows = backward_kernels(gen)

    # ---- 7. the training path at full width: Trainer.train, canonical recipe
    torch.manual_seed(0)
    generator = init_parameters(
        TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True, stn=True), 1234
    ).to(DEV)
    student = init_parameters(CRNN(), 1235).to(DEV)
    teacher = init_parameters(CRNN(), 1236).to(DEV)
    train_ds = SyntheticTextDataset(n=8 * BATCH, seed=1)
    for i in range(len(train_ds)):  # render (and cache) every sample up front
        train_ds[i]
    trainer = Trainer(
        generator, student, teacher, train_ds, DEV, StepConfig(),
        batch_size=BATCH, val_interval=0, display_interval=10**9,
    )
    t0 = time.perf_counter()
    first = trainer.train(max_iters=TRAIN_WARM)  # builds, cuDNN autotuning
    torch.cuda.synchronize()
    print(f"[train] warm-up: {TRAIN_WARM} steps in {time.perf_counter() - t0:.2f} s")
    reset_counts()
    t0 = time.perf_counter()
    timed = trainer.train(max_iters=TRAIN_WARM + TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = read_counts()
    per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
    losses = first["metrics"]["loss_total"] + timed["metrics"]["loss_total"]
    print(f"[train] {TRAIN_STEPS} steps at batch {BATCH}: {wall:.3f} s, "
          f"{wall / TRAIN_STEPS * 1e3:.2f} ms per step, "
          f"images/s {TRAIN_STEPS * BATCH / wall:.1f}")
    print(f"[train] launches per step {json.dumps(per_step)}")
    print(f"[train] loss_total by step {json.dumps([round(v, 4) for v in losses])}")
    last = {k: v[-1] for k, v in timed["metrics"].items()}
    print(f"[train] last step {json.dumps(last)}")
    if per_step != {k: float(v) for k, v in STEP_LAUNCHES.items()}:
        fail(f"train launches per step {per_step} (want {STEP_LAUNCHES})")
    if not all(math.isfinite(v) for vals in (first, timed) for m in vals["metrics"].values() for v in m):
        fail("non-finite training metrics")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"loss_total did not fall: {losses[:3]} -> {losses[-3:]}")

    # ---- 8. one train step at full width, batch 8: card (kernels) against CPU (plain twins)
    tatt = TATT(srb_nums=5, hidden_units=32, out_text_channels=64, mask=True, stn=True, dropout=0.0)
    models_cpu = [init_parameters(tatt, 7)] + [init_parameters(CRNN(), s) for s in (8, 9)]
    sds = SyntheticTextDataset(n=STEP_BATCH, seed=5)
    b = collate([sds[i] for i in range(STEP_BATCH)])
    rot = {"rot_arc": torch.linspace(-0.08, 0.08, STEP_BATCH),
           "rot_offs": torch.linspace(0.1, 0.9, STEP_BATCH)}
    grads = {}
    # the CPU step in float32 and in float64 (how far float32 rounding
    # alone moves each gradient), then the card
    for tag, dev, dt in (("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64),
                         ("card", DEV, torch.float32)):
        models = [copy.deepcopy(m).to(dev, dt) for m in models_cpu]
        hr, lr = to_device(b, torch.device(dev), True)
        batch = {"images_hr": hr.to(dt), "images_lr": lr.to(dt),
                 **{k: v.to(dev, dt) for k, v in rot.items()}}
        opt = torch.optim.SGD([p for m in models[:2] for p in m.parameters()], lr=1.0)
        reset_counts()
        t0 = time.perf_counter()
        metrics = train_step(models[0].train(), models[1].train(), models[2].eval(), opt, batch,
                             StepConfig(), torch.Generator(device=dev).manual_seed(0))
        counts = read_counts()
        grads[tag] = [{k: p.grad.double().cpu() for k, p in m.named_parameters()}
                      for m in models[:2]]
        print(f"[step] {tag} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps({k: v.item() for k, v in metrics.items()})} launches {json.dumps(counts)}")
    if counts != STEP_LAUNCHES:
        fail(f"card train step launches {counts} (want {STEP_LAUNCHES})")
    for i, (name, model) in enumerate(zip(("generator", "student"), models_cpu)):
        card = leaf_errors(grads["cpu"][i], grads["card"][i])
        f32 = leaf_errors(grads["cpu64"][i], grads["cpu"][i])
        card64 = leaf_errors(grads["cpu64"][i], grads["card"][i])
        rnn = rnn_leaves(model)
        for what, keys, tol in (("BiGRU/BiLSTM", rnn, RNN_LEAF_TOL),
                                ("other", set(card) - rnn, LEAF_TOL)):
            worst = sorted(keys, key=lambda k: -card[k])
            print(f"[step] {name}, {len(keys)} {what} leaves, ||card - CPU|| / ||CPU|| "
                  f"(tol {tol}; CPU float32 vs float64; card vs CPU float64):")
            for k in worst[:3]:
                print(f"[step]   {card[k]:.3e}  ({f32[k]:.3e}; {card64[k]:.3e})  {k}")
            bad = {k: card[k] for k in worst if not card[k] <= tol}
            if bad:
                fail(f"{name} {what} gradients card vs CPU above {tol}: {bad}")
    del models_cpu, models

    # ---- 9. where the device time goes over a few train steps
    profile_window(lambda: trainer.train(max_iters=trainer.iters + PROFILE_STEPS),
                   f"{PROFILE_STEPS} train steps")
    del trainer, generator, student, teacher

    # ---- the kernels line: per launch, weighted by the training path's mix
    # (per step gru1 and gru2 five times each, forward and backward; the
    # student's and the teacher's rnn0 and rnn1 forward, the student's backward)
    def mix(rows):
        out = {k: float(np.mean([r[k] for r in rows])) for k in
               ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        out["bound_by"] = rows[int(np.argmax([r["bound_ms"] for r in rows]))]["bound_by"]
        return out

    kernels = []
    for name, src, rep, rows, checked in (
        ("bigru_fwd", "tatt_tpu_torch/csrc/bigru_fwd.cu", "tatt_tpu/kernels/pallas_gru.py:63",
         gru_rows[2:4], gru_rows),
        ("bigru_bwd", "tatt_tpu_torch/csrc/bigru_bwd.cu", "tatt_tpu/kernels/pallas_gru.py:132",
         gru_bwd_rows[:2], gru_bwd_rows),
        ("bilstm_fwd", "tatt_tpu_torch/csrc/bilstm_fwd.cu", "tatt_tpu/kernels/pallas_lstm.py:22",
         lstm_rows[:2], lstm_rows),
        ("bilstm_bwd", "tatt_tpu_torch/csrc/bilstm_bwd.cu", "tatt_tpu/kernels/pallas_lstm.py:53",
         lstm_bwd_rows[:2], lstm_bwd_rows),
    ):
        m = mix(rows)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": train_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": m["kernel_ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
