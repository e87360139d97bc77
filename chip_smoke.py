"""Smoke run of tatt_tpu_torch on one CUDA card: the port's eval path at
full width, with both hand-written kernels held against their plain
PyTorch versions.

  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on after its own):
  1. card name and power limit; build the CUDA kernels from csrc/
  2. each kernel against its plain version at the main path's shapes,
     with timings (CUDA events) of kernel, plain version and cuDNN
  3. the full-width eval path (Evaluator over 256 synthetic images at
     batch 64), launch counts, and one batch on the card against the CPU
  4. the trained fixture judge reads HR through the LSTM kernel
  5. a profiler window over one eval batch: device time by kernel
The last line is the JSON object the chip check reads.  Imports no JAX.
"""

from __future__ import annotations

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
from tatt_tpu_torch.kernels.gru import bigru_recurrence, bigru_recurrence_ref  # noqa: E402
from tatt_tpu_torch.kernels.lstm import bilstm_recurrence, bilstm_recurrence_ref  # noqa: E402
from tatt_tpu_torch.kernels.rnn import compose_input_projection  # noqa: E402
from tatt_tpu_torch.models.common import init_parameters  # noqa: E402
from tatt_tpu_torch.models.recognizers.crnn import CRNN, parse_crnn_input  # noqa: E402
from tatt_tpu_torch.models.tsrn import TATT  # noqa: E402
from tatt_tpu_torch.train.loop import Evaluator  # noqa: E402
from tatt_tpu_torch.train.steps import eval_step  # noqa: E402

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


def bound(kind: str, length: int, rows: int, hid: int):
    """Least time (ms) for one launch, and what sets it: each input read
    once and each output written once at the HBM rate, or the float32
    operations (matvec multiply-adds as 2, each gate nonlinearity and
    elementwise op as 1) at the f32 peak."""
    g = (3 if kind == "gru" else 4) * hid
    nbytes = 4 * (2 * length * rows * g + length * rows * 2 * hid + 2 * g * hid + 2 * g)
    per_row_step = 2 * g * hid + (14 if kind == "gru" else 12) * hid
    flops = 2 * length * rows * per_row_step
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gru(name, length, rows, cin, cmid, hid, gen):
    """gates as GruBlock makes them: x [R, L, Cin] through the folded 1x1
    conv into the input projection."""
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=gen).mul_(sc).to(DEV)  # noqa: E731
    x = rnd(rows, length, cin)
    pre_k, pre_b = rnd(cmid, cin, sc=cin**-0.5), rnd(cmid, sc=0.1)
    b = hid**-0.5
    w_ih, w_hh = rnd(2, 3 * hid, cmid, sc=b), rnd(2, 3 * hid, hid, sc=b)
    b_ih, b_hh = rnd(2, 3 * hid, sc=b), rnd(2, 3 * hid, sc=b)
    w_eff, b_eff = compose_input_projection(w_ih, b_ih, pre_k, pre_b)
    gates = (torch.einsum("rli,dgi->dlgr", x, w_eff) + b_eff[:, None, :, None]).contiguous()
    out = bigru_recurrence(gates, w_hh, b_hh)
    ref = bigru_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lib = torch.nn.GRU(cin, hid, bidirectional=True, batch_first=True).to(DEV)
    with torch.no_grad():
        for d, sfx in enumerate(("l0", "l0_reverse")):
            getattr(lib, f"weight_ih_{sfx}").copy_(w_eff[d])
            getattr(lib, f"weight_hh_{sfx}").copy_(w_hh[d])
            getattr(lib, f"bias_ih_{sfx}").copy_(b_eff[d])
            getattr(lib, f"bias_hh_{sfx}").copy_(b_hh[d])
    lib_err = (lib(x)[0] - ref.permute(2, 0, 1)).abs().max().item()
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin, max_abs_err=err, tol=KERNEL_ATOL,
        kernel_ms=timed_ms(lambda: bigru_recurrence(gates, w_hh, b_hh), 50),
        plain_ms=timed_ms(lambda: bigru_recurrence_ref(gates, w_hh, b_hh), 5),
        library_ms=timed_ms(lambda: lib(x), 50), library_err=lib_err,
    )
    row["bound_ms"], row["bound_by"] = bound("gru", length, rows, hid)
    return row


def check_lstm(name, length, rows, cin, hid, gen):
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=gen).mul_(sc).to(DEV)  # noqa: E731
    b = hid**-0.5
    x = rnd(rows, length, cin)
    w_ih, w_hh = rnd(2, 4 * hid, cin, sc=b), rnd(2, 4 * hid, hid, sc=b)
    b_ih, b_hh = rnd(2, 4 * hid, sc=b), rnd(2, 4 * hid, sc=b)
    gates = torch.matmul(x, w_ih.transpose(1, 2)[:, None]) + b_ih[:, None, None]
    out = bilstm_recurrence(gates, w_hh, b_hh)
    ref = bilstm_recurrence_ref(gates, w_hh, b_hh)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lib = torch.nn.LSTM(cin, hid, bidirectional=True, batch_first=True).to(DEV)
    with torch.no_grad():
        for d, sfx in enumerate(("l0", "l0_reverse")):
            getattr(lib, f"weight_ih_{sfx}").copy_(w_ih[d])
            getattr(lib, f"weight_hh_{sfx}").copy_(w_hh[d])
            getattr(lib, f"bias_ih_{sfx}").copy_(b_ih[d])
            getattr(lib, f"bias_hh_{sfx}").copy_(b_hh[d])
    lib_err = (lib(x)[0] - ref).abs().max().item()
    row = dict(
        shape=name, L=length, R=rows, H=hid, In=cin, max_abs_err=err, tol=KERNEL_ATOL,
        kernel_ms=timed_ms(lambda: bilstm_recurrence(gates, w_hh, b_hh), 50),
        plain_ms=timed_ms(lambda: bilstm_recurrence_ref(gates, w_hh, b_hh), 5),
        library_ms=timed_ms(lambda: lib(x), 50), library_err=lib_err,
    )
    row["bound_ms"], row["bound_by"] = bound("lstm", length, rows, hid)
    return row


def load_judge():
    variables, meta = load_npz(ASSET)
    judge = CRNN(nh=int(meta["nh"]), nm=tuple(int(v) for v in meta["nm"]))
    judge.load_state_dict(from_jax(variables))
    return judge.eval()


def main() -> int:
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
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {' | '.join(regs)}")

    # ---- 2. kernels against their plain versions at the main path's shapes
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        gru_rows = [
            check_gru("gru1 (height scan)", 16, BATCH * 64, 128, 64, 32, gen),
            check_gru("gru2 (width scan)", 64, BATCH * 16, 64, 64, 32, gen),
            check_gru("gru1 ragged rows", 16, BATCH * 64 + 3, 128, 64, 32, gen),
        ]
        lstm_rows = [
            check_lstm("student rnn0", 26, BATCH, 512, 256, gen),
            check_lstm("student rnn1", 26, BATCH, 256, 256, gen),
            check_lstm("judge rnn0 (H=64)", 26, BATCH, 128, 64, gen),
            check_lstm("judge rnn1 (H=64)", 26, BATCH, 64, 64, gen),
            check_lstm("student rnn0 ragged rows", 26, BATCH - 3, 512, 256, gen),
        ]
    for row in gru_rows + lstm_rows:
        print("[kernel] " + json.dumps(row))
        if not row["max_abs_err"] <= KERNEL_ATOL:
            fail(f"kernel {row['shape']}: err {row['max_abs_err']} > {KERNEL_ATOL}")

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
    bigru_recurrence.launches = 0
    bilstm_recurrence.launches = 0
    t0 = time.perf_counter()
    summary = evaluator.evaluate(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"bigru_fwd": bigru_recurrence.launches, "bilstm_fwd": bilstm_recurrence.launches}
    n_batches = math.ceil(len(ds) / BATCH)
    print(
        f"[eval] images {summary['images']} psnr {summary['psnr_avg']:.4f} ssim "
        f"{summary['ssim_avg']:.5f} (bicubic LR: psnr {summary['psnr_avg_lr']:.4f} ssim "
        f"{summary['ssim_avg_lr']:.5f}) acc SR {summary['accuracy']:.4f} LR "
        f"{summary['accuracy_lr']:.4f} HR {summary['accuracy_hr']:.4f} "
        f"images/s {summary['images'] / wall:.1f}"
    )
    print(f"[eval] launches {json.dumps(launches)} over {n_batches} batches of {BATCH}")
    # 10 GruBlocks per generator forward; 2 BiLSTMs per CRNN forward, 4
    # CRNN forwards per batch (student, then the judge on SR, LR, HR)
    if launches != {"bigru_fwd": 10 * n_batches, "bilstm_fwd": 8 * n_batches}:
        fail(f"eval launches {launches} (want 10 and 8 per batch)")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluator.evaluate(warm)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device kernels only: an operator's device time repeats its kernels'
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy > 0:
        print(f"[profile] one batch: wall {window * 1e3:.2f} ms, device busy {busy:.2f} ms "
              f"(idle share {max(0.0, 1 - busy / (window * 1e3)):.3f})")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    else:
        print("[profile] the profiler recorded no device time: not measured")

    # ---- the kernels line: per launch, weighted by the main path's mix
    # (gru1 and gru2 five times each per generator forward; per eval batch
    # 2 student BiLSTMs at H=256 and 6 judge BiLSTMs at H=64)
    def mix(rows, weights):
        w = np.asarray(weights, np.float64) / sum(weights)
        out = {k: float(np.dot(w, [r[k] for r in rows])) for k in
               ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
        top = int(np.argmax(w * np.asarray([r["bound_ms"] for r in rows])))
        out["bound_by"] = rows[top]["bound_by"]
        return out

    kernels = []
    for name, src, rep, rows, weights in (
        ("bigru_fwd", "tatt_tpu_torch/csrc/bigru_fwd.cu",
         "tatt_tpu/kernels/pallas_gru.py:63", gru_rows[:2], [1, 1]),
        ("bilstm_fwd", "tatt_tpu_torch/csrc/bilstm_fwd.cu",
         "tatt_tpu/kernels/pallas_lstm.py:22", lstm_rows[:4], [1, 1, 3, 3]),
    ):
        m = mix(rows, weights)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in (gru_rows if name == "bigru_fwd" else lstm_rows)),
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
