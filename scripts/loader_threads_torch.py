"""Loader threads against throughput on the PyTorch port's LMDB data path
(one CUDA card): the loader alone and the canonical recipe trained through
``tatt_tpu_torch.cli.main``, plain, under ``--syn`` and under ``--mixed``,
with 1 and 4 loader threads in turns.

It writes a TextZoom-layout LMDB of ``--crops`` synthetic samples (PNG,
128x32 HR and 64x16 LR), so that an epoch holds many more batches than a
4-thread loader keeps in flight (4 workers + 2 prefetched).  For each mode:

- the loader alone: ``--loader_epochs`` whole epochs a run, ms a batch;
- training: one ``cli.run`` of ``--warm`` steps builds the trainer, then
  ``--steps`` timed steps a run (images/s), each run a new pass of the
  loader.

Runs follow ``--order`` (thread counts, default 1,4,4,1: each count both
first and last).  One JSON line a run, then a summary line of the
median a (mode, threads) and the card's name and power limit.

  python scripts/loader_threads_torch.py [--crops 2048] [--steps 30]
      [--order 1,4,4,1] [--modes plain,syn,mixed]

A CPU rehearsal at a small size: ``--crops 64 --batch 4 --steps 2 --warm 1
--extra "--srb 1 --hd_u 4 --tiny_tpg --device cpu"``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tatt_tpu_torch.cli import main as cli  # noqa: E402
from tatt_tpu_torch.data.lmdb_dataset import LmdbTextDataset, MixDataset  # noqa: E402
from tatt_tpu_torch.data.lmdb_lite import write_lmdb  # noqa: E402
from tatt_tpu_torch.data.loader import DataLoader  # noqa: E402
from tatt_tpu_torch.data.synthetic import SyntheticTextDataset  # noqa: E402

RECIPE = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
          "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss", "--test_model=CRNN"]
MODES = {"plain": [], "syn": ["--syn"], "mixed": ["--mixed"]}


def _png(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def write_corpus(root: str, n: int) -> str:
    ds = SyntheticTextDataset(n=n, seed=41)
    records = {b"num-samples": str(n).encode()}
    for i in range(n):
        hr, lr, label = ds[i]
        records[b"label-%09d" % (i + 1)] = label.encode()
        records[b"image_hr-%09d" % (i + 1)] = _png(hr)
        records[b"image_lr-%09d" % (i + 1)] = _png(lr)
    write_lmdb(root, records)
    return root


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--crops", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--loader_epochs", type=int, default=1)
    ap.add_argument("--order", default="1,4,4,1")
    ap.add_argument("--modes", default="plain,syn,mixed")
    ap.add_argument("--extra", default="", help="more flags for cli.run (a CPU rehearsal)")
    args = ap.parse_args(argv)
    order = [int(w) for w in args.order.split(",")]
    modes = args.modes.split(",")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = write_corpus(os.path.join(tmp, "train"), args.crops)
        print(f"[threads] {args.crops} crops written in {time.perf_counter() - t0:.1f} s", flush=True)
        yaml = os.path.join(tmp, "threads.yaml")
        with open(yaml, "w") as fh:
            fh.write(f"TRAIN:\n  train_data_dir: ['{root}']\n  batch_size: {args.batch}\n"
                     f"  workers: {order[0]}\n  saveInterval: 0\n"
                     f"  ckpt_dir: '{os.path.join(tmp, 'ckpt')}'\n"
                     f"  VAL:\n    val_data_dir: ['{root}']\n    valInterval: 0\n"
                     "    crnn_pretrained: ''\n")
        for mode in modes:
            ds = MixDataset(LmdbTextDataset(root)) if mode == "mixed" else LmdbTextDataset(root)
            for workers in order:
                loader = DataLoader(ds, args.batch, num_workers=workers, syn=mode == "syn", seed=5)
                t0, n = time.perf_counter(), 0
                for _ in range(args.loader_epochs):
                    n += sum(1 for _ in loader)
                row = {"what": "loader", "mode": mode, "threads": workers, "batches": n,
                       "ms_a_batch": (time.perf_counter() - t0) * 1e3 / n}
                rows.append(row)
                print(json.dumps(row), flush=True)
            code, trainer = cli.run(RECIPE + MODES[mode] + args.extra.split()
                                    + ["--config", yaml, "--max_iters", str(args.warm)])
            sync()
            if code != 0:
                print(f"[threads] cli.run {mode}: exit {code}")
                return 1
            for workers in order:
                trainer.loader.num_workers = workers
                t0 = time.perf_counter()
                result = trainer.train(max_iters=trainer.iters + args.steps)
                sync()
                wall = time.perf_counter() - t0
                loss = result["metrics"]["loss_sr"]
                row = {"what": "train", "mode": mode, "threads": workers, "steps": args.steps,
                       "images_per_s": args.steps * args.batch / wall,
                       "loss_sr_last": loss[-1] if loss else None}
                rows.append(row)
                print(json.dumps(row), flush=True)
            del trainer
    summary = {}
    for row in rows:
        key = f"{row['what']} {row['mode']}, {row['threads']} threads"
        summary.setdefault(key, []).append(row.get("ms_a_batch", row.get("images_per_s")))
    print("[threads] median (loader: ms a batch; train: images/s) over "
          f"{args.crops} crops at batch {args.batch} ({card()}): "
          + json.dumps({k: statistics.median(v) for k, v in summary.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
