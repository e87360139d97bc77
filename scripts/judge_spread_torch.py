"""Run-to-run and seed-to-seed spread of the fixture judge's CTC
pretraining recipe on the PyTorch port (one CUDA card).

The recipe of ``experiments/train_fixture_judge.py``: a CRNN with nh=64,
nm=(16, 32, 64, 64, 128, 128, 128), batch 128, lr 1e-3, on the 16,384
synthetic crops of seed 7, word accuracy on the 256 held-out crops of
seed 991, through ``tatt_tpu_torch.train.pretrain.pretrain_recognizer``.
Each run is a process of its own, so that cuDNN's autotuning starts
afresh as in a new run of the trainer.  A run is ``MODE:SEED``; the seed
draws the initial weights, the batches and the augmentation.  Modes:

- ``default``: the entry points' settings (``set_cuda_flags``: cuDNN
  autotuning on);
- ``cudnn-deterministic``: those, then ``cudnn.benchmark`` off and
  ``cudnn.deterministic`` on;
- ``deterministic``: that, and ``torch.use_deterministic_algorithms``
  (warnings only, so an op without a deterministic form still runs and is
  named in the run's output).

  python scripts/judge_spread_torch.py --steps 300 --eval_every 20 \\
      default:0 default:0 cudnn-deterministic:0 cudnn-deterministic:0

prints one JSON line a run (mode, seed, steps, mean loss of each window of
``eval_every`` steps, held-out word accuracy, seconds) and, for each
(mode, seed) run more than once, whether the runs' window losses are
bitwise equal and the first window where they differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NH, NM = 64, (16, 32, 64, 64, 128, 128, 128)
TRAIN_SEED, TRAIN_N, HELDOUT_SEED, HELDOUT_N = 7, 16384, 991, 256


def _render(job):
    """HR crops (uint8) and labels of samples ``lo .. hi - 1`` of
    ``SyntheticTextDataset(seed=seed)``, in a worker process."""
    import numpy as np

    from tatt_tpu_torch.data.synthetic import SyntheticTextDataset

    seed, lo, hi = job
    ds = SyntheticTextDataset(n=hi, seed=seed)
    return [(np.asarray(ds[i][0].convert("RGB")), ds[i][2]) for i in range(lo, hi)]


class _Crops:
    """(HR, None, label) samples of rendered crops."""

    def __init__(self, crops):
        self.crops = crops

    def __len__(self) -> int:
        return len(self.crops)

    def __getitem__(self, i):
        from PIL import Image

        hr, label = self.crops[i]
        return Image.fromarray(hr), None, label


def render(seed: int, n: int) -> _Crops:
    """The first ``n`` samples of ``SyntheticTextDataset(seed=seed)``, by
    forked workers started before any CUDA state exists."""
    import concurrent.futures
    import multiprocessing

    jobs = [(seed, lo, min(lo + 512, n)) for lo in range(0, n, 512)]
    with concurrent.futures.ProcessPoolExecutor(
            min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("fork")) as pool:
        return _Crops([c for chunk in pool.map(_render, jobs) for c in chunk])


def child(mode: str, seed: int, steps: int, eval_every: int) -> dict:
    """One run of the recipe in this process."""
    import warnings

    t0 = time.perf_counter()
    train, heldout = render(TRAIN_SEED, TRAIN_N), render(HELDOUT_SEED, HELDOUT_N)
    render_s = time.perf_counter() - t0
    import torch

    from tatt_tpu_torch.core.device import set_cuda_flags
    from tatt_tpu_torch.models.common import init_parameters
    from tatt_tpu_torch.models.recognizers.crnn import CRNN
    from tatt_tpu_torch.train.pretrain import pretrain_recognizer

    set_cuda_flags()
    if mode in ("cudnn-deterministic", "deterministic"):
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
    if mode == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
    crnn = init_parameters(CRNN(nh=NH, nm=NM), seed)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = pretrain_recognizer(crnn, train, steps=steps, batch_size=128, lr=1e-3, seed=seed,
                                  eval_dataset=heldout, eval_every=eval_every, log_fn=None,
                                  device="cuda")
    torch.cuda.synchronize()
    return {"mode": mode, "seed": seed, "steps": steps, "render_s": render_s,
            "train_s": time.perf_counter() - t0,
            "window_loss": [h["loss"] for h in res.history],
            "accuracy": [h["acc"] for h in res.history],
            "final_accuracy": res.final_accuracy,
            "nondeterministic_ops": sorted({str(w.message).split(" does not")[0]
                                            for w in caught if "deterministic" in str(w.message)}),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+", metavar="MODE:SEED")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        mode, seed = args.runs[0].split(":")
        print("RESULT " + json.dumps(child(mode, int(seed), args.steps, args.eval_every)))
        return 0
    results = []
    for run in args.runs:
        mode, _ = run.split(":")
        env = dict(os.environ)
        if mode == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", run, "--steps", str(args.steps),
             "--eval_every", str(args.eval_every)],
            cwd=ROOT, env={**env, "PYTHONPATH": ROOT}, capture_output=True, text=True, check=False)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(f"run {run} failed (exit {out.returncode}): {out.stderr[-2000:]}")
            return 1
        results.append(json.loads(lines[-1][len("RESULT "):]))
        print(json.dumps(results[-1]), flush=True)
    groups: dict = {}
    for r in results:
        groups.setdefault((r["mode"], r["seed"]), []).append(r["window_loss"])
    for (mode, seed), runs in groups.items():
        if len(runs) < 2:
            continue
        first = runs[0]
        diverge = [next((i for i, (a, b) in enumerate(zip(first, other)) if a != b), None)
                   for other in runs[1:]]
        print(json.dumps({"mode": mode, "seed": seed, "runs": len(runs),
                          "bitwise_equal": all(d is None for d in diverge),
                          "first_differing_window": diverge}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
