"""Whether the recipe's training repeats bit for bit on one CUDA card.

Runs ``cli.run`` of the canonical recipe at batch 64 for a few steps twice
in one process, in three modes and with the rotation on and off, and
prints how many entries of the state (both models' ``state_dict``s and
Adam's) differ between the two runs of a pair:

- ``autotuned``: the port's flags (``core/device.set_cuda_flags``);
- ``cudnn-deterministic``: ``torch.backends.cudnn.deterministic``;
- ``deterministic-algorithms``: ``torch.use_deterministic_algorithms(True,
  warn_only=True)`` (the setting phase 20 of ``chip_smoke.py`` compares
  bits under).

  python3 scripts/cuda_repeatability.py [--steps 4]

The rotation's backward (``F.grid_sample``'s input gradient) adds with
atomics on CUDA, so the pairs with it are not expected to repeat.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = ["--arch=tatt", "--STN", "--mask", "--use_distill", "--gradient", "--sr_share",
          "--stu_iter=1", "--rotate_train=5.0", "--tssim_loss", "--test_model=CRNN"]
BATCH = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cuda_repeatability: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from tatt_tpu_torch.cli import main as cli
    from tatt_tpu_torch.cli.launch import state_of

    # one process on one card (--dp_devices 0, the default, takes them all)
    base = RECIPE + ["--dp_devices", "1", "--batch_size", str(BATCH), "--max_iters", str(args.steps),
                     "--synthetic", str(args.steps * BATCH), "--vis_dir", "repeatability"]
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for mode in ("autotuned", "cudnn-deterministic", "deterministic-algorithms"):
        torch.backends.cudnn.deterministic = mode == "cudnn-deterministic"
        torch.use_deterministic_algorithms(mode == "deterministic-algorithms", warn_only=True)
        for rotate in ("5.0", "0"):
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                code, trainer = cli.run(base + [f"--rotate_train={rotate}"])
                torch.cuda.synchronize()
                if code:
                    print(f"cli.run exited {code}", file=sys.stderr)
                    return code
                runs.append((state_of(trainer.generators + trainer.students, trainer.optimizer),
                             time.perf_counter() - t0))
                del trainer
            (a, ta), (b, tb) = runs
            bad = [k for k in a if not torch.equal(a[k], b[k])]
            print(f"[repeat] {mode}, --rotate_train={rotate}: {len(bad)} of {len(a)} entries "
                  f"differ between two runs of {args.steps} steps ({ta:.1f} s, {tb:.1f} s)"
                  + (f"; first {bad[:3]}" if bad else ""), flush=True)
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
