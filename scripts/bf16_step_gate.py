"""Read the margins of ``chip_smoke.py`` phase 18's bf16 step gates on a card.

Each full-width bf16 step of ``--cases`` (``chip_smoke.BF16_STEP_CASES``:
the recipe, ``srresnet_tl`` with the CRNN, the Chinese recipe ``--CHNSR
--tpg OPT``) on the card against the port's CPU bf16 step, at each batch
given, repeated, then with each of the case's planted faults (cuBLAS's
bf16 reduced-precision reduction, a PReLU that promotes to f32, TF32, the
TPG's BatchNorms promoting to f32): the generator's and the student's
whole-model gradient gaps, the worst leaf, the loss gap, and each fault
against the sound card step.  One JSON line a case and batch, then the
card's name and power limit:

  python3 scripts/bf16_step_gate.py --batches 8 64 --repeats 2
  python3 scripts/bf16_step_gate.py --cases srresnet_tl chinese --repeats 4
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (exits without a CUDA card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cases", nargs="+", default=["recipe"], choices=list(chip_smoke.BF16_STEP_CASES))
    args = ap.parse_args()
    chip_smoke.set_cuda_flags()
    chip_smoke._build.build()
    for case in args.cases:
        for batch in args.batches:
            print(json.dumps(chip_smoke.bf16_step_readings(batch, args.repeats, case)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
