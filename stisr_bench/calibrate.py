"""The readings that a cell's limits are set from, on the card.

    python3 -m stisr_bench.calibrate --workload <cell> --seeds 11 12 ... \
        --control-seeds 11 12 13 [--out FILE]

For each seed, in one process and without a measured window, the cell's
mix driver's ``calibrate_seed``: the cell's set-up, the program's first
training steps (or, for an evaluation cell, one warm pass and one
recorded pass), then the reference, and the numbers of ``checks`` for
the program (the lower readings).  On the control seeds also:

- ``control``: the reference with TF32 on put in the program's place
  (the configuration states float32 with TF32 off, so TF32 is the step
  below it);
- ``half_batch``: the reference in the program's place with half of
  every batch left out, the mean taken over the rest.

A state left unchanged reads 1 on ``update_gap`` by construction and
needs no run; an altered answer reads 1 or more on ``strings_off``.  One
JSON line a seed and reading goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from stisr_bench import bench, guard, harness


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = bench.Cell(args.workload)
    if harness.on_card():
        guard.require_cards(cell.chips)
    reading = cell.driver().calibrate_seed
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        got = reading(cell, seed, seed in args.control_seeds)
        for kind, numbers in got.items():
            line = json.dumps({"workload": cell.name, "seed": seed, "reading": kind,
                               "numbers": numbers, "device": harness.device_name()})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        print(f"[calibrate] seed {seed} took {time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)
        harness.free_program()
    guard.require_no_jax()


if __name__ == "__main__":
    main()
