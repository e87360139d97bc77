"""The benchmark of ``tatt_tpu_torch`` on NVIDIA cards.

    python3 -m stisr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process renders the cell's data,
builds the port's trainer or evaluator, warms it up, measures for
``--seconds``, checks what the measured path produced against the plain
reference in ``stisr_bench/reference``, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (and ``breakdown`` when traced), then ``checks``, each number
compared beside its limit.  It refuses, with no result line, a machine
without enough CUDA cards, and a process that loaded JAX or the JAX
package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    from stisr_bench import bench, guard

    cell = bench.Cell(args.workload)
    guard.require_cards(cell.chips)
    cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    main()
