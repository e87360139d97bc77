"""The control on the card: the reference computed with TF32, the step
below the float32 that the configurations state, put in the program's
place, fails at least one of the cell's committed limits, and so does
half of each batch left out.  At batch 32 and a quarter of the crops, so
that a test run holds it; the full-size readings, the program's among
them, come from ``python3 -m stisr_bench.calibrate``."""

import math

import pytest
import torch

from stisr_bench import bench, checks

CELLS = ["tatt-train-b256", "tsrn-train-b256", "tatt-eval-b256"]


def smaller(name: str):
    cell = bench.Cell(name)
    cell.workload = dict(cell.workload, batch=32)
    cell.config = dict(cell.config, train_pairs=1024,
                       test_sets={k: v // 4 for k, v in cell.config["test_sets"].items()})
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_a_fault_fail_the_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = smaller(name)
    limits = cell.workload["limits"]
    got = cell.driver().calibrate_seed(cell, 2**31 + 1234, True)
    for kind in ("control", "half_batch"):
        ok, compared = checks.verdict(got[kind], limits)
        assert not ok, (kind, compared)
        assert any(not math.isfinite(c["value"]) or c["value"] > c["limit"]
                   for c in compared.values())
