"""Tests of the benchmark on the CPU, and of its control on the card.

A test that needs the card carries the ``cuda`` marker and decides inside
the test whether there is one (never while a module is imported), so
that every worker collects the same tests.  ``tiny_cell`` is a cell of
the manifest at a size the CPU runs in seconds: one SRB, the narrow
CRNN of the port's ``--tiny_tpg``, a few dozen crops, batch 4.
"""

import copy
import os

import pytest
import torch

os.environ.setdefault("OMP_NUM_THREADS", "2")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped (with a reason) without one")


@pytest.fixture
def cpu_harness(monkeypatch):
    """The harness on the CPU: the tests drive a run without a card."""
    from stisr_bench import harness

    monkeypatch.setattr(harness, "DEVICE", torch.device("cpu"))
    torch.set_num_threads(2)
    return harness


@pytest.fixture
def tiny_cell():
    from stisr_bench import bench

    def make(name: str, limits=None):
        cell = bench.Cell(name)
        cfg = copy.deepcopy(cell.config)
        cfg["flags"] = cfg["flags"] + ["--tiny_tpg"]
        cfg["recognizer"] = {"nclass": 37, "nh": 16, "nm": [8, 8, 16, 16, 32, 32, 32]}
        cfg["srb"] = 1
        cfg["train_pairs"] = 24
        cfg["test_sets"] = {"easy": 10, "hard": 7}
        cfg["workers"] = 2
        cell.config = cfg
        cell.workload = dict(cell.workload, batch=4)
        if limits is not None:
            cell.workload["limits"] = limits
        cell.mix = dict(cell.mix, trace_steps=2)
        return cell

    return make
