"""The yardstick's arithmetic: the roofline bound, the FLOP count, the
guard's module check, the weights and the refusal without a card."""

import ast
import json
import math
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stisr_bench import bench, guard, harness, program, roofline, weights
from stisr_bench.bounds import recurrence
from stisr_bench.reference import nets, ops

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("kind,length,rows,hid,backward,ms,by", [
    ("gru", 16, 8192, 32, False, 0.0401, "bytes"),
    ("lstm", 26, 64, 256, False, 0.0262, "operations"),
    ("lstm", 26, 64, 256, True, 0.0784, "operations"),
])
def test_bound_reproduces_the_kernel_table(kind, length, rows, hid, backward, ms, by):
    t, what = recurrence.bound(kind, length, rows, hid, backward, H100)
    assert round(t * 1e3, 4) == ms and what == by


def test_peaks_name_the_card():
    assert H100["flops_per_s"]["float32"] == 67e12 and H100["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("cpu") is None


def test_flop_count_matches_a_hand_count():
    """One 3x3 convolution and one GRU step, forward, on meta tensors."""
    with torch.device("meta"):
        conv = nets.Conv2d(4, 8)
        x = torch.zeros(2, 4, 16, 64)
        h = torch.zeros(2, 5, 32)
        w_hh, b = torch.zeros(2, 96, 32), torch.zeros(2, 96)
    with FlopCounterMode(display=False) as c:
        conv(x)
    assert c.get_total_flops() == 2 * 2 * 8 * 16 * 64 * 4 * 9
    with FlopCounterMode(display=False) as c:
        torch.baddbmm(b[:, None], h, w_hh.transpose(1, 2))  # one step of ops.bigru's recurrence
    assert c.get_total_flops() == 2 * 2 * 5 * 96 * 32


@pytest.mark.parametrize("unit_s,seconds,units", [(10.0, 51, 5), (10.5, 51, 4), (60.0, 51, 1),
                                                   (4.0, 51, 12)])
def test_window_is_the_whole_units_that_end_inside_the_seconds(unit_s, seconds, units,
                                                                monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))

    def unit(k):
        clock[0] += unit_s

    each = harness.whole_units(unit, seconds)
    assert each == [unit_s] * units and (units == 1 or sum(each) <= seconds)


@pytest.mark.parametrize("tf32", [False, True])
def test_a_run_states_the_precision_it_computes_in(tf32):
    program.prepare_device(build=False)
    if tf32:
        with pytest.raises(SystemExit, match="TF32 off"):
            harness.require_precision({"tf32": True})
    else:
        harness.require_precision({"tf32": False})
    for name in ("tatt", "tsrn"):
        assert bench.Cell(f"{name}-train-b256").config["tf32"] is False


def test_forbidden_modules_compare_whole_names():
    names = ["tatt_tpu_torch", "tatt_tpu_torch.models", "jaxtyping", "flaxen", "numpy"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(names + ["tatt_tpu.models", "jax", "optax.x"]) == [
        "jax", "optax.x", "tatt_tpu.models"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for folder, _, files in os.walk(bench.HERE):
        for f in files:
            if not f.endswith(".py") or "tests" in folder:
                continue
            path = os.path.join(folder, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(guard.FORBIDDEN), path
            if os.path.relpath(folder, bench.HERE).split(os.sep)[0] == "reference":
                assert "tatt_tpu_torch" not in tops and "stisr_bench" not in tops, path


def test_weights_draw_every_leaf_once():
    config = json.load(open(os.path.join(bench.HERE, "configs", "tsrn.json")))
    models = nets.build(config)
    leaves = weights.make(models, 2**31 + 7, "cpu")
    again = weights.make(nets.build(config), 2**31 + 7, "cpu")
    other = weights.make(nets.build(config), 2**31 + 8, "cpu")
    w = "block2.conv1.weight"
    assert torch.equal(leaves["generator"][w], again["generator"][w])
    assert not torch.equal(leaves["generator"][w], other["generator"][w])
    assert float(leaves["generator"][w].abs().max()) <= 1 / math.sqrt(64 * 9)
    assert torch.equal(leaves["generator"]["block2.bn1.weight"], torch.ones(64))
    assert float(leaves["generator"]["block1.1.weight"]) == 0.25
    ctrl = leaves["generator"]["stn_head.stn_fc2.bias"].reshape(20, 2)
    assert torch.allclose(ctrl[:10, 1], torch.full((10,), 0.01))
    for name, module in models.items():
        weights.load(module, leaves[name])


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "stisr_bench.run", "--workload", "tatt-train-b256",
                          "--seed", str(2**31 + 3), "--seconds", "10", "--trace", "0"],
                         cwd=bench.ROOT, capture_output=True, text=True, env={
                             **os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "no CUDA card" in out.stderr


def test_the_traffic_is_the_seeds():
    from stisr_bench import traffic

    store = {"odd_every": 7, "odd_size": {"hr": [120, 30], "lr": [72, 18]}, "jpeg_every": 4}
    a = traffic.render(2**31 + 1, 8, (128, 32), (64, 16), store, 1)
    b = traffic.render(2**31 + 1, 8, (128, 32), (64, 16), store, 2)
    c = traffic.render(2**31 + 2, 8, (128, 32), (64, 16), store, 1)
    assert a == b and a != c
    arrays = traffic.batch_arrays(a, range(8), (128, 32), (64, 16))
    assert arrays["images_hr"].shape == (8, 32, 128, 3) and arrays["images_lr"].shape == (8, 16, 64, 3)
    assert ops.ctc_greedy([[1, 1, 0, 1, 2]]) == ["001"]
