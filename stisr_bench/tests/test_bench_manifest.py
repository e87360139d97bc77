"""BENCHMARK.json against the contract it is written to, and the files
it names."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from stisr_bench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return bench.manifest()


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for name in names + [m["name"] for m in metrics]:
        assert NAME.match(name), name
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in manifest[kind]}) == len(manifest[kind])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert LINE.match(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in manifest["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_paths_and_command(manifest):
    assert manifest["paths"] == ["stisr_bench"]
    assert len(manifest["command"]) <= 32
    for word in manifest["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)


def test_budget_of_a_full_check(manifest):
    """24 cells at this run length fit the check's 43,200 seconds."""
    s = manifest["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])


def test_metric_cells_exist_and_report_what_they_move(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [m for m in manifest["end_to_end"] if cell in m.get("workloads", cells)]
        assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])


def test_every_per_layer_metric_lists_its_cells(manifest):
    """The harness reports a per-layer metric in the cells its
    ``workloads`` name, and nowhere else."""
    for m in manifest["per_layer"]:
        assert m.get("workloads"), m["name"]


def test_each_name_has_its_files(manifest):
    for c in manifest["configs"]:
        config = json.load(open(os.path.join(bench.ROOT, c["file"])))
        assert config["name"] == c["name"] and set(c["reduced"]) <= set(config)
        assert c["file"].startswith("stisr_bench/")
    for w in manifest["workloads"]:
        cell = bench.Cell(w["name"], manifest)
        assert cell.config["name"] == w["config"]
        assert os.path.exists(os.path.join(bench.HERE, "drivers", cell.mix["driver"] + ".py"))
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(bench.HERE, "metrics", m["name"] + ".py")), m["name"]


def test_shares_are_percent(manifest):
    for m in manifest["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_is_files_alone(tmp_path):
    """A workload file and a manifest entry, no code: the copy finds it."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.HERE, root / "stisr_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = bench.manifest()
    manifest["workloads"].append({"name": "tatt-train-b128", "config": "tatt", "traffic": "train",
                                  "chips": 1, "why": "a smaller batch"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "tatt-train-b256" in m.get("workloads", ()):
            m["workloads"].append("tatt-train-b128")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / "stisr_bench" / "workloads" / "tatt-train-b128.json").write_text(
        json.dumps({"name": "tatt-train-b128", "config": "tatt", "traffic": "train", "batch": 128,
                    "limits": {}}))
    code = ("from stisr_bench import bench; c = bench.Cell('tatt-train-b128'); "
            "print(c.workload['batch'], c.config['name'], c.mix['driver'], "
            "sorted(m['name'] for m in c.per_layer))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         check=True).stdout
    assert out.startswith("128 tatt train") and "bilstm_roofline.train" in out
