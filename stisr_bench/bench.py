"""The manifest and the files it names, and the run's result line.

A cell (``--workload``) is found by its name in ``BENCHMARK.json`` at the
checkout's root; its entry names a configuration (``configs/<config>.json``,
whose ``arch`` names its plain reference, ``reference/archs/<arch>.py``)
and a traffic mix (``mixes/<traffic>.json``, whose ``driver`` is
``drivers/<driver>.py``); the cell's own parameters are in
``workloads/<name>.json``; each per-layer metric that the manifest lists
for the cell (each lists its cells under ``workloads``) is read by
``metrics/<metric>.py``, and a kernel's roofline metrics
``<kernel>_roofline.<mode>`` by the spec ``metrics/<kernel>_roofline.json``
and its bound file ``bounds/<bound>.py`` (:mod:`stisr_bench.bounds`).
Nothing here names a cell, a configuration, an arch, a metric or a
kernel: a new one is new files and entries.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


class Cell:
    """One workload of the manifest with its configuration, mix and
    metrics."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = manifest() if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"stisr_bench: no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(entries)})")
        self.name, self.entry = name, entries[name]
        self.workload = _json(HERE, "workloads", f"{name}.json")
        self.config = _json(HERE, "configs", f"{self.entry['config']}.json")
        self.mix = _json(HERE, "mixes", f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]

    def driver(self):
        return load_module(os.path.join(HERE, "drivers", f"{self.mix['driver']}.py"))


def load_module(path: str):
    name = "stisr_bench._loaded." + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rooflines(cell: Cell) -> dict:
    """{name: spec} of the kernel roofline specs, ``metrics/<name>.json``,
    that the cell's per-layer metrics ``<name>.<mode>`` read."""
    out = {}
    for m in cell.per_layer:
        name = m["name"].split(".", 1)[0]
        if os.path.exists(os.path.join(HERE, "metrics", f"{name}.json")):
            out[name] = _json(HERE, "metrics", f"{name}.json")
    return out


def bounds(spec: dict):
    """The bound file of a roofline spec, ``bounds/<bound>.py``."""
    return load_module(os.path.join(HERE, "bounds", f"{spec['bound']}.py"))


def read_per_layer(cell: Cell, ctx: dict) -> dict:
    """{metric: {"value", "unit"}} of every per-layer metric of the cell
    whose reader finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py")).read(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class Setup:
    """Set-up's parts, each timed and printed on its own line."""

    def __init__(self, t0: float):
        self.t0, self.parts = t0, {}
        # the interpreter, the imports of the harness and the mix's driver
        self.parts["start"] = time.perf_counter() - t0
        print(f"[setup] start {self.parts['start']:.3f} s", file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        yield
        self.parts[name] = time.perf_counter() - t
        print(f"[setup] {name} {self.parts[name]:.3f} s", file=sys.stderr, flush=True)

    def seconds(self) -> float:
        return time.perf_counter() - self.t0


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         checks: dict, breakdown: dict | None = None) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard
    output, with ``checks`` as its last key."""
    checks = {k: {"value": _number(c["value"]), "limit": _number(c["limit"])}
              for k, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr, flush=True)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)


def _number(x):
    """A finite number as it is; NaN or infinity as its name (JSON has
    neither)."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def device_info(chips: int, peak_bytes: int, trace: dict | None = None) -> dict:
    from stisr_bench.harness import device_name

    out = {"platform": "gpu", "kind": device_name(), "count": chips,
           "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        out["busy_s"], out["window_s"] = trace["busy_s"], trace["window_s"]
    return out
