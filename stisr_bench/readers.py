"""What the per-layer metric files share.

Each file ``metrics/<metric>.py`` defines ``read(ctx)``, which returns the
metric's value or None when the run holds nothing for it to read; the
harness then leaves the metric out of the line.  ``ctx`` (built by the
drivers) holds ``mode`` ("train" or "eval"), ``window`` (the untraced
window: ``seconds``, ``images``, ``steps``, ``loader_wait_s``,
``loader_waits``, ``peak_bytes``), ``flops`` (model FLOPs of a step or of
an image), ``peak`` (the card's row of ``peaks.json``) and ``trace`` (a
:func:`stisr_bench.trace.profile` result).
"""

from __future__ import annotations

import json
import os

from stisr_bench import bench

HERE = os.path.dirname(os.path.abspath(__file__))


def idle_share(ctx: dict, mode: str):
    """Percent of the profiled window in which no operation ran on the
    card."""
    t = ctx.get("trace")
    if ctx["mode"] != mode or not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx: dict, mode: str):
    """Percent of the card's peak for the configuration's dtype that the
    window's model FLOPs over its wall time reach."""
    w, peak = ctx.get("window"), ctx.get("peak")
    if ctx["mode"] != mode or not w or not peak or not ctx.get("flops") or w["seconds"] <= 0:
        return None
    work = ctx["flops"] * (w["steps"] if mode == "train" else w["images"])
    return 100.0 * work / w["seconds"] / peak["flops_per_s"][ctx["dtype"]]


def roofline(ctx: dict, mode: str, spec_file: str):
    """Percent: the least time of the profiled window's launches of one
    kernel (the bound file of the spec ``metrics/<spec_file>`` at each
    launch's shape) over the device seconds of the kernels that the spec
    names.  None when the recorded launches disagree with the program's
    own launch counters, or no such kernel ran."""
    t, peak = ctx.get("trace"), ctx.get("peak")
    if ctx["mode"] != mode or not t or not peak:
        return None
    with open(os.path.join(HERE, "metrics", spec_file)) as f:
        spec = json.load(f)
    calls = t["launches"].get(spec_file[: -len(".json")], [])
    fwd = len(calls)
    bwd = sum(1 for _, b in calls if b)
    if fwd == 0 or (fwd, bwd) != tuple(t["counted"].get(c) for c in spec["counters"]):
        return None
    bounds = bench.bounds(spec)
    least = sum(bounds.bound(s, False, peak)[0] + (bounds.bound(s, True, peak)[0] if b else 0.0)
                for s, b in calls)
    spent = sum(s for name, s in t["device_s"].items() if any(k in name for k in spec["kernels"]))
    return 100.0 * least / spent if spent > 0 else None


def loader_wait_ms(ctx: dict, mode: str):
    """Mean host milliseconds a step blocks in the loader's ``next()``."""
    w = ctx.get("window")
    if ctx["mode"] != mode or not w or not w.get("loader_waits"):
        return None
    return 1e3 * w["loader_wait_s"] / w["loader_waits"]


def peak_mem_gib(ctx: dict, mode: str):
    """``torch.cuda.max_memory_allocated`` over the window, GiB."""
    w = ctx.get("window")
    if ctx["mode"] != mode or not w or not w.get("peak_bytes"):
        return None
    return w["peak_bytes"] / 2**30
