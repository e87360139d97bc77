"""One profiled window on the card, reduced to what the per-layer metrics
and the result's ``breakdown`` read.

``torch.profiler`` records host operations and device activity (CUPTI)
over a call that ends in a synchronize.  From the device events: the busy
seconds (the union of their intervals), device seconds by name, and the
idle gaps between busy intervals, each named by what the host's main
thread was doing at the gap's middle (the innermost operation or
benchmark span open there, or ``host: python``).  For each kernel
roofline that the cell reads (``metrics/<name>.json``, see
:mod:`stisr_bench.bounds`), forward pre-hooks on the program's layers of
the spec's class record the shape of each launch over the same window,
and the spec's launch counters are read before and after it.
"""

from __future__ import annotations

import bisect
import pkgutil
import time
from collections import Counter, defaultdict

import torch

from stisr_bench import bench

SPAN = "stisr_bench."  # prefix of the benchmark's own record_function spans
IDLE = "host: python"  # no operation open on the host


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _ShapeHooks:
    """{roofline: [(shape, backward), ...]}: each launch of each spec's
    kernel (its bound file's ``shapes``) in the calls of the spec's layer
    class while installed; ``backward`` when autograd records the call
    and the layer has a parameter that wants a gradient."""

    def __init__(self, models, rooflines: dict):
        self.models, self.rooflines, self.handles = models, rooflines, []
        self.calls = {name: [] for name in rooflines}

    def __enter__(self):
        def hook_for(name, shapes):
            def hook(module, args):
                grad = torch.is_grad_enabled() and any(
                    p.requires_grad for p in module.parameters(recurse=False))
                self.calls[name].extend((s, bool(grad)) for s in shapes(module, args))
            return hook

        for name, spec in self.rooflines.items():
            cls = pkgutil.resolve_name(spec["module"])
            hook = hook_for(name, bench.bounds(spec).shapes)
            seen = set()
            for model in self.models:
                for module in model.modules():
                    if isinstance(module, cls) and id(module) not in seen:
                        seen.add(id(module))
                        self.handles.append(module.register_forward_pre_hook(hook))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def _counters(rooflines: dict) -> dict:
    """{path: value} of every launch counter that the specs name."""
    return {c: pkgutil.resolve_name(c) for spec in rooflines.values() for c in spec["counters"]}


def profile(fn, models, rooflines: dict, sync=torch.cuda.synchronize) -> dict:
    """Run ``fn()`` under the profiler, with the shape hooks of
    ``rooflines`` ({name: spec}, :func:`stisr_bench.bench.rooflines`) on
    the layers inside ``models``; returns ``busy_s``, ``window_s``,
    ``device_s`` {name: seconds}, ``device_ops`` and ``idle_gaps`` (the
    ten largest, [name, seconds]), ``launches`` (the shape hooks' calls)
    and ``counted`` (each spec counter's launches over the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync()
    before = _counters(rooflines)
    with _ShapeHooks(models, rooflines) as hooks, torch_profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    after = _counters(rooflines)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA and _on_device(e)]
    busy = _merge((e.time_range.start, e.time_range.end) for e in device)
    busy_s = sum(e - s for s, e in busy) / 1e6
    device_s = Counter()
    for e in device:
        device_s[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    host = [e for e in events if e.device_type == DeviceType.CPU]
    by_thread = defaultdict(list)
    for e in host:
        by_thread[e.thread].append(e)
    main = _main_thread(by_thread)
    lines = {tid: _timeline(evs) for tid, evs in by_thread.items()}
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        gaps[_doing(lines, main, (end + nxt) / 2)] += (nxt - end) / 1e6
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_s": dict(device_s),
        "device_ops": [[n[:160], s] for n, s in device_s.most_common(10)],
        "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        "launches": hooks.calls,
        "counted": {k: after[k] - before[k] for k in after},
    }


def _on_device(e) -> bool:
    """A kernel, copy or fill: not a range that a host annotation (an
    optimizer's step, a benchmark span) marks on the device's timeline."""
    return (e.time_range.end > e.time_range.start and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith((SPAN, "Optimizer.")))


def _main_thread(by_thread: dict):
    """The thread that ran the measured call: the one holding the
    benchmark's spans, else the one whose first operation came first (the
    autograd engine runs the backward on a thread of its own)."""
    for tid, evs in by_thread.items():
        if any(e.name.startswith(SPAN) for e in evs):
            return tid
    return min(by_thread, key=lambda t: min(e.time_range.start for e in by_thread[t]), default=None)


def _doing(lines: dict, main, t: float) -> str:
    """What the host was doing at ``t``: the main thread's innermost open
    operation, or while it ran bare Python, the operation another thread
    (the autograd engine's) had open."""
    label = _at(lines.get(main), t)
    if label != IDLE:
        return label
    for tid, line in lines.items():
        other = _at(line, t)
        if tid != main and other != IDLE:
            return f"other thread / {other}"
    return IDLE


def _at(line, t: float) -> str:
    if not line:
        return IDLE
    starts, labels = line
    i = bisect.bisect_right(starts, t) - 1
    return labels[i] if i >= 0 else IDLE


def _timeline(host) -> tuple[list, list]:
    """A host thread's activity as piecewise-constant segments: (segment
    starts, labels), each label the innermost operation open there, with
    the benchmark span around it if any, or ``IDLE``."""
    marks = sorted([(e.time_range.start, 1, i) for i, e in enumerate(host)]
                   + [(e.time_range.end, 0, i) for i, e in enumerate(host)])
    open_, starts, labels = [], [], []
    for t, opening, i in marks:
        if opening:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
        names = [host[j].name for j in open_]
        ops = [n for n in names if not n.startswith(SPAN)]
        spans = [n for n in names if n.startswith(SPAN)]
        label = ops[-1] if ops else IDLE
        if spans:
            label = f"{spans[0]} / {label}"
        if starts and starts[-1] == t:
            labels[-1] = label
        else:
            starts.append(t)
            labels.append(label)
    return starts, labels
