"""The port's own spans (``tatt_tpu_torch.train.observe``) as the
per-layer metrics ``metrics/<name>_ms.<mode>.py`` read them: host
milliseconds of the profiled call, per call of a span.

The program adds to its span totals only while a profiler runs, so in a
run of the benchmark they hold the one profiled call.  A program without
spans (an older checkout) gives None, as does a run of the other mode or
one without a profiled call.
"""

from __future__ import annotations


def totals() -> dict:
    """{span: {"calls", "seconds", "self_seconds"}} of the program, or {}
    where it has no spans."""
    from tatt_tpu_torch.train import observe

    read = getattr(observe, "span_totals", None)
    return read() if read is not None else {}


def ms_per(ctx: dict, mode: str, name: str, per: str):
    """Host ms of span ``name`` per call of span ``per`` in the profiled
    call of a ``mode`` run, or None."""
    if ctx["mode"] != mode or not ctx.get("trace"):
        return None
    t = totals()
    if name not in t or not t.get(per, {}).get("calls"):
        return None
    return 1e3 * t[name]["seconds"] / t[per]["calls"]
