"""Observability: the port's spans and the operator's profiler trace
(counterpart of ``tatt_tpu/train/observe.py``).

``span(name)`` marks one phase of the program where it runs: a step and
its parts, the generator and recognizers, the evaluation's batches and
judge, the loader.  While no profiler runs it is one shared null context,
and costs the read of the profiler's flag.  While ``torch.profiler`` runs
(the benchmark's traced call, or :func:`trace`) it is a
``record_function`` range on the profiler's clock, the clock of the
device's events, so a trace names the host time between launches by
phase; it also adds its host duration to the in-memory totals that
:func:`span_totals` returns (calls, inclusive and self seconds), under a
lock, since the loader's spans run on its threads.

The profiler's flag is the calling thread's: a thread the program starts
(the loader's pool) does not see a profiler started elsewhere, so its
spans take ``on`` from the thread that hands them their work; their
``record_function`` ranges do not reach that profiler's trace, their
totals do.

This module imports only ``torch``, so ``data/`` and ``models/`` can use
it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

import torch

# every span of the program, one line each; a test holds the program to
# this list
SPANS = (
    "tatt.step",  # Trainer.train: one training step, m.train() through its bookkeeping
    "tatt.step.batch",  # step_batch: the batch to the device
    "tatt.step.forward",  # train_step / plain_train_step: everything before the backward
    "tatt.step.backward",  # _backward: loss.backward() and the gradients' all-reduce
    "tatt.step.optimizer",  # gradient metrics, per-copy clipping, Adam, metric reduction
    "tatt.teacher",  # the frozen teacher's prior (train_step)
    "tatt.student",  # a student's prior (train_step, eval_step)
    "tatt.generator",  # a generator forward (train and eval steps)
    "tatt.tp_interpreter",  # TPInterpreter.forward
    "tatt.query_gru",  # TPInterpreter.query_pos: the query table's BiGRU, plain loop
    "tatt.eval.batch",  # Evaluator.evaluate: one batch, loader wait excluded
    "tatt.eval.sr",  # the batch's SR images
    "tatt.eval.score",  # PSNR / SSIM / LPIPS of SR and of the bicubic LR, read to the host
    "tatt.judge",  # one judge reading of a batch (make_judge)
    "tatt.judge.decode",  # the reading's copy to the host and its host decode
    "tatt.loader.first",  # DataLoader: the wait for an epoch's first batch, nothing prefetched
    "tatt.loader.wait",  # DataLoader: the wait for every later batch
    "tatt.loader.read",  # DataLoader worker: a batch's dataset reads (LMDB fetch, decode)
    "tatt.loader.collate",  # DataLoader worker: a batch's collate
)

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_totals: dict[str, list] = {}  # name -> [calls, seconds, self seconds]


def tracing() -> bool:
    """Whether a profiler runs on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str, on: Optional[bool] = None):
    """A context manager that marks ``name`` (one of :data:`SPANS`);
    ``on``: whether to record, else :func:`tracing`."""
    if not (torch.autograd._profiler_enabled() if on is None else on):
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "range", "parent", "child_s", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.child_s = 0.0
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_s += seconds
        with _lock:
            total = _totals.setdefault(self.name, [0, 0.0, 0.0])
            total[0] += 1
            total[1] += seconds
            total[2] += seconds - self.child_s
        self.range.__exit__(*exc)
        return False


def span_totals() -> dict:
    """{span: {"calls", "seconds", "self_seconds"}} of the spans recorded
    so far in this process: host seconds, inclusive and less the time of
    the spans opened inside them on the same thread."""
    with _lock:
        return {name: {"calls": c, "seconds": s, "self_seconds": own}
                for name, (c, s, own) in _totals.items()}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record host and (where there is a card) device activity of the
    block, the spans included, into a TensorBoard / Perfetto trace under
    ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof
