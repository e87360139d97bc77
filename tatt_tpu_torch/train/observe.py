"""Observability: profiler traces, parameter counts and FLOPs audits
(counterpart of ``tatt_tpu/train/observe.py``).

The reference prints wall-clock spans, images/s and a ptflops / thop
audit of each model (``interfaces/base.py:372-377``,
``super_resolution.py:96-122``).  Here :func:`trace` records a
``torch.profiler`` trace (TensorBoard / Perfetto), :func:`audit_model`
counts parameters and the FLOPs of one call with
``torch.utils.flop_counter.FlopCounterMode`` (matmuls and convolutions,
as torch counts them), and :class:`StepTimer` is an images/s meter.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator

import torch
from torch import nn


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record host and (where there is a card) device activity of the
    block into a trace under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def audit_model(name: str, fn: Callable, model: nn.Module, *example_args, log=print) -> dict:
    """Parameters of ``model`` and the FLOPs of ``fn(*example_args)``
    (without autograd), printed like the reference's audit."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*example_args)
    flops, n_params = counter.get_total_flops(), param_count(model)
    log(f"---------------- {name} -----------------\n"
        f"Number of parameters: {n_params / 1e6:.2f} M\n"
        + (f"Computational complexity: {flops / 1e9:.2f} GFLOPs\n" if flops > 0 else "")
        + "--------------------------------------------")
    return {"params": n_params, "flops": float(flops)}


class StepTimer:
    """images/s since construction; synchronize the card before reading a
    rate that should include its queued work."""

    def __init__(self):
        self.t0 = time.time()
        self.images = 0

    def update(self, batch_size: int) -> None:
        self.images += batch_size

    def rate(self) -> float:
        dt = time.time() - self.t0
        return self.images / dt if dt > 0 else 0.0
