"""Pieces the drivers share: the run's scratch directory, the loader
proxy, the window of whole units, the per-layer context, freeing the
program before the reference.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import tempfile
import time

import torch

from stisr_bench import program, roofline

# the card the run measures; the CPU only in the tests, which drive a run
# without a card at a tiny size
DEVICE = torch.device("cuda", 0)


def on_card() -> bool:
    return DEVICE.type == "cuda"


def sync() -> None:
    if on_card():
        torch.cuda.synchronize()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated() if on_card() else 0


def reset_peak() -> None:
    if on_card():
        torch.cuda.reset_peak_memory_stats()


def device_name() -> str:
    return torch.cuda.get_device_name(0) if on_card() else "cpu"


@contextlib.contextmanager
def scratch():
    """A directory under ``TMPDIR`` for the run's LMDBs and YAML, removed
    at the end."""
    path = tempfile.mkdtemp(prefix="stisr_bench_")
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def write_yaml(directory: str, text: str) -> str:
    path = os.path.join(directory, "run.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def timed(iterable):
    """(seconds its ``next()`` took, item) for each item of ``iterable``,
    each ``next()`` under the span ``stisr_bench.loader_next``; the
    iterator is closed when the consumer stops."""
    it = iter(iterable)
    try:
        while True:
            t = time.perf_counter()
            with torch.profiler.record_function("stisr_bench.loader_next"):
                item = next(it, None)
            if item is None:
                return
            yield time.perf_counter() - t, item
    finally:
        it.close()


class LoaderProxy:
    """Stands in for ``Trainer.loader``: yields the loader's batches and
    times each ``next()`` (:func:`timed`).  ``on_next(k)`` is called after
    the k-th batch of the proxy's life arrives, before it is stepped on;
    the first ``keep`` batches' uint8 crops are kept."""

    def __init__(self, loader):
        self.loader = loader
        self.wait_s, self.waits, self.delivered = 0.0, 0, 0
        self.on_next, self.keep, self.kept = None, 0, []

    def __len__(self) -> int:
        return len(self.loader)

    def reset(self) -> None:
        self.wait_s, self.waits = 0.0, 0

    def __iter__(self):
        for waited, batch in timed(self.loader):
            self.wait_s += waited
            self.waits += 1
            self.delivered += 1
            if len(self.kept) < self.keep:
                self.kept.append((batch.images_hr, batch.images_lr))
            if self.on_next is not None:
                self.on_next(self.delivered)
            yield batch


def whole_units(unit, seconds: float) -> list[float]:
    """The window: ``unit(k)`` runs the k-th whole unit (an epoch, a
    pass), each ending on a host read that waits for the card.  Units run
    while the next is due to end inside ``seconds`` by the mean of those
    so far, and at least one; returns each unit's seconds."""
    each = []
    t = time.perf_counter()
    while not each or time.perf_counter() - t + sum(each) / len(each) <= seconds:
        unit(len(each))
        each.append(time.perf_counter() - t - sum(each))
    return each


def half(batch: dict) -> dict:
    """Half of every row array of a batch: the fault of a half batch."""
    return {k: v[: len(v) // 2] for k, v in batch.items()}


def context(mode: str, config: dict, window: dict) -> dict:
    return {"mode": mode, "dtype": config["dtype"], "window": window,
            "peak": roofline.peaks(device_name())}


def free_program() -> None:
    """Collect the program's dropped objects and give their memory back
    to the card before the reference runs."""
    gc.collect()
    sync()
    if on_card():
        torch.cuda.empty_cache()


def shape(config: dict) -> tuple[tuple[int, int], tuple[int, int]]:
    """(HR size, LR size) as (W, H)."""
    g = config["geometry"]
    s = g["down_sample_scale"]
    return (g["width"], g["height"]), (g["width"] // s, g["height"] // s)


def require_precision(config: dict) -> None:
    """Refuse a run whose program computes with TF32 otherwise than the
    configuration's ``tf32`` states."""
    tf32 = torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    if tf32 != config["tf32"]:
        raise SystemExit(f"stisr_bench: the program runs with TF32 {'on' if tf32 else 'off'}, "
                         f"the configuration states tf32 {config['tf32']}")


def prepare(setup, seed: int, config: dict):
    """The card, the port's kernels and the seeded weights: (device,
    {model: {leaf: tensor}})."""
    from stisr_bench import weights
    from stisr_bench.reference import nets

    device = DEVICE
    with setup.part("cuda_init"):
        torch.zeros(1, device=device)
    with setup.part("kernels"):
        program.prepare_device(build=on_card())
    require_precision(config)
    with setup.part("weights"):
        leaves = weights.make(nets.build(config), seed, device)
    return device, leaves
