"""Host ms a training step spends in its forward (span tatt.step.forward),
over the profiled call's steps (span tatt.step)."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "train", "tatt.step.forward", "tatt.step")
