"""Host ms a training step spends in gradient norms, clipping, Adam and the
metrics' reduction (span tatt.step.optimizer), over the profiled call's steps."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "train", "tatt.step.optimizer", "tatt.step")
