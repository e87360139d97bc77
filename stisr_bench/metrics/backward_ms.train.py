"""Host ms a training step spends in its backward and gradient all-reduce
(span tatt.step.backward), over the profiled call's steps."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "train", "tatt.step.backward", "tatt.step")
