"""Host ms the loader makes a training call wait for its first batch, the
thread pool started with nothing built (span tatt.loader.first), a call."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "train", "tatt.loader.first", "tatt.loader.first")
