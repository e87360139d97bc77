"""Host ms the loader makes an evaluation wait for a test set's first batch
(span tatt.loader.first), a set."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "eval", "tatt.loader.first", "tatt.loader.first")
