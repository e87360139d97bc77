"""The whole eval step's model FLOPs over the window, as a percent of the
card's peak for the configuration's dtype."""
from stisr_bench.readers import mfu


def read(ctx):
    return mfu(ctx, "eval")
