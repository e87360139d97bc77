"""Percent of a profiled train window with no operation on the card."""
from stisr_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "train")
