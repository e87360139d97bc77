"""Percent of a profiled eval window with no operation on the card."""
from stisr_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "eval")
