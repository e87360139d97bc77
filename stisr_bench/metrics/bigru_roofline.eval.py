"""The bigru recurrence kernels' share of their roofline in a profiled
eval window; the kernels and counters are named in bigru_roofline.json."""
from stisr_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "eval", "bigru_roofline.json")
