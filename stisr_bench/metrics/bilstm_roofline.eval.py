"""The bilstm recurrence kernels' share of their roofline in a profiled
eval window; the kernels and counters are named in bilstm_roofline.json."""
from stisr_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "eval", "bilstm_roofline.json")
