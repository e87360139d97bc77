"""The bilstm recurrence kernels' share of their roofline in a profiled
train window; the kernels and counters are named in bilstm_roofline.json."""
from stisr_bench.readers import roofline


def read(ctx):
    return roofline(ctx, "train", "bilstm_roofline.json")
