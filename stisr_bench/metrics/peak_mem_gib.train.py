"""Peak device memory allocated over the training window, GiB."""
from stisr_bench.readers import peak_mem_gib


def read(ctx):
    return peak_mem_gib(ctx, "train")
