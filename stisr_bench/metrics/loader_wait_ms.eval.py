"""Mean host ms an evaluation batch waits in the loader's next()."""
from stisr_bench.readers import loader_wait_ms


def read(ctx):
    return loader_wait_ms(ctx, "eval")
