"""Host ms a training step spends in the TP Interpreter's query GRU forward
(span tatt.query_gru; its backward is in backward_ms), over the profiled steps."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "train", "tatt.query_gru", "tatt.step")
