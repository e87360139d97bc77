"""Host ms an evaluation batch spends in the TP Interpreter's query GRU
(span tatt.query_gru), over the profiled pass's batches (span tatt.eval.batch)."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "eval", "tatt.query_gru", "tatt.eval.batch")
