"""Host ms an evaluation batch spends in its three judge readings, decode
included (span tatt.judge), over the profiled pass's batches."""
from stisr_bench.spans import ms_per


def read(ctx):
    return ms_per(ctx, "eval", "tatt.judge", "tatt.eval.batch")
