"""The rank work's least time over the device time spent inside the rank
calls, in %: 2 fp32 adds per (query, candidate, dim) of the real queries
(both directions) and candidates, over 33.5e12 adds/s, against the
device-busy time inside the `rank.call` spans. Counted from shapes, it reads
the same work whatever kernels do it."""

from benchmark.metrics._common import FP32_ADDS


def read(ctx):
    if ctx.trace is None or ctx.lost or not ctx.window.rank_ops:
        return None
    busy = ctx.trace.time_in_spans("rank.call")
    if busy <= 0:
        return None
    return 100.0 * ctx.window.rank_ops / FP32_ADDS / busy
