"""The rank work's operations (2 fp32 adds per query, candidate and dim)
over the window's time and the chip's fp32 add peak, in %: the whole
window's share of the peak, which bounds the rank kernel's roofline share."""

from benchmark.metrics._common import FP32_ADDS


def read(ctx):
    if not ctx.window.rank_ops:
        return None
    return 100.0 * ctx.window.rank_ops / ctx.window.seconds / FP32_ADDS
