"""The share of the traced window in which the loader's thread was inside
its spans, in %: `prefetch.assemble` (the next host batch: the loader's
numpy gathers) and `prefetch.place` (pinning and the copy's enqueue)."""

from benchmark.metrics import _spans


def read(ctx):
    busy = _spans.covered(ctx, _spans.LOADER)
    if busy is None:
        return None
    return 100.0 * _spans.length(busy) / _spans.window_ns(ctx)
