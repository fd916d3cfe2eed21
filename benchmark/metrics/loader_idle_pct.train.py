"""The share of the window's device-idle time in which the loader's thread
was inside its spans (`prefetch.assemble`, `prefetch.place`), in %: well
above `loader_busy_pct.train` where the loader holds the interpreter lock
that the main thread needs to launch the step."""

from benchmark.metrics import _spans


def read(ctx):
    busy = _spans.covered(ctx, _spans.LOADER)
    if busy is None:
        return None
    idle = ctx.trace.idle_gaps()
    total = _spans.length(idle)
    if not total:
        return None
    return 100.0 * _spans.overlap(idle, busy) / total
