"""The main thread's self time a call in the rank loop's host work, in ms:
`eval.ent2idx`, `eval.filters` (the filter-width pass over every triple),
and per batch `eval.batch_filters` and `eval.to_device` (the positions' and
filters' copies)."""

from benchmark.metrics import _spans


def read(ctx):
    ns = _spans.self_ns(ctx, _spans.PREP)
    if ns is None or not ctx.window.steps:
        return None
    return ns * 1e-6 / ctx.window.steps
