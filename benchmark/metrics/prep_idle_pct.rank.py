"""The share of the traced window in which the device sat idle while the
main thread was inside the rank loop's host work (`eval.ent2idx`,
`eval.filters`, `eval.batch_filters`, `eval.to_device`), in %: the part of
`idle_pct.rank` that this host work holds."""

from benchmark.metrics import _spans


def read(ctx):
    prep = _spans.covered(ctx, _spans.PREP)
    if prep is None:
        return None
    return 100.0 * _spans.overlap(ctx.trace.idle_gaps(), prep) / _spans.window_ns(ctx)
