"""The share of the traced window in which no kernel, copy or memset ran
on the device, in %."""

from benchmark.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
