"""Model FLOPs of the window (counted from shapes over the real tokens,
forward and, in training, backward, no recomputation; models/<family>.py)
over the window's time and the bf16 peak, in %."""

from benchmark.metrics._common import flops_share


def read(ctx):
    return flops_share(ctx)
