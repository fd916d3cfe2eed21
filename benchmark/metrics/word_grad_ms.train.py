"""Device ms a step of the gathers' backward: torch's index backward (the
index sort and `indexing_backward_kernel`). The word table's gather is
nearly all of it; the relations' and the negatives' gathers add theirs."""

from benchmark.metrics._common import device_ms_a_step


def read(ctx):
    return device_ms_a_step(ctx, "index backward")
