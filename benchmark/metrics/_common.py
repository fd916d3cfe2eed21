"""What the per-layer readers share (not a metric: no metric is named with
a leading underscore)."""

#: Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
#: the 700 W limit), as the port's chip_smoke.py states them: bf16 tensor
#: FLOP/s, and plain fp32 adds a second (67 TFLOP/s counts an FMA as two).
BF16_FLOPS = 989e12
FP32_ADDS = 67e12 / 2


def device_ms_a_step(ctx, layer: str):
    """Device milliseconds a step of `layer` (kernel_layers.json), or None
    where the trace lost events, has no steps, or has nothing of it."""
    if ctx.trace is None or ctx.lost or not ctx.window.steps:
        return None
    seconds = ctx.trace.by_layer(ctx.layers).get(layer)
    if not seconds:
        return None
    return 1e3 * seconds / ctx.window.steps


def idle_pct(ctx):
    if ctx.trace is None or ctx.lost:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def flops_share(ctx):
    """The window's model FLOPs over its time and the bf16 peak, in %."""
    if not ctx.window.flops:
        return None
    return 100.0 * ctx.window.flops / ctx.window.seconds / BF16_FLOPS
