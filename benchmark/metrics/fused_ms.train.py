"""Device ms a step of the port's fused kernels F1 (bias_act), F2 (add_ln),
F3 (attn_softmax) and the site dropout kernel."""

from benchmark.metrics._common import device_ms_a_step


def read(ctx):
    return device_ms_a_step(ctx, "F1 F2 F3 site")
