"""Device ms a step of copies: copy kernels (dtype casts, cat, contiguous)
and device-to-device copies; ctx's f32 round trip is most of them."""

from benchmark.metrics._common import device_ms_a_step


def read(ctx):
    return device_ms_a_step(ctx, "copies")
