"""Device ms of the kernels, copies and fills that the host issued inside the
slice's ``condition`` spans, per 1000 real windows."""

from benchmark import spans


def read(ctx):
    return spans.read_device_ms_per_kwin(ctx, "condition")
