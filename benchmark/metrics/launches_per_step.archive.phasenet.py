"""The host's launch calls (kernels, copies, fills) inside the slice's
``step`` spans, per step."""

from benchmark import spans


def read(ctx):
    return spans.read_launches_per_step(ctx)
