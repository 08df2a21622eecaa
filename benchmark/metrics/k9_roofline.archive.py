"""K9's share of its roofline in the traced slice: the summed bounds of the
slice's ``convpool_relu_kernel`` launches (one an encoder layer a forward),
each the larger of its bytes and its float32 operations over the card's
peaks (``bounds.bound_s``), over the summed device time of their rows, in
percent. The layer shapes come from the configuration's ``model_args``, the
batches from the requests' forwards; None where the slice holds no such row
(a program without K9)."""

import re

from benchmark import bounds

MATCH = re.compile(r"convpool_relu_kernel")


def k9_work(batch: int, c_in: int, c_out: int, k: int, length: int):
    """(bytes, float32 operations, special-function operations) of one K9
    ``convpool_relu`` launch, one encoder layer: x (batch, c_in, length) read
    once, the weights (c_out, c_in, k) and the bias once, the pooled output
    (batch, c_out, (length + length % 2) // 2) written once; a multiply-add
    (2 operations) for each tap that falls inside the input, of every conv
    output: tap j of 'same' padding ((k - 1) // 2 on the left) falls inside
    for length - |j - (k - 1) // 2| of the outputs."""
    pooled = (length + length % 2) // 2
    n_bytes = 4 * (batch * c_in * length + c_out * c_in * k + c_out + batch * c_out * pooled)
    taps = sum(max(0, length - abs(j - (k - 1) // 2)) for j in range(k))
    return float(n_bytes), 2.0 * batch * c_out * c_in * taps, 0.0


def encoder_layers(model_args: dict):
    """[(c_in, c_out, k, length in)] of the configuration's encoder."""
    f = list(model_args["filters"])
    layers, length = [], model_args["in_samples"]
    for c_in, c_out, k in zip([model_args["in_channels"]] + f[:-1], f, model_args["kernel_sizes"]):
        layers.append((c_in, c_out, k, length))
        length = (length + length % 2) // 2
    return layers


def read(ctx):
    if ctx.slice is None:
        return None
    rows = ctx.slice.matching(MATCH)
    if not rows:
        return None
    layers = encoder_layers(ctx.cfg["model_args"])
    bound = sum(ctx.slice_requests * bounds.bound_s(*k9_work(batch, *layer))[0]
                for batch in ctx.plan.forwards for layer in layers)
    t = sum(b - a for _, a, b, _ in rows) / 1e9
    return 100.0 * bound / t
