"""The tests' rule for stretching a seeded model's heads (numpy and torch
only, so that the card's tests can load this file by its path)."""

import numpy as np
import torch


def _stats(logit: np.ndarray):
    mid, top = np.percentile(logit.astype(np.float64), [50, 99.9])
    return 5.0 / float(top - mid), float(mid)


def stretch_eqt_heads(model, logits) -> None:
    """``torch_eval_common.stretch_heads``' rule for the EQTransformer family,
    given one array of logit samples a head, detection first: the median
    moves to -5 and the 99.9th percentile to 0."""
    with torch.no_grad():
        for head, logit in zip([model.conv_d] + list(model.pick_convs), logits):
            a, m = _stats(np.asarray(logit))
            head.bias.copy_((head.bias - m) * a - 5.0)
            head.weight.mul_(a)
