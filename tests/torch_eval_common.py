"""Shared pieces of the tests that hold the port's evaluation path against the
JAX package: one synthetic dataset directory, seeded models whose heads are
stretched so that their curves have isolated peaks, and the same parameters
as a JAX tree."""

import numpy as np
import torch

from tests.torch_train_common import perturbed_params, state_dict_from_jax
from volpick_tpu_torch.models import EQTransformer, PhaseNet
from volpick_tpu_torch.models.convert import jax_tree_from_model

DS = dict(n_events=30, n_noise=10, n_samples=6000, seed=11)  # tests/test_eval.py's dataset
SMALL_EQT = dict(in_samples=1504, lstm_blocks=1)
FORWARD_TOL = {"phasenet": 2e-5, "eqtransformer": 2e-4}  # the README's forward pins


def _stats(logit: np.ndarray):
    mid, top = np.percentile(logit.astype(np.float64), [50, 99.9])
    return 5.0 / float(top - mid), float(mid)


def stretch_heads(model, frames: torch.Tensor) -> None:
    """Seeded weights give nearly flat curves. Rescale each head's logit
    about its median on `frames` so that the median sits at -5 and the
    99.9th percentile at 0: mostly ~0.007, with isolated peaks that reach
    about 0.5. For PhaseNet's softmax the logit of P and S is taken against N."""
    with torch.no_grad():
        out = model(frames)
        if isinstance(model, PhaseNet):
            w, b = model.out.weight, model.out.bias
            ni = model.phases.index("N")
            for k in (model.phases.index("P"), model.phases.index("S")):
                a, m = _stats(torch.log(out[:, k] / out[:, ni]).numpy())
                w[k] = a * (w[k] - w[ni]) + w[ni]
                b[k] = a * (b[k] - b[ni] - m) + b[ni] - 5.0
            return
    stretch_eqt_heads(model, [torch.log(p / (1 - p)).numpy() for p in out])


def stretch_eqt_heads(model, logits) -> None:
    """``stretch_heads``' rule for the EQTransformer family, given one array
    of logit samples a head, detection first."""
    with torch.no_grad():
        for head, logit in zip([model.conv_d] + list(model.pick_convs), logits):
            a, m = _stats(np.asarray(logit))
            head.bias.copy_((head.bias - m) * a - 5.0)
            head.weight.mul_(a)


def model_pair(arch: str, frames_of):
    """(port model in eval mode on the CPU, the same parameters as a JAX
    tree): seeded, BatchNorm statistics and biases moved off their initial
    values, heads stretched on ``frames_of(window)``."""
    cls, kw = {"phasenet": (PhaseNet, {}), "eqtransformer": (EQTransformer, SMALL_EQT)}[arch]
    model = cls(generator=torch.Generator().manual_seed(3), **kw)
    model.load_state_dict(state_dict_from_jax(arch, perturbed_params(model)), strict=True)
    model.eval()
    stretch_heads(model, torch.as_tensor(frames_of(model.in_samples)))
    return model, jax_tree_from_model(model)
