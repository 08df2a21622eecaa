"""EMA and SWA weight averaging (PyTorch port of ``volpick_tpu/train/ema.py``).

The reference wraps its optimiser in an `EMAOptimizer` (decay 0.999, updated
every step; `volpick/model/ema.py:214-418`) that averages what the optimiser
owns: the parameters. BatchNorm running statistics are buffers, not
optimiser state; the EMA copy takes them from the live model
(`ema.py:195-202`). SWA (PyTorch Lightning's StochasticWeightAveraging in the
reference) is a running mean of the weights at epoch ends, ``swa_update``.
"""

from __future__ import annotations

from typing import Dict

import torch


def ema_state_of(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of the model's state dict: the EMA's starting point."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def ema_update(ema_state: Dict[str, torch.Tensor], model: torch.nn.Module, decay: float = 0.999) -> None:
    """In place: ema ← decay·ema + (1 − decay)·param for every parameter;
    every buffer (BatchNorm running statistics) copied from the model."""
    for name, p in model.named_parameters():
        e = ema_state[name]
        e.copy_(decay * e + (1.0 - decay) * p)
    for name, b in model.named_buffers():
        ema_state[name].copy_(b)


@torch.no_grad()
def swa_update(swa_state: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], n_models: int) -> None:
    """In place: swa ← (swa·n + p)/(n + 1) for every floating-point entry of
    the state dict `state`: the parameters and the BatchNorm running
    statistics, which are exactly the leaves of the JAX package's params tree
    that its ``swa_update`` averages (``models/convert.py::jax_tree_from_model``
    maps them). An integer entry (BatchNorm's ``num_batches_tracked``, which
    the JAX tree does not have) takes the latest value."""
    for name, p in state.items():
        a = swa_state[name]
        if a.is_floating_point():
            a.copy_((a * n_models + p) / (n_models + 1))
        else:
            a.copy_(p)
