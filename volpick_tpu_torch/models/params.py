"""Parameter holders shared by the port's models.

The models apply the functional layers of ``models/layers.py``; these modules
only own the parameters, under the names the state dicts use (BatchNorm is
the exception: in train mode the module itself normalises, see ``norm``).
Random initial values come from a ``torch.Generator`` so a seed gives the
same model on every device.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from volpick_tpu_torch.models.layers import batch_norm, conv1d_same


def uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


class Conv(nn.Module):
    """Conv1d parameters under torch's names: weight (O, I, K) and, with
    `bias`, bias (O,); uniform(±sqrt(6/(I*K))) weights, zero bias."""

    def __init__(self, i: int, o: int, k: int, gen: torch.Generator, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(uniform((o, i, k), (6.0 / (i * k)) ** 0.5, gen))
        self.bias = nn.Parameter(torch.zeros(o)) if bias else None

    def same(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_same(x, self.weight, self.bias)


class WB(nn.Module):
    """A weight `w` and bias `b` under the JAX tree's own names (TPUPickNet)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def bn(c: int, eps: float = 1e-3) -> nn.BatchNorm1d:
    """Holds scale/bias/running stats under torch's names; applied by ``norm``."""
    return nn.BatchNorm1d(c, eps=eps)


def norm(m: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm of (B, C, W) by module `m`: in eval mode ``layers.batch_norm``
    on its running statistics; in train mode the module itself, which
    normalises by the batch's biased variance over (B, W) and updates the
    running statistics with momentum 0.1 and the unbiased variance, as the JAX
    ``batch_norm(train=True)`` does."""
    if m.training:
        return m(x)
    return batch_norm(x, bn_params(m), m.eps)


def bn_params(m: nn.BatchNorm1d) -> Dict[str, torch.Tensor]:
    return {"scale": m.weight, "bias": m.bias, "mean": m.running_mean, "var": m.running_var}
