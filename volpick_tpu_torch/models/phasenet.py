"""PhaseNet (Zhu & Beroza 2019) 1D U-Net in PyTorch, eval and train forwards.

Port of ``volpick_tpu/models/phasenet.py``: 3→8 ``inc`` conv (k7) + BN, five
down stages (same-conv + BN, then a stride-4 conv + BN on all but the last;
channels 8..128), four up stages (transposed conv stride 4 + BN, centre crop
to the skip length, concat [skip, x], same-conv + BN), a 1x1 output conv and
a softmax over the classes (P, S, N). Window 3001 samples at 100 Hz, ZNE.

The stride-4 convs of stages 1-3 take the manual (left, right) pads of the
original TF model, stage 0 a symmetric k//2. BN eps is 1e-3. In train mode
(``model.train()``) every BatchNorm normalises by the batch's statistics and
updates its running statistics in place, as JAX ``apply(train=True)``; the
model has no dropout.

Submodules carry the SeisBench state-dict names (``inc``, ``in_bn``,
``down_branch.{i}.{0..3}``, ``up_branch.{i}.{0..3}``, ``out``; the names of
``tests/torch_oracle.py::PhaseNetTorch``), so a published
``phasenet/volpick.pt.v1`` loads with ``load_state_dict(strict=True)``. The
transposed convs keep torch's ConvTranspose1d weight layout (I, O, K).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from volpick_tpu_torch.models.layers import conv1d, conv_transpose1d
from volpick_tpu_torch.models.params import Conv, bn, norm, uniform

# manual (left, right) pads before the stride-4 convs of stages 1..3
_DOWN_PADS = {1: (2, 3), 2: (1, 3), 3: (2, 3)}
_BN_EPS = 1e-3


class _ConvTranspose(nn.Module):
    """ConvTranspose1d weight (I, O, K), no bias; uniform(±sqrt(6/(I*K)))."""

    def __init__(self, i: int, o: int, k: int, gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(uniform((i, o, k), (6.0 / (i * k)) ** 0.5, gen))


class PhaseNet(nn.Module):
    """x (B, 3, in_samples) → (B, classes, in_samples) class probabilities.

    Parameters are drawn from ``generator`` (a fresh ``torch.Generator``
    seeded 0 when omitted) with the distributions of the JAX
    ``PhaseNet.init``; BN statistics start at identity."""

    name = "PhaseNet"

    def __init__(
        self,
        in_channels: int = 3,
        classes: int = 3,
        phases: str = "PSN",
        norm: str = "peak",
        sampling_rate: float = 100.0,
        in_samples: int = 3001,
        depth: int = 5,
        kernel_size: int = 7,
        stride: int = 4,
        filters_root: int = 8,
        component_order: str = "ZNE",
        default_args: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.classes = classes
        self.phases = phases
        self.norm = norm
        self.sampling_rate = sampling_rate
        self.in_samples = in_samples
        self.depth = depth
        self.kernel_size = kernel_size
        self.stride = stride
        self.filters_root = filters_root
        self.component_order = component_order
        self.default_args = dict(default_args or {})
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        fr, ks = filters_root, kernel_size
        self.inc = Conv(in_channels, fr, ks, gen)
        self.in_bn = bn(fr, _BN_EPS)
        self.down_branch = nn.ModuleList()
        last = fr
        for i in range(depth):
            filters = int(2**i * fr)
            stage = [Conv(last, filters, ks, gen, bias=False), bn(filters, _BN_EPS), None, None]
            last = filters
            if i < depth - 1:
                stage[2:] = [Conv(filters, filters, ks, gen, bias=False), bn(filters, _BN_EPS)]
            self.down_branch.append(nn.ModuleList(stage))
        self.up_branch = nn.ModuleList()
        for i in range(depth - 1):
            filters = int(2 ** (depth - 2 - i) * fr)
            self.up_branch.append(nn.ModuleList([
                _ConvTranspose(last, filters, ks, gen), bn(filters, _BN_EPS),
                Conv(2 * filters, filters, ks, gen, bias=False), bn(filters, _BN_EPS),
            ]))
            last = filters
        self.out = Conv(fr, classes, 1, gen)

    @property
    def labels(self) -> str:
        return self.phases

    @property
    def pred_sample_rate(self) -> float:
        return self.sampling_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def bn_relu(h, m):
            return F.relu(norm(m, h))

        h = bn_relu(self.inc.same(x), self.in_bn)
        skips: List[torch.Tensor] = []
        for i, (conv_same, bn1, conv_down, bn2) in enumerate(self.down_branch):
            h = bn_relu(conv_same.same(h), bn1)
            if conv_down is not None:
                skips.append(h)
                pad = _DOWN_PADS.get(i, (self.kernel_size // 2, self.kernel_size // 2))
                h = bn_relu(conv1d(h, conv_down.weight, stride=self.stride, padding=pad), bn2)
        for (conv_up, bn1, conv_same, bn2), skip in zip(self.up_branch, skips[::-1]):
            h = bn_relu(conv_transpose1d(h, conv_up.weight, self.stride), bn1)
            offset = (h.shape[-1] - skip.shape[-1]) // 2
            h = torch.cat([skip, h[..., offset : offset + skip.shape[-1]]], dim=1)
            h = bn_relu(conv_same.same(h), bn2)
        return torch.softmax(conv1d(h, self.out.weight, self.out.bias), dim=1)
