"""TPUPickNet (the JAX package's own picker) in PyTorch, eval and train forwards.

Port of ``volpick_tpu/models/tpupicknet.py`` (v2): five stride-2 conv stages
take 3008 samples to 94 tokens at d_model 128 (gelu after each, the outputs
kept as skips), learned positions, ``n_layers`` pre-norm transformer blocks
(multi-head softmax attention, MLP x``mlp_ratio``), a final layer norm, five
x2 polyphase upsample-convs with additive encoder skips, and a P/S/N softmax.

Parameters keep the flattened names of the JAX tree (``enc.{i}.w``, ``pos``,
``blocks.{i}.qkv.w``, ...), the keys ``train/model_io.py::export_pretrained``
writes into a ``.npz.v1``, so native weights map one to one. Dense weights
are (in, out) and applied as ``y @ w + b``; conv kernels are (O, I, K).

``attn`` selects the attention: ``"xla"`` is the plain einsum route,
``"pallas"`` is K7 (``ops/cuda/attention.py::mha_qkv``: the CUDA kernel for
a CUDA tensor, its plain twin for a CPU tensor), which reads q, k, v in place
from the block's (B, T, 3, H, Dh) projection. The names are the JAX
package's, so its configs and ``VOLPICK_TPN_ATTN`` carry over. In train mode
(``model.train()``) the forward always takes ``"xla"``, as JAX
``apply(train=True)`` does: K7 has no backward. The model has no BatchNorm
and no dropout.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from volpick_tpu_torch.models.layers import conv1d, conv1d_same, upsample2_conv1d_same
from volpick_tpu_torch.models.params import WB, normal, uniform
from volpick_tpu_torch.ops.cuda.attention import mha_qkv

_LN_EPS = 1e-6
_ENC_KERNELS = (7, 5, 5, 3, 3)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    return F.gelu(x, approximate="tanh")


def _layer_norm(x: torch.Tensor, p: "_LN") -> torch.Tensor:
    """Over the last axis of (B, T, D)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * p.scale + p.bias


class _LN(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


def _dense(i: int, o: int, std: float, gen: torch.Generator) -> WB:
    return WB(normal((i, o), std, gen), torch.zeros(o))


def _conv(o: int, i: int, k: int, gen: torch.Generator) -> WB:
    return WB(uniform((o, i, k), (6.0 / (i * k)) ** 0.5, gen), torch.zeros(o))


class _Block(nn.Module):
    def __init__(self, d: int, mlp_ratio: int, gen: torch.Generator):
        super().__init__()
        self.ln1 = _LN(d)
        self.qkv = _dense(d, 3 * d, math.sqrt(1.0 / d), gen)
        self.proj = _dense(d, d, math.sqrt(1.0 / d), gen)
        self.ln2 = _LN(d)
        self.mlp1 = _dense(d, mlp_ratio * d, math.sqrt(2.0 / d), gen)
        self.mlp2 = _dense(mlp_ratio * d, d, math.sqrt(1.0 / (mlp_ratio * d)), gen)


class TPUPickNet(nn.Module):
    """x (B, 3, in_samples) → (B, classes, in_samples) class probabilities.

    Parameters are drawn from ``generator`` (a fresh ``torch.Generator``
    seeded 0 when omitted) with the distributions of the JAX
    ``TPUPickNet.init``."""

    name = "TPUPickNet"

    def __init__(
        self,
        in_channels: int = 3,
        in_samples: int = 3008,
        classes: int = 3,
        phases: str = "PSN",
        norm: str = "peak",
        sampling_rate: float = 100.0,
        d_model: int = 128,
        n_heads: int = 4,
        n_layers: int = 4,
        mlp_ratio: int = 4,
        patch_stride: int = 32,
        component_order: str = "ZNE",
        default_args: Optional[dict] = None,
        attn: Optional[str] = None,
        default_classify_batch: int = 128,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.in_samples = in_samples
        self.classes = classes
        self.phases = phases
        self.norm = norm
        self.sampling_rate = sampling_rate
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.mlp_ratio = mlp_ratio
        self.patch_stride = patch_stride
        self.component_order = component_order
        self.default_args = dict(default_args or {})
        self.attn = attn
        # forward-chunk default of WaveformPicker for this architecture
        self.default_classify_batch = default_classify_batch
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        d = d_model
        self.blocks = nn.ModuleList(_Block(d, mlp_ratio, gen) for _ in range(n_layers))
        c1, c2, c3, c4, c5 = self._enc_channels
        ins = (in_channels, c1, c2, c3, c4)
        self.enc = nn.ModuleList(
            _conv(o, i, k, gen) for o, i, k in zip((c1, c2, c3, c4, c5), ins, _ENC_KERNELS)
        )
        self.pos = nn.Parameter(normal((self.n_tokens, d), 0.02, gen))
        self.ln_f = _LN(d)
        self.dec = nn.ModuleList(
            _conv(o, i, 3, gen) for o, i in ((c4, d), (c3, c4), (c2, c3), (c1, c2), (d // 8, c1))
        )
        self.out = _conv(classes, d // 8, 7, gen)

    @property
    def _enc_channels(self):
        d = self.d_model
        return (d // 4, d // 2, d, d, d)

    @property
    def n_tokens(self) -> int:
        return self.in_samples // self.patch_stride

    def resolve_attn(self, sharded: bool = False) -> str:
        """The attention route: the ``attn`` field, else ``$VOLPICK_TPN_ATTN``,
        else ``"xla"`` (the order of the JAX ``resolve_attn``). ``sharded``
        (a picker over a mesh) ignores the environment, as JAX does: only
        the field can pick ``"pallas"`` there."""
        if self.attn is not None:
            return self.attn
        env = os.environ.get("VOLPICK_TPN_ATTN", "").strip().lower()
        return env if env and not sharded else "xla"

    def _attention(self, qkv: torch.Tensor, attn: str) -> torch.Tensor:
        """The projection qkv (B, T, 3, H, Dh) → (B, T, H*Dh), q scaled by
        1/sqrt(Dh). Under ``"pallas"`` K7 reads the projection in place."""
        b, t, _, h, dh = qkv.shape
        scale = 1.0 / math.sqrt(dh)
        if attn == "pallas":
            return mha_qkv(qkv, scale)
        q, k, v = qkv.unbind(2)
        att = torch.softmax(torch.einsum("bthd,bshd->bhts", q, k) * scale, dim=-1)
        return torch.einsum("bhts,bshd->bthd", att, v).reshape(b, t, h * dh)

    @property
    def labels(self) -> str:
        return self.phases

    def forward(self, x: torch.Tensor, attn: Optional[str] = None) -> torch.Tensor:
        attn = attn if attn is not None else self.resolve_attn()
        if attn not in ("xla", "pallas"):
            raise ValueError(f"unknown attn implementation: {attn!r}")
        if self.training:
            attn = "xla"
        b = x.shape[0]
        d = self.d_model
        skips = []
        h = x
        for p, k in zip(self.enc, _ENC_KERNELS):
            h = _gelu(conv1d(h, p.w, p.b, stride=2, padding=(k // 2, k // 2)))
            skips.append(h)

        h = h.transpose(1, 2) + self.pos[None]  # (B, T, D)
        t = h.shape[1]
        for blk in self.blocks:
            y = _layer_norm(h, blk.ln1)
            qkv = (y @ blk.qkv.w + blk.qkv.b).reshape(b, t, 3, self.n_heads, d // self.n_heads)
            y = self._attention(qkv, attn)
            h = h + y @ blk.proj.w + blk.proj.b
            y = _gelu(_layer_norm(h, blk.ln2) @ blk.mlp1.w + blk.mlp1.b)
            h = h + y @ blk.mlp2.w + blk.mlp2.b
        h = _layer_norm(h, self.ln_f).transpose(1, 2)  # (B, D, T)

        for i, p in enumerate(self.dec):
            h = upsample2_conv1d_same(h, p.w, p.b)
            skip_i = len(skips) - 2 - i  # 188, 376, 752, 1504 resolutions
            if skip_i >= 0:
                h = h + skips[skip_i]
            h = _gelu(h)
        return torch.softmax(conv1d_same(h, self.out.w, self.out.b), dim=1)
