"""Functional layers of the picking trunks (PyTorch, NCW layout).

Port of ``volpick_tpu/models/layers.py``. Tensors are (B, C, W); conv
kernels are (O, I, K) and LSTM weights keep torch's (i, f, g, o) gate
layout, so parameters carry over from the JAX tree unchanged. The merged
LSTM recurrence runs through ``ops/cuda/lstm.py::lstm_branches`` (a CUDA
kernel on the card, its plain twin on the CPU); ``lstm(kernel=False)`` and
``bilstm(fused=True | False)`` are the JAX package's routes without the
kernel, the same recurrences in plain PyTorch on any device. ``batch_norm``
is the eval form; in train mode the models call their ``nn.BatchNorm1d``
modules, whose batch statistics and running-statistics update (momentum 0.1,
unbiased variance) are the JAX function's. ``dropout`` and
``spatial_dropout1d`` draw their keep masks from an explicit generator, or
from a ``RankRows`` of one shared by the ranks of a data mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from volpick_tpu_torch.ops.cuda.lstm import lstm_branches, lstm_branches_reference


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Tuple[int, int] = (0, 0),
    groups: int = 1,
) -> torch.Tensor:
    """1D convolution, (B, I, W) x (O, I/G, K) → (B, O, W'), explicit (left,
    right) pad. With groups=G the input channels split into G groups and
    filter rows [g·O/G, (g+1)·O/G) convolve group g: several same-shaped
    branches as one wider conv."""
    if padding != (0, 0):
        x = F.pad(x, padding)
    return F.conv1d(x, w, b, stride=stride, groups=groups)


def conv1d_same(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, groups: int = 1
) -> torch.Tensor:
    """'same' conv; an even kernel pads one extra sample on the right (the
    keras asymmetric 'same' of the reference models). torch's own
    padding="same" puts the extra sample on the left instead."""
    k = w.shape[-1]
    return conv1d(x, w, b, padding=((k - 1) // 2, k // 2), groups=groups)


def upsample2_conv1d_same(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    crop_last: bool = False,
    groups: int = 1,
) -> torch.Tensor:
    """``conv1d_same(upsample_nearest(x, 2)[..., :-1 if crop_last else None], w, b, groups)``
    as two polyphase convs at input resolution (odd kernels only).

    Output parity r reads ``out[2i+r] = sum_j w[j] x[(2i+r+j-p)//2]``, so taps
    that floor to the same input index are summed into one. ``crop_last``
    takes the even-length result to 2T-1 samples and removes what the
    phantom last copy of x[T-1] added to the final (k-1)//2 outputs."""
    k = w.shape[-1]
    if k % 2 == 0:
        raise ValueError("upsample2_conv1d_same supports odd kernels only")
    p = (k - 1) // 2
    t = x.shape[-1]
    outs = []
    for r in (0, 1):
        d_vals = [(r + j - p) // 2 for j in range(k)]
        d_min, d_max = d_vals[0], d_vals[-1]
        wk = w.new_zeros(w.shape[:-1] + (d_max - d_min + 1,))
        for j, d in enumerate(d_vals):
            wk[..., d - d_min] += w[..., j]
        outs.append(conv1d(x, wk, padding=(-d_min, d_max), groups=groups))
    y = torch.stack(outs, dim=-1).reshape(x.shape[0], w.shape[0], 2 * t)
    if crop_last:
        y = y[..., : 2 * t - 1]
        if p > 0:
            # position m of the last p used tap 2p - m on x[T-1]
            xg = x[..., t - 1].reshape(x.shape[0], groups, w.shape[1])
            wg = w[..., p + 1 :].flip(-1).reshape(groups, w.shape[0] // groups, w.shape[1], p)
            corr = torch.einsum("bgi,goip->bgop", xg, wg).reshape(x.shape[0], w.shape[0], p)
            y = torch.cat([y[..., : 2 * t - 1 - p], y[..., 2 * t - 1 - p :] - corr], dim=-1)
    if b is not None:
        y = y + b[None, :, None]
    return y


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int = 0) -> torch.Tensor:
    """Transposed conv with a torch ConvTranspose1d weight (I, O, K), no bias:
    output length (L-1)*stride + K - 2*padding. The JAX package stores the
    same kernel transposed and flipped for an input-dilated conv
    (``volpick_tpu/models/torch_import.py``); ``models/convert.py`` undoes that."""
    return F.conv_transpose1d(x, w, stride=stride, padding=padding)


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-3) -> torch.Tensor:
    """Eval-mode BatchNorm over (B, C, W) from running statistics; `p` holds
    scale/bias/mean/var (C,). eps 1e-3 is the Keras convention of the models."""
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"][None, :, None]) * (inv * p["scale"])[None, :, None] + p["bias"][
        None, :, None
    ]


def layer_norm_keras(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-14
) -> torch.Tensor:
    """Keras LayerNormalization over the channel axis of (B, C, W); gamma and
    beta are (C, 1) as in the reference weights."""
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    return gamma[None] * (x - mean) / torch.sqrt(var + eps) + beta[None]


def max_pool1d(x: torch.Tensor, k: int = 2, stride: Optional[int] = None, padding: int = 0):
    """Max pooling over the last axis with -inf padding on both sides."""
    if padding:
        x = F.pad(x, (padding, padding), value=float("-inf"))
    return F.max_pool1d(x, k, stride or k)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling along time."""
    return torch.repeat_interleave(x, factor, dim=-1)


@dataclasses.dataclass(frozen=True)
class RankRows:
    """A generator that every rank of a data mesh seeds alike, for rank
    `rank` of `world`: a mask is drawn at the global batch's shape and the
    rank keeps its block of rows, so the masks of a data-parallel step are
    those of one process holding the whole batch (JAX's sharded step draws
    them at the global shape too)."""

    generator: torch.Generator
    rank: int
    world: int


def _drop(x: torch.Tensor, rate: float, generator: Union[torch.Generator, RankRows, None], train: bool,
          mask_shape):
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    if isinstance(generator, RankRows):
        b = mask_shape[0]
        u = torch.rand((b * generator.world,) + tuple(mask_shape[1:]), generator=generator.generator,
                       device=x.device)[generator.rank * b : (generator.rank + 1) * b]
    else:
        u = torch.rand(mask_shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, generator: Union[torch.Generator, RankRows, None], train: bool):
    """Zero each element with probability `rate` and scale the kept ones by
    1 / (1 - rate); the identity unless training with a generator and rate > 0."""
    return _drop(x, rate, generator, train, x.shape)


def spatial_dropout1d(x: torch.Tensor, rate: float, generator: Union[torch.Generator, RankRows, None],
                      train: bool):
    """``dropout`` of whole channels of (B, C, W) (keras SpatialDropout1D)."""
    return _drop(x, rate, generator, train, (x.shape[0], x.shape[1], 1))


def lstm(
    x: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b_ih: torch.Tensor,
    b_hh: torch.Tensor,
    reverse: bool = False,
    kernel: bool = True,
) -> torch.Tensor:
    """One LSTM over (B, C, T) → (B, H, T), optionally scanning time reversed.
    ``kernel=False`` takes the plain recurrence on any device."""
    run = lstm_branches if kernel else lstm_branches_reference
    return run(x, w_ih[None], w_hh[None], (b_ih + b_hh)[None], reverse=(reverse,))


def bilstm(x: torch.Tensor, p: Dict[str, torch.Tensor], fused="pallas") -> torch.Tensor:
    """Bidirectional LSTM, (B, C, T) → (B, 2H, T), forward states first on the
    channel axis. ``fused`` is the JAX function's switch: ``"pallas"`` (the
    port's default) runs both directions in one ``lstm_branches`` call over
    the same x, the kernel on the card; ``True`` the same merged recurrence
    without the kernel; ``False`` one plain recurrence a direction."""
    if not fused:
        fwd = lstm(x, p["w_ih"], p["w_hh"], p["b_ih"], p["b_hh"], kernel=False)
        bwd = lstm(x, p["w_ih_rev"], p["w_hh_rev"], p["b_ih_rev"], p["b_hh_rev"],
                   reverse=True, kernel=False)
        return torch.cat([fwd, bwd], dim=1)
    w_ih = torch.stack([p["w_ih"], p["w_ih_rev"]])
    w_hh = torch.stack([p["w_hh"], p["w_hh_rev"]])
    bias = torch.stack([p["b_ih"], p["b_ih_rev"]]) + torch.stack([p["b_hh"], p["b_hh_rev"]])
    run = lstm_branches if fused == "pallas" else lstm_branches_reference
    return run(x, w_ih, w_hh, bias, reverse=(False, True))


def seq_self_attention(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """Dense additive self-attention over (B, C, T) with the reference
    weights' parameterisation: e[t, s] = Wa . tanh(x_t Wt + x_s Wx + bh) + ba,
    softmax over s with max subtraction and `eps` added to the denominator.
    Returns values (B, C, T)."""
    xt = x.transpose(1, 2)  # (B, T, C)
    q = xt @ p["Wt"]
    k = xt @ p["Wx"]
    h = torch.tanh(q[:, :, None, :] + k[:, None, :, :] + p["bh"])  # (B, T, T, U)
    e = (h @ p["Wa"])[..., 0] + p["ba"][0]
    e = torch.exp(e - e.amax(dim=-1, keepdim=True))
    a = e / (e.sum(dim=-1, keepdim=True) + eps)
    return (a @ xt).transpose(1, 2)


def seq_self_attention_masked(
    x: torch.Tensor, p: Dict[str, torch.Tensor], attention_width: int, eps: float = 1e-5
) -> torch.Tensor:
    """``seq_self_attention`` with a band mask of `attention_width` around the
    diagonal: the dense (B, T, T) energies are computed, stabilised by the
    max of the whole row and masked afterwards (the keras SeqSelfAttention
    semantics of the reference's pick branches; the JAX function's
    ``attention_width=`` option). Returns values (B, C, T)."""
    t = x.shape[-1]
    xt = x.transpose(1, 2)  # (B, T, C)
    q = xt @ p["Wt"]
    k = xt @ p["Wx"]
    h = torch.tanh(q[:, :, None, :] + k[:, None, :, :] + p["bh"])  # (B, T, T, U)
    e = (h @ p["Wa"])[..., 0] + p["ba"][0]
    e = torch.exp(e - e.amax(dim=-1, keepdim=True))
    idx = torch.arange(t, device=x.device)
    lower = idx - attention_width // 2
    mask = (idx[None, :] >= lower[:, None]) & (idx[None, :] < (lower + attention_width)[:, None])
    e = torch.where(mask[None], e, torch.zeros_like(e))
    a = e / (e.sum(dim=-1, keepdim=True) + eps)
    return (a @ xt).transpose(1, 2)


def seq_self_attention_banded(
    x: torch.Tensor, p: Dict[str, torch.Tensor], attention_width: int, eps: float = 1e-5
) -> torch.Tensor:
    """``seq_self_attention`` restricted to its `attention_width` diagonals:
    width*B*T*U tanh evaluations instead of B*T^2*U. The stabilising max is
    taken over the band rather than the whole row, which moves the result by
    O(eps) through the +eps of the denominator. Returns values (B, C, T)."""
    t = x.shape[-1]
    xt = x.transpose(1, 2)  # (B, T, C)
    q = xt @ p["Wt"] + p["bh"]
    k = xt @ p["Wx"]
    idx = torch.arange(t, device=x.device)
    lo = -(attention_width // 2)
    raws, valids, vals = [], [], []
    for d in range(lo, lo + attention_width):
        raw = torch.tanh(q + torch.roll(k, -d, dims=1)) @ p["Wa"] + p["ba"][0]  # (B, T, 1)
        raws.append(raw[..., 0])
        valids.append((idx + d >= 0) & (idx + d < t))
        vals.append(torch.roll(xt, -d, dims=1))
    raw = torch.stack(raws, dim=-1)  # (B, T, W)
    valid = torch.stack(valids, dim=-1)[None]  # (1, T, W)
    neg = torch.full_like(raw, float("-inf"))
    m = torch.where(valid, raw, neg).amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(raw - m), torch.zeros_like(raw))
    a = e / (e.sum(dim=-1, keepdim=True) + eps)
    v = torch.einsum("btw,bwtc->btc", a, torch.stack(vals, dim=1))
    return v.transpose(1, 2)
