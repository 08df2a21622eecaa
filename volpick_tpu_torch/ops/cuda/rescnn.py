"""EQTransformer's residual CNN stack as one kernel: ``csrc/rescnn.cu`` and
its plain PyTorch twin.

Port of ``volpick_tpu/ops/pallas/rescnn.py``: ``fold_res_cnn_params`` packs
the model's pre-activation residual blocks (eval-mode BatchNorm folded into
per-channel affines, every conv as three taps over offsets (-1, 0, +1)), and
``res_cnn_stack(x, packed)`` runs all blocks on x (B, C, T) → (B, C, T) with
the activation resident on the SM and each conv's weights staged in shared
memory. ``rescnn_plan(b, n_sm)`` says how the windows go over CTAs. As in the
JAX package it is wired into no model forward: it is held against the model's
own res-CNN section.

``res_cnn_stack`` takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from volpick_tpu_torch.ops.cuda import _build, refuse_autograd

MAX_CHANNELS = 64  # a conv's weights lie in shared memory as 3 x 64 x 64
MAX_TOKENS = 48  # four time groups of 12 steps, each in one thread's registers
MAX_WINDOWS = 4  # windows a CTA: what shared memory holds beside two convs' weights
# output channels a thread owns in the default build of csrc/rescnn.cu (RESCNN_CO)
CHANNELS_PER_THREAD = 4
# windows a CTA; None lets rescnn_plan choose (scripts/k6_designs.py sets it)
WINDOWS_PER_CTA: Optional[int] = None

launches = 0  # kernel launches made by res_cnn_stack on CUDA tensors

_KEYS = ("w1", "w2", "cb1", "cb2", "g1", "b1", "g2", "b2")


def _taps(w: torch.Tensor) -> torch.Tensor:
    """(O, I, K) conv kernel → (3, I, O) taps over offsets (-1, 0, +1). A
    kernel of 2 is the right-asymmetric 'same' conv y[t] = W0 x[t] + W1 x[t+1]:
    taps (0, +1) and a zero -1 tap."""
    k = w.shape[-1]
    out = w.new_zeros((3, w.shape[1], w.shape[0]))
    if k == 3:
        out.copy_(w.permute(2, 1, 0))
    elif k == 2:
        out[1:].copy_(w.permute(2, 1, 0))
    else:
        raise ValueError(f"unsupported res-cnn kernel size {k}")
    return out


def _fold_bn(norm: torch.nn.BatchNorm1d):
    g = norm.weight / torch.sqrt(norm.running_var + norm.eps)
    return g, norm.bias - norm.running_mean * g


@torch.no_grad()
def fold_res_cnn_params(res_cnn_stack) -> Dict[str, torch.Tensor]:
    """Pack a model's ``res_cnn_stack`` (its ``members``: blocks with norm1,
    conv1, norm2, conv2) into dense float32 arrays on the blocks' device:
    w1, w2 (NB, 3, C, C) as [block, tap, in, out]; cb1, cb2 (NB, C) conv
    biases; g1, b1, g2, b2 (NB, C) folded BatchNorm affines
    (g = γ/√(σ² + eps), b = β − μ g)."""
    blocks = list(res_cnn_stack.members)
    affines = [(_fold_bn(b.norm1), _fold_bn(b.norm2)) for b in blocks]
    packed = {
        "w1": torch.stack([_taps(b.conv1.weight) for b in blocks]),
        "w2": torch.stack([_taps(b.conv2.weight) for b in blocks]),
        "cb1": torch.stack([b.conv1.bias for b in blocks]),
        "cb2": torch.stack([b.conv2.bias for b in blocks]),
        "g1": torch.stack([a[0][0] for a in affines]),
        "b1": torch.stack([a[0][1] for a in affines]),
        "g2": torch.stack([a[1][0] for a in affines]),
        "b2": torch.stack([a[1][1] for a in affines]),
    }
    return {k: v.detach().float().contiguous() for k, v in packed.items()}


def res_cnn_stack_reference(x: torch.Tensor, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch twin, on any device: the folded affines and three-tap
    convs of the kernel, one convolution call per conv."""
    def conv(y, taps, bias):  # taps (3, I, O) → torch's (O, I, 3)
        return F.conv1d(y, taps.permute(2, 1, 0), bias, padding=1)

    col = lambda v: v[None, :, None]
    for j in range(packed["w1"].shape[0]):
        y = F.relu(x * col(packed["g1"][j]) + col(packed["b1"][j]))
        y = conv(y, packed["w1"][j], packed["cb1"][j])
        y = F.relu(y * col(packed["g2"][j]) + col(packed["b2"][j]))
        x = x + conv(y, packed["w2"][j], packed["cb2"][j])
    return x


def rescnn_plan(b: int, n_sm: int, wpc: Optional[int] = None) -> Tuple[int, int, int]:
    """``(windows a CTA, CTAs, bytes of dynamic shared memory a CTA)`` for B
    windows on a card of ``n_sm`` SMs. A CTA stages every conv's weights once
    for all its windows and holds an SM alone (two weight buffers are 96 KB),
    so it takes as few windows as leave no SM with a second CTA, at most
    ``MAX_WINDOWS``; more windows than that run in waves. ``wpc`` fixes the
    windows a CTA instead."""
    if b < 1 or n_sm < 1:
        raise ValueError(f"rescnn_plan needs b >= 1 and n_sm >= 1, got {b}, {n_sm}")
    if wpc is None:
        wpc = min(MAX_WINDOWS, -(-b // n_sm))
    if not 1 <= wpc <= MAX_WINDOWS:
        raise ValueError(f"windows a CTA must be 1 ... {MAX_WINDOWS}, got {wpc}")
    # csrc/rescnn.cu: two weight buffers, two parameter buffers of 6 x 64, two
    # activation buffers a window of 64 rows of 56 words, each row skewed by 4
    # words a thread's channel group
    act_words = MAX_CHANNELS * 56 + 4 * (MAX_CHANNELS // CHANNELS_PER_THREAD)
    words = 2 * 3 * MAX_CHANNELS * MAX_CHANNELS + 2 * 6 * MAX_CHANNELS + wpc * 2 * act_words
    return wpc, -(-b // wpc), 4 * words


def _check(x: torch.Tensor, packed: Dict[str, torch.Tensor]) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    c = x.shape[1]
    missing = [k for k in _KEYS if k not in packed]
    if missing:
        raise ValueError(f"packed lacks {missing}")
    nb = packed["w1"].shape[0]
    for k in _KEYS:
        want = (nb, 3, c, c) if k in ("w1", "w2") else (nb, c)
        if tuple(packed[k].shape) != want:
            raise ValueError(f"packed[{k!r}] must be {want}, got {tuple(packed[k].shape)}")
    for name, a in [("x", x)] + [(k, packed[k]) for k in _KEYS]:
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")


def res_cnn_stack(x: torch.Tensor, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """All residual blocks of ``packed`` (from ``fold_res_cnn_params``) on
    x (B, C, T) float32 → (B, C, T)."""
    global launches
    _check(x, packed)
    if x.device.type == "cpu":
        return res_cnn_stack_reference(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"res_cnn_stack runs on cpu or cuda, got {x.device}")
    b, c, t = x.shape
    if c > MAX_CHANNELS or t > MAX_TOKENS:
        raise ValueError(
            f"channels {c} / tokens {t} exceed the kernel's limits {MAX_CHANNELS} / {MAX_TOKENS}"
        )
    for name, a in [("x", x)] + [(k, packed[k]) for k in _KEYS]:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    refuse_autograd("res_cnn_stack", x=x, **{k: packed[k] for k in _KEYS})
    out = torch.empty_like(x)
    if b * c * t == 0 or packed["w1"].shape[0] == 0:
        return out.copy_(x)
    fn = _build.function(
        "rescnn_f32", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    wpc, _, _ = rescnn_plan(b, n_sm, WINDOWS_PER_CTA)
    err = fn(
        x.data_ptr(), *(packed[k].data_ptr() for k in _KEYS), out.data_ptr(),
        b, c, t, packed["w1"].shape[0], wpc, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rescnn_f32 launch failed: cudaError {err}")
    launches += 1
    return out
