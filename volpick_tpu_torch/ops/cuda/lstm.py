"""Merged LSTM recurrences: the CUDA kernel ``csrc/lstm_multi.cu`` and its
plain PyTorch twin.

Port of ``volpick_tpu/ops/pallas/lstm.py::lstm_multi_pallas`` (the kernel)
and of ``volpick_tpu/models/layers.py::lstm_multi`` (the twin): G
independent LSTMs, xs (G, B, C, T) → hidden states (G, B, H, T), torch gate
order (i, f, g, o), zero initial state. Branches that run reversed are
time-flipped by the caller.

``lstm_multi`` takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from volpick_tpu_torch.ops.cuda import _build

MAX_HIDDEN = 32  # the kernel keeps 4H x H weights + 8 x H states in shared memory

launches = 0  # kernel launches made by lstm_multi on CUDA tensors


def lstm_multi_reference(
    xs: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch twin, on any device: w_ih (G, 4H, C), w_hh (G, 4H, H),
    bias (G, 4H) (= b_ih + b_hh). The input projection is hoisted out of the
    time loop, as in the JAX scan."""
    g, b, c, t = xs.shape
    h_dim = w_hh.shape[-1]
    x_proj = torch.einsum("tgbc,ghc->tgbh", xs.permute(3, 0, 1, 2), w_ih) + bias[:, None, :]
    h = xs.new_zeros((g, b, h_dim))
    cell = xs.new_zeros((g, b, h_dim))
    hs = []
    for step in range(t):
        gates = x_proj[step] + torch.einsum("gbh,gkh->gbk", h, w_hh)
        i, f, gg, o = gates.chunk(4, dim=-1)
        cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(cell)
        hs.append(h)
    return torch.stack(hs, dim=-1)  # (G, B, H, T)


def _check(xs, w_ih, w_hh, bias) -> None:
    if xs.dim() != 4:
        raise ValueError(f"xs must be (G, B, C, T), got {tuple(xs.shape)}")
    g, _, c, _ = xs.shape
    if w_hh.dim() != 3 or w_hh.shape[0] != g or w_hh.shape[1] != 4 * w_hh.shape[2]:
        raise ValueError(f"w_hh must be (G, 4H, H), got {tuple(w_hh.shape)}")
    h = w_hh.shape[2]
    if tuple(w_ih.shape) != (g, 4 * h, c):
        raise ValueError(f"w_ih must be {(g, 4 * h, c)}, got {tuple(w_ih.shape)}")
    if tuple(bias.shape) != (g, 4 * h):
        raise ValueError(f"bias must be {(g, 4 * h)}, got {tuple(bias.shape)}")
    for name, t in (("xs", xs), ("w_ih", w_ih), ("w_hh", w_hh), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xs.device:
            raise ValueError(f"{name} is on {t.device}, xs on {xs.device}")


def lstm_multi(
    xs: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """G independent LSTM recurrences, xs (G, B, C, T) → (G, B, H, T).

    On CUDA the input projection for all T steps is one batched matmul
    (G, T, B, C) x (G, 1, C, 4H); the kernel runs the recurrence only."""
    global launches
    _check(xs, w_ih, w_hh, bias)
    if xs.device.type == "cpu":
        return lstm_multi_reference(xs, w_ih, w_hh, bias)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_multi runs on cpu or cuda, got {xs.device}")
    g, b, _, t = xs.shape
    h = w_hh.shape[2]
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden size {h} exceeds the kernel's limit {MAX_HIDDEN}")
    if not w_hh.is_contiguous():
        raise ValueError("w_hh must be contiguous")
    xp = torch.matmul(xs.permute(0, 3, 1, 2), w_ih.transpose(1, 2).unsqueeze(1))
    xp = (xp + bias[:, None, None, :]).contiguous()  # (G, T, B, 4H)
    out = torch.empty((g, b, h, t), dtype=torch.float32, device=xs.device)
    if g * b * t == 0:
        return out
    fn = _build.function(
        "lstm_multi_f32", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    err = fn(
        xp.data_ptr(), w_hh.data_ptr(), out.data_ptr(), g, b, t, h,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_multi_f32 launch failed: cudaError {err}")
    launches += 1
    return out
