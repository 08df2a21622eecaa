"""Merged LSTM recurrences: the CUDA kernel ``csrc/lstm_multi.cu`` and its
plain PyTorch twins.

Port of ``volpick_tpu/ops/pallas/lstm.py::lstm_multi_pallas`` (the kernel)
and of ``volpick_tpu/models/layers.py::lstm_multi`` (the twin), torch gate
order (i, f, g, o), zero initial state, in two forms served by one kernel
body:

- ``lstm_multi(xs, w_ih, w_hh, bias)`` keeps the JAX package's contract: G
  independent LSTMs, xs (G, B, C, T) → hidden states (G, B, H, T); branches
  that run reversed are time-flipped by the caller.
- ``lstm_branches(x, w_ih, w_hh, bias, reverse)`` runs G LSTMs over ONE
  input x (B, C, T), branch g scanning time backward where ``reverse[g]``,
  and returns (B, G·H, T) with branch g in channels g·H .. g·H+H-1: what a
  bidirectional LSTM, or several LSTMs reading one trunk, need, without
  stacked or flipped copies of x and without flipping and concatenating the
  states. All branches share one projection of x against the stacked W_ih.

On CUDA in float32 the input projection for all T steps is one batched
matrix product outside the kernel, against W_ih with its rows permuted
unit-major (``unit_major``), so that a thread's four gate inputs lie side by
side; the kernel adds the bias and runs the recurrence. Each entry takes its
twin for a CPU tensor and the kernel for a CUDA tensor; there is no other
route.

Both forms take float32 or bfloat16 (x and the weights of one type). The
bfloat16 entry computes what the Pallas kernel computes on bf16 operands,
with the projection as ``lstm_multi_pallas`` forms it: the gate inputs are
bf16(bf16(x . W_ih) + b) (a bf16 product with float32 sums, rounded, the
bias added in bf16), h and c are carried and the gates computed in float32,
and the states are written as bf16. On CUDA that is one launch a call
(``csrc/lstm_multi.cu``'s bf16 body projects on the tensor cores inside the
kernel, no W_ih copy, no matrix product outside). The bf16 twins take the
product from ``project``; the card sums it in another order, which can move
a gate input by one bf16 ulp. There is no route that casts bf16 up and calls
the float32 entry.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from volpick_tpu_torch.ops.cuda import ENTRY_SUFFIX, _build, refuse_autograd

MAX_HIDDEN = 32  # a window's units are the lanes of one warp
MAX_BRANCHES = 32  # bits of the kernel's reverse mask

launches = 0  # kernel launches made by lstm_multi and lstm_branches on CUDA tensors
bf16_launches = 0  # of them, launches of the bf16 instantiation


def lstm_multi_reference(
    xs: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch twin, on any device: w_ih (G, 4H, C), w_hh (G, 4H, H),
    bias (G, 4H) (= b_ih + b_hh). The input projection is hoisted out of the
    time loop, as in the JAX scan. On bfloat16 operands the projection is
    the wrapper's own bf16 product (``project``) and the recurrence runs in
    float32 (``_recurrence_reference``), the states rounded to bf16."""
    if xs.dtype == torch.bfloat16:
        return _recurrence_reference(project(xs, w_ih), w_hh, bias)
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


def _recurrence_reference(xp: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's arithmetic in plain PyTorch: xp (G, B, T, 4H), the
    bf16 projection without bias in unit-major order (``unit_major``), gets
    the bias added in bf16 (bf16(xp + b), as ``lstm_multi_pallas`` forms its
    projection) and is widened to float32, as are W_hh; gates, h and c in
    float32; the states (G, B, H, T) come back rounded to xp's type."""
    g, b, t, four_h = xp.shape
    h_dim = four_h // 4
    w = w_hh.float()
    bias_um = unit_major(bias.to(xp.dtype))  # (G, 4H)
    xb = (xp + bias_um[:, None, None, :]).float().reshape(g, b, t, h_dim, 4)
    h = xp.new_zeros((g, b, h_dim), dtype=torch.float32)
    cell = torch.zeros_like(h)
    hs = []
    for step in range(t):
        rec = torch.einsum("gbh,gkh->gbk", h, w).reshape(g, b, 4, h_dim).transpose(2, 3)
        gates = xb[:, :, step] + rec
        i, f, gg, o = gates.unbind(-1)
        cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(cell)
        hs.append(h)
    return torch.stack(hs, dim=-1).to(xp.dtype)


def lstm_branches_reference(
    x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
    reverse: Sequence[bool],
) -> torch.Tensor:
    """Plain PyTorch twin of ``lstm_branches``, on any device: the reversed
    branches scan a time-flipped copy of x and their states are flipped back,
    then the branches are concatenated on the channel axis."""
    xs = torch.stack([x.flip(-1) if r else x for r in reverse])
    hs = lstm_multi_reference(xs, w_ih, w_hh, bias)
    return torch.cat([hs[g].flip(-1) if r else hs[g] for g, r in enumerate(reverse)], dim=1)


def unit_major(w: torch.Tensor) -> torch.Tensor:
    """Rows of a (G, 4H, ...) gate-major tensor (i, f, g, o blocks of H)
    reordered unit-major: row 4u + gate of the result is row gate·H + u."""
    g, four_h = w.shape[:2]
    rest = w.shape[2:]
    return w.reshape((g, 4, four_h // 4) + rest).transpose(1, 2).reshape((g, four_h) + rest)


def _check_weights(g: int, c: int, w_ih, w_hh, bias, like: torch.Tensor) -> None:
    if w_hh.dim() != 3 or w_hh.shape[0] != g or w_hh.shape[1] != 4 * w_hh.shape[2]:
        raise ValueError(f"w_hh must be (G, 4H, H), got {tuple(w_hh.shape)}")
    h = w_hh.shape[2]
    if tuple(w_ih.shape) != (g, 4 * h, c):
        raise ValueError(f"w_ih must be {(g, 4 * h, c)}, got {tuple(w_ih.shape)}")
    if tuple(bias.shape) != (g, 4 * h):
        raise ValueError(f"bias must be {(g, 4 * h)}, got {tuple(bias.shape)}")
    if like.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {like.dtype}")
    for name, t in (("x", like), ("w_ih", w_ih), ("w_hh", w_hh), ("bias", bias)):
        if t.dtype != like.dtype:
            raise TypeError(f"{name} must be {like.dtype} as x is, got {t.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, x on {like.device}")


def _check(xs, w_ih, w_hh, bias) -> None:
    if xs.dim() != 4:
        raise ValueError(f"xs must be (G, B, C, T), got {tuple(xs.shape)}")
    _check_weights(xs.shape[0], xs.shape[2], w_ih, w_hh, bias, xs)


def recurrence(
    xp: torch.Tensor, x_strides, w_hh: torch.Tensor, bias: torch.Tensor,
    out: torch.Tensor, out_strides, b: int, t: int, reverse_mask: int = 0,
) -> None:
    """Launch the float32 kernel on a projected input: gate inputs of (branch
    g, window n, time s, unit u) are the 4 elements of `xp` at
    g·x_strides[0] + n·x_strides[1] + s·x_strides[2] + 4u; its state goes to
    `out` at g·out_strides[0] + n·out_strides[1] + u·T + s. CUDA only."""
    global launches
    refuse_autograd("lstm recurrence", xp=xp, w_hh=w_hh, bias=bias)
    g, _, h = w_hh.shape
    _check_launch(g, h, reverse_mask)
    if xp.dtype != torch.float32:
        raise TypeError(f"the recurrence alone runs on float32, got {xp.dtype}")
    _check_operands(xp.dtype, xp=xp, w_hh=w_hh, bias=bias, out=out)
    if g * b * t == 0:
        return
    fn = _build.function(
        "lstm_multi_f32",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 5
        + [ctypes.c_uint, ctypes.c_void_p],
    )
    err = fn(
        xp.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), out.data_ptr(), g, b, t, h,
        *x_strides, *out_strides, reverse_mask,
        torch.cuda.current_stream(xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_multi_f32 launch failed: cudaError {err}")
    launches += 1


def _check_launch(g: int, h: int, reverse_mask: int) -> None:
    if h > MAX_HIDDEN:
        raise ValueError(f"hidden size {h} exceeds the kernel's limit {MAX_HIDDEN}")
    if reverse_mask and g > MAX_BRANCHES:
        raise ValueError(f"{g} branches exceed the {MAX_BRANCHES} the reverse flags cover")


def _check_operands(dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    for name, a in tensors.items():
        if a.device.type != "cuda" or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")


def fused_bf16(
    x: torch.Tensor, x_branch_stride: int, w_ih: torch.Tensor, w_hh: torch.Tensor,
    bias: torch.Tensor, out: torch.Tensor, out_strides, reverse_mask: int = 0,
) -> None:
    """Launch the bf16 kernel, projection included: window n of branch g
    reads x (C, T) at g·x_branch_stride + n·C·T (0 when every branch reads
    one x), W_ih (G, 4H, C), W_hh (G, 4H, H) and the bias (G, 4H) as the
    caller holds them (gate-major); its state goes to `out` at
    g·out_strides[0] + n·out_strides[1] + u·T + s. CUDA only."""
    global launches, bf16_launches
    refuse_autograd("lstm_multi bf16", x=x, w_ih=w_ih, w_hh=w_hh, bias=bias)
    g, _, h = w_hh.shape
    _check_launch(g, h, reverse_mask)
    _check_operands(torch.bfloat16, x=x, w_ih=w_ih, w_hh=w_hh, bias=bias, out=out)
    b, c, t = x.shape[-3:]
    if g * b * t == 0:
        return
    fn = _build.function(
        "lstm_multi_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        + [ctypes.c_uint, ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), out.data_ptr(),
        g, b, c, t, h, x_branch_stride, *out_strides, reverse_mask,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_multi_bf16 launch failed: cudaError {err}")
    launches += 1
    bf16_launches += 1


def project(xs: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """``lstm_multi``'s input projection on CUDA: xs (G, B, C, T) against
    unit-major W_ih → (G, B, T, 4H)."""
    w = unit_major(w_ih).transpose(1, 2)  # (G, C, 4H)
    return torch.matmul(xs.transpose(2, 3), w.unsqueeze(1)).contiguous()


def project_shared(x: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """``lstm_branches``'s input projection on CUDA: x (B, C, T), read in
    place as its transpose, against the stacked unit-major W_ih →
    (B, T, G·4H), one batched product for all branches."""
    b, c, _ = x.shape
    w = unit_major(w_ih).reshape(-1, c).t()  # (C, G·4H)
    return torch.bmm(x.transpose(1, 2), w.unsqueeze(0).expand(b, c, w.shape[1]))


def lstm_multi(
    xs: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """G independent LSTM recurrences, xs (G, B, C, T) → (G, B, H, T)."""
    _check(xs, w_ih, w_hh, bias)
    if xs.device.type == "cpu":
        return lstm_multi_reference(xs, w_ih, w_hh, bias)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_multi runs on cpu or cuda, got {xs.device}")
    refuse_autograd("lstm_multi", xs=xs, w_ih=w_ih, w_hh=w_hh, bias=bias)
    g, b, _, t = xs.shape
    h = w_hh.shape[2]
    if not w_hh.is_contiguous():
        raise ValueError("w_hh must be contiguous")
    out = torch.empty((g, b, h, t), dtype=xs.dtype, device=xs.device)
    if xs.dtype == torch.bfloat16:
        fused_bf16(xs.contiguous(), b * xs.shape[2] * t, w_ih.contiguous(), w_hh,
                   bias.contiguous(), out, (b * h * t, h * t))
        return out
    xp = project(xs, w_ih) if out.numel() else out  # (G, B, T, 4H)
    recurrence(xp, (b * t * 4 * h, t * 4 * h, 4 * h), w_hh, bias.contiguous(),
               out, (b * h * t, h * t), b, t)
    return out


def lstm_branches(
    x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
    reverse: Sequence[bool],
) -> torch.Tensor:
    """G LSTMs over one input, x (B, C, T) → (B, G·H, T); branch g scans time
    backward where ``reverse[g]`` (its state at time s is still at index s)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    g = len(reverse)
    _check_weights(g, x.shape[1], w_ih, w_hh, bias, x)
    if x.device.type == "cpu":
        return lstm_branches_reference(x, w_ih, w_hh, bias, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_branches runs on cpu or cuda, got {x.device}")
    refuse_autograd("lstm_branches", x=x, w_ih=w_ih, w_hh=w_hh, bias=bias)
    b, _, t = x.shape
    h = w_hh.shape[2]
    if not w_hh.is_contiguous():
        raise ValueError("w_hh must be contiguous")
    out = torch.empty((b, g * h, t), dtype=x.dtype, device=x.device)
    mask = sum(1 << i for i, r in enumerate(reverse) if r)
    if x.dtype == torch.bfloat16:
        fused_bf16(x.contiguous(), 0, w_ih.contiguous(), w_hh, bias.contiguous(), out,
                   (h * t, g * h * t), mask)
        return out
    xp = project_shared(x, w_ih) if out.numel() else out  # (B, T, G·4H)
    recurrence(xp, (4 * h, t * g * 4 * h, g * 4 * h), w_hh, bias.contiguous(),
               out, (h * t, g * h * t), b, t, mask)
    return out
