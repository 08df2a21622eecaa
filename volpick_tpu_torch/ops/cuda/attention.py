"""Softmax multi-head self-attention: the CUDA kernel ``csrc/mha.cu`` and its
plain PyTorch twin.

Port of ``volpick_tpu/ops/pallas/attention.py::mha_pallas``: q, k, v are
(B, H·Dh, T) float32, packed head-major, with any query scaling already
folded into q. Per window b and head h the output is
``softmax_s(q_hᵀ k_h) v_h``: the row max is subtracted, and the exponentials
are divided by their plain sum (no eps). The output has the shape of q.

``mha`` takes the twin for a CPU tensor and the kernel for a CUDA tensor;
there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from volpick_tpu_torch.ops.cuda import _build

MAX_HEAD_DIM = 32  # one lane per output channel of a head
MAX_TOKENS = 128  # four scores per lane in registers
MAX_SHARED_BYTES = 48 * 1024  # q, k, v of one head, no opt-in shared memory

launches = 0  # kernel launches made by mha on CUDA tensors


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain PyTorch twin, on any device."""
    b, d, t = q.shape
    qh, kh, vh = (a.reshape(b, n_heads, d // n_heads, t) for a in (q, k, v))
    s = torch.einsum("bhdt,bhds->bhts", qh, kh)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhts,bhds->bhdt", p, vh).reshape(b, d, t)


def _padded_row(t: int) -> int:
    """Shared-memory row stride of the kernel: odd, so the 32 lanes of a warp
    reading one column of a (Dh, T) tile hit 32 different banks."""
    return t | 1


def _check(q, k, v, n_heads: int) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H*Dh, T), got {tuple(q.shape)}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape:
            raise ValueError(f"{name} is {tuple(a.shape)}, q is {tuple(q.shape)}")
    if n_heads < 1 or q.shape[1] % n_heads:
        raise ValueError(f"{q.shape[1]} channels do not split into {n_heads} heads")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-head softmax attention over head-major packed (B, H·Dh, T) tensors."""
    global launches
    _check(q, k, v, n_heads)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, got {q.device}")
    b, d, t = q.shape
    dh = d // n_heads
    if dh > MAX_HEAD_DIM or t > MAX_TOKENS:
        raise ValueError(
            f"head dim {dh} / tokens {t} exceed the kernel's limits {MAX_HEAD_DIM} / {MAX_TOKENS}"
        )
    smem = 3 * dh * _padded_row(t) * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"one head needs {smem} B of shared memory, above {MAX_SHARED_BYTES}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if b * t == 0:
        return out
    fn = _build.function("mha_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n_heads, dh, t,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mha_f32 launch failed: cudaError {err}")
    launches += 1
    return out
