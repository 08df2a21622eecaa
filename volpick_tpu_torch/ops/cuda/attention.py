"""Softmax multi-head self-attention: the CUDA kernel ``csrc/mha.cu`` and its
plain PyTorch twins.

Port of ``volpick_tpu/ops/pallas/attention.py::mha_pallas``, in two layouts:

- ``mha(q, k, v, n_heads)`` keeps the JAX package's contract: q, k, v are
  (B, H·Dh, T), packed head-major, with any query scaling already folded
  into q; the output has the shape and type of q.
- ``mha_qkv(qkv, scale)`` reads q, k, v in place from a model's projection
  (B, T, 3, H, Dh), multiplies ``scale`` into q inside the kernel and returns
  (B, T, H·Dh): no packing copy, no scale pass and no transpose around the
  launch.

Per window b and head h the output is ``softmax_s(q_hᵀ k_h) v_h``: the row
max is subtracted, and the exponentials are divided by their plain sum (no
eps). Each entry takes its twin for a CPU tensor and the kernel for a CUDA
tensor; there is no other route.

Both entries take float32 or bfloat16, with a kernel body each. On float32,
``mha_qkv`` scales q by the same single float32 multiply as ``q * scale``.
On bf16 the kernel multiplies bf16 q and k on the tensor cores with float32
sums, takes the softmax in float32, rounds the probabilities to bf16 (the
Pallas kernel casts them to ``v.dtype``), multiplies them by bf16 v with
float32 sums and writes bf16; the twins do the same arithmetic in another
order. The bf16 ``mha_qkv`` scales q as the JAX model hands it to the
Pallas kernel: ``to_pk(q) * scale`` there multiplies a bf16 array by a
Python float, which JAX types weakly, so the scale itself is first rounded
to bf16 and the product is rounded to bf16 again: q' = bf16(q · bf16(scale)),
the multiply in float32 (exact for two bf16 values) and both roundings to
nearest even. There is no route that casts bf16 up and calls the float32
entry.
"""

from __future__ import annotations

import ctypes

import torch

from volpick_tpu_torch.ops.cuda import ENTRY_SUFFIX, _build, refuse_autograd

MAX_HEAD_DIM = 32  # eight float4 channel groups a head in the PV product
MAX_TOKENS = 128  # four scores per lane in the softmax
MAX_SHARED_BYTES = 227 * 1024  # what a block may opt in to on sm_90

launches = 0  # kernel launches made by mha and mha_qkv on CUDA tensors
bf16_launches = 0  # of them, launches of the bf16 instantiation


def _softmax_rows(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The max-subtracted softmax over the last axis, divided by the plain
    sum; on bf16 operands the probabilities are rounded to bf16."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return p.to(dtype).float() if dtype == torch.bfloat16 else p


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain PyTorch twin, on any device; bf16 as the module's note says."""
    dtype = q.dtype
    if dtype == torch.bfloat16:
        q, k, v = (a.float() for a in (q, k, v))
    b, d, t = q.shape
    qh, kh, vh = (a.reshape(b, n_heads, d // n_heads, t) for a in (q, k, v))
    p = _softmax_rows(torch.einsum("bhdt,bhds->bhts", qh, kh), dtype)
    return torch.einsum("bhts,bhds->bhdt", p, vh).reshape(b, d, t).to(dtype)


def mha_qkv_reference(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch twin of ``mha_qkv``, on any device; bf16 as the module's
    note says (q scaled and rounded to bf16 first)."""
    dtype = qkv.dtype
    b, t, _, h, dh = qkv.shape
    q, k, v = qkv.unbind(2)
    if dtype == torch.bfloat16:
        s = torch.tensor(scale).to(torch.bfloat16).float()  # bf16(q · bf16(scale))
        q, k, v = (q.float() * s).to(torch.bfloat16).float(), k.float(), v.float()
    else:
        q = q * scale
    p = _softmax_rows(torch.einsum("bthd,bshd->bhts", q, k), dtype)
    return torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, h * dh).to(dtype)


def shared_bytes(dh: int, t: int) -> int:
    """Dynamic shared memory of one CTA (mirrors ``launch`` in csrc/mha.cu):
    q, k, v as (8·ceil(T/8), DP) tiles, DP = Dh rounded up to a multiple of 4
    whose quarter is odd, and the (T, T) scores with 4 floats of row padding."""
    tp = -(-t // 8) * 8
    d4 = -(-dh // 4) * 4
    dp = d4 if (d4 // 4) % 2 else d4 + 4
    return (3 * tp * dp + tp * (-(-t // 4) * 4 + 4)) * 4


def _check_limits(dh: int, t: int) -> None:
    if dh > MAX_HEAD_DIM or t > MAX_TOKENS:
        raise ValueError(
            f"head dim {dh} / tokens {t} exceed the kernel's limits {MAX_HEAD_DIM} / {MAX_TOKENS}"
        )
    if shared_bytes(dh, t) > MAX_SHARED_BYTES:
        raise ValueError(
            f"one head needs {shared_bytes(dh, t)} B of shared memory, above {MAX_SHARED_BYTES}"
        )


def _check(q, k, v, n_heads: int) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H*Dh, T), got {tuple(q.shape)}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape:
            raise ValueError(f"{name} is {tuple(a.shape)}, q is {tuple(q.shape)}")
    if n_heads < 1 or q.shape[1] % n_heads:
        raise ValueError(f"{q.shape[1]} channels do not split into {n_heads} heads")
    if q.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} as q is, got {a.dtype}")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-head softmax attention over head-major packed (B, H·Dh, T) tensors."""
    global launches, bf16_launches
    _check(q, k, v, n_heads)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, got {q.device}")
    refuse_autograd("mha", q=q, k=k, v=v)
    b, d, t = q.shape
    _check_limits(d // n_heads, t)
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if b * t == 0:
        return out
    entry = f"mha_{ENTRY_SUFFIX[q.dtype]}"
    fn = _build.function(entry, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n_heads, d // n_heads, t,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches += 1
    bf16_launches += out.dtype == torch.bfloat16
    return out


def mha_qkv(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-head softmax attention read in place from a (B, T, 3, H, Dh)
    projection, q scaled by `scale`; returns (B, T, H·Dh)."""
    global launches, bf16_launches
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be (B, T, 3, H, Dh), got {tuple(qkv.shape)}")
    if qkv.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.device.type == "cpu":
        return mha_qkv_reference(qkv, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_qkv runs on cpu or cuda, got {qkv.device}")
    refuse_autograd("mha_qkv", qkv=qkv)
    b, t, _, h, dh = qkv.shape
    _check_limits(dh, t)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    out = torch.empty((b, t, h * dh), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    entry = f"mha_qkv_{ENTRY_SUFFIX[qkv.dtype]}"
    fn = _build.function(
        entry,
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        qkv.data_ptr(), out.data_ptr(), b, h, dh, t, float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches += 1
    bf16_launches += out.dtype == torch.bfloat16
    return out
