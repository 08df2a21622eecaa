"""Dense additive self-attention: the CUDA kernel ``csrc/addattn.cu`` and its
plain PyTorch twin.

Port of ``volpick_tpu/ops/pallas/addattn.py::seq_self_attention_pallas``.
``seq_self_attention(x, p)`` is the drop-in for
``models/layers.py::seq_self_attention``: x (B, C, T) → values (B, C, T) with

    e[t, s]   = Wa . tanh(x_t Wt + bh + x_s Wx)
    a[t, s]   = exp(e[t, s] - max_s e[t, :]) / (sum_s exp(...) + eps)
    out[c, t] = sum_s x[c, s] a[t, s]

The scalar offset ``ba`` is left out, as in the Pallas kernel: it cancels
under the max-subtracted softmax. The projections q = xᵀWt + bh and k = xᵀWx
are plain matmuls outside the kernel, as in the JAX wrapper; ``addattn`` does
the rest.

``addattn`` takes the twin for CPU tensors and the kernel for CUDA tensors;
there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from volpick_tpu_torch.ops.cuda import _build

MAX_SHARED_BYTES = 48 * 1024  # q, k, x, Wa and the energies of one window, no opt-in

launches = 0  # kernel launches made by addattn on CUDA tensors


def addattn_reference(
    x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, wa: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Plain PyTorch twin, on any device: x (B, C, T), q and k (B, T, U) with
    bh folded into q, wa (U,)."""
    h = torch.tanh(q[:, :, None, :] + k[:, None, :, :])  # (B, T, T, U)
    e = (h * wa).sum(dim=-1)
    e = torch.exp(e - e.amax(dim=-1, keepdim=True))
    a = e / (e.sum(dim=-1, keepdim=True) + eps)
    return torch.einsum("bcs,bts->bct", x, a)


def _smem_bytes(c: int, t: int, u: int) -> int:
    """Shared memory of one CTA, as ``csrc/addattn.cu::smem_bytes`` counts it."""
    return 4 * (2 * t * (u + 1) + t * (t | 1) + c * t + u)


def _check(x, q, k, wa) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    b, _, t = x.shape
    if q.dim() != 3 or q.shape[:2] != (b, t):
        raise ValueError(f"q must be ({b}, {t}, U), got {tuple(q.shape)}")
    if k.shape != q.shape:
        raise ValueError(f"k is {tuple(k.shape)}, q is {tuple(q.shape)}")
    if tuple(wa.shape) != (q.shape[2],):
        raise ValueError(f"wa must be ({q.shape[2]},), got {tuple(wa.shape)}")
    for name, a in (("x", x), ("q", q), ("k", k), ("wa", wa)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")


def addattn(
    x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, wa: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Additive attention from projected queries and keys: x (B, C, T), q and
    k (B, T, U), wa (U,) → (B, C, T)."""
    global launches
    _check(x, q, k, wa)
    if x.device.type == "cpu":
        return addattn_reference(x, q, k, wa, eps)
    if x.device.type != "cuda":
        raise ValueError(f"addattn runs on cpu or cuda, got {x.device}")
    b, c, t = x.shape
    u = q.shape[2]
    smem = _smem_bytes(c, t, u)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"one window (C {c}, T {t}, U {u}) needs {smem} B of shared memory, "
            f"above {MAX_SHARED_BYTES}"
        )
    for name, a in (("x", x), ("q", q), ("k", k), ("wa", wa)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(x)
    if b * c * t == 0:
        return out
    fn = _build.function(
        "addattn_f32",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), q.data_ptr(), k.data_ptr(), wa.data_ptr(), out.data_ptr(), b, c, t, u,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"addattn_f32 launch failed: cudaError {err}")
    launches += 1
    return out


def seq_self_attention(
    x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-5
) -> torch.Tensor:
    """Drop-in for ``models/layers.py::seq_self_attention``: x (B, C, T) →
    values (B, C, T); `p` holds Wt, Wx (C, U), bh (U,), Wa (U, 1) (and ba,
    which is not read)."""
    xt = x.transpose(1, 2)
    q = (xt @ p["Wt"] + p["bh"]).contiguous()
    k = (xt @ p["Wx"]).contiguous()
    return addattn(x.contiguous(), q, k, p["Wa"].reshape(-1).contiguous(), eps)
