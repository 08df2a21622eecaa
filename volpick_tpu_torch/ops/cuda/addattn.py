"""Dense additive self-attention: the CUDA kernel ``csrc/addattn.cu`` and its
plain PyTorch twins.

Port of ``volpick_tpu/ops/pallas/addattn.py::seq_self_attention_pallas``.
``seq_self_attention(x, p)`` is the drop-in for
``models/layers.py::seq_self_attention``: x (B, C, T) → values (B, C, T) with

    e[t, s]   = Wa . tanh(x_t Wt + bh + x_s Wx)
    a[t, s]   = exp(e[t, s] - max_s e[t, :]) / (sum_s exp(...) + eps)
    out[c, t] = sum_s x[c, s] a[t, s]

The scalar offset ``ba`` is left out, as in the Pallas kernel: it cancels
under the max-subtracted softmax. Two entries share the kernel:

- ``addattn(x, q, k, wa)`` keeps the Pallas kernel's contract: the projections
  q = xᵀWt + bh and k = xᵀWx are plain matmuls outside, the kernel does the
  rest;
- ``addattn_x(x, wt, bh, wx, wa)`` reads the block's input in place: the
  kernel projects q and k in shared memory and they never reach device memory.
  ``seq_self_attention`` goes through it: one launch a block.

Each entry takes its twin for CPU tensors and the kernel for CUDA tensors;
there is no other route. ``launches`` counts the kernel launches of both.

Both entries take float32 or bfloat16 (all operands of one type). On bf16
the kernel (a body of its own, on the tensor cores) and the twins round
where the Pallas kernel and its caller round in bf16: q = bf16(bf16(xᵀWt) +
bh) and k = bf16(xᵀWx) (``addattn`` takes them given), q + k and tanh in
bf16; the energies Wa . h, the softmax and the value product's sums in
float32, the output rounded to bf16. The probabilities stay float32 where
the Pallas kernel rounds them to bf16 (the kernel feeds them to its products
as two bf16 terms): rounded, they put the port farther from JAX's bf16 than
2^-7 of its largest output where tanh saturates. The
kernel's tanh (``tanh.approx.f32`` rounded to bf16) is the twins' correctly
rounded one on every bf16 input. There is no route that casts bf16 up and
calls the float32 entry.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from volpick_tpu_torch.ops.cuda import ENTRY_SUFFIX, _build, refuse_autograd

# what a CTA of an H100 can be given with the opt-in attribute; the kernel
# keeps q, k, x, Wa and the (T, T) energies of its windows there (and in
# addattn_x the two weights): the main path's two windows take 57 KB, one
# window of T = 128 takes 117 KB, T = 256 does not fit
MAX_SHARED_BYTES = 227 * 1024
MAX_WINDOWS_PER_CTA = 4
MAX_UNITS_BF16 = 32  # the bf16 body keeps a row of q in registers

launches = 0  # kernel launches made by addattn and addattn_x on CUDA tensors
bf16_launches = 0  # of them, launches of the bf16 instantiation


def addattn_reference(
    x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, wa: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Plain PyTorch twin of ``addattn``, on any device: x (B, C, T), q and k
    (B, T, U) with bh folded into q, wa (U,). bfloat16 operands: q + k and
    its tanh rounded to bf16, the rest float32 arithmetic on their values,
    the result rounded to bf16."""
    dtype = x.dtype
    h = torch.tanh(q[:, :, None, :] + k[:, None, :, :])  # (B, T, T, U)
    if dtype == torch.bfloat16:
        h, x, wa = h.float(), x.float(), wa.float()
    e = (h * wa).sum(dim=-1)
    e = torch.exp(e - e.amax(dim=-1, keepdim=True))
    a = e / (e.sum(dim=-1, keepdim=True) + eps)
    return torch.einsum("bcs,bts->bct", x, a).to(dtype)


def addattn_x_reference(
    x: torch.Tensor, wt: torch.Tensor, bh: torch.Tensor, wx: torch.Tensor, wa: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch twin of ``addattn_x``, on any device: the two projections
    as matmuls, then ``addattn_reference``. bfloat16 operands: each
    projection and the bias sum in bf16, as ``seq_self_attention_pallas``
    forms them."""
    xt = x.transpose(1, 2)
    return addattn_reference(x, xt @ wt + bh, xt @ wx, wa, eps)


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _smem_bytes(c: int, t: int, u: int, g: int = 1, project: bool = False) -> int:
    """Shared memory of one CTA that holds g windows, as
    ``csrc/addattn.cu::layout`` counts it: q and k rows of U padded to 8, 16
    or a multiple of 32 units plus 4 floats, energies with a row stride of
    T | 1, x, the max and the sum of every row over each of the stretches its
    s axis is cut into, Wa and, where the kernel projects, Wt, Wx and bh."""
    ku = 8 if u <= 8 else (16 if u <= 16 else 32)
    up = -(-u // ku) * ku
    rows = g * t
    row_groups = -(-rows // 32)
    stretches = 1  # a power of two, at most T, within 16 warps a CTA
    while row_groups * stretches * 2 <= 16 and stretches * 2 <= t:
        stretches *= 2
    floats = (2 * rows * (up + 4) + _round4(rows * (t | 1)) + _round4(g * c * t)
              + 2 * stretches * _round4(rows) + up)
    if project:
        floats += 2 * c * up + up
    return 4 * floats


def _smem_bytes_bf16(c: int, t: int, u: int, g: int = 1, project: bool = False) -> int:
    """Shared memory of one CTA of the bf16 body that holds g windows, as
    ``csrc/addattn.cu::layout_bf16`` counts it (U <= 32): x; q and k rows of
    U padded to 16 or 32 plus 8 bf16; p's hi and lo terms, ceil16(T) rows of
    ceil16(T) + 8 bf16 a window; the float32 energies, stretch maxima and sums
    as in the float body; Wa and (projecting) bh in float32, Wt and Wx
    transposed to rows of ceil16(C) + 8 bf16."""
    def a16(n: int) -> int:
        return -(-n // 16) * 16

    up = 16 if u <= 16 else 32
    tp, cp = a16(t), a16(c)
    rows = g * t
    row_groups = -(-rows // 32)
    stretches = 1
    while row_groups * stretches * 2 <= 16 and stretches * 2 <= t:
        stretches *= 2
    total = (a16(2 * g * c * t) + 2 * a16(2 * rows * (up + 8)) + 2 * 2 * g * tp * (tp + 8)
             + a16(4 * rows * (t | 1)) + 2 * 4 * stretches * _round4(rows) + 4 * up)
    if project:
        total += 4 * up + 2 * 2 * up * (cp + 8)
    return total


def windows_per_cta(
    b: int, c: int, t: int, u: int, n_sm: int, project: bool = False, bf16: bool = False
) -> int:
    """How many windows one CTA takes: as many as leave no more CTAs than the
    card has SMs (so that at B = 232 on 132 SMs two windows fill 94 of 96
    lanes and every SM ends together), at most ``MAX_WINDOWS_PER_CTA``, and no
    more than fit in shared memory (the float32 body's or, ``bf16``, the bf16
    body's). 0 where one window does not fit."""
    smem = _smem_bytes_bf16 if bf16 else _smem_bytes
    g = max(1, min(MAX_WINDOWS_PER_CTA, -(-b // n_sm)))
    while g > 0 and smem(c, t, u, g, project) > MAX_SHARED_BYTES:
        g -= 1
    return g


def _check_floats(x: torch.Tensor, **tensors: torch.Tensor) -> None:
    if x.dtype not in ENTRY_SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, a in dict(x=x, **tensors).items():
        if a.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} as x is, got {a.dtype}")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")


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
    _check_floats(x, q=q, k=k, wa=wa)


def _check_x(x, wt, bh, wx, wa) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    c = x.shape[1]
    if wt.dim() != 2 or wt.shape[0] != c:
        raise ValueError(f"wt must be ({c}, U), got {tuple(wt.shape)}")
    if wx.shape != wt.shape:
        raise ValueError(f"wx is {tuple(wx.shape)}, wt is {tuple(wt.shape)}")
    for name, a in (("bh", bh), ("wa", wa)):
        if tuple(a.shape) != (wt.shape[1],):
            raise ValueError(f"{name} must be ({wt.shape[1]},), got {tuple(a.shape)}")
    _check_floats(x, wt=wt, bh=bh, wx=wx, wa=wa)


def _launch(entry: str, x: torch.Tensor, operands, u: int, eps: float, project: bool) -> torch.Tensor:
    """Launch `entry` (its name without the type suffix) on x (B, C, T) and
    its other operands (all CUDA, checked for shape and type by the caller);
    the instantiation is the one of x's type."""
    global launches, bf16_launches
    entry = f"{entry}_{ENTRY_SUFFIX[x.dtype]}"
    refuse_autograd(entry, x=x, **dict(operands))
    b, c, t = x.shape
    for name, a in [("x", x)] + operands:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(x)
    if b * c * t == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    if bf16 and u > MAX_UNITS_BF16:
        raise ValueError(f"the bf16 body takes U <= {MAX_UNITS_BF16}, got {u}")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    g = windows_per_cta(b, c, t, u, n_sm, project, bf16)
    if g == 0:
        smem = (_smem_bytes_bf16 if bf16 else _smem_bytes)(c, t, u, 1, project)
        raise ValueError(
            f"one window (C {c}, T {t}, U {u}) needs {smem} B of shared memory, above "
            f"{MAX_SHARED_BYTES}"
        )
    fn = _build.function(
        entry,
        [ctypes.c_void_p] * (len(operands) + 2) + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), *(a.data_ptr() for _, a in operands), out.data_ptr(), b, c, t, u, g,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches += 1
    bf16_launches += x.dtype == torch.bfloat16
    return out


def addattn(
    x: torch.Tensor, q: torch.Tensor, k: torch.Tensor, wa: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Additive attention from projected queries and keys: x (B, C, T), q and
    k (B, T, U), wa (U,) → (B, C, T)."""
    _check(x, q, k, wa)
    if x.device.type == "cpu":
        return addattn_reference(x, q, k, wa, eps)
    if x.device.type != "cuda":
        raise ValueError(f"addattn runs on cpu or cuda, got {x.device}")
    return _launch("addattn", x, [("q", q), ("k", k), ("wa", wa)], q.shape[2], eps, False)


def addattn_x(
    x: torch.Tensor, wt: torch.Tensor, bh: torch.Tensor, wx: torch.Tensor, wa: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Additive attention of x (B, C, T) with itself, projections included:
    wt and wx (C, U), bh and wa (U,) → (B, C, T). On a CUDA tensor one kernel
    launch; q and k stay in shared memory."""
    _check_x(x, wt, bh, wx, wa)
    if x.device.type == "cpu":
        return addattn_x_reference(x, wt, bh, wx, wa, eps)
    if x.device.type != "cuda":
        raise ValueError(f"addattn_x runs on cpu or cuda, got {x.device}")
    return _launch("addattn_x", x, [("wt", wt), ("bh", bh), ("wx", wx), ("wa", wa)],
                   wt.shape[1], eps, True)


def seq_self_attention(
    x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-5
) -> torch.Tensor:
    """Drop-in for ``models/layers.py::seq_self_attention``: x (B, C, T) →
    values (B, C, T); `p` holds Wt, Wx (C, U), bh (U,), Wa (U, 1) (and ba,
    which is not read)."""
    return addattn_x(x.contiguous(), p["Wt"].contiguous(), p["bh"].contiguous(),
                     p["Wx"].contiguous(), p["Wa"].reshape(-1).contiguous(), eps)
