"""Per-window conditioning: the CUDA kernel ``csrc/conditioning.cu`` and its
plain PyTorch twin.

Port of ``volpick_tpu/ops/pallas/conditioning.py::condition_windows_pallas``:
x (N, C, W) float32 windows → conditioned windows of the same shape. Per
(window, channel) row: subtract the mean (and, with ``detrend``, the
least-squares line, slope in closed form over centred integer time), then
divide by the peak of the absolute value (``norm="peak"``) or the standard
deviation (``norm="std"``) plus ``eps``. N is free: the kernel has no tile.

``condition_windows`` takes the twin for a CPU tensor and the kernel for a
CUDA tensor; there is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from volpick_tpu_torch.ops.cuda import _build

# one row in shared memory beside the kernel's 32 B of reduction scratch,
# within the 48 KB that need no opt-in
MAX_SAMPLES = (48 * 1024 - 32) // 4

launches = 0  # kernel launches made by condition_windows on CUDA tensors


def condition_windows_reference(
    x: torch.Tensor, detrend: bool = False, norm: str = "peak", eps: float = 1e-10
) -> torch.Tensor:
    """Plain PyTorch twin, on any device, in the kernel's order of arithmetic."""
    w = x.shape[-1]
    mean = x.mean(dim=-1, keepdim=True)
    if detrend:
        t = torch.arange(w, dtype=x.dtype, device=x.device) - (w - 1) / 2.0
        var_t = w * (w * w - 1) / 12.0  # sum of t^2 over centred integer coordinates
        slope = ((x - mean) * t).sum(dim=-1, keepdim=True) / var_t
        y = x - mean - slope * t
    else:
        y = x - mean
    if norm == "peak":
        scale = y.abs().amax(dim=-1, keepdim=True)
    else:
        scale = y.std(dim=-1, keepdim=True, correction=0)
    return y / (scale + eps)


def condition_windows(
    x: torch.Tensor, detrend: bool = False, norm: str = "peak", eps: float = 1e-10
) -> torch.Tensor:
    """Condition (N, C, W) float32 windows per channel; see the module docstring."""
    global launches
    if x.dim() != 3 or x.shape[-1] < 1:
        raise ValueError(f"x must be (N, C, W) with W >= 1, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if norm not in ("peak", "std"):
        raise ValueError(f"unknown norm {norm!r}")
    if x.device.type == "cpu":
        return condition_windows_reference(x, detrend, norm, eps)
    if x.device.type != "cuda":
        raise ValueError(f"condition_windows runs on cpu or cuda, got {x.device}")
    n, c, w = x.shape
    if w > MAX_SAMPLES:
        raise ValueError(f"window of {w} samples exceeds the kernel's limit {MAX_SAMPLES}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    if n * c == 0:
        return out
    fn = _build.function(
        "condition_windows_f32",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        x.data_ptr(), out.data_ptr(), n * c, w, int(bool(detrend)), int(norm == "peak"),
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"condition_windows_f32 launch failed: cudaError {err}")
    launches += 1
    return out
