"""Per-window conditioning: the CUDA kernel ``csrc/conditioning.cu`` and its
plain PyTorch twin.

Port of ``volpick_tpu/ops/pallas/conditioning.py::condition_windows_pallas``:
x (N, C, W) float32 windows → conditioned windows of the same shape. Per
(window, channel) row: subtract the mean (and, with ``detrend``, the
least-squares line, slope in closed form over centred integer time), then
divide by the peak of the absolute value (``norm="peak"``) or the standard
deviation (``norm="std"``) plus ``eps``. N is free: the kernel has no tile.
The kernel is a few persistent CTAs an SM, each streaming its rows through a
ring of row buffers in shared memory; ``ring_plan(rows, W, n_sm)`` says how
many CTAs and buffers a launch takes.

``condition_windows`` takes the twin for a CPU tensor and the kernel for a
CUDA tensor; there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from volpick_tpu_torch.ops.cuda import _build, refuse_autograd

# the longest row the kernel takes (one row buffer of 48 KB less 32 B)
MAX_SAMPLES = (48 * 1024 - 32) // 4

# the kernel's ring: row buffers a CTA asks for (at most 3) and persistent CTAs
# an SM (at most 4), where shared memory allows both (2 and 4: 7-11% less
# kernel time at (232, 3, 6000) on an H100 than one CTA a row, which 3 and 3
# only match)
RING_BUFFERS = 2
CTAS_PER_SM = 4
# an H100's shared memory an SM, and what a CTA takes of it beside its ring
# (1 KB the system reserves, the kernel's static 64 B)
_SMEM_PER_SM = 228 * 1024
_SMEM_PER_CTA = 1024 + 256

launches = 0  # kernel launches made by condition_windows on CUDA tensors
_sm_count: dict = {}  # device index -> its number of SMs


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


def ring_plan(rows: int, w: int, n_sm: int, bulk: bool = True) -> Tuple[int, int]:
    """``(ctas, n_buf)``: the launch of the kernel for `rows` rows of W
    samples on a card of `n_sm` SMs. ``CTAS_PER_SM`` CTAs an SM with
    ``RING_BUFFERS`` row buffers each where an SM's shared memory holds them;
    else fewer buffers (down to one), then fewer CTAs. Rows that cannot move
    by bulk copies (``bulk`` false: W not a multiple of 4, or x not 16-byte
    aligned) have one buffer, and then as many CTAs an SM as its threads
    allow. The CTAs walk the rows in turns, so their number is cut to what
    gives each the same count of rows, up to one (696 rows on 528 CTAs are two
    rows each on 348)."""
    row_bytes = 4 * w
    # the ring's instantiation takes 63 registers a thread: 4 CTAs of 256 an SM
    n_buf, per_sm = max(1, min(RING_BUFFERS, 3)), max(1, min(CTAS_PER_SM, 4))
    if not bulk:
        n_buf, per_sm = 1, 8
    fits = lambda: per_sm * (n_buf * row_bytes + _SMEM_PER_CTA) <= _SMEM_PER_SM
    while not fits() and n_buf > 1:
        n_buf -= 1
    while not fits() and per_sm > 1:
        per_sm -= 1
    ctas = max(1, min(rows, n_sm * per_sm))
    turns = -(-rows // ctas)
    return -(-rows // turns), n_buf


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
    refuse_autograd("condition_windows", x=x)
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
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p],
    )
    n_sm = _sm_count.get(x.device.index)
    if n_sm is None:
        n_sm = _sm_count[x.device.index] = torch.cuda.get_device_properties(
            x.device).multi_processor_count
    ctas, n_buf = ring_plan(
        n * c, w, n_sm, bulk=w % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = fn(
        x.data_ptr(), out.data_ptr(), n * c, w, int(bool(detrend)), int(norm == "peak"),
        float(eps), ctas, n_buf,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"condition_windows_f32 launch failed: cudaError {err}")
    launches += 1
    return out
