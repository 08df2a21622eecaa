"""Sliding-window framing and overlap stacking with blinding (PyTorch).

Port of ``volpick_tpu/ops/windows.py``. Continuous streams are cut into fixed
windows at stride = window - overlap, and per-window predictions are stacked
back into continuous curves with edge blinding ("avg" or "max").
``window_starts``, ``uniform_stack_weights``, ``steered_window_indices`` and
``pad_frame`` are host-side numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def window_starts(n_samples: int, window: int, overlap: int) -> np.ndarray:
    """Window start offsets for a stream of n_samples.

    Windows sit at 0, stride, 2*stride, ...; if the last one does not end at
    the last sample, one extra window flush with the end is added (SeisBench
    annotate placement). Streams shorter than one window give one start at 0
    (the caller pads)."""
    if overlap >= window:
        raise ValueError(f"overlap {overlap} must be < window {window}")
    stride = window - overlap
    if n_samples <= window:
        return np.array([0], dtype=np.int64)
    starts = np.arange(0, n_samples - window + 1, stride, dtype=np.int64)
    if starts[-1] + window < n_samples:
        starts = np.append(starts, n_samples - window)
    return starts


def frame_windows(x: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """Gather windows: x (..., C, W_total), starts (N,) → (N, ..., C, window).

    Starts are clamped so every window lies inside x, as JAX's dynamic_slice
    clamps them."""
    starts = starts.to(device=x.device, dtype=torch.long).clamp(0, x.shape[-1] - window)
    idx = starts[:, None] + torch.arange(window, device=x.device)[None, :]  # (N, window)
    return x[..., idx].movedim(-2, 0)


def frame_windows_uniform(
    x: torch.Tensor, n_win: int, stride: int, window: int
) -> torch.Tensor:
    """Gather-free framing for starts i*stride: x (..., C, T) → (N, ..., C, window).

    With m = ceil(window/stride), x reshapes into stride blocks and window i
    is blocks [i, i+m): m contiguous slices instead of a gather. Same output
    as ``frame_windows(x, arange(n_win) * stride, window)``."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    m = -(-window // stride)
    lead = x.shape[:-1]
    t = x.shape[-1]
    nb = max(-(-t // stride), n_win - 1 + m)
    if nb * stride > t:
        x = F.pad(x, (0, nb * stride - t))
    xb = x.reshape(lead + (nb, stride))
    fr = torch.stack([xb[..., i : i + n_win, :] for i in range(m)], dim=-2)  # (..., N, m, stride)
    fr = fr.reshape(lead + (n_win, m * stride))[..., :window]
    return fr.movedim(-2, 0)


def _blind_mask(window: int, blinding: Tuple[int, int], dtype, device) -> torch.Tensor:
    l, r = blinding
    mask = torch.zeros(window, dtype=dtype, device=device)
    mask[l : window - r if r else window] = 1.0
    return mask


def overlap_stack(
    preds: torch.Tensor,
    starts: torch.Tensor,
    total_len: int,
    blinding: Tuple[int, int] = (0, 0),
    stacking: str = "avg",
) -> torch.Tensor:
    """Reassemble overlapping windows: preds (..., N, K, window) → (..., K, total_len).

    ``blinding=(l, r)`` drops the first l / last r samples of every window.
    "avg" averages the remaining contributions per sample, "max" takes their
    maximum; samples no window covers come out 0. Contributions that fall
    outside [0, total_len) are dropped."""
    *lead, n, k, window = preds.shape
    flat = preds.reshape((-1, n, k, window))
    valid = _blind_mask(window, blinding, preds.dtype, preds.device)
    idx = starts.to(device=preds.device, dtype=torch.long)[:, None] + torch.arange(
        window, device=preds.device
    )
    idx = idx.reshape(-1)  # (N*window,)
    keep = (idx >= 0) & (idx < total_len)
    contrib = (flat * valid).permute(0, 2, 1, 3).reshape(flat.shape[0], k, n * window)
    contrib = contrib[..., keep]
    idx = idx[keep]
    out = preds.new_zeros((flat.shape[0], k, total_len))
    if stacking == "avg":
        weight = preds.new_zeros((total_len,))
        weight.index_add_(0, idx, valid.repeat(n)[keep])
        out.index_add_(2, idx, contrib)
        out = out / torch.clamp(weight, min=1.0)
    elif stacking == "max":
        out.scatter_reduce_(2, idx.expand(out.shape[0], k, -1), contrib, reduce="amax")
    else:
        raise ValueError(f"unknown stacking {stacking!r}")
    return out.reshape(tuple(lead) + (k, total_len))


def overlap_stack_uniform(
    preds: torch.Tensor,
    stride: int,
    blinding: Tuple[int, int] = (0, 0),
    stacking: str = "avg",
    return_sums: bool = False,
):
    """Scatter-free stacking for starts i*stride: preds (..., N, K, window).

    With m = ceil(window/stride), window j covers output blocks [j, j+m), so
    each output block is a sum (or max) of m shifted contiguous slices.
    Returns (..., K, (N+m-1)*stride); callers trim to their stream length.
    With ``return_sums`` the "avg" division is deferred and
    ``(sums (..., K, L), weights (L,))`` is returned, so callers can add
    extra windows before normalising."""
    *lead, n, k, window = preds.shape
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    m = max(-(-window // stride), 1)
    total_blocks = n + m - 1
    a = F.pad(preds, (0, m * stride - window)).reshape(tuple(lead) + (n, k, m, stride))
    w_mask = F.pad(_blind_mask(window, blinding, preds.dtype, preds.device), (0, m * stride - window))
    w_mask = w_mask.reshape(m, stride)

    wgt = preds.new_zeros((total_blocks, 1, stride))
    for i in range(m):
        wgt[i : i + n] += w_mask[i]
    out = preds.new_zeros(tuple(lead) + (total_blocks, k, stride))
    if stacking == "avg":
        for i in range(m):
            out[..., i : i + n, :, :] += a[..., i, :] * w_mask[i]
        if not return_sums:
            out = out / torch.clamp(wgt, min=1.0)
    elif stacking == "max":
        for i in range(m):
            cur = out[..., i : i + n, :, :]
            cur.copy_(torch.maximum(cur, a[..., i, :] * w_mask[i]))
    else:
        raise ValueError(f"unknown stacking {stacking!r}")
    out = out.movedim(-3, -2).reshape(tuple(lead) + (k, total_blocks * stride))
    if return_sums:
        return out, wgt.reshape(total_blocks * stride)
    return out


def uniform_stack_weights(
    n_win: int,
    stride: int,
    window: int,
    blinding: Tuple[int, int],
    out_len: int,
) -> np.ndarray:
    """Static per-sample stacking weights of a uniform window grid: the number
    of non-blinded window samples covering each output sample. Same shifted-add
    order as ``overlap_stack_uniform``, so the float sums are identical."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    m = max(-(-window // stride), 1)
    l, r = blinding
    w_mask = np.zeros((m * stride,), dtype=np.float32)
    w_mask[l : window - r] = 1.0
    w_mask = w_mask.reshape(m, stride)
    total_blocks = n_win + m - 1
    w = np.zeros((total_blocks, stride), dtype=np.float32)
    for i in range(m):
        w[i : i + n_win] += w_mask[i]
    w = w.reshape(-1)
    out = np.zeros(out_len, dtype=np.float32)
    n = min(out_len, w.size)
    out[:n] = w[:n]
    return out


def steered_window_indices(
    n_samples: int,
    start_sample: np.ndarray,
    end_sample: np.ndarray,
    window: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Window placement for steered evaluation (SeisBench SteeredWindow semantics).

    Places a fixed-length window containing the region [start_sample, end_sample)
    of each trace: the region is centred when possible, shifted to stay inside
    the trace, with zero-padding when the trace is shorter than the window
    (strategy="pad", reference `volpick/model/models.py:445-452`).

    Returns (window_start, border_lo, border_hi): window_start is the offset of
    the window in the trace, and [border_lo, border_hi) is the region's span
    inside the window (the reference's "window_borders")."""
    start_sample = np.asarray(start_sample, dtype=np.int64)
    end_sample = np.asarray(end_sample, dtype=np.int64)
    region = end_sample - start_sample
    slack = window - region
    w0 = start_sample - slack // 2
    if n_samples >= window:
        w0 = np.clip(w0, 0, n_samples - window)
    else:
        w0 = np.zeros_like(w0)  # pad right
    border_lo = start_sample - w0
    border_hi = border_lo + region
    return w0, border_lo, border_hi


def pad_frame(data: np.ndarray, w0: int, window: int) -> np.ndarray:
    """Host-side framing with zero pad for out-of-range regions: data (C, W)
    → (C, window) for the window starting at w0, which may extend beyond
    either end of data."""
    c, n = data.shape
    out = np.zeros((c, window), dtype=data.dtype)
    lo = max(w0, 0)
    hi = min(w0 + window, n)
    if hi > lo:
        out[:, lo - w0 : hi - w0] = data[:, lo:hi]
    return out
