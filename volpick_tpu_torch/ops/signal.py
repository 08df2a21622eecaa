"""Per-window signal conditioning (PyTorch).

Port of the conditioning half of ``volpick_tpu/ops/signal.py``: demean or
linear detrend per channel, then peak or std amplitude normalisation.
Waveforms are (..., C, W), time last. The filters and resampling of the JAX
module are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from volpick_tpu_torch.ops.windows import frame_windows_uniform

EPS = 1e-10


def demean(x: torch.Tensor, mask: Optional[torch.Tensor] = None, dim: int = -1) -> torch.Tensor:
    """Remove the mean along `dim`. With `mask` (..., W), only valid samples count."""
    if mask is None:
        return x - x.mean(dim=dim, keepdim=True)
    m = mask.to(x.dtype)
    if m.dim() == x.dim() - 1:
        m = m.unsqueeze(-2)  # broadcast over channels
    denom = torch.clamp(m.sum(dim=dim, keepdim=True), min=1.0)
    mean = (x * m).sum(dim=dim, keepdim=True) / denom
    return (x - mean) * m


def _centred_time(w: int, dtype, device) -> torch.Tensor:
    return torch.arange(w, dtype=dtype, device=device) - (w - 1) / 2.0


def detrend_linear(x: torch.Tensor) -> torch.Tensor:
    """Remove the least-squares straight line along the last axis (closed form)."""
    t = _centred_time(x.shape[-1], x.dtype, x.device)
    var_t = (t * t).sum()
    mean = x.mean(dim=-1, keepdim=True)
    slope = ((x - mean) * t).sum(dim=-1, keepdim=True) / var_t
    return x - mean - slope * t


def _scale(x: torch.Tensor, norm: str, dims) -> torch.Tensor:
    if norm == "peak":
        return x.abs().amax(dim=dims, keepdim=True)
    if norm == "std":
        return x.std(dim=dims, keepdim=True, correction=0)
    raise ValueError(f"unknown norm {norm!r}")


def normalize_amplitude(
    x: torch.Tensor, norm: str = "peak", per_channel: bool = False, eps: float = EPS
) -> torch.Tensor:
    """Divide by max |x| ("peak") or the standard deviation ("std"), per
    channel or over (C, W) jointly (SeisBench Normalize semantics)."""
    dims = (-1,) if per_channel else (-2, -1)
    return x / (_scale(x, norm, dims) + eps)


def normalize(
    x: torch.Tensor,
    norm: str = "peak",
    do_demean: bool = True,
    do_detrend: bool = False,
    eps: float = EPS,
) -> torch.Tensor:
    """The per-window conditioning block: detrend or demean, then amplitude
    normalisation over (C, W) jointly (the reference's eval augmentation,
    `volpick/model/models.py:445-452`)."""
    if do_detrend:
        x = detrend_linear(x)
    elif do_demean:
        x = demean(x)
    return normalize_amplitude(x, norm=norm, eps=eps)


def condition_windows_from_span(
    sp: torch.Tensor,
    n_win: int,
    stride: int,
    window: int,
    detrend: bool = False,
    norm: str = "peak",
    per_channel: bool = True,
    eps: float = EPS,
) -> torch.Tensor:
    """Conditioned windows i*stride of a span: sp (..., C, span) → (n_win, ..., C, window).

    Same result as ``normalize_amplitude(detrend_linear or demean(
    frame_windows_uniform(sp, ...)))``, but each window's mean and LS slope
    come from the un-expanded span: from per-stride-block partial sums when
    the stride divides the window (EQTransformer 6000/500), else from one
    strided convolution in full float32 (TF32 must be off on CUDA)."""
    t = _centred_time(window, sp.dtype, sp.device)
    var_t = (t * t).sum()
    if window % stride == 0:
        # window i covers stride blocks [i, i+m) exactly
        m = window // stride
        lead = sp.shape[:-1]
        length = sp.shape[-1]
        need = max(-(-length // stride), n_win - 1 + m) * stride
        spp = F.pad(sp, (0, need - length)) if need > length else sp
        xb = spp.reshape(lead + (-1, stride))  # (..., C, nb, stride)
        bs = xb.sum(dim=-1)  # block sums
        sums = bs[..., 0:n_win]
        for k in range(1, m):
            sums = sums + bs[..., k : k + n_win]
        stats = [sums / window]
        if detrend:
            local = torch.arange(stride, dtype=sp.dtype, device=sp.device)
            bt = (xb * local).sum(dim=-1)  # block first moments in local time
            c = (window - 1) / 2.0
            num = bt[..., 0:n_win] + (0 * stride - c) * bs[..., 0:n_win]
            for k in range(1, m):
                num = num + (bt[..., k : k + n_win] + (k * stride - c) * bs[..., k : k + n_win])
            stats.append(num / var_t)
        stats = torch.stack(stats, dim=-2)  # (..., C, O, n_win)
    else:
        kernels = [torch.full((window,), 1.0 / window, dtype=sp.dtype, device=sp.device)]
        if detrend:
            kernels.append(t / var_t)
        weight = torch.stack(kernels, dim=0)[:, None, :]  # (O, 1, window)
        lead = sp.shape[:-1]
        flat = sp.reshape((-1, 1, sp.shape[-1]))
        stats = F.conv1d(flat, weight, stride=stride)[..., :n_win]  # (B, O, n_win)
        stats = stats.reshape(lead + stats.shape[1:])
    mean = stats[..., 0, :].movedim(-1, 0)[..., None]  # (N, ..., C, 1)
    det = frame_windows_uniform(sp, n_win, stride, window) - mean
    if detrend:
        slope = stats[..., 1, :].movedim(-1, 0)[..., None]
        det = det - slope * t
    dims = (-1,) if per_channel else (-2, -1)
    return det / (_scale(det, norm, dims) + eps)
