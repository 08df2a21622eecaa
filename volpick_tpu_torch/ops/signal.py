"""Per-window signal conditioning (PyTorch).

Port of ``volpick_tpu/ops/signal.py``: demean or linear detrend per
channel, then peak or std amplitude normalisation; the cosine taper, the
Butterworth second-order sections (designed by scipy on the host), the biquad
cascade ``sosfilt`` and the polyphase ``resample_poly_device``. Waveforms are
(..., C, W), time last, on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def taper_cosine(x: torch.Tensor, fraction: float = 0.05, dim: int = -1) -> torch.Tensor:
    """Symmetric cosine (Tukey) taper, used before filtering long segments."""
    w = x.shape[dim]
    n = max(int(w * fraction), 1)
    ramp = 0.5 * (1 - torch.cos(torch.pi * torch.arange(n, dtype=x.dtype, device=x.device) / n))
    window = torch.cat([ramp, torch.ones(w - 2 * n, dtype=x.dtype, device=x.device), ramp.flip(0)])
    shape = [1] * x.dim()
    shape[dim] = w
    return x * window.reshape(shape)


def sosfilt_coeffs_bandpass(freqmin: float, freqmax: float, fs: float, order: int = 4):
    """Butterworth bandpass second-order sections (host-side; scipy design)."""
    from scipy.signal import butter

    return butter(order, [freqmin, freqmax], btype="bandpass", fs=fs, output="sos")


def sosfilt_coeffs_highpass(freq: float, fs: float, order: int = 4):
    from scipy.signal import butter

    return butter(order, freq, btype="highpass", fs=fs, output="sos")


def sosfilt(x: torch.Tensor, sos) -> torch.Tensor:
    """IIR cascade of biquads along the last axis (scipy's ``sosfilt`` with
    zero initial state), in x's type on x's device.

    A loop over time, as the JAX function's ``lax.scan``: each section
    carries its two delay states for all leading lanes at once and filters
    the whole signal before the next section starts. Used for the QC band
    filters the reference applies on CPU (reference
    `volpick/data/utils.py:694-713`: 0.3 Hz highpass / 1-20 Hz bandpass)."""
    sos = torch.as_tensor(np.asarray(sos), dtype=x.dtype, device=x.device)  # (n, 6)
    w = x.shape[-1]
    y = x.reshape(-1, w)
    for section in sos:
        b0, b1, b2, _, a1, a2 = section.unbind()
        z1 = y.new_zeros(y.shape[0])
        z2 = y.new_zeros(y.shape[0])
        out = []
        for xt in y.unbind(-1):
            yt = b0 * xt + z1
            z1 = b1 * xt - a1 * yt + z2
            z2 = b2 * xt - a2 * yt
            out.append(yt)
        y = torch.stack(out, dim=-1)
    return y.reshape(x.shape)


def resample_poly_device(x: torch.Tensor, up: int, down: int, window_size: int = 64) -> torch.Tensor:
    """Polyphase rational resampling on the device (Kaiser-windowed sinc FIR),
    the counterpart of scipy.signal.resample_poly used in the ingest path
    (reference `volpick/data/convert.py:122-140` resamples all traces to
    100 Hz): zero-stuff by `up`, one convolution with the FIR taps at stride
    `down`, trimmed to ceil(W * up / down) samples, as the JAX function's
    input-dilated ``conv_general_dilated``."""
    from scipy.signal import firwin

    g = np.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    max_rate = max(up, down)
    half_len = (window_size // 2) * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0)) * up
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)

    w = x.shape[-1]
    flat = x.reshape(-1, 1, w)
    stuffed = flat.new_zeros((flat.shape[0], 1, (w - 1) * up + 1))
    stuffed[..., ::up] = flat
    out = F.conv1d(stuffed, h.reshape(1, 1, -1), stride=down, padding=half_len)
    new_w = (w * up) // down + (1 if (w * up) % down else 0)
    out = out[..., :new_w]
    return out.reshape(x.shape[:-1] + (out.shape[-1],))
