"""Waveform features: frequency index (FI) and SNR, batched on tensors.

Port of ``volpick_tpu/ops/features.py``, the device-side counterparts of the
reference's per-trace feature functions used during dataset compilation:

- frequency index: FI = log10(mean|A| in 10-15 Hz / mean|A| in 1-5 Hz) over a
  Hann-windowed rFFT (reference `volpick/data/utils.py:27-42`); used to
  separate LP from VT events.
- SNR: per-component 95th-percentile amplitude ratio in dB between a signal
  window after the S (or P) arrival and a noise window before the P arrival
  (reference `volpick/data/utils.py:45-102`).
"""

from __future__ import annotations

from typing import Tuple

import torch


def frequency_index(
    data: torch.Tensor,
    dt: float,
    low_freq_band: Tuple[float, float] = (1.0, 5.0),
    high_freq_band: Tuple[float, float] = (10.0, 15.0),
) -> torch.Tensor:
    """FI over the last axis; data (..., W) → (...)."""
    w = data.shape[-1]
    t = torch.arange(w, dtype=data.dtype, device=data.device)
    hann = 0.5 * (1 - torch.cos(2 * torch.pi * t / (w - 1)))
    spec = torch.fft.rfft(data * hann, dim=-1).abs()[..., : w // 2]
    # k / (n·dt), as numpy's and JAX's rfftfreq form it (torch's multiplies by
    # 1 / (n·dt), which moves bins on a band edge across it)
    freq = torch.arange(w // 2, dtype=data.dtype, device=data.device) / (w * dt)
    hi = (freq > high_freq_band[0]) & (freq < high_freq_band[1])
    lo = (freq > low_freq_band[0]) & (freq < low_freq_band[1])
    a_hi = (spec * hi).sum(dim=-1) / max(int(hi.sum()), 1)
    a_lo = (spec * lo).sum(dim=-1) / max(int(lo.sum()), 1)
    return torch.log10(a_hi / a_lo)


def _percentile95_abs(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """95th percentile of |x| over valid samples along the last axis.

    Masked percentile via sort: invalid samples are pushed to +inf and the
    quantile index is computed from the valid count (linear interpolation,
    numpy's 'linear' method); fixed shapes throughout."""
    ax = x.abs()
    valid = valid.expand(ax.shape)
    vals = torch.sort(torch.where(valid, ax, torch.full_like(ax, float("inf"))), dim=-1).values
    n = valid.sum(dim=-1)
    q = 0.95 * (n.to(x.dtype) - 1.0)
    lo_idx = torch.clamp(torch.floor(q).long(), 0, x.shape[-1] - 1)
    hi_idx = torch.clamp(lo_idx + 1, 0, x.shape[-1] - 1)
    frac = q - lo_idx.to(x.dtype)
    lo = torch.gather(vals, -1, lo_idx[..., None])[..., 0]
    hi = torch.gather(vals, -1, hi_idx[..., None])[..., 0]
    hi = torch.where(hi_idx.to(x.dtype) > (n - 1).to(x.dtype), lo, hi)
    return lo + frac * (hi - lo)


def snr_db(
    data: torch.Tensor,
    p_sample: torch.Tensor,
    s_sample: torch.Tensor,
    winlen: int = 500,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched SNR in dB. data (B, C, W); p/s_sample (B,) float (NaN = absent).

    Semantics follow the reference (`volpick/data/utils.py:45-102`):
    noise = P95(|x|) in [p - winlen, p); signal = P95(|x|) in [s, s + winlen)
    when an S pick exists with s < W - 10, else [p, p + winlen). Traces with
    no P or p < 10 → NaN. Returns (per-channel SNRs (B, C), mean SNR (B,))."""
    _, _, w = data.shape
    t = torch.arange(w, device=data.device)[None, None, :]
    p = p_sample[:, None, None]
    s = s_sample[:, None, None]
    has_p = ~torch.isnan(p_sample) & (p_sample >= 10)
    has_s = ~torch.isnan(s_sample) & (s_sample < w - 10)

    noise_valid = (t >= torch.clamp(p - winlen, min=0)) & (t < p)
    sig_start = torch.where(has_s[:, None, None], s, p)
    sig_valid = (t >= sig_start) & (t < torch.clamp(sig_start + winlen, max=w))

    noi = _percentile95_abs(data, noise_valid)
    sig = _percentile95_abs(data, sig_valid)
    good = (noi > 1e-30) & (sig > 1e-30) & has_p[:, None]
    snr = torch.where(good, 20.0 * torch.log10(sig / torch.clamp(noi, min=1e-30)),
                      torch.full_like(noi, float("nan")))
    return snr, torch.nanmean(snr, dim=-1)
