"""The two numpy measurements of ``volpick_tpu/acquisition/convert.py`` that
``data/synthetic.py`` records in its metadata: the frequency index and the
per-component P95 SNR. Copies; the converter itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


def _frequency_index_numpy(
    data: np.ndarray, dt: float, low=(1.0, 5.0), high=(10.0, 15.0)
) -> float:
    """FI = log10(mean|A| in high band / mean|A| in low band), Hann-windowed
    FFT (reference `volpick/data/utils.py:27-42`)."""
    n = len(data)
    if n < 8:
        return float("nan")
    hann = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / (n - 1)))
    spec = np.abs(np.fft.rfft(data * hann))[: n // 2]
    freq = np.fft.rfftfreq(n, dt)[: n // 2]
    hi = (freq > high[0]) & (freq < high[1])
    lo = (freq > low[0]) & (freq < low[1])
    if not hi.any() or not lo.any():
        return float("nan")
    return float(np.log10(np.mean(spec[hi]) / np.mean(spec[lo])))


def _snr_db_numpy(data: np.ndarray, p_sample, s_sample, winlen: int):
    """Per-component 95th-percentile SNR (reference `utils.py:45-102`)."""
    n = data.shape[-1]
    if p_sample is None or (isinstance(p_sample, float) and np.isnan(p_sample)) or p_sample < 10:
        return [float("nan")] * data.shape[0], float("nan")
    p = int(p_sample)
    use_s = s_sample is not None and not np.isnan(float(s_sample)) and s_sample < n - 10
    sig_start = int(s_sample) if use_s else p
    if p > n or sig_start >= n or sig_start < 0:  # picks outside the trace
        return [float("nan")] * data.shape[0], float("nan")
    snrs = []
    for comp in data:
        noi_seg = np.abs(comp[max(0, p - winlen) : p])
        sig_seg = np.abs(comp[sig_start : min(sig_start + winlen, n)])
        if not len(noi_seg) or not len(sig_seg):
            snrs.append(float("nan"))
            continue
        noi = np.percentile(noi_seg, 95)
        sig = np.percentile(sig_seg, 95)
        if np.isclose(noi, 0) or np.isclose(sig, 0):
            snrs.append(float("nan"))
        else:
            snrs.append(float(20 * np.log10(sig / noi)))
    mean = float(np.nanmean(snrs)) if not np.all(np.isnan(snrs)) else float("nan")
    return snrs, mean
