"""Host-side numpy oracle of the SeisBench annotate()/classify() algorithm.

The reference delegates continuous picking to SeisBench's WaveformModel
(reference `README.md:54-84`): sliding windows at stride = window - overlap
plus one final window flush with the stream end, per-window conditioning
(demean or detrend, then peak/std amplitude normalization), model forward,
edge blinding, "avg"/"max" stacking of the overlapping window predictions
back into continuous probability curves, and two-threshold trigger pick
extraction on the stacked curves.

This module re-states that whole algorithm in plain numpy, one step at a
time, with no batching/fusion tricks — it is the executable specification
that the device path (`picker/annotate.py`) is held to sample-exactly
(tests/test_torch_oracle.py). It is deliberately slow and obvious. It is the
port's own copy of `volpick_tpu/picker/oracle.py`, held equal to it by the
same test.

The model forward is injected as `predict_fn` so the oracle can pin the
placement/stacking/trigger algebra independently of any network weights.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from volpick_tpu_torch.ops.triggers import trigger_onset_numpy


def oracle_window_starts(n_samples: int, window: int, stride: int) -> List[int]:
    """SeisBench window placement: 0, stride, 2·stride, …, plus a final
    window flush with the stream end when the grid does not already end
    there. Streams shorter than one window get a single window at 0
    (the caller zero-pads)."""
    if n_samples <= window:
        return [0]
    starts = list(range(0, n_samples - window + 1, stride))
    if starts[-1] + window < n_samples:
        starts.append(n_samples - window)
    return starts


def oracle_condition(frame: np.ndarray, detrend: bool, norm: str) -> np.ndarray:
    """Per-window conditioning: demean (or linear detrend) per channel, then
    per-channel peak/std amplitude normalization (reference
    `volpick/model/models.py:259-264` Normalize semantics)."""
    frame = np.asarray(frame, dtype=np.float64)
    w = frame.shape[-1]
    if detrend:
        t = np.arange(w) - (w - 1) / 2.0
        mean = frame.mean(axis=-1, keepdims=True)
        slope = ((frame - mean) * t).sum(axis=-1, keepdims=True) / (t * t).sum()
        frame = frame - mean - slope * t
    else:
        frame = frame - frame.mean(axis=-1, keepdims=True)
    if norm == "peak":
        scale = np.abs(frame).max(axis=-1, keepdims=True)
    elif norm == "std":
        scale = frame.std(axis=-1, keepdims=True)
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return frame / (scale + 1e-10)


def oracle_annotate(
    data: np.ndarray,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    window: int,
    overlap: int,
    blinding: Tuple[int, int] = (0, 0),
    stacking: str = "avg",
    detrend: bool = False,
    norm: str = "peak",
) -> np.ndarray:
    """Continuous probability curves for one instrument, the slow exact way.

    data: (C, n) raw waveform; predict_fn: conditioned (C, window) →
    (K, window) per-window probabilities. Returns (K, n) stacked curves.
    """
    c, n = data.shape
    stride = window - overlap
    if n < window:  # pad like the device path, crop at the end
        data = np.pad(data, ((0, 0), (0, window - n)))
    total = max(n, window)
    starts = oracle_window_starts(total, window, stride)

    k = None
    acc = None
    wgt = np.zeros(total, dtype=np.float64)
    l, r = blinding
    for s0 in starts:
        frame = oracle_condition(data[:, s0 : s0 + window], detrend, norm)
        pred = np.asarray(predict_fn(frame), dtype=np.float64)  # (K, window)
        if acc is None:
            k = pred.shape[0]
            if stacking == "avg":
                acc = np.zeros((k, total), dtype=np.float64)
            elif stacking == "max":
                acc = np.zeros((k, total), dtype=np.float64)
            else:
                raise ValueError(f"unknown stacking {stacking!r}")
        lo, hi = l, window - r
        if stacking == "avg":
            acc[:, s0 + lo : s0 + hi] += pred[:, lo:hi]
            wgt[s0 + lo : s0 + hi] += 1.0
        else:
            seg = acc[:, s0 + lo : s0 + hi]
            acc[:, s0 + lo : s0 + hi] = np.maximum(seg, pred[:, lo:hi])
    if stacking == "avg":
        acc = acc / np.maximum(wgt, 1.0)[None, :]
    return acc[:, :n]


def oracle_classify(
    data: np.ndarray,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    window: int,
    overlap: int,
    thresholds: Dict[str, float],
    channels: List[str],
    blinding: Tuple[int, int] = (0, 0),
    stacking: str = "avg",
    detrend: bool = False,
    norm: str = "peak",
) -> Dict[str, List[Tuple[int, float, int, int]]]:
    """Picks per label: {label: [(peak_idx, peak_val, on, off), ...]}.

    Trigger semantics: obspy trigger_onset(curve, thr, thr/2) with pick =
    argmax over the inclusive [on, off] span (reference
    `volpick/model/eval_taks0.py:46-56`). Picks whose onset or peak fall at
    or beyond the real stream end (possible only for streams shorter than
    one window, where the single window is zero-padded) are dropped, and the
    trigger end is clamped to the last real sample — mirroring classify().
    """
    n = data.shape[-1]
    curves = oracle_annotate(
        data, predict_fn, window, overlap, blinding=blinding, stacking=stacking,
        detrend=detrend, norm=norm,
    )
    # for short streams the triggers must see the same padded curve length
    # the device path scans (window), then the boundary rules drop pad picks
    if n < window:
        full = oracle_annotate(
            np.pad(data, ((0, 0), (0, window - n))), predict_fn, window, overlap,
            blinding=blinding, stacking=stacking, detrend=detrend, norm=norm,
        )
    else:
        full = curves
    out: Dict[str, List[Tuple[int, float, int, int]]] = {}
    for ki, label in enumerate(channels):
        if label == "N":
            continue
        thr = thresholds[label]
        picks = []
        for on, off in trigger_onset_numpy(full[ki], thr, thr / 2.0):
            seg = full[ki][on : off + 1]
            pk = on + int(np.argmax(seg))
            if on >= n or pk >= n:
                continue
            picks.append((pk, float(full[ki][pk]), on, min(off, n - 1)))
        out[label] = picks
    return out
