"""Two-threshold trigger + peak extraction on batched probability curves.

Port of ``volpick_tpu/ops/triggers.py::extract_triggers_batched``: obspy
``trigger_onset(prob, thres1, thres2)`` semantics with an in-trigger argmax,
for many curves at once with per-row thresholds. The work is done by
``ops/cuda/triggers.py``: its CUDA kernels for a CUDA tensor, their plain
PyTorch twins for a CPU tensor.

Methods (the names of the JAX package, so ``$VOLPICK_TRIGGER_METHOD`` means
the same in both):

- ``"pallas_full"`` (default): scan and pick emission in one kernel,
  ``trigger_extract``;
- ``"pallas"``: the ``trigger_scan`` kernel writes the scanned state at every
  position, and the emission (run-end mask, earliest-k, gathers) follows in
  plain PyTorch;
- ``"shift"``: the scan itself in plain PyTorch (shift + combine passes)
  followed by the same emission, on any device;
- ``"blocked"``: as ``"shift"``, the scan in two levels (inside blocks of 2048
  samples, then over the blocks' summaries), on any device;
- ``"assoc"``: as ``"shift"``, the scan as an up-sweep over pairs and a
  down-sweep (the recursion ``jax.lax.associative_scan`` lowers the JAX
  package's method of that name to), on any device.

All give the same picks. ``trigger_onset_numpy`` is the host oracle of the
trigger rule and ``picks_from_prob_numpy`` that of the picks, numpy only.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from volpick_tpu_torch.ops.cuda.triggers import (
    Picks,
    emit_picks,
    trigger_extract,
    trigger_extract_assoc,
    trigger_extract_blocked,
    trigger_extract_reference,
    trigger_scan,
)

_METHODS = ("pallas_full", "pallas", "shift", "blocked", "assoc")


def trigger_onset_numpy(prob: np.ndarray, thres1: float, thres2: float) -> List[Tuple[int, int]]:
    """Host oracle: list of (on, off) triggers, obspy trigger_onset semantics.
    For each maximal run of samples with prob > thres2 that holds a sample
    with prob > thres1: (first such sample, last index of the run)."""
    prob = np.asarray(prob)
    above2 = prob > thres2
    if not above2.any():
        return []
    # run boundaries of above2
    d = np.diff(above2.astype(np.int8))
    run_starts = list(np.where(d == 1)[0] + 1)
    run_ends = list(np.where(d == -1)[0])  # inclusive last index of run
    if above2[0]:
        run_starts.insert(0, 0)
    if above2[-1]:
        run_ends.append(len(prob) - 1)
    triggers = []
    above1 = prob > thres1
    for s, e in zip(run_starts, run_ends):
        idx = np.where(above1[int(s) : int(e) + 1])[0]
        if len(idx):
            triggers.append((int(s) + int(idx[0]), int(e)))
    return triggers


def picks_from_prob_numpy(
    prob: np.ndarray, thres: float, thres2: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pick samples + peak values from a probability curve (host oracle).

    Matches reference `eval_taks0.get_picks_from_prob` (`eval_taks0.py:46-56`):
    trigger_onset(prob, thres, thres/2); pick = on + argmax(prob[on:off]).
    """
    if thres2 is None:
        thres2 = thres / 2.0
    triggers = trigger_onset_numpy(prob, thres, thres2)
    picks, values = [], []
    for on, off in triggers:
        # the reference searches prob[s0 : s1 + 1] — inclusive of the
        # (obspy-inclusive) off index (`eval_taks0.py:46-56`)
        seg = prob[on : off + 1]
        k = int(np.argmax(seg))
        picks.append(on + k)
        values.append(float(prob[on + k]))
    return np.asarray(picks, dtype=np.int64), np.asarray(values, dtype=np.float64)


def default_trigger_method() -> str:
    """``$VOLPICK_TRIGGER_METHOD``, else ``"pallas_full"``."""
    return os.environ.get("VOLPICK_TRIGGER_METHOD", "").strip() or "pallas_full"


def extract_triggers_batched(
    prob: torch.Tensor, thres1, thres2=None, max_picks: int = 32, method: Optional[str] = None
) -> Picks:
    """Returns (peak_idx, peak_value, valid, onset_idx, offset_idx), each
    (B, max_picks), for prob (B, W) float32.

    thres1/thres2 are scalars or per-row (B,) values; thres2 defaults to
    thres1 / 2 computed in float32. Picks are the earliest max_picks per row
    in time order; invalid entries have idx/onset/offset -1 and value 0.
    offset is the last index of the > thres2 run (inclusive, obspy).
    `method` selects the route (see the module docstring); None takes
    ``default_trigger_method()``."""
    if method is None:
        method = default_trigger_method()
    if method not in _METHODS:
        raise ValueError(f"unknown trigger scan method {method!r}")
    b = prob.shape[0]
    t1 = torch.as_tensor(thres1, dtype=torch.float32, device=prob.device)
    t2 = t1 / 2.0 if thres2 is None else torch.as_tensor(
        thres2, dtype=torch.float32, device=prob.device
    )
    t1 = t1.reshape(-1).expand(b).contiguous()
    t2 = t2.reshape(-1).expand(b).contiguous()
    prob = prob.contiguous()
    if method == "pallas_full":
        return trigger_extract(prob, t1, t2, max_picks)
    if method == "pallas":
        return emit_picks(prob, t2, trigger_scan(prob, t1, t2), max_picks)
    if method == "blocked":
        return trigger_extract_blocked(prob, t1, t2, max_picks)
    if method == "assoc":
        return trigger_extract_assoc(prob, t1, t2, max_picks)
    return trigger_extract_reference(prob, t1, t2, max_picks)


def extract_picks_batched(
    prob: torch.Tensor, thres1, thres2=None, max_picks: int = 32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peaks only: (pick_idx, pick_value, valid), each (B, max_picks), the
    first three outputs of ``extract_triggers_batched``."""
    idx, val, valid, _, _ = extract_triggers_batched(prob, thres1, thres2, max_picks)
    return idx, val, valid
