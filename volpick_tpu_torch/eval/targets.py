"""Evaluation-target generation (reference `volpick/model/generate_eval_targets.py`).

Port of ``volpick_tpu/eval/targets.py`` (a copy: numpy and pandas only; the
samplers draw from the global ``np.random`` stream seeded 42 in the same
order, so both packages write the same CSVs from one dataset).

- task0: 30 s windows containing the first arrival (+ optional pre-event noise
  windows), keeping every pick contained in the window; used for the
  threshold-sweep pick benchmark.
- task1: 30 s detection windows labeled earthquake/noise.
- task23: 10 s single-onset windows with 0.5 s isolation spacing; used for
  P-vs-S discrimination (task2) and onset-residual (task3) scoring.

All samplers are seeded with np.random.seed(42), matching the reference, so
target CSVs are reproducible.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Optional

import numpy as np

from volpick_tpu_torch.pipeline.generator import PHASE_COLUMNS

if TYPE_CHECKING:
    import pandas as pd


def select_window_containing(npts, windowlen, containing=None, bounds=(100, 100)):
    """Seeded window sampler (reference `generate_eval_targets.py:420-448`)."""
    if npts <= windowlen:
        return 0, npts
    if containing is None:
        start = np.random.randint(0, npts - windowlen + 1)
        return start, start + windowlen
    earliest = max(0, containing - windowlen + bounds[1])
    latest = min(npts - windowlen, containing - bounds[0])
    if latest <= earliest:
        return 0, npts
    start = np.random.randint(earliest, latest + 1)
    return start, start + windowlen


def _arrivals(metadata: dict, npts: int):
    """Sorted (onset, label, column) for valid picks in the trace."""
    import pandas as pd

    out = []
    for col, label in PHASE_COLUMNS.items():
        v = metadata.get(col)
        if v is not None and not pd.isna(v) and 0 <= float(v) < npts:
            out.append((float(v), label, col))
    return sorted(out)


def generate_task0(
    dataset,
    output,
    sampling_rate: float = 100.0,
    noise_before_events: bool = False,
    windowlen_t: float = 30.0,
    keep_source_type: bool = False,
    replace_if_exist: bool = True,
) -> Optional[pd.DataFrame]:
    import pandas as pd

    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    if (output / "task0.csv").exists() and not replace_if_exist:
        return None
    np.random.seed(42)
    windowlen = int(windowlen_t * sampling_rate)
    labels = []
    for i in range(len(dataset)):
        waveforms, metadata = dataset.get_sample(i)
        npts = waveforms.shape[-1]
        base = {
            "trace_name": metadata["trace_name"],
            "trace_idx": i,
            "trace_split": metadata.get("split", ""),
            "sampling_rate": sampling_rate,
            "trace_chunk": metadata.get("trace_chunk", ""),
        }
        if keep_source_type:
            for k in ("source_type", "source_frequency_index", "trace_frequency_index"):
                if k in metadata:
                    base[k] = metadata[k]
        arrivals = _arrivals(metadata, npts)
        if not arrivals:
            s0, s1 = select_window_containing(npts, windowlen)
            labels.append(dict(base, start_sample=s0, end_sample=s1, trace_type="noise"))
        else:
            first = arrivals[0][0]
            s0, s1 = select_window_containing(npts, windowlen, containing=first)
            if s1 - s0 <= windowlen:
                row = dict(base, start_sample=s0, end_sample=s1, trace_type="earthquake")
                any_pick = False
                for onset, label, col in arrivals:
                    if s0 <= onset < s1:
                        row[col] = onset
                        any_pick = True
                if any_pick:
                    labels.append(row)
            if noise_before_events and first > windowlen:
                s0, s1 = select_window_containing(min(npts, int(first)), windowlen)
                if s1 - s0 <= windowlen:
                    labels.append(dict(base, start_sample=s0, end_sample=s1, trace_type="noise"))
    df = pd.DataFrame(labels)
    if len(df):
        df = df[df["end_sample"] - df["start_sample"] > 100]
    df.to_csv(output / "task0.csv", index=False)
    return df


def generate_task1(
    dataset,
    output,
    sampling_rate: float = 100.0,
    noise_before_events: bool = True,
    windowlen_t: float = 30.0,
    replace_if_exist: bool = True,
) -> Optional[pd.DataFrame]:
    """Detection windows: same geometry as task0 but always labeled by
    earthquake/noise content (reference `generate_eval_targets.py:196-308`)."""
    import pandas as pd

    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    if (output / "task1.csv").exists() and not replace_if_exist:
        return None
    np.random.seed(42)
    windowlen = int(windowlen_t * sampling_rate)
    labels = []
    for i in range(len(dataset)):
        waveforms, metadata = dataset.get_sample(i)
        npts = waveforms.shape[-1]
        base = {
            "trace_name": metadata["trace_name"],
            "trace_idx": i,
            "trace_split": metadata.get("split", ""),
            "sampling_rate": sampling_rate,
            "trace_chunk": metadata.get("trace_chunk", ""),
        }
        arrivals = _arrivals(metadata, npts)
        if not arrivals:
            s0, s1 = select_window_containing(npts, windowlen)
            labels.append(dict(base, start_sample=s0, end_sample=s1, trace_type="noise"))
        else:
            first = arrivals[0][0]
            s0, s1 = select_window_containing(npts, windowlen, containing=first)
            if s1 - s0 <= windowlen:
                labels.append(dict(base, start_sample=s0, end_sample=s1, trace_type="earthquake"))
            if noise_before_events and first > windowlen:
                s0, s1 = select_window_containing(min(npts, int(first)), windowlen)
                if s1 - s0 <= windowlen:
                    labels.append(dict(base, start_sample=s0, end_sample=s1, trace_type="noise"))
    df = pd.DataFrame(labels)
    if len(df):
        df = df[df["end_sample"] - df["start_sample"] > 100]
    df.to_csv(output / "task1.csv", index=False)
    return df


def generate_task23(
    dataset, output, sampling_rate: float = 100.0, replace_if_exist: bool = True
) -> Optional[pd.DataFrame]:
    import pandas as pd

    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    if (output / "task23.csv").exists() and not replace_if_exist:
        return None
    np.random.seed(42)
    windowlen = int(10 * sampling_rate)
    spacing = int(0.5 * sampling_rate)
    labels = []
    for idx in range(len(dataset)):
        waveforms, metadata = dataset.get_sample(idx)
        npts = waveforms.shape[-1]
        arrivals = _arrivals(metadata, npts)
        if not arrivals:
            continue
        for i, (onset, phase, col) in enumerate(arrivals):
            onset_before = 0 if i == 0 else int(arrivals[i - 1][0]) + spacing
            onset_after = np.inf if i == len(arrivals) - 1 else int(arrivals[i + 1][0]) - spacing
            if onset_after - onset_before < windowlen or onset_before > onset or onset_after < onset:
                continue
            onset_after = min(onset_after, npts)
            s0, s1 = select_window_containing(
                int(onset_after - onset_before), windowlen, containing=int(onset - onset_before), bounds=(50, 50)
            )
            s0 += onset_before
            s1 += onset_before
            if s1 - s0 <= windowlen:
                labels.append(
                    {
                        "trace_name": metadata["trace_name"],
                        "trace_idx": idx,
                        "trace_split": metadata.get("split", ""),
                        "sampling_rate": sampling_rate,
                        "start_sample": s0,
                        "end_sample": s1,
                        "phase_label": phase,
                        "full_phase_label": col.split("_")[1],
                        "phase_onset": onset,
                        "trace_chunk": metadata.get("trace_chunk", ""),
                    }
                )
    df = pd.DataFrame(labels)
    if len(df):
        df = df[df["end_sample"] - df["start_sample"] > 100]
    df.to_csv(output / "task23.csv", index=False)
    return df
