"""Performance vs frequency index / SNR analysis.

Port of ``volpick_tpu/eval/analysis.py`` (the model runs on `device`, the
card unless ``device="cpu"``).

Counterpart of the reference's `Performance_vs_freq_vs_snr` notebooks: bins
evaluation windows by trace SNR and frequency index and computes per-bin
recall / residual statistics, separating LP from regular events.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Sequence

import numpy as np

if TYPE_CHECKING:
    import pandas as pd


def recall_by_bins(
    targets: pd.DataFrame,
    picks_per_window: Sequence[np.ndarray],
    truth_per_window: Sequence[np.ndarray],
    bin_column: str,
    bins: Sequence[float],
    sampling_rate: float = 100.0,
    tolerance: float = 0.5,
) -> pd.DataFrame:
    """Recall and onset MAE per bin of `bin_column` (e.g. trace_mean_snr_db or
    trace_frequency_index). Rows of `targets` align with the pick lists."""
    import pandas as pd

    values = targets[bin_column].to_numpy(dtype=float)
    edges = np.asarray(bins, dtype=float)
    rows = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (values >= lo) & (values < hi)
        tp = fn = 0
        residuals = []
        for i in np.where(sel)[0]:
            truth, pred = truth_per_window[i], picks_per_window[i]
            if len(truth) == 0:
                continue
            t = truth[0]
            if len(pred) and np.min(np.abs(pred - t)) / sampling_rate <= tolerance:
                tp += 1
                residuals.append((pred[np.argmin(np.abs(pred - t))] - t) / sampling_rate)
            else:
                fn += 1
        rows.append(
            {
                "bin_lo": lo,
                "bin_hi": hi,
                "n": tp + fn,
                "recall": tp / (tp + fn) if tp + fn else np.nan,
                "mae_s": float(np.mean(np.abs(residuals))) if residuals else np.nan,
            }
        )
    return pd.DataFrame(rows)


def performance_vs_snr_fi(
    model,
    dataset,
    targets_path,
    output_dir,
    set_name: str = "test",
    prob_threshold: Optional[float] = None,
    s_threshold: Optional[float] = None,
    snr_bins: Sequence[float] = (-10, 0, 5, 10, 15, 20, 30, 60),
    fi_bins: Sequence[float] = (-3, -1.5, -1.0, -0.5, 0.0, 0.5, 1.5),
    batch_size: int = 256,
    device=None,
) -> Dict[str, pd.DataFrame]:
    """Run the task0 picks once and bin P and S recall by SNR and FI.

    Requires the dataset metadata to carry trace_mean_snr_db /
    trace_frequency_index (written by the converter / hard generator).
    Probability curves are computed once and reused for both thresholds
    (P picks at `prob_threshold`, S picks at `s_threshold`, which defaults
    to `prob_threshold` — pass the dev-optimal pair from opt_prob_metrics)."""
    import pandas as pd

    from pathlib import Path

    from volpick_tpu_torch.eval.task0 import _SteeredRunner, evaluate, get_ground_truth

    if prob_threshold is None:
        prob_threshold = model.default_args.get("P_threshold", 0.3)
    if s_threshold is None:
        s_threshold = prob_threshold
    targets = pd.read_csv(Path(targets_path) / "task0.csv")
    targets = targets[targets["trace_split"] == set_name].reset_index(drop=True)
    runner = _SteeredRunner(model, batch_size=batch_size, device=device)
    curves = runner.prob_curves(dataset, targets)
    p_pred, s_pred = evaluate(model, dataset, targets, prob_threshold, curves=curves, device=device)
    if s_threshold != prob_threshold:
        s_pred = evaluate(model, dataset, targets, s_threshold, curves=curves, device=device)[1]
    p_gt, s_gt = get_ground_truth(dataset, targets)

    md = dataset.metadata
    for col in ("trace_mean_snr_db", "trace_frequency_index", "source_type"):
        if col in md.columns:
            targets[col] = md[col].to_numpy()[targets["trace_idx"].to_numpy()]

    out: Dict[str, pd.DataFrame] = {}
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    phase_sets = (("p", p_pred, p_gt), ("s", s_pred, s_gt))
    if "trace_mean_snr_db" in targets.columns:
        for ph, pred, gt in phase_sets:
            key = f"{ph}_recall_vs_snr"
            out[key] = recall_by_bins(targets, pred, gt, "trace_mean_snr_db", snr_bins)
            out[key].to_csv(output_dir / f"{set_name}_{key}.csv", index=False)
    if "trace_frequency_index" in targets.columns:
        for ph, pred, gt in phase_sets:
            key = f"{ph}_recall_vs_fi"
            out[key] = recall_by_bins(targets, pred, gt, "trace_frequency_index", fi_bins)
            out[key].to_csv(output_dir / f"{set_name}_{key}.csv", index=False)
    if "source_type" in targets.columns:
        rows = []
        for st in targets["source_type"].dropna().unique():
            sel = np.where((targets["source_type"] == st).to_numpy())[0]
            row = {"source_type": st}
            for ph, pred, gt in phase_sets:
                tp = sum(
                    1
                    for i in sel
                    if len(gt[i]) and len(pred[i]) and np.min(np.abs(pred[i] - gt[i][0])) <= 50
                )
                n = sum(1 for i in sel if len(gt[i]))
                row[f"n_{ph}"] = n
                row[f"{ph}_recall"] = tp / n if n else np.nan
            rows.append(row)
        out["recall_vs_type"] = pd.DataFrame(rows)
        out["recall_vs_type"].to_csv(output_dir / f"{set_name}_recall_vs_type.csv", index=False)
    return out
