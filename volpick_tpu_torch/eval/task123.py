"""Tasks 1/2/3: SeisBench pick-benchmark protocol (reference
`volpick/model/eval_taks123.py`).

Port of ``volpick_tpu/eval/task123.py``:

- eval_tasks123: steered inference producing per-window
  (score_detection, score_p_or_s, p_sample_pred, s_sample_pred), the
  predict_step contract of the reference (`models.py:454-480`, `:881-906`),
  written to {set}_task{1,23}.csv; the masked max / argmax run on `device`
  (the card unless ``device="cpu"``) and 4 numbers a window come back (7
  for VolEQTransformer);
- parse_task1: detection PR/AUC with the dev-F1-optimal threshold applied to
  test;
- parse_task23: P-vs-S precision/recall/F1 + MCC (50-candidate threshold
  scan) and onset-residual statistics (mean/median/RMSE/MAE, outlier fraction
  and |r|<1 s trimmed variants).

The metrics come from ``eval/_metrics.py`` (numpy), not from scikit-learn as
in the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional, Sequence

import numpy as np
import torch

from volpick_tpu_torch.device import inference_work, resolve_device
from volpick_tpu_torch.eval._metrics import (
    matthews_corrcoef,
    precision_recall_curve,
    precision_recall_fscore_support,
    roc_auc_score,
)
from volpick_tpu_torch.eval.task0 import _region, _set_targets, _steered_batches, trace_source
from volpick_tpu_torch.pipeline.generator import RawBatchSource

if TYPE_CHECKING:
    import pandas as pd


def _scores(model, frames: torch.Tensor, mask: torch.Tensor):
    """(score_det, score_ps, p_sample, s_sample[, rg, lp, rg/lp]) of a batch:
    max / argmax over the steered region of each window (-inf outside it;
    PhaseNet's noise channel +inf, so 1 - noise is -inf there)."""
    neg = torch.tensor(-torch.inf, device=frames.device)

    def masked(c):
        return torch.where(mask, c, neg)

    def tail(p_m, s_m):
        return (p_m.amax(-1) / s_m.amax(-1), p_m.argmax(-1), s_m.argmax(-1))

    if model.name == "VolEQTransformer":
        # the commented reference predict_step (`models.py:1310-1374`):
        # score_detection = max over max(rg, lp); plus per-type scores
        rg_m, lp_m, p_m, s_m = (masked(c) for c in model(frames))
        rg_max, lp_max = rg_m.amax(-1), lp_m.amax(-1)
        return (torch.maximum(rg_m, lp_m).amax(-1),) + tail(p_m, s_m) + (rg_max, lp_max, rg_max / lp_max)
    if model.name == "EQTransformer":
        det_m, p_m, s_m = (masked(c) for c in model(frames))
        return (det_m.amax(-1),) + tail(p_m, s_m)
    pred = model(frames)
    pi, si, ni = (model.phases.index(c) for c in "PSN")
    n_m = torch.where(mask, pred[:, ni], -neg)
    return ((1 - n_m).amax(-1),) + tail(masked(pred[:, pi]), masked(pred[:, si]))


def _predict_scores(model, dataset, targets: pd.DataFrame, batch_size: int = 256, device=None,
                    source: Optional[RawBatchSource] = None):
    """Batched predict_step: masked max/argmax within the steered region, on
    `device`; only the scores of each window come back. `source` is the
    dataset's ``trace_source``, when the caller holds one."""
    device = resolve_device(device, "_predict_scores")
    model = model.to(device).eval()
    window = model.in_samples
    cols = ["score_detection", "score_p_or_s", "p_sample_pred", "s_sample_pred"]
    if model.name == "VolEQTransformer":
        cols += ["score_rg_detection", "score_lp_detection", "score_rg_or_lp"]
    out = {k: [] for k in cols}
    with inference_work(device):
        for frames, borders in _steered_batches(model, trace_source(dataset, source), targets, batch_size,
                                                device):
            mask = _region(torch.as_tensor(borders).to(device), window)
            res = [r.cpu().numpy() for r in _scores(model, frames, mask)]
            # argmaxes are window-relative; the reference's predict_step slices
            # the region, so its argmax is region-relative: subtract border_lo
            res[2] = res[2] - borders[:, 0]
            res[3] = res[3] - borders[:, 0]
            for k, v in zip(cols, res):
                out[k].append(v)
    return {k: np.concatenate(v) for k, v in out.items()}


def eval_tasks123(
    model,
    dataset,
    targets_path,
    output_dir,
    sets: Sequence[str] = ("dev", "test"),
    batch_size: int = 256,
    num_test_run: Optional[int] = None,
    device=None,
):
    """Writes {set}_task1.csv and {set}_task23.csv prediction tables: the
    targets with the scores appended."""
    import pandas as pd

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    targets_path = Path(targets_path)
    src = trace_source(dataset)
    for task, fname in (("1", "task1.csv"), ("23", "task23.csv")):
        f = targets_path / fname
        if not f.exists():
            continue
        all_targets = pd.read_csv(f)
        for set_name in sets:
            targets = _set_targets(all_targets, set_name, num_test_run)
            if not len(targets):
                continue
            scores = _predict_scores(model, dataset, targets, batch_size, device=device, source=src)
            pred = targets.copy()
            for k, v in scores.items():
                pred[k] = v
            pred.to_csv(output_dir / f"{set_name}_task{task}.csv", index=False)
    return output_dir


def parse_task1(exp_dir) -> Dict:
    import pandas as pd

    exp_dir = Path(exp_dir)
    if not ((exp_dir / "dev_task1.csv").is_file() and (exp_dir / "test_task1.csv").is_file()):
        return {}
    dev = pd.read_csv(exp_dir / "dev_task1.csv")
    test = pd.read_csv(exp_dir / "test_task1.csv")
    dev["bin"] = dev["trace_type"] == "earthquake"
    test["bin"] = test["trace_type"] == "earthquake"

    prec, recall, thr = precision_recall_curve(dev["bin"], dev["score_detection"])
    with np.errstate(invalid="ignore"):
        f1 = 2 * prec * recall / (prec + recall)
    auc = roc_auc_score(dev["bin"], dev["score_detection"]) if dev["bin"].nunique() > 1 else np.nan
    opt = int(np.nanargmax(f1))
    opt_thr = thr[min(opt, len(thr) - 1)]
    stats = {
        "dev_det_precision": prec[opt],
        "dev_det_recall": recall[opt],
        "dev_det_f1": f1[opt],
        "dev_det_auc": auc,
        "det_threshold": opt_thr,
    }
    p, r, f, _ = precision_recall_fscore_support(
        test["bin"], test["score_detection"] > opt_thr
    )
    stats.update(
        {
            "test_det_precision": p,
            "test_det_recall": r,
            "test_det_f1": f,
            "test_det_auc": roc_auc_score(test["bin"], test["score_detection"])
            if test["bin"].nunique() > 1
            else np.nan,
        }
    )
    return stats


def parse_task23(exp_dir) -> Dict:
    import pandas as pd

    exp_dir = Path(exp_dir)
    if not ((exp_dir / "dev_task23.csv").is_file() and (exp_dir / "test_task23.csv").is_file()):
        return {}
    dev = pd.read_csv(exp_dir / "dev_task23.csv")
    test = pd.read_csv(exp_dir / "test_task23.csv")
    for df in (dev, test):
        df["bin"] = df["phase_label"] == "P"
        for col in ("s_sample_pred", "score_p_or_s"):
            if col not in df.columns:
                df[col] = np.nan
        df["score_p_or_s"] = np.clip(df["score_p_or_s"].to_numpy(), -1e100, 1e100)

    stats: Dict = {}
    dev_r = dev[~np.isnan(dev["score_p_or_s"])]
    if len(dev_r):
        prec, recall, thr = precision_recall_curve(dev_r["bin"], dev_r["score_p_or_s"])
        with np.errstate(invalid="ignore"):
            f1 = 2 * prec * recall / (prec + recall)
        opt = int(np.nanargmax(f1))
        opt_thr = thr[min(opt, len(thr) - 1)]
        mcc_thrs = np.sort(dev["score_p_or_s"].to_numpy())
        mcc_thrs = mcc_thrs[np.linspace(0, len(mcc_thrs) - 1, 50, dtype=int)]
        mccs = [matthews_corrcoef(dev["bin"], dev["score_p_or_s"] > t) for t in mcc_thrs]
        stats.update(
            {
                "dev_phase_precision": prec[opt],
                "dev_phase_recall": recall[opt],
                "dev_phase_f1": f1[opt],
                "phase_threshold": opt_thr,
                "dev_phase_mcc": np.max(mccs),
                "phase_threshold_mcc": mcc_thrs[int(np.argmax(mccs))],
            }
        )
        test_r = test[~np.isnan(test["score_p_or_s"])]
        p, r, f, _ = precision_recall_fscore_support(
            test_r["bin"], test_r["score_p_or_s"] > opt_thr
        )
        stats.update(
            {
                "test_phase_precision": p,
                "test_phase_recall": r,
                "test_phase_f1": f,
                "test_phase_mcc": matthews_corrcoef(
                    test["bin"], test["score_p_or_s"] > stats["phase_threshold_mcc"]
                ),
            }
        )

    for pred, set_str in ((dev, "dev"), (test, "test")):
        for phase in ("P", "S"):
            sub = pred[pred["phase_label"] == phase]
            col = f"{phase.lower()}_sample_pred"
            if not len(sub):
                continue
            # predictions are region-relative; onsets are trace-absolute
            diff = (sub[col] + sub["start_sample"] - sub["phase_onset"]) / sub["sampling_rate"]
            diff = diff.to_numpy()
            stats[f"{set_str}_{phase}_mean_s"] = np.mean(diff)
            stats[f"{set_str}_{phase}_median_s"] = np.median(diff)
            stats[f"{set_str}_{phase}_rmse_s"] = np.sqrt(np.mean(diff**2))
            stats[f"{set_str}_{phase}_mae_s"] = np.mean(np.abs(diff))
            trimmed = diff[(diff > -1) & (diff < 1)]
            stats[f"{set_str}_{phase}_out_s"] = np.sum((diff > 1) | (diff < -1)) / len(diff)
            stats[f"{set_str}_{phase}_modified_rmse_s"] = (
                np.sqrt(np.mean(trimmed**2)) if len(trimmed) else np.nan
            )
            stats[f"{set_str}_{phase}_modified_mae_s"] = (
                np.mean(np.abs(trimmed)) if len(trimmed) else np.nan
            )
    return stats


def get_optimal_model(df: pd.DataFrame) -> Optional[int]:
    """Multi-metric model ranking (reference `eval_taks0.py:1297-1305`):
    normalize dev detection AUC, phase MCC, and inverse P/S residual stds to
    their column maxima and pick the row with the best mean."""
    cols = ["dev_det_auc", "dev_phase_mcc"]
    for phase in ("P", "S"):
        for cand in (f"dev_{phase}_std_s", f"dev_{phase}_rmse_s"):
            if cand in df.columns:
                cols.append(cand)
                break
    have = [c for c in cols if c in df.columns]
    if not have:
        return None
    x = df[have].to_numpy(dtype=float).copy()
    for i, c in enumerate(have):
        if c.endswith("_std_s") or c.endswith("_rmse_s"):
            x[:, i] = 1.0 / x[:, i]
    with np.errstate(invalid="ignore"):
        x /= np.nanmax(x, axis=0, keepdims=True)
        means = np.nanmean(x, axis=1)
    if np.isnan(means).all():
        return None
    return int(np.nanargmax(means))


def collect_task123_results(base_dir, experiments: Sequence[str]) -> pd.DataFrame:
    import pandas as pd

    rows = []
    for exp in experiments:
        d = Path(base_dir) / exp
        row = {"experiment": exp}
        row.update(parse_task1(d))
        row.update(parse_task23(d))
        rows.append(row)
    return pd.DataFrame(rows)
