"""Task-0 evaluation: threshold-sweep pick benchmark (reference
`volpick/model/eval_taks0.py`).

Port of ``volpick_tpu/eval/task0.py``. Per threshold in 0.1..0.9: steered
batched inference on the task0 windows → per-window pick extraction with
trigger_onset(prob, thr, thr/2) + in-trigger argmax → TP/FP/FN within ±0.5 s
→ precision/recall/F1 + the residual-statistics block per phase. Writes
{set}_metrics.csv (one row per threshold) and {set}_task0.csv (per-window
picks at each threshold), with the JAX package's columns and row order.

The model runs on `device` (the card unless ``device="cpu"``) under
``inference_work``: one host-to-device copy of raw trace buffers a batch,
framing and conditioning there (``pipeline.generator.steered_frames``), and
``evaluate_sweep`` extracts every threshold's picks there too (K1 for a CUDA
tensor), so that only the pick buffers come back. The port does not pad a
batch to a fixed size as the JAX package does to avoid recompiling: every
output row depends on its own row alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from volpick_tpu_torch.device import inference_work, resolve_device
from volpick_tpu_torch.ops.triggers import extract_picks_batched, extract_triggers_batched
from volpick_tpu_torch.pipeline.generator import (
    RawBatchSource,
    _onset_arrays,
    steered_frames,
    steered_window_offsets,
)

if TYPE_CHECKING:
    import pandas as pd

SAMPLING_RATE = 100.0


# ------------------------------------------------------------------- metrics
def count_TP_FP_FN(picks_truth, picks_predicted, tp_thre=0.5, sampling_rate=100, method=0):
    """±tp_thre-second matching (reference `eval_taks0.py:242-311`)."""
    tps = np.zeros(len(picks_predicted))
    fps = np.zeros(len(picks_predicted))
    fns = np.zeros(len(picks_predicted))
    for i in range(len(tps)):
        truth, pred = picks_truth[i], picks_predicted[i]
        if method == 0:
            if len(pred) == 0:
                fns[i] += len(truth)
            elif len(truth) == 0:
                fps[i] += len(pred)
            else:
                for t in truth:
                    if np.any(np.abs((pred - t) / sampling_rate) <= tp_thre):
                        tps[i] += 1
                    else:
                        fns[i] += 1
                for p in pred:
                    if np.all(np.abs((p - truth) / sampling_rate) > tp_thre):
                        fps[i] += 1
        else:  # method == 1: one pick per trace, ambiguous cases count as FP
            if len(pred) == 0:
                if len(truth) > 0:
                    fns[i] += 1
            elif len(truth) == 0:
                fps[i] += 1
            elif np.any(np.abs((pred - truth[0]) / sampling_rate) <= tp_thre):
                tps[i] += 1
            else:
                fps[i] += 1
    return np.sum(tps), np.sum(fps), np.sum(fns), tps, fps, fns


def calculate_precision_recall_F1score(TP, FP, FN):
    precision = TP / (TP + FP)
    recall = TP / (TP + FN)
    return precision, recall, 2.0 * precision * recall / (precision + recall)


def compute_residuals(picks_truth, picks_predicted, sampling_rate, method=0):
    residuals = []
    for i in range(len(picks_truth)):
        if len(picks_truth[i]) and len(picks_predicted[i]):
            if method == 0:
                for p in picks_predicted[i]:
                    res = p - picks_truth[i]
                    residuals.append(res[np.argmin(np.abs(res))] / sampling_rate)
            else:
                res = picks_predicted[i] - picks_truth[i][0]
                residuals.append(res[np.argmin(np.abs(res))] / sampling_rate)
    return np.array(residuals)


def _residual_stats(residuals: np.ndarray, prefix: str) -> Dict:
    """The 18 per-phase residual statistics columns of {set}_metrics.csv."""
    cols = [
        "mean", "median", "std", "MAE", "MAD", "out",
        "modified_mean", "modified_median", "modified_std", "modified_RMSE",
        "modified_MAE", "modified_MAD",
        "modified_mean2", "modified_median2", "modified_std2", "modified_RMSE2",
        "modified_MAE2", "modified_MAD2",
    ]
    if len(residuals) == 0:
        return {f"{prefix}_{c}": None for c in cols}
    r = residuals
    clip = np.clip(r, -1, 1)
    trim = r[(r > -1) & (r < 1)]
    out = {
        f"{prefix}_mean": np.mean(r),
        f"{prefix}_median": np.median(r),
        f"{prefix}_std": np.std(r, ddof=1),
        f"{prefix}_MAE": np.mean(np.abs(r)),
        f"{prefix}_MAD": np.median(np.abs(r - np.median(r))),
        f"{prefix}_out": np.sum((r < -1) | (r > 1)) / r.size,
        f"{prefix}_modified_mean": np.mean(clip),
        f"{prefix}_modified_median": np.median(clip),
        f"{prefix}_modified_std": np.std(clip, ddof=1),
        f"{prefix}_modified_RMSE": np.sqrt(np.mean(clip**2)),
        f"{prefix}_modified_MAE": np.mean(np.abs(clip)),
        f"{prefix}_modified_MAD": np.median(np.abs(clip - np.median(clip))),
    }
    if len(trim):
        out.update(
            {
                f"{prefix}_modified_mean2": np.mean(trim),
                f"{prefix}_modified_median2": np.median(trim),
                f"{prefix}_modified_std2": np.std(trim, ddof=1) if len(trim) > 1 else 0.0,
                f"{prefix}_modified_RMSE2": np.sqrt(np.mean(trim**2)),
                f"{prefix}_modified_MAE2": np.mean(np.abs(trim)),
                f"{prefix}_modified_MAD2": np.median(np.abs(trim - np.median(trim))),
            }
        )
    else:
        out.update({f"{prefix}_modified_{c}2": None for c in ("mean", "median", "std", "RMSE", "MAE", "MAD")})
    return out


# ----------------------------------------------------------------- inference
def _model_out(model, frames: torch.Tensor) -> torch.Tensor:
    """(B, K, window) float32 probabilities; the EQT family returns one
    (B, window) tensor per head."""
    out = model(frames)
    return (torch.stack(out, dim=1) if isinstance(out, tuple) else out).float()


def _target_arrays(targets: pd.DataFrame):
    return (targets["trace_idx"].to_numpy(), targets["start_sample"].to_numpy(),
            targets["end_sample"].to_numpy())


def trace_source(dataset, source: Optional[RawBatchSource] = None) -> RawBatchSource:
    """The raw trace buffers that the steered batches read: `source` when the
    caller already holds one for `dataset`, else a new one. Building it copies
    the whole trace pool, so an entry point builds it once and passes it on."""
    return RawBatchSource(dataset) if source is None else source


def _steered_batches(model, src: RawBatchSource, targets: pd.DataFrame, batch_size: int,
                     device: torch.device):
    """(frames (B, C, window) on `device`, borders (B, 2) host) for each
    batch of `targets`, framed at ``model.in_samples`` and normalised by
    ``model.norm``: one copy of the raw buffers a batch to the device,
    framing and conditioning there. Every model is demeaned, EQT included:
    the reference's eval augmentations demean for all models
    (`models.py:849-856`); detrend is in EQT's training block only (`:663`)."""
    window = model.in_samples
    idxs, ss, es = _target_arrays(targets)
    for lo in range(0, len(targets), batch_size):
        hi = min(lo + batch_size, len(targets))
        batch = src.take(idxs[lo:hi])
        w0, borders = steered_window_offsets(batch["len"], ss[lo:hi], es[lo:hi], window)
        x = torch.as_tensor(batch["x"]).to(device)
        yield steered_frames(x, torch.as_tensor(w0).to(device), window, norm=model.norm), borders


def _region(borders: torch.Tensor, window: int) -> torch.Tensor:
    t = torch.arange(window, device=borders.device)[None, :]
    return (t >= borders[:, :1]) & (t < borders[:, 1:2])


class _SteeredRunner:
    """Batched steered inference returning the P/S probability windows.

    `model` is moved to `device` (the card unless ``device="cpu"``) and put
    in eval mode; framing, conditioning and the forward run there a batch at
    a time (replaces the reference's CPU SteeredWindow/Normalize DataLoader
    path, `volpick/model/eval_taks0.py:458-469`)."""

    def __init__(self, model, batch_size: int = 256, device=None, source: Optional[RawBatchSource] = None):
        self.device = resolve_device(device, "_SteeredRunner")
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self._source = source

    def _get_source(self, dataset) -> RawBatchSource:
        self._source = trace_source(dataset, self._source)
        return self._source

    def prob_curves(self, dataset, targets: pd.DataFrame) -> Tuple[np.ndarray, np.ndarray]:
        """((N, K, window) probability curves, (N, 2) borders) for all target
        windows, on the host."""
        outs, borders_all = [], []
        with inference_work(self.device):
            for frames, borders in _steered_batches(
                    self.model, self._get_source(dataset), targets, self.batch_size, self.device):
                outs.append(_model_out(self.model, frames).cpu().numpy())
                borders_all.append(borders)
        return np.concatenate(outs), np.concatenate(borders_all)


def _phase_channels(model) -> Dict[str, int]:
    if model.name == "VolEQTransformer":
        return {"P": 2, "S": 3}  # (rg_det, lp_det, P, S)
    if model.name == "EQTransformer":
        return {"P": 1, "S": 2}
    return {"P": model.phases.index("P"), "S": model.phases.index("S")}


def evaluate(
    model,
    dataset,
    targets: pd.DataFrame,
    prob_threshold: float,
    batch_size: int = 256,
    curves: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device=None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-window P/S pick lists (absolute sample indices in the trace) at
    one threshold. `curves` = (preds, borders) from
    ``_SteeredRunner.prob_curves`` skips the forward; the extraction runs on
    `device` a batch at a time."""
    device = resolve_device(device, "evaluate")
    if curves is None:
        runner = _SteeredRunner(model, batch_size=batch_size, device=device)
        preds, borders = runner.prob_curves(dataset, targets)
    else:
        preds, borders = curves
    chans = _phase_channels(model)
    starts = targets["start_sample"].to_numpy()
    results = {}
    window = preds.shape[-1]
    t = np.arange(window)[None, :]
    region = (t >= borders[:, :1]) & (t < borders[:, 1:2])
    for phase, ki in chans.items():
        prob = preds[:, ki] * region  # restrict to the steered region
        # max_picks=64 covers even very jittery low-threshold curves
        idx_parts, valid_parts = [], []
        with inference_work(device):
            for lo in range(0, len(prob), batch_size):
                i_c, _, v_c = extract_picks_batched(
                    torch.as_tensor(prob[lo : lo + batch_size]).to(device), prob_threshold, max_picks=64)
                idx_parts.append(i_c.cpu().numpy())
                valid_parts.append(v_c.cpu().numpy())
        idx = np.concatenate(idx_parts)
        valid = np.concatenate(valid_parts)
        picks = []
        for i in range(len(targets)):
            # window position → absolute trace sample: the window starts at
            # start_sample - border_lo
            picks.append(idx[i][valid[i]] + (starts[i] - borders[i, 0]))
        results[phase] = picks
    return results["P"], results["S"]


def _sweep_batch(model, frames: torch.Tensor, borders: np.ndarray, kis: Sequence[int], thr: torch.Tensor,
                 max_picks: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The device half of a sweep batch: forward → region mask → each
    phase's (B, window) rows tiled over the thresholds, [thr0·B, thr1·B,
    ...] with per-row float32 thresholds → one trigger extraction of
    (n_thr·B, window) rows a phase. Returns (idx, valid), each (n_thr, B,
    max_picks) on the device, for each channel of `kis`."""
    b, window = frames.shape[0], frames.shape[-1]
    preds = _model_out(model, frames)
    region = _region(torch.as_tensor(borders).to(frames.device), window)
    thr_rows = thr.repeat_interleave(b)
    out = []
    for ki in kis:
        flat = (preds[:, ki] * region).repeat(len(thr), 1)
        idx, _, valid, _, _ = extract_triggers_batched(flat, thr_rows, max_picks=max_picks)
        out.append((idx.reshape(len(thr), b, max_picks), valid.reshape(len(thr), b, max_picks)))
    return out


def evaluate_sweep(
    model,
    dataset,
    targets: pd.DataFrame,
    prob_thresholds: Sequence[float],
    batch_size: int = 256,
    max_picks: int = 64,
    device=None,
    source: Optional[RawBatchSource] = None,
) -> List[Tuple[List[np.ndarray], List[np.ndarray]]]:
    """All thresholds' P/S pick lists in one device pass a batch
    (``_sweep_batch``): only the (n_thr, B, max_picks) pick buffers leave the
    device; the curves stay there. `source` is the dataset's
    ``trace_source``, when the caller holds one.

    Returns a list of (p_picks, s_picks) pairs aligned with
    `prob_thresholds`, the pick lists ``evaluate`` gives at each threshold."""
    device = resolve_device(device, "evaluate_sweep")
    model = model.to(device).eval()
    kis = tuple(_phase_channels(model).values())
    thr = torch.as_tensor(np.asarray(list(prob_thresholds), dtype=np.float32)).to(device)
    _, ss, _ = _target_arrays(targets)
    n = len(targets)
    parts = {ki: ([], []) for ki in kis}
    border_lo = [np.zeros(0, np.int64)]
    with inference_work(device):
        for frames, borders in _steered_batches(model, trace_source(dataset, source), targets, batch_size,
                                                device):
            border_lo.append(borders[:, 0])
            for ki, (idx, valid) in zip(kis, _sweep_batch(model, frames, borders, kis, thr, max_picks)):
                parts[ki][0].append(idx.cpu().numpy())
                parts[ki][1].append(valid.cpu().numpy())
    border_lo = np.concatenate(border_lo)
    out = []
    for ti in range(len(thr)):
        phase_lists = []
        for ki in kis:
            idx = np.concatenate([p[ti] for p in parts[ki][0]], axis=0)
            valid = np.concatenate([p[ti] for p in parts[ki][1]], axis=0)
            phase_lists.append([idx[i][valid[i]] + (ss[i] - border_lo[i]) for i in range(n)])
        out.append(tuple(phase_lists))
    return out


def get_ground_truth(dataset, targets: pd.DataFrame):
    """Per-window P/S ground-truth picks (reference `eval_taks0.py:203-239`)."""
    p_all, s_all = _onset_arrays(dataset.metadata, target_rate=dataset.sampling_rate)
    p_gt, s_gt = [], []
    for _, row in targets.iterrows():
        i = int(row["trace_idx"])
        s0, s1 = row["start_sample"], row["end_sample"]
        pt, st = p_all[i], s_all[i]
        p_gt.append(np.array([pt]) if (not np.isnan(pt) and s0 <= pt < s1) else np.array([]))
        s_gt.append(np.array([st]) if (not np.isnan(st) and s0 <= st < s1) else np.array([]))
    return p_gt, s_gt


# --------------------------------------------------------------- entry points
def _set_targets(task_targets_all: pd.DataFrame, set_name: str, num_test_run: Optional[int]) -> pd.DataFrame:
    targets = task_targets_all[task_targets_all["trace_split"] == set_name].reset_index(drop=True)
    if num_test_run:
        targets = targets.sample(min(num_test_run, len(targets)), random_state=42).reset_index(drop=True)
    return targets


def eval_task0(
    model,
    dataset,
    targets_path,
    output_dir,
    sets: Sequence[str] = ("dev", "test"),
    prob_thresholds: Sequence[float] = tuple(np.arange(0.1, 0.95, 0.1)),
    batch_size: int = 256,
    num_test_run: Optional[int] = None,
    count_tp_method: int = 0,
    no_p: bool = False,
    no_s: bool = False,
    curve_chunk: int = 8192,
    device=None,
):
    """Threshold sweep; writes {set}_metrics.csv + {set}_task0.csv rows.

    `curve_chunk` bounds what one ``evaluate_sweep`` call takes; pick lists
    accumulate across chunks, so the metrics are those of an unchunked
    pass."""
    import pandas as pd

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    task_targets_all = pd.read_csv(Path(targets_path) / "task0.csv")
    src = trace_source(dataset)
    results = {}
    for set_name in sets:
        targets = _set_targets(task_targets_all, set_name, num_test_run)
        if not len(targets):
            continue
        p_gt, s_gt = [], []
        p_pred_all = {thr: [] for thr in prob_thresholds}
        s_pred_all = {thr: [] for thr in prob_thresholds}
        pick_rows = []
        for c_lo in range(0, len(targets), curve_chunk):
            chunk = targets.iloc[c_lo : c_lo + curve_chunk].reset_index(drop=True)
            sweep = evaluate_sweep(model, dataset, chunk, prob_thresholds, batch_size, device=device, source=src)
            gp, gs = get_ground_truth(dataset, chunk)
            p_gt.extend(gp)
            s_gt.extend(gs)
            for thr, (p_pred, s_pred) in zip(prob_thresholds, sweep):
                p_pred_all[thr].extend(p_pred)
                s_pred_all[thr].extend(s_pred)
                for i in range(len(chunk)):
                    pick_rows.append(
                        {
                            "trace_name": chunk.iloc[i]["trace_name"],
                            "trace_idx": chunk.iloc[i]["trace_idx"],
                            "prob_threshold": thr,
                            # plain python floats: numpy-2 scalar reprs
                            # ("np.float64(x)") are not literal_eval-able
                            "p_picks": [float(x) for x in np.asarray(p_pred[i])],
                            "s_picks": [float(x) for x in np.asarray(s_pred[i])],
                        }
                    )
        rows = []
        for thr in prob_thresholds:
            # the reference's {set}_metrics.csv schema (`eval_taks0.py:780-783`)
            row = {"prob_thre": thr, "tp_thre": 0.5}
            for phase, gt, pred, skip in (
                ("p", p_gt, p_pred_all[thr], no_p),
                ("s", s_gt, s_pred_all[thr], no_s),
            ):
                if skip:
                    continue
                TP, FP, FN, *_ = count_TP_FP_FN(gt, pred, method=count_tp_method)
                if TP + FP > 0 and TP + FN > 0 and TP > 0:
                    prec, rec, f1 = calculate_precision_recall_F1score(TP, FP, FN)
                else:
                    prec = rec = f1 = 0.0
                row.update(
                    {
                        f"{phase}_TP": TP,
                        f"{phase}_FP": FP,
                        f"{phase}_FN": FN,
                        f"{phase}_precision": prec,
                        f"{phase}_recall": rec,
                        f"{phase}_F1score": f1,
                    }
                )
                res = compute_residuals(gt, pred, SAMPLING_RATE, method=count_tp_method)
                row.update(_residual_stats(res, phase))
            rows.append(row)
        # pick rows grouped per threshold for byte-stable CSV ordering
        pick_rows.sort(key=lambda r: r["prob_threshold"])
        metrics = pd.DataFrame(rows)
        metrics.to_csv(output_dir / f"{set_name}_metrics.csv", index=False)
        pd.DataFrame(pick_rows).to_csv(output_dir / f"{set_name}_task0.csv", index=False)
        results[set_name] = metrics
    return results


def eval_task0_true_negative_rate(
    model,
    dataset,
    targets_path,
    output_dir,
    sets: Sequence[str] = ("dev", "test"),
    prob_thresholds: Sequence[float] = tuple(np.arange(0.1, 1.0, 0.1)),
    batch_size: int = 256,
    num_test_run: Optional[int] = None,
    device=None,
):
    """Per-threshold true-negative rate on noise windows: TN = windows with
    neither a true nor a predicted pick, FP = pickless windows with a
    prediction (reference `eval_taks0.py:828-980`). Writes {set}_tnr.csv."""
    import pandas as pd

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    task_targets_all = pd.read_csv(Path(targets_path) / "task0.csv")
    src = trace_source(dataset)
    results = {}
    for set_name in sets:
        targets = _set_targets(task_targets_all, set_name, num_test_run)
        if not len(targets):
            continue
        runner = _SteeredRunner(model, batch_size=batch_size, device=device, source=src)
        curves = runner.prob_curves(dataset, targets)
        p_gt, s_gt = get_ground_truth(dataset, targets)
        rows = []
        for thr in prob_thresholds:
            p_pred, s_pred = evaluate(model, dataset, targets, thr, curves=curves, device=device)
            row = {"prob_thre": thr}
            for phase, gt, pred in (("p", p_gt, p_pred), ("s", s_gt, s_pred)):
                tn = sum(1 for t, p in zip(gt, pred) if len(t) == 0 and len(p) == 0)
                fp = sum(1 for t, p in zip(gt, pred) if len(t) == 0 and len(p) > 0)
                row[f"{phase}_TN"] = tn
                row[f"{phase}_FP"] = fp
                row[f"{phase}_true_negative_rate"] = tn / (tn + fp) if tn + fp else np.nan
            rows.append(row)
        df = pd.DataFrame(rows)
        df.to_csv(output_dir / f"{set_name}_tnr.csv", index=False)
        results[set_name] = df
    return results


def bootstrap_f1(picks_truth, picks_predicted, n_boot: int = 2000, seed: int = 0,
                 tp_thre: float = 0.5, method: int = 0, ci: float = 0.95) -> Dict:
    """Nonparametric bootstrap CI on task0 F1: resample windows with
    replacement from the per-window TP/FP/FN contributions and recompute F1
    (the reference reports point F1s only, `eval_taks0.py:314-323`).
    Returns {"f1", "lo", "hi", "n"}."""
    _, _, _, tps, fps, fns = count_TP_FP_FN(
        picks_truth, picks_predicted, tp_thre=tp_thre, method=method
    )
    n = len(tps)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_boot, n))
    tp_b = tps[idx].sum(axis=1)
    fp_b = fps[idx].sum(axis=1)
    fn_b = fns[idx].sum(axis=1)
    f1_b = 2.0 * tp_b / np.maximum(2.0 * tp_b + fp_b + fn_b, 1.0)
    tp, fp, fn = tps.sum(), fps.sum(), fns.sum()
    point = 2.0 * tp / max(2.0 * tp + fp + fn, 1.0)
    alpha = (1.0 - ci) / 2.0
    return {
        "f1": float(point),
        "lo": float(np.quantile(f1_b, alpha)),
        "hi": float(np.quantile(f1_b, 1.0 - alpha)),
        "n": int(n),
    }


def bootstrap_f1_from_artifacts(output_dir, dataset, targets_path, set_name: str,
                                phase: str, threshold: float, **kw) -> Dict:
    """bootstrap_f1 recomputed from a finished eval_task0 run's artifacts:
    ground truth from the dataset + task0 targets, predictions from
    `{set}_task0.csv` at the given threshold."""
    import pandas as pd

    import ast
    import re

    output_dir = Path(output_dir)
    targets = pd.read_csv(Path(targets_path) / "task0.csv")
    targets = targets[targets["trace_split"] == set_name].reset_index(drop=True)
    p_gt, s_gt = get_ground_truth(dataset, targets)
    gt = p_gt if phase == "p" else s_gt
    picks = pd.read_csv(output_dir / f"{set_name}_task0.csv")
    picks = picks[np.isclose(picks["prob_threshold"], threshold)]
    # rows are "[x, y]" (current writer) or "[np.float64(x)]" (numpy-2 scalar
    # reprs of older artifacts): drop the latter's wrappers, then literal_eval
    clean = re.compile(r"np\.\w+")
    by_name = {
        (r["trace_name"], int(r["trace_idx"])): np.asarray(
            ast.literal_eval(clean.sub("", str(r[f"{phase}_picks"]))), dtype=float
        )
        for _, r in picks.iterrows()
    }
    pred = [
        by_name.get((row["trace_name"], int(row["trace_idx"])), np.array([]))
        for _, row in targets.iterrows()
    ]
    return bootstrap_f1(gt, pred, **kw)


def opt_prob_metrics(output_dir, phases=("p", "s")) -> Dict:
    """Dev-F1-optimal threshold per phase applied to the test sweep
    (reference `eval_taks0.py:1139-1294`)."""
    import pandas as pd

    output_dir = Path(output_dir)
    dev = pd.read_csv(output_dir / "dev_metrics.csv")
    test = pd.read_csv(output_dir / "test_metrics.csv")
    out = {}
    for phase in phases:
        col = f"{phase}_F1score"
        if col not in dev.columns:
            continue
        i = int(dev[col].fillna(-1).idxmax())
        thr = float(dev.iloc[i]["prob_thre"])
        out[f"{phase}_threshold"] = thr
        j = int(np.argmin(np.abs(test["prob_thre"].to_numpy() - thr)))
        for c in test.columns:
            if c.startswith(f"{phase}_"):
                out[f"test_{c}"] = test.iloc[j][c]
        out[f"dev_{phase}_F1score"] = dev.iloc[i][col]
    return out


def collect_task0_results(base_dir, experiments: Sequence[str]) -> pd.DataFrame:
    """Aggregate opt_prob_metrics across experiment output dirs."""
    import pandas as pd

    rows = []
    for exp in experiments:
        d = Path(base_dir) / exp
        if not (d / "dev_metrics.csv").exists():
            continue
        row = {"experiment": exp}
        row.update(opt_prob_metrics(d))
        rows.append(row)
    return pd.DataFrame(rows)
