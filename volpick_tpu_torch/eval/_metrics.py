"""The four scikit-learn metrics that task-1/2/3 parsing calls, in numpy.

The JAX package's ``eval/task123.py`` imports them from ``sklearn.metrics``;
the port computes them here, so that the evaluation runs where scikit-learn
is not installed. Each follows scikit-learn 1.9's arithmetic for a binary
0/1 (or boolean) target without sample weights, ties included:

- ``precision_recall_curve(y_true, y_score)``;
- ``roc_auc_score(y_true, y_score)`` (NaN when one class is absent, where
  scikit-learn warns and returns NaN);
- ``precision_recall_fscore_support(y_true, y_pred)`` with
  ``average="binary"`` and ``zero_division=0``;
- ``matthews_corrcoef(y_true, y_pred)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _binary(y) -> np.ndarray:
    return np.asarray(y).astype(bool)


def _counts_at_thresholds(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds): positives and negatives scored >= each
    distinct score, the scores in decreasing order."""
    y = _binary(y_true).astype(np.float64)
    score = np.asarray(y_score)
    if not np.all(np.isfinite(score)):
        raise ValueError("y_score contains NaN or infinity")
    order = np.argsort(-score, kind="stable")
    score, y = score[order], y[order]
    # the last index of each run of equal scores, and the end
    ends = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[ends]
    fps = 1 + ends.astype(np.float64) - tps
    return fps, tps, score[ends]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), thresholds increasing; precision
    ends in 1 and recall in 0."""
    fps, tps, thresholds = _counts_at_thresholds(y_true, y_score)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, tps / ps, 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1]


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve (trapezoids over the points where the
    curve changes direction, as ``roc_curve(drop_intermediate=True)``)."""
    if np.unique(_binary(y_true)).size != 2:
        return float("nan")
    fps, tps, _ = _counts_at_thresholds(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.trapezoid(tpr, fpr))


def precision_recall_fscore_support(y_true, y_pred):
    """(precision, recall, F1, None) of the positive class; a zero
    denominator gives 0."""
    t, p = _binary(y_true), _binary(y_pred)
    tp, pred, true = float(np.sum(t & p)), float(np.sum(p)), float(np.sum(t))

    def divide(num, den):
        return num / den if den != 0 else 0.0

    return divide(tp, pred), divide(tp, true), divide(2.0 * tp, true + pred), None


def matthews_corrcoef(y_true, y_pred) -> float:
    t, p = _binary(y_true), _binary(y_pred)
    c = np.array([[np.sum(~t & ~p), np.sum(~t & p)], [np.sum(t & ~p), np.sum(t & p)]], dtype=np.float64)
    t_sum, p_sum = c.sum(axis=1), c.sum(axis=0)
    n_correct, n = np.trace(c), p_sum.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n**2 - np.dot(p_sum, p_sum)
    cov_ytyt = n**2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp * cov_ytyt))
