"""The port's evaluation metrics against the JAX package and scikit-learn.

Fed identical pick lists, curves' residuals and metric tables, the port's
``count_TP_FP_FN`` and ``compute_residuals`` (both methods),
``_residual_stats``, ``bootstrap_f1``, ``opt_prob_metrics``,
``collect_task0_results`` and ``get_optimal_model`` give exactly the JAX
package's values. ``eval/_metrics.py`` (numpy, used where scikit-learn is
absent) matches scikit-learn's four calls within 1e-12, ties, a split with
one class only and a zero denominator included.
"""

import math

import numpy as np
import pandas as pd
import pytest
import sklearn.metrics as skm
from hypothesis import given, settings
from hypothesis import strategies as st

from volpick_tpu.eval import task0 as jt0
from volpick_tpu.eval import task123 as jt123
from volpick_tpu_torch.eval import _metrics
from volpick_tpu_torch.eval import task0 as pt0
from volpick_tpu_torch.eval import task123 as pt123

SK_TOL = 1e-12

picks = st.lists(st.floats(0, 3000, allow_nan=False).map(lambda v: round(v, 1)), max_size=4).map(np.array)
truth = st.lists(st.floats(0, 3000, allow_nan=False).map(lambda v: round(v, 1)), max_size=1).map(np.array)
windows = st.lists(st.tuples(truth, picks), min_size=1, max_size=12)


def _same(a, b):
    """Equal values, NaN equal to NaN and None to None, at any nesting."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    if a is None or b is None:
        return a is b
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@settings(max_examples=60, deadline=None, database=None)
@given(windows, st.sampled_from([0, 1]), st.sampled_from([0.5, 0.2]))
def test_counting_and_residuals_match_jax(ws, method, tp_thre):
    gt = [t for t, _ in ws]
    pred = [p for _, p in ws]
    got = pt0.count_TP_FP_FN(gt, pred, tp_thre=tp_thre, method=method)
    want = jt0.count_TP_FP_FN(gt, pred, tp_thre=tp_thre, method=method)
    assert _same(got, want)
    assert _same(pt0.compute_residuals(gt, pred, 100.0, method=method),
                 jt0.compute_residuals(gt, pred, 100.0, method=method))


def test_counting_golden_case():
    truth_ = [np.array([100.0]), np.array([]), np.array([500.0]), np.array([900.0])]
    pred_ = [np.array([120.0]), np.array([300.0]), np.array([]), np.array([820.0, 960.0])]
    TP, FP, FN, *_ = pt0.count_TP_FP_FN(truth_, pred_, tp_thre=0.5, sampling_rate=100)
    assert (TP, FP, FN) == (1, 3, 2)
    assert pt0.calculate_precision_recall_F1score(TP, FP, FN) == jt0.calculate_precision_recall_F1score(TP, FP, FN)


@pytest.mark.parametrize("residuals", [
    np.array([]), np.array([0.3]), np.array([2.0, -3.0]), np.array([0.25, -0.5, 1.5, -0.01, 0.0]),
    np.random.default_rng(3).normal(0, 0.8, 200),
], ids=["empty", "one", "all-outside", "mixed", "normal-200"])
def test_residual_stats_match_jax(residuals):
    assert _same(pt0._residual_stats(residuals, "p"), jt0._residual_stats(residuals, "p"))


def test_bootstrap_f1_matches_jax():
    rng = np.random.default_rng(0)
    gt, pred = [], []
    for _ in range(300):
        t = float(rng.uniform(100, 900))
        gt.append(np.array([t]) if rng.random() < 0.9 else np.array([]))
        pred.append(np.array([t + rng.normal(0, 30)]) if rng.random() < 0.8 else np.array([]))
    for method in (0, 1):
        kw = dict(n_boot=300, seed=4, method=method)
        assert pt0.bootstrap_f1(gt, pred, **kw) == jt0.bootstrap_f1(gt, pred, **kw)


def _metrics_table(rng, thresholds):
    cols = {"prob_thre": thresholds, "tp_thre": 0.5}
    for ph in ("p", "s"):
        for c in ("TP", "FP", "FN"):
            cols[f"{ph}_{c}"] = rng.integers(0, 50, len(thresholds)).astype(float)
        cols[f"{ph}_F1score"] = rng.random(len(thresholds))
        cols[f"{ph}_mean"] = rng.normal(size=len(thresholds))
    cols["s_F1score"][2] = np.nan  # a threshold with no S picks
    return pd.DataFrame(cols)


def test_opt_prob_metrics_and_collection_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    thr = np.arange(0.1, 0.95, 0.1)
    for exp in ("a", "b"):
        d = tmp_path / exp
        d.mkdir()
        _metrics_table(rng, thr).to_csv(d / "dev_metrics.csv", index=False)
        _metrics_table(rng, thr[::-1]).to_csv(d / "test_metrics.csv", index=False)
    assert _same(pt0.opt_prob_metrics(tmp_path / "a"), jt0.opt_prob_metrics(tmp_path / "a"))
    pd.testing.assert_frame_equal(pt0.collect_task0_results(tmp_path, ["a", "b", "missing"]),
                                  jt0.collect_task0_results(tmp_path, ["a", "b", "missing"]))


def test_get_optimal_model_matches_jax():
    df = pd.DataFrame({"dev_det_auc": [0.7, 0.9, np.nan], "dev_phase_mcc": [0.5, 0.4, 0.8],
                       "dev_P_rmse_s": [0.2, 0.3, 0.1], "dev_S_std_s": [0.4, np.nan, 0.5]})
    assert pt123.get_optimal_model(df) == jt123.get_optimal_model(df)
    assert pt123.get_optimal_model(pd.DataFrame({"x": [1]})) is None


def _score_cases():
    rng = np.random.default_rng(7)
    n = 200
    y = rng.random(n) < 0.4
    yield "continuous", y, rng.normal(size=n) + y
    yield "ties", y, np.round(rng.random(n) * 4) / 4
    yield "all-tied", y, np.full(n, 0.5)
    yield "one-class-true", np.ones(n, bool), rng.random(n)
    yield "one-class-false", np.zeros(n, bool), rng.random(n)
    yield "two", np.array([True, False]), np.array([0.3, 0.3])
    yield "huge", y, np.where(rng.random(n) < 0.1, 1e100, rng.random(n))


SCORE_CASES = list(_score_cases())


def _close(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return a.shape == b.shape and np.allclose(a, b, rtol=0, atol=SK_TOL, equal_nan=True)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name,y,score", SCORE_CASES, ids=[c[0] for c in SCORE_CASES])
def test_curves_and_auc_match_sklearn(name, y, score):
    for got, want in zip(_metrics.precision_recall_curve(y, score), skm.precision_recall_curve(y, score)):
        assert _close(got, want), name
    assert _close(_metrics.roc_auc_score(y, score), skm.roc_auc_score(y, score)), name


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name,y,score", SCORE_CASES, ids=[c[0] for c in SCORE_CASES])
def test_binary_scores_match_sklearn(name, y, score):
    for thr in (-np.inf, np.median(score), np.max(score)):  # all, about half, none predicted
        pred = score > thr
        got = _metrics.precision_recall_fscore_support(y, pred)
        want = skm.precision_recall_fscore_support(y, pred, average="binary", zero_division=0)
        assert got[3] is None and want[3] is None
        assert _close(got[:3], want[:3]), (name, thr)
        assert _close(_metrics.matthews_corrcoef(y, pred), skm.matthews_corrcoef(y, pred)), (name, thr)


def test_metrics_take_pandas_booleans():
    df = pd.DataFrame({"bin": [True, False, True, True], "s": [0.9, 0.1, 0.4, 0.4]})
    assert _close(_metrics.roc_auc_score(df["bin"], df["s"]), skm.roc_auc_score(df["bin"], df["s"]))
    assert _close(_metrics.matthews_corrcoef(df["bin"], df["s"] > 0.3),
                  skm.matthews_corrcoef(df["bin"], df["s"] > 0.3))


def test_nonfinite_scores_are_refused():
    with pytest.raises(ValueError):
        _metrics.precision_recall_curve([True, False], [np.inf, 0.0])
