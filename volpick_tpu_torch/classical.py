"""Classical phase pickers: Baer-Kradolfer and AR-AIC.

The reference uses obspy's implementations as sanity baselines, tuned by
Bayesian optimization (reference `model_training/tune_pk_baer.py:51-56,197-201`
uses `bayes_opt.BayesianOptimization` — a GP surrogate with an acquisition
function over the parameter bounds). These are clean-room implementations of
the published algorithms (Baer & Kradolfer 1987; Akazawa 2004-style AR-AIC),
vectorized in numpy, plus `gp_maximize` — a self-contained GP/expected-
improvement optimizer filling the `BayesianOptimization`/`gp_minimize` role
(no scikit-optimize in this environment) — driving `tune_picker`.

A copy of ``volpick_tpu/classical.py`` (numpy and scipy on the host).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _characteristic_function(y: np.ndarray, sr: float) -> np.ndarray:
    """Baer-Kradolfer envelope CF: e(i) = y² + ẏ²·(Σy²/Σẏ²), fourth-powered
    and standardized by running statistics."""
    y = np.asarray(y, dtype=np.float64)
    y = y - y.mean()
    dy = np.diff(y, prepend=y[0]) * sr
    cum_y2 = np.cumsum(y**2) + 1e-30
    cum_dy2 = np.cumsum(dy**2) + 1e-30
    e = y**2 + dy**2 * (cum_y2 / cum_dy2)
    return e**2


def baer_kradolfer_pick(
    y: np.ndarray,
    sampling_rate: float,
    tdownmax: float = 0.2,
    tupevent: float = 0.6,
    thr1: float = 10.0,
    thr2: float = 20.0,
    preset_len: float = 1.0,
    p_dur: float = 1.0,
) -> Tuple[Optional[int], str]:
    """Single-trace P onset (sample index) + quality flag ('P'/'noise').

    CF statistics (mean/std) accumulate only while the detector is idle;
    a trigger opens when CF exceeds thr1 standard deviations, may close if it
    drops below within tdownmax seconds, and is confirmed once the cumulative
    time above threshold within the first p_dur seconds exceeds tupevent.
    """
    n = len(y)
    sr = sampling_rate
    cf = _characteristic_function(y, sr)
    preset = max(int(preset_len * sr), 2)
    if n <= preset + 2:
        return None, "noise"

    mean = float(np.mean(cf[:preset]))
    var = float(np.var(cf[:preset])) + 1e-30

    itdown = int(tdownmax * sr)
    pick = None
    trigger_open = False
    time_up = 0
    time_down = 0
    candidate = None
    for i in range(preset, n):
        z = (cf[i] - mean) / np.sqrt(var)
        if not trigger_open:
            if z > thr1:
                trigger_open = True
                candidate = i
                time_up = 1
                time_down = 0
            else:
                # update running stats only while idle
                mean += (cf[i] - mean) / (i + 1)
                var += ((cf[i] - mean) ** 2 - var) / (i + 1)
        else:
            if z > thr1:
                time_up += 1
                time_down = 0
            else:
                time_down += 1
                if time_down > itdown and time_up < int(tupevent * sr):
                    trigger_open = False
                    candidate = None
                    time_up = 0
                    time_down = 0
                    continue
            if time_up >= int(tupevent * sr):
                pick = candidate
                break
        if candidate is not None and (i - candidate) > int(p_dur * sr) and pick is None:
            if time_up >= int(tupevent * sr) // 2:
                pick = candidate
            break
    if pick is None:
        return None, "noise"
    quality = "P" if (cf[pick : pick + int(tupevent * sr)] > mean + thr2 * np.sqrt(var)).any() else "p"
    return int(pick), quality


def aic_onset(y: np.ndarray) -> int:
    """AIC onset on a window known to contain one arrival:
    AIC(k) = k·log(var(y[:k])) + (N−k−1)·log(var(y[k:])); onset = argmin."""
    y = np.asarray(y, dtype=np.float64)
    n = len(y)
    if n < 8:
        return 0
    # cumulative second moments for O(n) variances
    c1 = np.cumsum(y)
    c2 = np.cumsum(y**2)
    k = np.arange(1, n - 1)
    var_l = c2[k - 1] / k - (c1[k - 1] / k) ** 2
    nr = n - k
    var_r = (c2[-1] - c2[k - 1]) / nr - ((c1[-1] - c1[k - 1]) / nr) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        aic = k * np.log(np.maximum(var_l, 1e-30)) + (n - k - 1) * np.log(
            np.maximum(var_r, 1e-30)
        )
    return int(np.argmin(aic)) + 1


def ar_aic_pick(
    z: np.ndarray,
    n: Optional[np.ndarray] = None,
    e: Optional[np.ndarray] = None,
    sampling_rate: float = 100.0,
    f1: float = 1.0,
    f2: float = 20.0,
    lta_p: float = 1.0,
    sta_p: float = 0.1,
    lta_s: float = 4.0,
    sta_s: float = 1.0,
) -> Tuple[Optional[int], Optional[int]]:
    """AR-AIC P (vertical) and S (horizontals) picks → sample indices.

    1. bandpass f1-f2;
    2. STA/LTA localizes the arrival region;
    3. AIC minimization inside the region refines the onset.
    """
    from scipy.signal import butter, sosfilt

    sr = sampling_rate
    sos = butter(4, [f1, min(f2, sr / 2 * 0.95)], btype="bandpass", fs=sr, output="sos")

    def sta_lta(x, sta_w, lta_w):
        x2 = x**2
        c = np.cumsum(x2)
        sta_n = max(int(sta_w * sr), 1)
        lta_n = max(int(lta_w * sr), sta_n + 1)
        sta = (c - np.concatenate([np.zeros(sta_n), c[:-sta_n]])) / sta_n
        lta = (c - np.concatenate([np.zeros(lta_n), c[:-lta_n]])) / lta_n
        ratio = np.zeros_like(x)
        ratio[lta_n:] = sta[lta_n:] / np.maximum(lta[lta_n:], 1e-30)
        return ratio

    def refine(x, sta_w, lta_w):
        xf = sosfilt(sos, x - x.mean())
        r = sta_lta(xf, sta_w, lta_w)
        if r.max() < 1.5:
            return None
        peak = int(np.argmax(r))
        lo = max(peak - int(2.0 * sr), 0)
        hi = min(peak + int(1.0 * sr), len(x))
        if hi - lo < 8:
            return None
        return lo + aic_onset(xf[lo:hi])

    p_pick = refine(np.asarray(z, np.float64), sta_p, lta_p)
    s_pick = None
    if n is not None and e is not None:
        h = np.asarray(n, np.float64) ** 2 + np.asarray(e, np.float64) ** 2
        h = np.sqrt(h)
        s_pick = refine(h, sta_s, lta_s)
        # S must come after P when both exist
        if p_pick is not None and s_pick is not None and s_pick <= p_pick:
            xf = sosfilt(sos, h - h.mean())
            lo = p_pick + int(0.3 * sampling_rate)
            if len(xf) - lo > 8:
                s_pick = lo + aic_onset(xf[lo:])
            else:
                s_pick = None
    return p_pick, s_pick


def _matern52(r2: np.ndarray) -> np.ndarray:
    """Matérn 5/2 kernel on squared distances (skopt's gp_minimize default)."""
    r = np.sqrt(np.maximum(r2, 0.0))
    sr = np.sqrt(5.0) * r
    return (1.0 + sr + 5.0 * r2 / 3.0) * np.exp(-sr)


def _gp_posterior(X: np.ndarray, y: np.ndarray, Xq: np.ndarray, length_scale: float, noise: float):
    """GP regression posterior mean/std at Xq. X/Xq in the unit cube,
    y standardized by the caller. O(n³) in trials — fine for n ≲ 200."""
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1) / length_scale**2
    K = _matern52(d2) + noise * np.eye(len(X))
    d2q = ((Xq[:, None, :] - X[None, :, :]) ** 2).sum(-1) / length_scale**2
    Kq = _matern52(d2q)
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    mu = Kq @ alpha
    v = np.linalg.solve(L, Kq.T)
    var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
    return mu, np.sqrt(var)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    from scipy.special import erf

    return 0.5 * (1.0 + erf(z / np.sqrt(2.0)))


def gp_maximize(
    fn,
    bounds: Dict[str, Tuple[float, float]],
    n_trials: int = 50,
    n_init: Optional[int] = None,
    seed: int = 0,
    length_scale: float = 0.25,
    noise: float = 1e-4,
    n_candidates: int = 2048,
) -> Dict:
    """Maximize `fn(**params)` under box bounds with a GP surrogate +
    expected-improvement acquisition — the role `bayes_opt.BayesianOptimization`
    plays in the reference tuner (`model_training/tune_pk_baer.py:51,197-201`).

    n_init quasi-random probes seed the GP; each subsequent trial evaluates
    the EI-argmax over `n_candidates` uniform draws plus local perturbations
    of the incumbent. Returns {"target", "params", "history"}.
    """
    rng = np.random.default_rng(seed)
    names = list(bounds)
    lo = np.array([bounds[k][0] for k in names], float)
    hi = np.array([bounds[k][1] for k in names], float)
    ndim = len(names)
    if n_init is None:
        n_init = max(2 * ndim, min(10, n_trials // 3))
    n_init = min(n_init, n_trials)

    X: list = []  # unit-cube coordinates
    y: list = []

    def evaluate(u: np.ndarray) -> float:
        params = {k: float(v) for k, v in zip(names, lo + u * (hi - lo))}
        t = float(fn(**params))
        X.append(u)
        y.append(t)
        return t

    # stratified (latin-hypercube) initialization
    strata = (rng.permuted(np.tile(np.arange(n_init), (ndim, 1)), axis=1).T + rng.random((n_init, ndim))) / n_init
    for u in strata:
        evaluate(u)

    for _ in range(n_trials - n_init):
        Xa = np.asarray(X)
        ya = np.asarray(y)
        mu0, sd0 = float(ya.mean()), float(ya.std()) + 1e-12
        ystd = (ya - mu0) / sd0
        best = ystd.max()
        cand = rng.random((n_candidates, ndim))
        # local refinement around the incumbent at three radii
        inc = Xa[int(np.argmax(ya))]
        for radius in (0.02, 0.05, 0.15):
            local = np.clip(inc + rng.normal(0, radius, (n_candidates // 8, ndim)), 0, 1)
            cand = np.concatenate([cand, local])
        mu, sd = _gp_posterior(Xa, ystd, cand, length_scale, noise)
        z = (mu - best) / sd
        ei = sd * (z * _norm_cdf(z) + np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi))
        evaluate(cand[int(np.argmax(ei))])

    ya = np.asarray(y)
    k = int(np.argmax(ya))
    return {
        "target": float(ya[k]),
        "params": {n: float(v) for n, v in zip(names, lo + np.asarray(X)[k] * (hi - lo))},
        "history": [float(v) for v in ya],
    }


def _pick_f1(pick_fn, params, traces, true_onsets, sampling_rate, tolerance) -> float:
    tp = fp = fn = 0
    for tr, onset in zip(traces, true_onsets):
        res = pick_fn(tr, sampling_rate, **params)
        pick = res[0] if isinstance(res, tuple) else res
        if pick is None:
            if not np.isnan(onset):
                fn += 1
        elif np.isnan(onset):
            fp += 1
        elif abs(pick - onset) / sampling_rate <= tolerance:
            tp += 1
        else:
            fp += 1
            fn += 1
    return 2 * tp / max(2 * tp + fp + fn, 1)


def tune_picker(
    pick_fn,
    param_space: Dict[str, Tuple[float, float]],
    traces: Sequence[np.ndarray],
    true_onsets: Sequence[float],
    sampling_rate: float = 100.0,
    n_trials: int = 50,
    tolerance: float = 0.5,
    seed: int = 0,
    method: str = "gp",
) -> Dict:
    """Tune a picker's parameters to maximize F1 of |pick − truth| ≤ tolerance
    over labeled traces. `method="gp"` (default) runs the GP/EI surrogate loop
    matching the reference's Bayesian tuning (`tune_pk_baer.py:197-201`);
    `method="random"` keeps the old random search as a comparison baseline."""
    if method == "gp":
        res = gp_maximize(
            lambda **params: _pick_f1(pick_fn, params, traces, true_onsets, sampling_rate, tolerance),
            param_space,
            n_trials=n_trials,
            seed=seed,
        )
        return {"f1": res["target"], "params": res["params"], "history": res["history"]}
    if method != "random":
        raise ValueError(f"unknown tuning method: {method!r}")
    rng = np.random.default_rng(seed)
    best = {"f1": -1.0, "params": None}
    history = []
    for _ in range(n_trials):
        params = {k: float(rng.uniform(*v)) for k, v in param_space.items()}
        f1 = _pick_f1(pick_fn, params, traces, true_onsets, sampling_rate, tolerance)
        history.append(f1)
        if f1 > best["f1"]:
            best = {"f1": f1, "params": params}
    best["history"] = history
    return best
