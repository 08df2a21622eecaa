"""The port's evaluation path against the JAX package, on the CPU.

Both packages read one dataset directory written by ``make_synthetic_dataset``
(40 traces of 6000 samples) and one set of target CSVs. The models are a
seeded PhaseNet and a small EQTransformer (1504 samples, one BiLSTM block)
with BatchNorm statistics moved off identity and the heads stretched
(``tests/torch_eval_common.py``), carried to JAX as the same tree.

- Curves: ``_SteeredRunner.prob_curves`` within the forward pins (2e-5
  PhaseNet, 2e-4 EQTransformer) of JAX's, with the same borders.
- Pick lists fed JAX's own curves through ``evaluate(curves=...)``: exactly
  JAX's, at every default threshold.
- ``evaluate_sweep`` equals the port's ``evaluate`` at every threshold.
- ``eval_task0`` (with ``curve_chunk`` forcing several chunks) writes
  byte-equal CSVs to JAX's at thresholds chosen by a fixed rule from a grid: no in-region sample of
  JAX's P or S curves lies within 10x the forward pin of a threshold or of
  its half, and every trigger's highest sample leads its second by more
  than twice the pin (so each sample sits on the same side of both
  thresholds and each argmax is the same in both packages). The rule is
  asserted, not tuned. ``eval_task0_true_negative_rate`` counts the same
  pick lists.
- ``_predict_scores``: scores within the pin (the P/S ratio within the
  bound the pin gives it); ``p_``/``s_sample_pred`` exact where the
  region's top two values differ by more than twice the pin.
- ``parse_task1`` / ``parse_task23`` within 1e-12 of JAX's on JAX's CSVs;
  ``performance_vs_snr_fi`` tables equal to JAX's.
"""

import math
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from tests.torch_eval_common import DS, FORWARD_TOL, SMALL_EQT, model_pair
from tests.torch_train_common import torch_alone
from volpick_tpu.data import VCSEIS
from volpick_tpu.data.synthetic import make_synthetic_dataset
from volpick_tpu.eval import analysis as janalysis
from volpick_tpu.eval import targets as jtargets
from volpick_tpu.eval import task0 as jt0
from volpick_tpu.eval import task123 as jt123
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu_torch.data.dataset import WaveformDataset
from volpick_tpu_torch.eval import analysis as panalysis
from volpick_tpu_torch.eval import task0 as pt0
from volpick_tpu_torch.eval import task123 as pt123
from volpick_tpu_torch.models import EQTransformer, VolEQTransformer
from volpick_tpu_torch.ops.signal import demean, detrend_linear, normalize_amplitude
from volpick_tpu_torch.ops.triggers import trigger_onset_numpy
from volpick_tpu_torch.pipeline.generator import eval_batch

ARCHS = ("phasenet", "eqtransformer")
JAX_MODELS = {"phasenet": lambda: JaxPhaseNet(), "eqtransformer": lambda: JaxEQT(**SMALL_EQT)}
THRESHOLDS = tuple(np.arange(0.1, 0.95, 0.1))  # eval_task0's default sweep
BATCH = 5  # several batches, the last one partial
PARSE_TOL = 1e-12
GOLDEN_METRICS = ["prob_thre", "tp_thre"] + [
    f"{ph}_{c}"
    for ph in ("p", "s")
    for c in (
        "TP", "FP", "FN", "precision", "recall", "F1score",
        "mean", "median", "std", "MAE", "MAD", "out",
        "modified_mean", "modified_median", "modified_std",
        "modified_RMSE", "modified_MAE", "modified_MAD",
        "modified_mean2", "modified_median2", "modified_std2",
        "modified_RMSE2", "modified_MAE2", "modified_MAD2",
    )
]


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """Torch on one thread: the test processes of a parallel run share the
    CPU, XLA's threads among them."""
    with torch_alone():
        yield


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_ds")
    make_synthetic_dataset(d, **DS)
    jds, pds = VCSEIS(d), WaveformDataset(d)
    targets = tmp_path_factory.mktemp("eval_targets")
    jtargets.generate_task0(jds, targets, noise_before_events=True)
    jtargets.generate_task1(jds, targets, noise_before_events=True)
    jtargets.generate_task23(jds, targets)
    t0 = pd.read_csv(targets / "task0.csv")

    def frames_of(window):
        return eval_batch(pds, t0["trace_idx"], window, t0["start_sample"], t0["end_sample"])[0]

    models = {arch: model_pair(arch, frames_of) for arch in ARCHS}
    evalset = t0[t0["trace_split"].isin(["dev", "test"])].reset_index(drop=True)
    curves = {arch: jt0._SteeredRunner(JAX_MODELS[arch](), models[arch][1], batch_size=BATCH)
              .prob_curves(jds, evalset) for arch in ARCHS}
    return SimpleNamespace(jds=jds, pds=pds, targets=targets, evalset=evalset, models=models,
                           curves=curves, tmp=tmp_path_factory)


def _in_region(preds, borders, ki):
    t = np.arange(preds.shape[-1])[None, :]
    return preds[:, ki] * ((t >= borders[:, :1]) & (t < borders[:, 1:2]))


def _margins(env, arch, thr):
    """(least distance of an in-region curve sample to thr or thr/2, least
    lead of a trigger's highest sample over its second) on JAX's curves."""
    preds, borders = env.curves[arch]
    t1 = np.float32(thr)
    t2 = t1 / np.float32(2)
    dist, lead = np.inf, np.inf
    for ki in pt0._phase_channels(env.models[arch][0]).values():
        prob = _in_region(preds, borders, ki)
        dist = min(dist, float(np.abs(prob - t1).min()), float(np.abs(prob - t2).min()))
        for row in prob:
            for on, off in trigger_onset_numpy(row, t1, t2):
                top = np.sort(row[on : off + 1])[::-1]
                lead = min(lead, float(top[0] - top[1]) if len(top) > 1 else np.inf)
    return dist, lead


@pytest.fixture(scope="module")
def clear_thresholds(env):
    """PhaseNet thresholds from the grid 0.05..0.95 (step 0.01) whose margins
    clear 10x the pin (distance) and 2x the pin (lead); the lowest, the
    middle and the highest of them."""
    tol = FORWARD_TOL["phasenet"]
    ok = [float(t) for t in np.round(np.arange(0.05, 0.951, 0.01), 2)
          if (lambda m: m[0] > 10 * tol and m[1] > 2 * tol)(_margins(env, "phasenet", t))]
    assert len(ok) >= 3, ok
    return (ok[0], ok[len(ok) // 2], ok[-1])


@pytest.fixture(scope="module")
def jax_task0(env, clear_thresholds):
    out = env.tmp.mktemp("jax_task0")
    jt0.eval_task0(JaxPhaseNet(), env.models["phasenet"][1], env.jds, env.targets, out,
                   prob_thresholds=clear_thresholds, batch_size=BATCH, curve_chunk=6)
    return out


@pytest.fixture(scope="module")
def jax_task123(env):
    out = env.tmp.mktemp("jax_task123")
    jt123.eval_tasks123(JaxPhaseNet(), env.models["phasenet"][1], env.jds, env.targets, out,
                        batch_size=BATCH)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_curves_match_jax(env, arch):
    preds, borders = pt0._SteeredRunner(env.models[arch][0], batch_size=BATCH, device="cpu").prob_curves(
        env.pds, env.evalset)
    want, want_borders = env.curves[arch]
    np.testing.assert_array_equal(borders, want_borders)
    assert preds.shape == want.shape and preds.dtype == np.float32
    np.testing.assert_allclose(preds, want, atol=FORWARD_TOL[arch], rtol=0)


def test_std_norm_reaches_every_steered_path(env):
    """A model's ``norm`` conditions every steered batch. PhaseNet with
    ``norm="std"`` (the same weights): the runner's curves and
    ``_predict_scores``' detection scores are within the pin of JAX's, the
    curves differ from the peak-normalised ones by far more than the pin, and
    ``evaluate_sweep`` equals ``evaluate`` on the runner's curves."""
    import copy

    model = copy.deepcopy(env.models["phasenet"][0])
    model.norm = "std"
    params = env.models["phasenet"][1]
    tol = FORWARD_TOL["phasenet"]
    got = pt0._SteeredRunner(model, batch_size=BATCH, device="cpu").prob_curves(env.pds, env.evalset)
    want = jt0._SteeredRunner(JaxPhaseNet(norm="std"), params, batch_size=BATCH).prob_curves(
        env.jds, env.evalset)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=tol, rtol=0)
    assert float(np.abs(got[0] - env.curves["phasenet"][0]).max()) > 100 * tol

    targets = pd.read_csv(env.targets / "task23.csv")
    targets = targets[targets["trace_split"].isin(["dev", "test"])].reset_index(drop=True)
    scores = pt123._predict_scores(model, env.pds, targets, BATCH, device="cpu")
    want_scores = jt123._predict_scores(JaxPhaseNet(norm="std"), params, env.jds, targets, BATCH)
    np.testing.assert_allclose(scores["score_detection"], want_scores["score_detection"], atol=tol, rtol=0)

    sweep = pt0.evaluate_sweep(model, env.pds, env.evalset, THRESHOLDS, batch_size=BATCH, device="cpu")
    for thr, (p_s, s_s) in zip(THRESHOLDS, sweep):
        p_e, s_e = pt0.evaluate(model, env.pds, env.evalset, thr, batch_size=BATCH, curves=got, device="cpu")
        for a, b in zip(p_s + s_s, p_e + s_e):
            np.testing.assert_array_equal(a, b)


def test_runner_demeans_for_eqt():
    """Eval-time conditioning is demean, not detrend, for every model, EQT
    included (the reference's eval augmentations, `models.py:445-452`,
    `:849-856`; the port's counterpart of
    tests/test_eval.py::test_steered_runner_demeans_for_eqt): on a strongly
    trending input the runner's curves are the demean-conditioned forward's
    and differ from the detrend-conditioned one's."""
    model = EQTransformer(generator=torch.Generator().manual_seed(0), **SMALL_EQT).eval()
    rng = np.random.default_rng(0)
    n = 4000
    x = (rng.normal(size=(2, 3, n)) * 0.1 + np.linspace(0, 50, n)[None, None, :]).astype(np.float32)

    class _FakeDS:
        sampling_rate = 100.0
        metadata = pd.DataFrame({"trace_name": ["a", "b"], "trace_sampling_rate_hz": [100.0, 100.0],
                                 "trace_p_arrival_sample": [1500.0, 1700.0],
                                 "trace_s_arrival_sample": [1800.0, 2100.0]})

        def get_sample(self, i):
            return x[i], {}

        def __len__(self):
            return 2

    targets = pd.DataFrame({"trace_idx": [0, 1], "start_sample": [1000, 1200], "end_sample": [2400, 2600],
                            "trace_split": ["test", "test"]})
    curves, borders = pt0._SteeredRunner(model, batch_size=2, device="cpu").prob_curves(_FakeDS(), targets)
    w0 = targets["start_sample"].to_numpy() - borders[:, 0]
    frames = torch.as_tensor(np.stack([x[i, :, int(w0[i]) : int(w0[i]) + model.in_samples] for i in (0, 1)]))
    for cond, should_match in ((demean, True), (detrend_linear, False)):
        with torch.no_grad():
            ref = torch.stack(model(normalize_amplitude(cond(frames), norm=model.norm, per_channel=True)),
                              dim=1).numpy()
        diff = float(np.abs(ref - curves).max())
        assert (diff < 1e-5) if should_match else (diff > 1e-3), (cond.__name__, diff)


@pytest.mark.parametrize("arch", ARCHS)
def test_pick_lists_from_jax_curves_equal_jax(env, arch):
    model, params = env.models[arch]
    curves = env.curves[arch]
    n_picks = 0
    for thr in THRESHOLDS:
        # one extraction chunk: JAX runs its extraction eagerly, a compile a shape
        got = pt0.evaluate(model, env.pds, env.evalset, thr, batch_size=64, curves=curves, device="cpu")
        want = jt0.evaluate(JAX_MODELS[arch](), params, env.jds, env.evalset, thr, batch_size=64,
                            curves=curves)
        for g_phase, w_phase in zip(got, want):
            for g, w in zip(g_phase, w_phase):
                np.testing.assert_array_equal(g, w)
                n_picks += len(w)
    assert n_picks > 20


@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_equals_per_threshold_path(env, arch):
    model = env.models[arch][0]
    sweep = pt0.evaluate_sweep(model, env.pds, env.evalset, THRESHOLDS, batch_size=BATCH, device="cpu")
    assert len(sweep) == len(THRESHOLDS)
    runner = pt0._SteeredRunner(model, batch_size=BATCH, device="cpu")
    curves = runner.prob_curves(env.pds, env.evalset)
    for thr, (p_s, s_s) in zip(THRESHOLDS, sweep):
        p_e, s_e = pt0.evaluate(model, env.pds, env.evalset, thr, batch_size=BATCH, curves=curves, device="cpu")
        for a, b in zip(p_s + s_s, p_e + s_e):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_eval_task0_csvs_equal_jax(env, clear_thresholds, jax_task0):
    out = env.tmp.mktemp("port_task0")
    res = pt0.eval_task0(env.models["phasenet"][0], env.pds, env.targets, out, prob_thresholds=clear_thresholds,
                         batch_size=BATCH, curve_chunk=6, device="cpu")
    assert list(res["test"].columns) == GOLDEN_METRICS
    assert res["test"]["p_TP"].sum() + res["test"]["s_TP"].sum() > 0
    for name in ("dev_metrics", "test_metrics", "dev_task0", "test_task0"):
        assert (out / f"{name}.csv").read_bytes() == (jax_task0 / f"{name}.csv").read_bytes(), name
    # the true-negative rate counts the same pick lists over the windows without a pick in truth
    tnr = pt0.eval_task0_true_negative_rate(env.models["phasenet"][0], env.pds, env.targets, out,
                                            prob_thresholds=clear_thresholds, batch_size=BATCH, device="cpu")
    test = env.evalset[env.evalset["trace_split"] == "test"].reset_index(drop=True)
    p_gt, _ = pt0.get_ground_truth(env.pds, test)
    picks = pd.read_csv(out / "test_task0.csv")
    for thr, row in zip(clear_thresholds, tnr["test"].itertuples()):
        p_lists = picks[np.isclose(picks["prob_threshold"], thr)]["p_picks"].tolist()
        assert row.p_TN == sum(1 for t, p in zip(p_gt, p_lists) if len(t) == 0 and p == "[]")
        assert row.p_TN + row.p_FP == sum(1 for t in p_gt if len(t) == 0)
    got = pt0.bootstrap_f1_from_artifacts(out, env.pds, env.targets, "test", "p", clear_thresholds[0], n_boot=200)
    want = jt0.bootstrap_f1_from_artifacts(jax_task0, env.jds, env.targets, "test", "p", clear_thresholds[0],
                                           n_boot=200)
    assert got == want


def _region_top2(preds, borders, ki):
    prob = np.where(_in_region(preds, borders, ki) > 0, preds[:, ki], -np.inf)
    top = np.sort(prob, axis=1)[:, ::-1]
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("task", ["task1", "task23"])
def test_predict_scores_match_jax(env, task):
    model, params = env.models["phasenet"]
    tol = FORWARD_TOL["phasenet"]
    targets = pd.read_csv(env.targets / f"{task}.csv")
    targets = targets[targets["trace_split"].isin(["dev", "test"])].reset_index(drop=True)
    got = pt123._predict_scores(model, env.pds, targets, BATCH, device="cpu")
    want = jt123._predict_scores(JaxPhaseNet(), params, env.jds, targets, BATCH)
    assert list(got) == list(want) == ["score_detection", "score_p_or_s", "p_sample_pred", "s_sample_pred"]
    np.testing.assert_allclose(got["score_detection"], want["score_detection"], atol=tol, rtol=0)
    # p/s of maxima each within tol: |d(p/s)| <= tol (1 + p/s) / (s - tol)
    preds, borders = jt0._SteeredRunner(JaxPhaseNet(), params, batch_size=BATCH).prob_curves(env.jds, targets)
    chans = pt0._phase_channels(model)
    s_max = np.where(_in_region(preds, borders, chans["S"]) > 0, preds[:, chans["S"]], 0).max(axis=1)
    ratio = want["score_p_or_s"]
    assert np.all(np.abs(got["score_p_or_s"] - ratio) <= tol * (1 + np.abs(ratio)) / (s_max - tol))
    checked = 0
    for col, phase in (("p_sample_pred", "P"), ("s_sample_pred", "S")):
        clear = _region_top2(preds, borders, chans[phase]) > 2 * tol
        np.testing.assert_array_equal(got[col][clear], want[col][clear])
        checked += int(clear.sum())
    assert checked > len(targets)


def test_voleqt_scores_have_seven_columns(env):
    model = VolEQTransformer(generator=torch.Generator().manual_seed(1), **SMALL_EQT).eval()
    targets = pd.read_csv(env.targets / "task23.csv").iloc[:7]
    got = pt123._predict_scores(model, env.pds, targets, BATCH, device="cpu")
    assert list(got) == ["score_detection", "score_p_or_s", "p_sample_pred", "s_sample_pred",
                         "score_rg_detection", "score_lp_detection", "score_rg_or_lp"]
    assert all(len(v) == len(targets) for v in got.values())
    np.testing.assert_array_equal(got["score_detection"],
                                  np.maximum(got["score_rg_detection"], got["score_lp_detection"]))


def _close_dicts(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), k
        else:
            assert abs(float(g) - float(w)) <= PARSE_TOL, (k, g, w)


def test_eval_tasks123_and_parsing_match_jax(env, jax_task123):
    out = env.tmp.mktemp("port_task123")
    pt123.eval_tasks123(env.models["phasenet"][0], env.pds, env.targets, out, batch_size=BATCH, device="cpu")
    for name in ("dev_task1", "test_task1", "dev_task23", "test_task23"):
        got, want = pd.read_csv(out / f"{name}.csv"), pd.read_csv(jax_task123 / f"{name}.csv")
        assert list(got.columns) == list(want.columns), name
        assert list(got.columns[-4:]) == ["score_detection", "score_p_or_s", "p_sample_pred", "s_sample_pred"]
    t1, t23 = pt123.parse_task1(jax_task123), pt123.parse_task23(jax_task123)
    assert "dev_det_auc" in t1 and "test_phase_mcc" in t23
    _close_dicts(t1, jt123.parse_task1(jax_task123))
    _close_dicts(t23, jt123.parse_task23(jax_task123))
    got = pt123.collect_task123_results(jax_task123.parent, [jax_task123.name])
    want = jt123.collect_task123_results(jax_task123.parent, [jax_task123.name])
    pd.testing.assert_frame_equal(got, want, atol=PARSE_TOL, rtol=0)


def test_performance_vs_snr_fi_matches_jax(env, clear_thresholds):
    d = env.jds.path
    jds, pds = VCSEIS(d), WaveformDataset(d)
    rng = np.random.default_rng(9)
    snr, fi = rng.uniform(-5, 40, len(pds)), rng.uniform(-2.5, 1.0, len(pds))
    for ds in (jds, pds):
        ds.metadata["trace_mean_snr_db"] = snr
        ds.metadata["trace_frequency_index"] = fi
    thr, s_thr = clear_thresholds[0], clear_thresholds[1]
    model, params = env.models["phasenet"]
    got = panalysis.performance_vs_snr_fi(model, pds, env.targets, env.tmp.mktemp("port_snr"),
                                          prob_threshold=thr, s_threshold=s_thr, batch_size=BATCH, device="cpu")
    want = janalysis.performance_vs_snr_fi(JaxPhaseNet(), params, jds, env.targets, env.tmp.mktemp("jax_snr"),
                                           prob_threshold=thr, s_threshold=s_thr, batch_size=BATCH)
    assert sorted(got) == sorted(want) and len(want) == 5
    for k in want:
        pd.testing.assert_frame_equal(got[k], want[k], check_exact=True)
