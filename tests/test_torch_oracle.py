"""The port's numpy oracle (``volpick_tpu_torch/picker/oracle.py``) vs the JAX
package's, and the port's picker vs the port's oracle.

The port keeps its own copy of the executable specification, so that nothing
of the port reaches into the JAX package. The copy must return exactly what
the original returns on the same seeded inputs (both are numpy, float64: bit
for bit), and the port's ``WaveformPicker`` must give the oracle's picks
sample for sample, its curves within 2e-5 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from tests.test_oracle import THRESHOLDS, WINDOW, DummyNet, make_data
from tests.test_torch_picker import TorchDummyNet, _picks
from volpick_tpu.ops.triggers import trigger_onset_numpy as jax_trigger_onset
from volpick_tpu.picker import oracle as jax_oracle
from volpick_tpu_torch.ops.triggers import extract_triggers_batched, trigger_onset_numpy
from volpick_tpu_torch.picker import WaveformPicker, oracle

CURVE_ATOL = 2e-5


@pytest.mark.parametrize("n,window,stride", [(1, 400, 100), (400, 400, 100), (401, 400, 100),
                                             (1234, 400, 300), (2000, 400, 400), (4100, 1504, 376),
                                             (120000, 6000, 500), (120001, 6000, 500)])
def test_window_starts_equal(n, window, stride):
    assert oracle.oracle_window_starts(n, window, stride) == jax_oracle.oracle_window_starts(n, window, stride)


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("norm", ["peak", "std"])
def test_condition_equal(detrend, norm):
    rng = np.random.default_rng(3)
    frame = rng.normal(size=(3, 400)) + rng.uniform(-20, 20, (3, 1)) + np.linspace(-5, 5, 400)
    np.testing.assert_array_equal(oracle.oracle_condition(frame, detrend, norm),
                                  jax_oracle.oracle_condition(frame, detrend, norm))
    with pytest.raises(ValueError, match="unknown norm"):
        oracle.oracle_condition(frame, detrend, "max")


@pytest.mark.parametrize("seed", range(6))
def test_trigger_onset_equal(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.integers(1, 3000))
    smooth = np.ones(int(rng.integers(1, 40)))
    prob = np.convolve(rng.random(w), smooth / smooth.size, mode="same")
    if seed == 0:
        prob[:] = 0.9  # one run that touches both ends
    if seed == 1:
        prob[:] = 0.1  # never triggers
    t1 = float(rng.uniform(0.3, 0.8))
    assert trigger_onset_numpy(prob, t1, t1 / 2) == jax_trigger_onset(prob, t1, t1 / 2)


CASES = [
    (1234, 100, (0, 0), "avg"),   # flush window
    (987, 200, (50, 50), "avg"),  # blinding + flush
    (120, 100, (0, 0), "avg"),    # shorter than one window: padded
    (1033, 150, (0, 0), "max"),   # max stacking + flush
    (2000, 300, (100, 100), "avg"),
]


@pytest.mark.parametrize("total,overlap,blinding,stacking", CASES)
@pytest.mark.parametrize("detrend", [False, True])
def test_annotate_and_classify_equal(total, overlap, blinding, stacking, detrend):
    data = make_data(np.random.default_rng(total), total)
    kw = dict(blinding=blinding, stacking=stacking, detrend=detrend, norm="peak")
    mine = oracle.oracle_annotate(data, DummyNet.predict_np, WINDOW, overlap, **kw)
    theirs = jax_oracle.oracle_annotate(data, DummyNet.predict_np, WINDOW, overlap, **kw)
    assert mine.shape == (3, total)
    np.testing.assert_array_equal(mine, theirs)
    got = oracle.oracle_classify(data, DummyNet.predict_np, WINDOW, overlap, THRESHOLDS,
                                 channels=list("PSN"), **kw)
    want = jax_oracle.oracle_classify(data, DummyNet.predict_np, WINDOW, overlap, THRESHOLDS,
                                      channels=list("PSN"), **kw)
    assert got == want and set(got) == {"P", "S"}
    with pytest.raises(ValueError, match="unknown stacking"):
        oracle.oracle_annotate(data, DummyNet.predict_np, WINDOW, overlap, stacking="sum")


@pytest.mark.parametrize("total,overlap,blinding,stacking", CASES)
@pytest.mark.parametrize("method", ["pallas_full", "assoc"])
def test_port_picker_matches_port_oracle(total, overlap, blinding, stacking, method, monkeypatch):
    monkeypatch.setenv("VOLPICK_TRIGGER_METHOD", method)
    data = make_data(np.random.default_rng(total), total)
    if total == 120:
        data[0, 100:120] += np.hanning(20) * 5.0  # a burst whose window reaches into the padded tail
    picker = WaveformPicker(TorchDummyNet(), device="cpu", detrend=False)
    kw = dict(overlap=overlap, blinding=blinding, stacking=stacking, batch_size=8)
    got = picker.classify_arrays(data[None], THRESHOLDS, **kw)
    orc = oracle.oracle_classify(data, DummyNet.predict_np, WINDOW, overlap, THRESHOLDS,
                                 channels=list("PSN"), blinding=blinding, stacking=stacking,
                                 detrend=False, norm="peak")
    for label in ("P", "S"):
        mine = _picks(got, label, total)
        assert [(p, o) for p, o, _ in mine] == [(t[0], t[2]) for t in orc[label]]
        assert [min(f, total - 1) for _, _, f in mine] == [t[3] for t in orc[label]]
        vals = [float(v) for v, ok in zip(got[label][1][0], got[label][2][0]) if ok][: len(mine)]
        np.testing.assert_allclose(vals, [t[1] for t in orc[label]], atol=CURVE_ATOL)
    curves = picker.annotate_array(data[None], **kw)[0]
    np.testing.assert_allclose(
        curves, oracle.oracle_annotate(data, DummyNet.predict_np, WINDOW, overlap, blinding=blinding,
                                       stacking=stacking, detrend=False, norm="peak"), atol=CURVE_ATOL)


def test_oracle_picks_from_the_pickers_own_curves():
    """The oracle's trigger rule on the picker's float32 curves gives exactly
    the picks of ``extract_triggers_batched`` on them, for every method."""
    data = make_data(np.random.default_rng(77), 2500)
    picker = WaveformPicker(TorchDummyNet(), device="cpu", detrend=False)
    curves = picker.annotate_array(data[None], overlap=200, blinding=(20, 20), batch_size=8)[0]
    for method in ("pallas_full", "pallas", "shift", "blocked", "assoc"):
        pk, val, valid, on, off = (a.numpy() for a in extract_triggers_batched(
            torch.as_tensor(curves[:2]), 0.5, max_picks=16, method=method))
        for row in range(2):
            trig = trigger_onset_numpy(curves[row], np.float32(0.5), np.float32(0.25))
            assert valid[row].sum() == len(trig) > 0
            assert list(zip(on[row][: len(trig)], off[row][: len(trig)])) == trig
            for j, (s0, s1) in enumerate(trig):
                assert pk[row, j] == s0 + int(np.argmax(curves[row, s0 : s1 + 1]))
                assert val[row, j] == curves[row, pk[row, j]]
