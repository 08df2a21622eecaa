"""The port's bench (``volpick_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, on the CPU.

The bench's stream is ``bench.py``'s; the call it times equals what
``bench.py`` times, ``JaxPicker._fused_classify_fn`` called as it calls it,
on a reduced EQTransformer (one BiLSTM block at the bench's window 6000,
heads stretched) over 2 stations x 2 minutes of the bench stream: peak and trigger indices and
validity exactly equal, peak values within the EQT forward pin (2e-4), at the
bench's thresholds and at thresholds near the curves' 99th percentile
(which yield picks). The timing and baseline functions run at a small size;
the command refuses a machine without CUDA; ``stage_times.profiled`` holds
its session open around the work and refuses one that recorded no device
row.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_picker_models import _threshold
from tests.torch_heads import stretch_eqt_heads
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models.torch_import import import_eqtransformer
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu_torch import bench
from volpick_tpu_torch.models import load_model
from volpick_tpu_torch.ops.windows import window_starts
from volpick_tpu_torch.picker import stage_times

REPO = Path(__file__).resolve().parents[1]
EQT_ATOL = 2e-4
LABELS = ("Detection", "P", "S")


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stream_and_windows_are_bench_py_s():
    root = _root_bench()
    data = stage_times.bench_stream_array(0)
    np.testing.assert_array_equal(data, root._make_stream_array(np.random.default_rng(0)))
    assert (root.STATIONS, root.WINDOW, root.OVERLAP, root.BLINDING) == (
        stage_times.STATIONS, bench.WINDOW, bench.OVERLAP, bench.BLINDING)
    starts = window_starts(data.shape[-1], bench.WINDOW, bench.OVERLAP)
    assert data.shape == (8, 3, 120_000) and data.shape[0] * len(starts) == 1832
    assert int(starts[-1]) == (len(starts) - 1) * (bench.WINDOW - bench.OVERLAP)  # no flush window


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    """A seeded port EQTransformer with one BiLSTM block at window 6000, its
    heads stretched on its own curves (seeded heads give nearly flat ones),
    its weights carried to JAX through the JAX package's torch importer, and
    2 stations x 2 minutes of the bench stream."""
    model = load_model("eqtransformer", seed=3, lstm_blocks=1, device="cpu")
    data = np.ascontiguousarray(stage_times.bench_stream_array(0)[:2, :, :12_000])
    l, r = bench.BLINDING
    curves = bench.make_picker(model, "cpu").annotate_array(
        data, overlap=bench.OVERLAP, blinding=bench.BLINDING, batch_size=bench.BATCH)[..., l:-r]
    stretch_eqt_heads(model, [np.log(curves[:, k] / (1 - curves[:, k])) for k in range(3)])
    path = tmp_path_factory.mktemp("eqt") / "volpick.pt.v1"
    torch.save(model.state_dict(), path)
    params = jax.tree_util.tree_map(jnp.asarray, import_eqtransformer(str(path), n_lstm=1))
    return model, JaxPicker(JaxEQT(lstm_blocks=1), params), data


def _jax_bench_call(jpick, data, thr):
    """``bench.py``'s call of the fused program (``bench.py:80-87``)."""
    starts = window_starts(data.shape[-1], bench.WINDOW, bench.OVERLAP)
    run = jpick._fused_classify_fn(
        data.shape[0], len(starts), data.shape[-1], bench.BLINDING, "avg",
        tuple(thr[lab] for lab in LABELS), bench.MAX_PICKS, bench.BATCH,
        stride=bench.WINDOW - bench.OVERLAP)
    out = run(jpick.params, jnp.asarray(data), jnp.asarray(starts))
    return {k: tuple(np.asarray(a) for a in v) for k, v in out.items()}


def test_timed_call_equals_jax_bench_call(reduced):
    model, jpick, data = reduced
    picker = bench.make_picker(model, "cpu")
    kw = dict(overlap=bench.OVERLAP, blinding=bench.BLINDING, batch_size=bench.BATCH)
    curves, jcurves = picker.annotate_array(data, **kw), jpick.annotate_array(data, **kw)
    np.testing.assert_allclose(curves, jcurves, atol=EQT_ATOL)
    # every sample farther from a threshold (and its half) than twice the
    # curves' distance: the two sides see the same crossings
    margin = 2 * float(np.abs(curves - jcurves).max()) + 1e-7
    near_99 = {lab: _threshold(jcurves[:, k], 0.99, margin) for k, lab in enumerate(LABELS)}
    for thr in (bench.THRESHOLDS, near_99):
        got = bench.classify(picker, data, thr)
        want = _jax_bench_call(jpick, data, thr)
        assert sorted(got) == sorted(want) == sorted(LABELS)
        for lab in LABELS:
            (pk, val, valid, on, off), (jpk, jval, jvalid, jon, joff) = got[lab], want[lab]
            assert pk.shape == jpk.shape == (2, bench.MAX_PICKS)
            for a, b in ((pk, jpk), (valid, jvalid), (on, jon), (off, joff)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(val, jval, atol=EQT_ATOL)
        if thr is near_99:
            assert all(got[lab][2].any() for lab in LABELS)


def test_throughput_on_the_cpu(reduced):
    model, _, data = reduced
    picker = bench.make_picker(model, "cpu")
    res = bench.throughput(picker, data, iters_a=1, iters_b=2)
    one = bench.classify(picker, data)
    assert np.isfinite(res.windows_per_s) and res.windows_per_s > 0
    assert res.windows == 2 * 13 and res.median_ms > 0
    assert res.n_picks == int(one["P"][2].sum())
    for a, b, c in zip(res.first["P"], res.last["P"], one["P"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_metric_line_is_bench_py_s():
    assert bench.metric_line(1234.5678, 12.345) == {
        "metric": "eqt_classify_windows_per_s", "value": 1234.57, "unit": "windows/s",
        "vs_baseline": round(1234.5678 / 12.345, 2)}
    for cpu in (float("nan"), 0.0):
        line = bench.metric_line(99.999, cpu)
        assert list(line) == ["metric", "value", "unit", "vs_baseline"]
        assert line["value"] == 100.0 and line["vs_baseline"] is None
    assert json.loads(json.dumps(bench.metric_line(1.0, 2.0)))["vs_baseline"] == 0.5


def test_cpu_baseline_runs():
    rate = bench.cpu_baseline(max_windows=4, batch=2, repeats=1)
    assert np.isfinite(rate) and rate > 0


@pytest.mark.parametrize("argv", [["-m", "volpick_tpu_torch", "bench"], ["-m", "volpick_tpu_torch.bench"]])
def test_bench_refuses_without_cuda(tmp_path, argv):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "eqt_classify_windows_per_s" not in out.stdout and "refusing" in out.stderr
    assert not (tmp_path / "BENCH_AXES.json").exists()


class _FakeSession:
    """Stands in for ``torch.profiler.profile``: its ``key_averages()`` are
    the given rows."""

    rows = []

    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return list(self.rows)


@pytest.mark.parametrize("rows,want", [
    ([], None),
    ([SimpleNamespace(key="aten::mm", device_type="DeviceType.CPU", self_device_time_total=0.0)], None),
    ([SimpleNamespace(key="aten::mm", device_type="DeviceType.CPU", self_device_time_total=0.0),
      SimpleNamespace(key="lstm_multi_kernel_bf16", device_type="DeviceType.CUDA",
                      self_device_time_total=12.0)], 0.012),
    # the card's copy of a span's record_function range is no device work
    ([SimpleNamespace(key="forward", device_type="DeviceType.CUDA", self_device_time_total=20.0,
                      is_user_annotation=True),
      SimpleNamespace(key="lstm_multi_kernel", device_type="DeviceType.CUDA", self_device_time_total=12.0,
                      is_user_annotation=False)], 0.012),
])
def test_profiled_refuses_a_session_without_device_rows(monkeypatch, rows, want):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", _FakeSession)
    monkeypatch.setattr(_FakeSession, "rows", rows)
    slept = []
    monkeypatch.setattr(stage_times.time, "sleep", slept.append)
    ran = []
    if want is None:
        with pytest.raises(RuntimeError, match="no device activity"):
            stage_times.profiled(lambda: ran.append(1))
    else:
        wall, device_ms, events = stage_times.profiled(lambda: ran.append(1))
        assert device_ms == pytest.approx(want) and wall >= 0 and len(events) == len(rows)
    assert ran == [1] and slept == [stage_times.PROFILE_PAD_S] * 2 and stage_times.PROFILE_PAD_S > 0
