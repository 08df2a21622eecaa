"""WaveformPicker of the port vs the JAX picker and the numpy oracle.

A torch mirror of tests/test_oracle.py::DummyNet pins the window placement,
flush window, blinding, stacking and trigger algebra: picks must be exactly
those of the JAX picker and of ``picker/oracle.py::oracle_classify``, curves
within 2e-5 (float32 sums in another order). A small EQTransformer pins the
model path: curves within 2e-4 of the JAX picker (the EQT forward pin).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_oracle import THRESHOLDS, WINDOW, DummyNet, make_data
from volpick_tpu.core import Stream, Trace, UTC
from volpick_tpu.models import EQTransformer as JaxEQT
from volpick_tpu.models.torch_import import import_eqtransformer
from volpick_tpu.ops.triggers import extract_triggers_batched as jax_extract
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu.picker.oracle import oracle_annotate, oracle_classify
from volpick_tpu_torch.models import from_pretrained, load_model
from volpick_tpu_torch.models.convert import eqtransformer_state_dict_from_jax
from volpick_tpu_torch.ops.triggers import extract_triggers_batched
from volpick_tpu_torch.picker import WaveformPicker

CURVE_ATOL = 2e-5
EQT_ATOL = 2e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TorchDummyNet(torch.nn.Module):
    """torch mirror of DummyNet: smoothed channel energy through steep sigmoids."""

    name = DummyNet.name
    in_samples = WINDOW
    phases = DummyNet.phases
    norm = DummyNet.norm
    sampling_rate = DummyNet.sampling_rate
    component_order = DummyNet.component_order
    default_args = DummyNet.default_args

    def forward(self, frames):  # (N, C, W) -> (N, 3, W)
        kern = torch.full((1, 1, 31), 1.0 / 31.0, dtype=frames.dtype)
        sm = lambda x: F.conv1d(x[:, None], kern, padding=15)[:, 0]
        p = torch.sigmoid((sm(frames[:, 0].abs()) * 3.0 - 1.0) * 3.0)
        s = torch.sigmoid((sm(frames[:, 1].abs()) * 3.0 - 1.0) * 3.0)
        return torch.stack([p, s, 1.0 - torch.maximum(p, s)], dim=1)


def _picks(res, label, total):
    pk, _, valid, on, off = (a[0] for a in res[label])
    return [(int(p), int(o), int(f)) for p, o, f, v in zip(pk, on, off, valid)
            if v and o < total and p < total]


@pytest.mark.parametrize(
    "total,overlap,blinding,stacking,max_span",
    [
        (1234, 100, (0, 0), "avg", 500_000),   # flush window
        (987, 200, (50, 50), "avg", 500_000),  # blinding + flush
        (120, 100, (0, 0), "avg", 500_000),    # shorter than one window: padded
        (640, WINDOW - 5, (0, 0), "avg", 500_000),  # stride 5: gather/scatter path
        (1033, 150, (0, 0), "max", 500_000),   # max stacking + flush
        (4000, 100, (20, 20), "avg", 1500),    # max_span: segmented and stitched
    ],
)
def test_dummy_net_matches_jax_and_oracle(total, overlap, blinding, stacking, max_span):
    rng = np.random.default_rng(total)
    data = make_data(rng, total)
    if total == 120:
        data[0, 100:120] += np.hanning(20) * 5.0  # burst in the padded tail's window
    port = WaveformPicker(TorchDummyNet(), device="cpu", detrend=False)
    kw = dict(overlap=overlap, blinding=blinding, stacking=stacking, batch_size=8)
    got = port.classify_arrays(data[None], THRESHOLDS, max_span=max_span, **kw)
    jpick = JaxPicker(DummyNet(), {}, detrend=False)
    want = jpick.classify_arrays(data[None], THRESHOLDS, max_span=max_span, **kw)
    orc = oracle_classify(data, DummyNet.predict_np, WINDOW, overlap, THRESHOLDS,
                          channels=list("PSN"), blinding=blinding, stacking=stacking,
                          detrend=False, norm="peak")
    for label in ("P", "S"):
        assert _picks(got, label, total) == _picks(want, label, total)
        assert [(p, o) for p, o, _ in _picks(got, label, total)] == [
            (t[0], t[2]) for t in orc[label]
        ]
    curves = port.annotate_array(data[None], **kw)[0]
    np.testing.assert_allclose(curves, jpick.annotate_array(data[None], **kw)[0], atol=CURVE_ATOL)
    np.testing.assert_allclose(
        curves,
        oracle_annotate(data, DummyNet.predict_np, WINDOW, overlap, blinding=blinding,
                        stacking=stacking, detrend=False, norm="peak"),
        atol=CURVE_ATOL,
    )


def _eqt_stream(rng, n, stations=("ST1", "ST2")):
    t0 = UTC("2024-06-01T00:00:00")
    traces = []
    t = np.arange(n) / 100.0
    for si, sta in enumerate(stations):
        data = rng.normal(size=(3, n)) * 0.05
        env = np.where(t >= 12 + 3 * si, np.exp(-(t - 12 - 3 * si) / 2.0), 0.0)
        data += np.sin(2 * np.pi * 6 * t) * env
        for ci, comp in enumerate("ZNE"):
            traces.append(Trace(data[ci].astype(np.float32), dict(
                network="XX", station=sta, channel=f"HH{comp}", sampling_rate=100.0,
                starttime=t0)))
    return Stream(traces)


@pytest.fixture(scope="module")
def small_eqt(tmp_path_factory):
    """The port's seeded model, carried to JAX through the JAX package's own
    torch importer (a state-dict file round trip)."""
    model = load_model("eqtransformer", seed=1, in_samples=1504, lstm_blocks=1, device="cpu")
    path = tmp_path_factory.mktemp("eqt") / "volpick.pt.v1"
    torch.save(model.state_dict(), path)
    params = import_eqtransformer(str(path), n_lstm=1)
    back = eqtransformer_state_dict_from_jax(params)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    jmodel = JaxEQT(in_samples=1504, lstm_blocks=1)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model


@pytest.mark.parametrize("overlap", [1128, 1004])  # stride 376 divides 1504; 500 does not
def test_small_eqt_stream_matches_jax(small_eqt, overlap):
    jmodel, jparams, model = small_eqt
    stream = _eqt_stream(np.random.default_rng(overlap), 4100)
    port = WaveformPicker(model, device="cpu")
    jpick = JaxPicker(jmodel, jparams)
    kw = dict(overlap=overlap, blinding=(200, 200), batch_size=8)
    arrays = np.stack([g[1] for g in port._group_arrays(stream)])
    curves = port.annotate_array(arrays, **kw)
    jcurves = jpick.annotate_array(arrays, **kw)
    assert curves.shape == jcurves.shape == (2, 3, 4100)
    np.testing.assert_allclose(curves, jcurves, atol=EQT_ATOL)

    # thresholds from the curves themselves (random weights have no fixed scale)
    thr = [float(np.percentile(jcurves[:, k], 99.0)) for k in range(3)]
    flat = jcurves.reshape(6, -1)
    rows = np.repeat(np.float32(thr), 2)
    mine = extract_triggers_batched(torch.from_numpy(flat.copy()), torch.from_numpy(rows), max_picks=16)
    theirs = jax_extract(jnp.asarray(flat), jnp.asarray(rows), max_picks=16, method="blocked")
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    out = port.classify(stream, detection_threshold=thr[0], P_threshold=thr[1],
                        S_threshold=thr[2], **kw)
    assert len(out.picks) > 0 and len(out.detections) > 0
    assert {p.phase for p in out.picks} <= {"P", "S"}
    ann = port.annotate(stream, **kw)
    assert {tr.stats.channel for tr in ann} == {
        "EQTransformer_Detection", "EQTransformer_P", "EQTransformer_S"}
    np.testing.assert_allclose(ann[0].data, curves[0, 0], atol=0)


def test_span_conditioning_matches_per_window_path(small_eqt):
    """Conditioning a step's windows from its span of the stream and
    conditioning the framed windows one by one give the same curves (within
    1e-5: the sums run in another order) and the same picks, where the stride
    divides the window. The port's counterpart of
    tests/test_picker.py::test_span_conditioning_matches_per_window_path."""
    _, _, model = small_eqt
    stream = _eqt_stream(np.random.default_rng(7), 4100)
    on = WaveformPicker(model, device="cpu", span_conditioning=True)
    off = WaveformPicker(model, device="cpu", span_conditioning=False)
    assert on.span_conditioning and not off.span_conditioning
    kw = dict(overlap=1128, blinding=(200, 200), batch_size=8)  # stride 376 divides 1504
    arrays = np.stack([g[1] for g in on._group_arrays(stream)])
    c_on, c_off = on.annotate_array(arrays, **kw), off.annotate_array(arrays, **kw)
    assert not np.array_equal(c_on, c_off)  # two branches, not one taken twice
    np.testing.assert_allclose(c_on, c_off, atol=1e-5)
    thr = [float(np.percentile(c_on[:, k], 99.0)) for k in range(3)]
    tkw = dict(detection_threshold=thr[0], P_threshold=thr[1], S_threshold=thr[2], **kw)
    out_on, out_off = on.classify(stream, **tkw), off.classify(stream, **tkw)
    assert len(out_on.picks) > 0
    assert [(p.trace_id, p.phase, p.peak_time.timestamp) for p in out_on.picks] == [
        (p.trace_id, p.phase, p.peak_time.timestamp) for p in out_off.picks]
    assert [(d.trace_id, d.start_time.timestamp, d.end_time.timestamp) for d in out_on.detections] == [
        (d.trace_id, d.start_time.timestamp, d.end_time.timestamp) for d in out_off.detections]


@pytest.mark.parametrize("env,want", [(None, True), ("0", False), ("1", True), (" 0 ", False),
                                      ("off", True), ("", True)])
def test_span_conditioning_env_resolves_as_in_jax(monkeypatch, env, want):
    """``span_conditioning=None`` reads ``$VOLPICK_SPAN_COND`` as the JAX picker
    does ("0" off, any other non-empty value on, unset on), once: a later
    change of the environment moves neither picker; an argument wins."""
    if env is None:
        monkeypatch.delenv("VOLPICK_SPAN_COND", raising=False)
    else:
        monkeypatch.setenv("VOLPICK_SPAN_COND", env)
    port = WaveformPicker(TorchDummyNet(), device="cpu")
    jpick = JaxPicker(DummyNet(), {})
    assert port.span_conditioning is want and jpick.span_conditioning is want
    monkeypatch.setenv("VOLPICK_SPAN_COND", "1" if not want else "0")
    assert port.span_conditioning is want and jpick.span_conditioning is want
    for arg in (True, False):
        assert WaveformPicker(TorchDummyNet(), device="cpu", span_conditioning=arg).span_conditioning is arg


def test_env_off_takes_the_per_window_branch(small_eqt, monkeypatch):
    """``VOLPICK_SPAN_COND=0`` gives exactly the curves of
    ``span_conditioning=False``, not those of the span branch."""
    _, _, model = small_eqt
    arrays = np.random.default_rng(3).normal(size=(2, 3, 3000)).astype(np.float32)
    kw = dict(overlap=1128, batch_size=8)
    monkeypatch.setenv("VOLPICK_SPAN_COND", "0")
    by_env = WaveformPicker(model, device="cpu")
    monkeypatch.delenv("VOLPICK_SPAN_COND")
    got = by_env.annotate_array(arrays, **kw)
    np.testing.assert_array_equal(
        got, WaveformPicker(model, device="cpu", span_conditioning=False).annotate_array(arrays, **kw))
    assert not np.array_equal(got, WaveformPicker(model, device="cpu").annotate_array(arrays, **kw))


def test_small_eqt_per_window_conditioning_matches_jax(small_eqt):
    """With ``span_conditioning=False`` on both sides the port's curves match
    the JAX picker's within the EQT forward pin, where the stride divides the
    window (the case in which the switch decides the branch)."""
    jmodel, jparams, model = small_eqt
    stream = _eqt_stream(np.random.default_rng(11), 4100)
    port = WaveformPicker(model, device="cpu", span_conditioning=False)
    jpick = JaxPicker(jmodel, jparams, span_conditioning=False)
    kw = dict(overlap=1128, blinding=(200, 200), batch_size=8)
    arrays = np.stack([g[1] for g in port._group_arrays(stream)])
    np.testing.assert_allclose(port.annotate_array(arrays, **kw), jpick.annotate_array(arrays, **kw),
                               atol=EQT_ATOL)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        WaveformPicker(TorchDummyNet(), device="cuda")
    with pytest.raises(ValueError):
        WaveformPicker(TorchDummyNet(), device="meta")


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``device=None`` is the card: without CUDA the picker, ``load_model`` and
    ``from_pretrained`` raise and name ``device="cpu"``; with it they run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(in_samples=1504, lstm_blocks=1)
    src = load_model("eqtransformer", seed=2, device="cpu", **small)
    d = tmp_path / "eqtransformer"
    d.mkdir()
    torch.save(src.state_dict(), d / "volpick.pt.v1")
    (d / "volpick.json.v1").write_text(json.dumps({"model_args": small}))
    for call in (
        lambda **kw: WaveformPicker(TorchDummyNet(), **kw),
        lambda **kw: load_model("eqtransformer", **small, **kw),
        lambda **kw: from_pretrained("eqtransformer", search_paths=[str(tmp_path)], **kw),
    ):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call(device=None)
        got = call(device="cpu")
        model = got.model if isinstance(got, WaveformPicker) else got
        assert all(p.device.type == "cpu" for p in model.parameters())
    assert WaveformPicker(TorchDummyNet(), device="cpu").device == torch.device("cpu")


def test_port_imports_no_jax():
    """In a fresh interpreter, importing the port, its picker, every module
    of the package (the ``ops/cuda`` wrappers among them) loads neither JAX
    nor anything of the JAX package."""
    code = (
        "import importlib, pkgutil, sys, volpick_tpu_torch\n"
        "import volpick_tpu_torch.picker\n"
        "names = [m.name for m in pkgutil.walk_packages(volpick_tpu_torch.__path__, 'volpick_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for want in ('core.stream', 'core.picks', 'picker.streaming', 'picker.oracle',\n"
        "             'picker.stage_times', 'ops.cuda.addattn', 'ops.cuda.conditioning',\n"
        "             'ops.cuda.rescnn', 'ops.cuda.triggers', 'ops.cuda.lstm', 'ops.cuda.attention',\n"
        "             'eval.task0', 'eval.task123', '__main__'):\n"
        "    assert 'volpick_tpu_torch.' + want in sys.modules, want\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'volpick_tpu')]\n"
        "print('BAD', sorted(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
