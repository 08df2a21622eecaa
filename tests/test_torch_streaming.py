"""StreamingPicker of the port vs the JAX class and offline classify().

The same chunks (numpy-seeded data, 1-second or 10-second packets a
component) go through ``volpick_tpu.picker.StreamingPicker`` and the port's,
once with the DummyNet pair of tests/test_oracle.py and
tests/test_torch_picker.py and once with a seeded PhaseNet carried over by
``models/convert.py``. Both must release the same picks at the same ingest
call (trace id, phase and the three times exactly: they are float64 host
arithmetic done in the same order; peak values within the model's forward
pin), and after ``flush()`` the DummyNet's streamed picks must be those of
offline ``classify()`` on the whole record, each once.

A pass starts when the first component of a packet lengthens the buffer, so
the other components' newest `chunk` samples are still zeros in it. Windows
that reach into them touch released samples only past their left blinding:
the cases that are held to offline classify() have ``blinding[0] >= chunk``,
which keeps every released sample clear of such a window. One more case has
no blinding: there both classes release the same picks all the same, and
those differ from offline (recorded in ROADMAP.md). PhaseNet's thresholds are
taken from the offline curves, away from every curve sample by far more than
the two packages differ, so no sample falls on the other side of a threshold
in one package only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_oracle import THRESHOLDS, WINDOW, DummyNet, make_data
from tests.test_torch_picker import TorchDummyNet
from tests.test_torch_picker_models import _threshold
from volpick_tpu.core import Trace as JaxTrace
from volpick_tpu.core import UTC as JaxUTC
from volpick_tpu.models import PhaseNet as JaxPhaseNet
from volpick_tpu.models import VolEQTransformer as JaxVolEQT
from volpick_tpu.picker import StreamingPicker as JaxStreamingPicker
from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker
from volpick_tpu_torch.models import PhaseNet, load_model
from volpick_tpu_torch.models.convert import phasenet_state_dict_from_jax
from volpick_tpu_torch.picker import UTC, Stream, StreamingPicker, Trace, WaveformPicker

SR = 100.0
T0 = "2024-03-01T00:00:07.250000"  # not a whole second: the float arithmetic has digits to lose


def _traces(trace_cls, utc_cls, data, lo, hi, station="STRM", comps="ZNE"):
    t0 = utc_cls(T0)
    return [trace_cls(data[i, lo:hi].copy(), dict(network="XX", station=station, channel=f"HH{c}",
                                                  sampling_rate=SR, starttime=t0 + lo / SR))
            for i, c in enumerate(comps)]


def _key(p):
    return (p.trace_id, p.phase, p.peak_time.timestamp, p.start_time.timestamp, p.end_time.timestamp)


def _stream_both(port_sp, jax_sp, records, chunk):
    """Feed both pickers the same chunks; the picks of every ingest call and of
    flush(), port and JAX side by side."""
    n = max(d.shape[-1] for d in records.values())
    passes = []
    for lo in range(0, n, chunk):
        for station, data in records.items():
            hi = min(lo + chunk, data.shape[-1])
            if hi <= lo:
                continue
            for tr, jtr in zip(_traces(Trace, UTC, data, lo, hi, station),
                               _traces(JaxTrace, JaxUTC, data, lo, hi, station)):
                passes.append((list(port_sp.ingest(tr)), list(jax_sp.ingest(jtr))))
    passes.append((list(port_sp.flush()), list(jax_sp.flush())))
    return passes


def _sample(p):
    return (p.trace_id, p.phase, int(round((p.peak_time.timestamp - UTC(T0).timestamp) * SR)))


def _same_pass_by_pass(passes, value_atol):
    """Port and JAX released the same picks at every call; all the port's picks."""
    got_all = []
    for got, want in passes:
        assert [_key(p) for p in got] == [_key(p) for p in want]
        np.testing.assert_allclose([p.peak_value for p in got], [p.peak_value for p in want],
                                   atol=value_atol)
        got_all += got
    assert len(got_all) > 0
    assert sum(1 for got, _ in passes[:-1] if got) >= 2  # released over several passes, not all at flush
    return got_all


def _check(passes, offline_picks, value_atol):
    streamed = sorted(_sample(p) for p in _same_pass_by_pass(passes, value_atol))
    assert len(streamed) == len(set(streamed))  # no duplicates
    assert streamed == sorted(_sample(p) for p in offline_picks)


def _dummy_run(total, overlap, blinding, hop, chunk):
    rng = np.random.default_rng(total)
    records = {"STA": make_data(rng, total), "STB": make_data(rng, total - 700)}
    port = WaveformPicker(TorchDummyNet(), device="cpu", detrend=False)
    jpick = JaxPicker(DummyNet(), {}, detrend=False)
    kw = dict(overlap=overlap, blinding=blinding, hop_seconds=hop, batch_size=8)
    passes = _stream_both(StreamingPicker(port, thresholds=THRESHOLDS, **kw),
                          JaxStreamingPicker(jpick, thresholds=THRESHOLDS, **kw), records, chunk)
    stream = Stream([tr for sta, d in records.items() for tr in _traces(Trace, UTC, d, 0, d.shape[-1], sta)])
    offline = port.classify(stream, P_threshold=0.5, S_threshold=0.5, overlap=overlap,
                            blinding=blinding, batch_size=8)
    return passes, offline.picks


@pytest.mark.parametrize("total,overlap,blinding,hop,chunk", [
    (5000, 300, (100, 100), 3.0, 100),  # stride 100, 1-second packets, history trimmed often
    (4321, 300, (100, 100), 5.0, 100),  # a flush window offline; the record ends inside a packet
    (3000, 200, (200, 100), 1.0, 200),  # a pass every packet
])
def test_dummy_net_streams_like_jax_and_offline(total, overlap, blinding, hop, chunk):
    passes, offline_picks = _dummy_run(total, overlap, blinding, hop, chunk)
    _check(passes, offline_picks, 2e-5)


def test_without_blinding_the_port_follows_jax_not_offline():
    """No blinding, 2.5-second packets: a pass that the Z packet starts sees
    zeros where N and E have not arrived, its last windows reach released
    samples, and a pick or two are released that offline classify() does not
    have. The port releases exactly what the JAX class releases."""
    passes, offline_picks = _dummy_run(4321, 100, (0, 0), 5.0, 250)
    streamed = sorted(_sample(p) for p in _same_pass_by_pass(passes, 2e-5))
    offline = sorted(_sample(p) for p in offline_picks)
    assert streamed != offline and len(set(streamed) & set(offline)) >= len(offline) - 2


def test_default_thresholds_are_the_models(monkeypatch):
    sp = StreamingPicker(WaveformPicker(TorchDummyNet(), device="cpu", detrend=False))
    jsp = JaxStreamingPicker(JaxPicker(DummyNet(), {}, detrend=False))
    assert sp.thresholds["P"] == jsp.thresholds["P"] == 0.5 and sp.thresholds["Detection"] == 0.3
    assert (sp.window, sp.overlap, sp.hop, sp.blinding) == (jsp.window, jsp.overlap, jsp.hop, jsp.blinding)
    assert (sp.window, sp.overlap, sp.hop) == (WINDOW, WINDOW // 2, 3000)


@pytest.fixture(scope="module")
def phasenet_pair():
    jmodel = JaxPhaseNet()
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(3)))
    model = PhaseNet()
    model.load_state_dict(phasenet_state_dict_from_jax(params), strict=True)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), model.eval()


def test_phasenet_streams_like_jax(phasenet_pair):
    """A seeded PhaseNet: both classes release the same picks at every call and
    at flush(), none twice. Offline classify() is not the yardstick here: an
    untrained PhaseNet's curves hover near 1/3, half a threshold lies under
    most of the curve, a trigger run is hundreds of samples long, and a run
    that is cut by a pass's release bound is released with the peak it has so
    far (both classes alike; recorded in ROADMAP.md)."""
    jmodel, jparams, model = phasenet_pair
    n = 15000  # 150 s: five windows of 3001 at stride 1501 and more, trimmed twice
    rng = np.random.default_rng(8)
    t = np.arange(n) / SR
    data = rng.normal(size=(3, n)) * 0.03
    for p_at in (30.0, 75.0, 120.0):
        env = np.where(t >= p_at, np.exp(-(t - p_at) / 1.5), 0.0)
        data[0] += np.sin(2 * np.pi * 8 * t) * env * 2
        env_s = np.where(t >= p_at + 3, np.exp(-(t - p_at - 3) / 2.5), 0.0)
        data[1] += np.sin(2 * np.pi * 4 * t) * env_s * 3
        data[2] += np.sin(2 * np.pi * 4 * t) * env_s * 2.6
    data = data.astype(np.float32)
    port = WaveformPicker(model, device="cpu")
    jpick = JaxPicker(jmodel, jparams)
    kw = dict(overlap=1500, blinding=(1000, 250), batch_size=8)  # 10-second packets: 1000 samples
    curves = port.annotate_array(data[None], **kw)[0]
    jcurves = jpick.annotate_array(data[None], **kw)[0]
    diff = float(np.abs(curves - jcurves).max())
    assert diff <= 2e-5
    margin = max(10 * diff, 1e-6)
    both = np.stack([curves, jcurves])
    thr = {lab: _threshold(both[:, k], 0.97, margin) for k, lab in enumerate(model.phases) if lab != "N"}
    thresholds = dict(thr, N=2.0)
    passes = _stream_both(
        StreamingPicker(port, thresholds=thresholds, hop_seconds=20.0, **kw),
        JaxStreamingPicker(jpick, thresholds=thresholds, hop_seconds=20.0, **kw), {"STRM": data}, 1000)
    streamed = [_sample(p) for p in _same_pass_by_pass(passes, 2e-5)]
    assert len(streamed) == len(set(streamed))  # no duplicates
    assert len(passes[-1][0]) > 0  # flush() released the rest


def test_late_packet_before_the_buffer_origin():
    """A packet that starts before the buffer's first sample keeps its
    in-buffer part; one that ends before it changes nothing."""
    rng = np.random.default_rng(5)
    data = make_data(rng, 2400)
    port = WaveformPicker(TorchDummyNet(), device="cpu", detrend=False)
    jpick = JaxPicker(DummyNet(), {}, detrend=False)
    kw = dict(overlap=200, blinding=(0, 0), hop_seconds=3.0, batch_size=8, thresholds=THRESHOLDS)
    sp, jsp = StreamingPicker(port, **kw), JaxStreamingPicker(jpick, **kw)
    got, want = [], []
    # the N component arrives first and starts 300 samples in: that is the origin
    order = [("N", 300, 900), ("Z", 0, 900), ("E", 250, 900), ("Z", 0, 100)]
    order += [(c, 900, 2400) for c in "ZNE"]
    key = "XX.STRM..HH"
    for k, (comp, lo, hi) in enumerate(order):
        i = "ZNE".index(comp)
        tr = _traces(Trace, UTC, data[i : i + 1], lo, hi, comps=comp)[0]
        jtr = _traces(JaxTrace, JaxUTC, data[i : i + 1], lo, hi, comps=comp)[0]
        got += list(sp.ingest(tr))
        want += list(jsp.ingest(jtr))
        if k == 3:  # before any history is dropped
            assert sp._t0[key] == jsp._t0[key] == UTC(T0).timestamp + 3.0
            # what lay before the origin was dropped, the rest of each packet kept
            for ci in range(3):
                np.testing.assert_array_equal(sp._buf[key][ci], data[ci, 300:900].astype(np.float32))
    got += list(sp.flush())
    want += list(jsp.flush())
    assert [_key(p) for p in got] == [_key(p) for p in want] and len(got) > 0
    assert sp._t0[key] == jsp._t0[key]
    np.testing.assert_array_equal(sp._buf[key], jsp._buf[key])


def test_unknown_component_is_ignored():
    port = WaveformPicker(TorchDummyNet(), device="cpu", detrend=False)
    sp = StreamingPicker(port, thresholds=THRESHOLDS)
    data = make_data(np.random.default_rng(2), 1000)
    out = sp.ingest(_traces(Trace, UTC, data[:1], 0, 1000, comps="X")[0])
    assert len(out) == 0 and sp._buf == {}
    assert len(sp.flush()) == 0


def test_voleqt_default_thresholds_do_not_raise():
    """The JAX class's default thresholds lack the two detection heads of a
    VolEQTransformer and its first pass raises KeyError; the port names both
    at the detection threshold, as classify() does."""
    small = dict(in_samples=1504, lstm_blocks=1)
    model = load_model("voleqtransformer", seed=1, device="cpu", **small)
    model.default_args = {"detection_threshold": 0.4}
    sp = StreamingPicker(WaveformPicker(model, device="cpu"), hop_seconds=5.0)
    assert sp.thresholds["Detection_rg"] == sp.thresholds["Detection_lp"] == 0.4
    data = np.random.default_rng(9).normal(size=(3, 2000)).astype(np.float32)
    for tr in _traces(Trace, UTC, data, 0, 2000):
        sp.ingest(tr)  # the third component fills the window: one pass
    assert sp._processed_n["XX.STRM..HH"] == 2000
    sp.flush()
    jmodel = JaxVolEQT(**small)
    jsp = JaxStreamingPicker(JaxPicker(jmodel, {}))
    assert "Detection_rg" not in jsp.thresholds
