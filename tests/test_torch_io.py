"""The port's waveform and metadata I/O against the JAX package's.

- miniSEED, SAC and WIN32: a file written by either package is read by the
  other and by itself into exactly the same arrays and headers, and both
  writers give the same bytes. The hand-built Steim-1 / Steim-2 records and
  the broken records of ``tests/test_io.py`` (a record cut short, a
  blockette-1000 length exponent out of range, a data offset past the record
  end) go through the port's reader with the JAX reader's outcome.
- The port builds its native decoders from ``native/*.cpp`` into
  ``build/volpick_tpu_torch/``, never into the JAX package.
- StationXML and the rotation to ZNE at 1e-12, the WGS84 geodesic at 1e-9,
  the obspy converters with an obspy-shaped stub (no obspy here).
- ``python -m volpick_tpu_torch pick --device cpu`` and the JAX package's
  ``pick`` on the same miniSEED and SAC files, with weights exported once to
  the directory named by ``$VOLPICK_TPU_MODELS``, write the same CSV rows.
  The model is a seeded PhaseNet with stretched heads
  (``tests/torch_eval_common.py``); its default thresholds are the highest of
  a grid that both packages' curves clear by the rule of
  ``tests/test_torch_eval.py`` (every sample more than ten times the PhaseNet
  forward pin, 2e-5, from each threshold and its half; a trigger's top sample
  ahead of its second by twice the pin), so no trigger and no peak can move
  between the packages.
"""

import struct
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import volpick_tpu.core.stream as jstream
import volpick_tpu_torch.core.stream as pstream
import torch

from tests.test_io import _fixed_header
from tests.test_oldformat import STATIONXML
from tests.test_torch_picker import _eqt_stream
from tests.torch_eval_common import stretch_heads
from tests.torch_train_common import torch_alone
from volpick_tpu.core import geo as jgeo
from volpick_tpu.core import interop as jinterop
from volpick_tpu.core import rotate as jrotate
from volpick_tpu.core import sacio as jsac
from volpick_tpu.io import miniseed as jmseed
from volpick_tpu.io import stationxml as jxml
from volpick_tpu.io import win32 as jwin
from volpick_tpu.models import registry as jregistry
from volpick_tpu_torch.core import geo as pgeo
from volpick_tpu_torch.core import interop as pinterop
from volpick_tpu_torch.core import rotate as protate
from volpick_tpu_torch.core import sacio as psac
from volpick_tpu_torch.io import _native
from volpick_tpu_torch.io import miniseed as pmseed
from volpick_tpu_torch.io import stationxml as pxml
from volpick_tpu_torch.io import win32 as pwin
from volpick_tpu_torch.models import load_model
from volpick_tpu_torch.ops.triggers import trigger_onset_numpy
from volpick_tpu_torch.picker import WaveformPicker
from volpick_tpu_torch.train.model_io import export_pretrained

PKG = {"jax": jstream, "port": pstream}


@pytest.fixture(scope="module", autouse=True)
def _torch_on_one_thread():
    """Torch on one thread: the test processes of a parallel run share the CPU."""
    with torch_alone():
        yield


def _stream(pkg, rng, n=5000, stations=("AAA", "BBB"), sr=100.0, t0=1.7e9 + 0.25, ints=False):
    m = PKG[pkg]
    traces = []
    for i, sta in enumerate(stations):
        for comp in "ZNE":
            data = rng.normal(size=n) * 1000
            data = np.round(data) if ints else data.astype(np.float32)
            traces.append(m.Trace(data, dict(network="XX", station=sta, location="00" if i else "",
                                             channel=f"HH{comp}", sampling_rate=sr,
                                             starttime=m.UTC(t0 + 7 * i))))
    return m.Stream(traces)


def _same(got, want):
    """Same traces in the same order: ids, rate, start, samples exactly."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.id == b.id
        assert a.stats.sampling_rate == b.stats.sampling_rate
        assert a.stats.starttime.timestamp == b.stats.starttime.timestamp
        assert a.data.dtype == b.data.dtype
        np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("encoding", ["float32", "int32"])
def test_mseed_files_read_the_same_in_both_packages(tmp_path, writer, encoding):
    rng = np.random.default_rng(3)
    ints = encoding == "int32"
    st = _stream(writer, rng, ints=ints)
    other = "port" if writer == "jax" else "jax"
    write = {"jax": jmseed.write_mseed, "port": pmseed.write_mseed}
    write[writer](st, tmp_path / "a.mseed", encoding=encoding)
    # the other package's writer gives the same bytes for the same traces
    twin = PKG[other].Stream([PKG[other].Trace(tr.data.copy(), dict(
        network=tr.stats.network, station=tr.stats.station, location=tr.stats.location,
        channel=tr.stats.channel, sampling_rate=tr.stats.sampling_rate,
        starttime=PKG[other].UTC(tr.stats.starttime.timestamp))) for tr in st])
    write[other](twin, tmp_path / "b.mseed", encoding=encoding)
    assert (tmp_path / "a.mseed").read_bytes() == (tmp_path / "b.mseed").read_bytes()

    got = pmseed.read_mseed(tmp_path / "a.mseed")
    want = jmseed.read_mseed(tmp_path / "a.mseed")
    _same(got, want)
    assert len(got) == 6 and got[0].stats.npts == 5000  # two records a trace, merged
    by_id = {tr.id: tr for tr in st}
    for a in got:
        np.testing.assert_array_equal(a.data, np.asarray(by_id[a.id].data, dtype=np.float64))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sac_files_read_the_same_in_both_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    st = _stream(writer, rng, n=3001, stations=("SPBG",), sr=50.0)
    write = {"jax": jsac.write_sac, "port": psac.write_sac}
    other = "port" if writer == "jax" else "jax"
    paths = []
    for i, tr in enumerate(st):
        write[writer](tr, tmp_path / f"{i}.sac")
        twin = PKG[other].Trace(tr.data.copy(), dict(
            network=tr.stats.network, station=tr.stats.station, location=tr.stats.location,
            channel=tr.stats.channel, sampling_rate=tr.stats.sampling_rate,
            starttime=PKG[other].UTC(tr.stats.starttime.timestamp)))
        write[other](twin, tmp_path / f"{i}b.sac")
        assert (tmp_path / f"{i}.sac").read_bytes() == (tmp_path / f"{i}b.sac").read_bytes()
        paths.append(tmp_path / f"{i}.sac")
    _same(psac.read_sac_stream(paths), jsac.read_sac_stream(paths))
    for p, tr in zip(paths, st):
        np.testing.assert_array_equal(psac.read_sac(p).data, tr.data)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_win32_files_read_the_same_in_both_packages(tmp_path, writer):
    rng = np.random.default_rng(5)
    m = PKG[writer]
    traces = [m.Trace(np.cumsum(rng.integers(-amp, amp + 1, 500)).astype(np.float64),
                      dict(network="N", station=f"C{0x100 + i:04X}", location="", channel="CH",
                           sampling_rate=100.0, starttime=m.UTC(1.6e9)))
              for i, amp in enumerate((3, 100, 20_000, 5_000_000))]
    write = {"jax": jwin.write_win32, "port": pwin.write_win32}
    ids = write[writer](m.Stream(traces), tmp_path / "a.cnt")
    other = "port" if writer == "jax" else "jax"
    o = PKG[other]
    twin = o.Stream([o.Trace(tr.data.copy(), dict(
        network="N", station=tr.stats.station, location="", channel="CH", sampling_rate=100.0,
        starttime=o.UTC(1.6e9))) for tr in traces])
    assert write[other](twin, tmp_path / "b.cnt") == ids
    assert (tmp_path / "a.cnt").read_bytes() == (tmp_path / "b.cnt").read_bytes()
    _same(pwin.read_win32(tmp_path / "a.cnt"), jwin.read_win32(tmp_path / "a.cnt"))

    table = tmp_path / "t.ch"
    table.write_text("# ch net sta comp\n0100 1 0 STA1 U 6 7 100.0 1.0 0.0 0.0 20.0 1e-6\n"
                     "0101 1 0 STA1 N 6 7 100.0 1.0 0.0 0.0 20.0\nzzzz bad\n")
    pt, jt = pwin.read_win32_channel_table(table), jwin.read_win32_channel_table(table)
    assert pt.equals(jt)
    _same(pwin.read_win32(tmp_path / "a.cnt", channel_table=pt),
          jwin.read_win32(tmp_path / "a.cnt", channel_table=jt))


def _steim1_record():
    """``tests/test_io.py``'s hand-built Steim-1 record and its samples."""
    samples = [100, 101, 99, 150, 150, 100000, 99999, 99998, 99999]
    rec = _fixed_header(len(samples), 9, 10)
    words = [struct.pack(">i", samples[0]), struct.pack(">i", samples[-1]),
             struct.pack(">bbbb", 0, 1, -2, 51), struct.pack(">i", 0), struct.pack(">i", 99850),
             struct.pack(">hh", -1, -1), struct.pack(">i", 1)]
    return rec, words, [0, 0, 0, 1, 3, 3, 2, 3], samples


def _steim2_record():
    """``tests/test_io.py``'s hand-built Steim-2 record and its samples."""
    x0, diffs = 5000, [3, -3, 10, -10, 7, 10000, -10000]
    samples = [x0]
    for d in diffs[1:]:
        samples.append(samples[-1] + d)
    rec = _fixed_header(len(samples), 9, 11)
    five = 0
    for d in (3, -3, 10, -10, 7):
        five = (five << 6) | (d & 0x3F)
    pair = (2 << 30) | ((10000 & 0x7FFF) << 15) | (-10000 & 0x7FFF)
    words = [struct.pack(">i", x0), struct.pack(">i", samples[-1]), struct.pack(">I", five),
             struct.pack(">I", pair)]
    return rec, words, [0, 0, 0, 3, 2], samples


@pytest.mark.parametrize("build", [_steim1_record, _steim2_record], ids=["steim1", "steim2"])
def test_steim_records_decode_as_in_jax(tmp_path, build):
    rec, words, codes, samples = build()
    frame = bytearray(64)
    nibbles = 0
    for i, c in enumerate(codes):
        nibbles |= c << (2 * (15 - i))
    frame[0:4] = struct.pack(">I", nibbles)
    for i, w in enumerate(words):
        frame[4 * (i + 1): 4 * (i + 2)] = w
    rec[64:128] = frame
    (tmp_path / "s.mseed").write_bytes(bytes(rec))
    got = pmseed.read_mseed(tmp_path / "s.mseed")
    np.testing.assert_array_equal(got[0].data, samples)
    _same(got, jmseed.read_mseed(tmp_path / "s.mseed"))


def test_broken_records_have_the_jax_outcome(tmp_path):
    rng = np.random.default_rng(6)
    # a final record cut in half: decoded short, same samples in both
    st = _stream("port", rng, n=2000, stations=("TRC",))
    pmseed.write_mseed(pstream.Stream([st[0]]), tmp_path / "t.mseed")
    raw = (tmp_path / "t.mseed").read_bytes()
    (tmp_path / "cut.mseed").write_bytes(raw[: len(raw) - 2048])
    got = pmseed.read_mseed(tmp_path / "cut.mseed")
    assert 0 < sum(t.stats.npts for t in got) < 2000
    _same(got, jmseed.read_mseed(tmp_path / "cut.mseed"))
    # blockette-1000 length exponent 2**31: the record is refused by both
    rec = _fixed_header(10, 9, 4)
    rec[54] = 31
    (tmp_path / "bad.mseed").write_bytes(bytes(rec))
    for read in (pmseed.read_mseed, jmseed.read_mseed):
        with pytest.raises(ValueError):
            read(tmp_path / "bad.mseed")
    # data offset past the record end: an empty record in both
    rec = _fixed_header(10, 9, 4)
    rec[44:46] = struct.pack(">H", 600)
    (tmp_path / "off.mseed").write_bytes(bytes(rec))
    got = pmseed.read_mseed(tmp_path / "off.mseed")
    assert sum(t.stats.npts for t in got) == 0
    _same(got, jmseed.read_mseed(tmp_path / "off.mseed"))


def test_native_decoders_build_into_the_ports_build_directory():
    """Both decoders load from ``build/volpick_tpu_torch/``, built from the
    repository's ``native/`` sources; nothing is written into the JAX
    package."""
    root = _native.NATIVE_DIR.parent
    for stem, mod in (("miniseed", pmseed), ("win32", pwin)):
        lib = mod._get_lib()
        path = _native.library_path(stem)
        assert path.exists() and path.parent == root / "build" / "volpick_tpu_torch"
        assert lib._name == str(path)
        assert (root / "native" / f"{stem}.cpp").exists()
    assert "volpick_tpu" not in {p.name for p in _native.library_path("miniseed").parents[:2]}


def test_stationxml_and_rotation_match_jax(tmp_path):
    (tmp_path / "s.xml").write_text(STATIONXML)
    inv = pxml.read_stationxml(tmp_path / "s.xml")
    assert inv == jxml.read_stationxml(tmp_path / "s.xml")
    ori = pxml.channel_orientations(inv, "AV", "SPBG")
    assert ori == jxml.channel_orientations(inv, "AV", "SPBG")

    rng = np.random.default_rng(7)
    data = rng.normal(size=(3, 400))
    out = {}
    for pkg, rot in (("jax", jrotate), ("port", protate)):
        m = PKG[pkg]
        hdr = dict(network="AV", station="SPBG", sampling_rate=100.0, starttime=m.UTC(0))
        st = m.Stream([m.Trace(d, dict(hdr, channel=c)) for d, c in zip(data, ("BHZ", "BH1", "BH2"))])
        out[pkg] = rot.rotate_to_zne(st, ori)
        with pytest.raises(ValueError):
            rot.rotate_to_zne(m.Stream(list(st)[:2]), ori)
    assert [t.id for t in out["port"]] == [t.id for t in out["jax"]] == [
        "AV.SPBG..BHZ", "AV.SPBG..BHN", "AV.SPBG..BHE"]
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a.data, b.data, rtol=0, atol=1e-12)


def test_geodesic_matches_jax():
    rng = np.random.default_rng(8)
    pts = np.concatenate([rng.uniform([-80, -180, -80, -180], [80, 180, 80, 180], size=(40, 4)),
                          [[0.0, 0.0, 0.0, 1.0], [10.0, 20.0, 10.0, 20.0], [0.0, 0.0, 0.5, 179.7],
                           [19.4, -155.3, 19.5, -155.2]]])
    for lat1, lon1, lat2, lon2 in pts:
        got = pgeo.gps2dist_azimuth(lat1, lon1, lat2, lon2)
        want = jgeo.gps2dist_azimuth(lat1, lon1, lat2, lon2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_obspy_converters_match_jax(monkeypatch):
    """``from_obspy`` on obspy-shaped fakes, ``to_obspy`` through a stubbed
    obspy module (the way ``tests/test_io.py`` drives the JAX pair)."""
    class FakeUTC:
        def __init__(self, ts):
            self.timestamp = float(ts)

    fakes = [types.SimpleNamespace(
        data=np.random.default_rng(0).normal(size=500).astype(np.float32),
        stats=types.SimpleNamespace(network="XX", station="AAA", location="00", channel=f"HH{c}",
                                    sampling_rate=100.0, starttime=FakeUTC(1.7e9 + 0.25)))
        for c in "ZNE"]
    got, want = pinterop.from_obspy(fakes), jinterop.from_obspy(fakes)
    _same(got, want)

    stub = types.ModuleType("obspy")
    stub.UTCDateTime = FakeUTC
    stub.Trace = lambda data=None, header=None: types.SimpleNamespace(
        data=data, stats=types.SimpleNamespace(**header))
    stub.Stream = list
    monkeypatch.setitem(sys.modules, "obspy", stub)
    back = pinterop.to_obspy(got)
    jback = jinterop.to_obspy(want)
    _same(pinterop.from_obspy(back), jinterop.from_obspy(jback))


PIN = 2e-5  # the PhaseNet forward pin of the port against JAX
GRID = np.round(np.arange(0.05, 0.951, 0.01), 2)


def _clears(curves, thr) -> bool:
    """Every curve sample lies more than 10x the pin from thr and thr / 2,
    and each trigger's highest sample leads its second by more than 2x the
    pin (the rule of ``tests/test_torch_eval.py``), so that no trigger and no
    peak moves between packages."""
    t1 = np.float32(thr)
    t2 = t1 / np.float32(2)
    for row in curves:
        if min(np.abs(row - t1).min(), np.abs(row - t2).min()) <= 10 * PIN:
            return False
        for on, off in trigger_onset_numpy(row, t1, t2):
            top = np.sort(row[on: off + 1])[::-1]
            if len(top) > 1 and top[0] - top[1] <= 2 * PIN:
                return False
    return True


def test_pick_command_writes_the_jax_csv(tmp_path, monkeypatch, capsys):
    import volpick_tpu.__main__ as jcli
    import volpick_tpu_torch.__main__ as pcli
    from volpick_tpu.models import from_pretrained as jax_from_pretrained
    from volpick_tpu.picker.annotate import WaveformPicker as JaxPicker

    stream = _eqt_stream(np.random.default_rng(12), 9000)
    files = []
    st1 = pstream.Stream([tr for tr in stream if tr.stats.station == "ST1"])
    pmseed.write_mseed(st1, tmp_path / "st1.mseed")
    files.append(str(tmp_path / "st1.mseed"))
    for tr in stream:
        if tr.stats.station == "ST2":
            path = tmp_path / f"st2.{tr.stats.channel}.sac"
            psac.write_sac(tr, path)
            files.append(str(path))

    model = load_model("phasenet", seed=2, device="cpu")
    picker = WaveformPicker(model, device="cpu")
    arrays = np.stack([g[1] for g in picker._group_arrays(stream)])
    with torch.no_grad():
        stretch_heads(model, picker._condition(torch.as_tensor(arrays[..., 2000:5001])))
    kw = dict(blinding=(500, 500), batch_size=256)
    curves = WaveformPicker(model, device="cpu").annotate_array(arrays, **kw)
    export_pretrained(model, tmp_path / "models", name="probe")
    monkeypatch.setattr(jregistry, "_DEFAULT_SEARCH", [str(tmp_path / "models")])
    jmodel, jparams = jax_from_pretrained("phasenet", "probe")
    jcurves = JaxPicker(jmodel, jparams).annotate_array(arrays, **kw)
    assert np.abs(jcurves - curves).max() < PIN
    # default thresholds: the highest of the grid that both packages' curves
    # clear and that gives a trigger on each phase
    thr = {}
    for k, name in ((0, "P_threshold"), (1, "S_threshold")):
        thr[name] = next(float(t) for t in GRID[::-1]
                         if any(len(trigger_onset_numpy(row, t, t / 2)) for row in curves[:, k])
                         and _clears(curves[:, k], t) and _clears(jcurves[:, k], t))
    export_pretrained(model, tmp_path / "models", name="cli", default_args=thr)
    monkeypatch.setenv("VOLPICK_TPU_MODELS", str(tmp_path / "models"))

    common = [*files, "--model", "phasenet", "--weights", "cli"]
    pcli.main(["pick", *common, "--device", "cpu", "--output", str(tmp_path / "p.csv")])
    jcli.main(["pick", *common, "--output", str(tmp_path / "j.csv")])
    rows = Path(tmp_path / "p.csv").read_text().splitlines()
    assert rows == Path(tmp_path / "j.csv").read_text().splitlines()
    assert len(rows) > 2 and {r.split(",")[1] for r in rows[1:]} == {"P", "S"}
    out = capsys.readouterr().out.splitlines()
    assert out.count(f"{len(rows) - 1} picks -> {tmp_path / 'p.csv'}") == 1
