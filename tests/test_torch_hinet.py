"""The port's ``acquisition/hinet.py`` and ``acquisition/hinet_net.py``
against the JAX package's (``tests/test_hinet_net.py``, ``tests/test_win32.py``
and the Hi-net cases of ``tests/test_parallel_misc.py`` the templates).

- request windows, the HinetPy-less downloader's refusal, trace names;
- the WIN32 event directories → miniSEED conversion: the same log and the
  same miniSEED bytes, with every error branch;
- the wire format, the box and circle geometry, the event selection, the
  fake-wire download loop (directories, extracted files, the event log), the
  unified-catalog download and its check, the zip extraction.
"""

import io
import zipfile
from datetime import date, datetime

import numpy as np
import pandas as pd
import pytest

import test_hinet_net as ref_net
from volpick_tpu.acquisition import hinet as jhin
from volpick_tpu.acquisition import hinet_net as jnet
from volpick_tpu.core.stream import Stream as JStream
from volpick_tpu.core.stream import Trace as JTrace
from volpick_tpu.core.stream import UTC as JUTC
from volpick_tpu.io.win32 import write_win32
from volpick_tpu_torch.acquisition import hinet as phin
from volpick_tpu_torch.acquisition import hinet_net as pnet


def test_request_windows_downloader_and_names_equal(tmp_path):
    df = pd.DataFrame({
        "source_id": ["e1", "e1", "e2", "e3", "e4"],
        "source_origin_time": ["2020-01-01T00:00:00"] * 2 + ["2020-01-02T00:00:00", None,
                                                            "2020-01-03T00:00:00"],
        "trace_p_arrival_time": ["2020-01-01T00:00:10", "2020-01-01T00:00:12", "2020-01-02T00:00:05", None,
                                 "2020-01-03T00:09:00"],
        "trace_s_arrival_time": ["2020-01-01T00:00:20", None, None, None, "2020-01-03T00:12:30"],
    })
    for kw in ({}, {"pre_event_s": 10.0, "post_event_s": 30.0, "max_span_minutes": 2}):
        got, want = phin.event_request_windows(df, **kw), jhin.event_request_windows(df, **kw)
        assert [(r.event_id, r.starttime.timestamp, r.span_minutes) for r in got] == \
               [(r.event_id, r.starttime.timestamp, r.span_minutes) for r in want]
    assert [r.span_minutes for r in phin.event_request_windows(df) if r.event_id == "e4"] == [5, 5, 5, 1]
    errors = []
    for mod in (jhin, phin):
        with pytest.raises(ImportError) as e:
            mod.HinetDownloader("user", "pass", tmp_path)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    for row in df.assign(trace_name=["named", None, np.nan, "x", None]).itertuples():
        assert phin._trace_name(row, "N") == jhin._trace_name(row, "N")


def _event_dir(path, t0, stations, seconds=180, seed=0):
    """A Hi-net event directory (WIN32 archive + channel table) written by
    the JAX package's writer, as in ``tests/test_win32.py``."""
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    trs, ids, lines = [], {}, []
    for s, sta in enumerate(stations):
        for k, comp in enumerate(("U", "N", "E")):
            steps = rng.integers(-4, 5, seconds * 100).astype(np.int64)
            steps[8000:8200] += rng.integers(-300, 300, 200)
            tr = JTrace(np.cumsum(steps).astype(np.float64),
                        dict(network="N", station=sta, location="", channel=f"{comp}{s}",
                             sampling_rate=100.0, starttime=JUTC(t0)))
            trs.append(tr)
            ids[tr.id] = 0x200 + 3 * s + k
            lines.append(f"{0x200 + 3 * s + k:04X} 1 0 {sta} {comp} 1 27 1.0 m/s 1.0 0.7 0.0 1.0")
    write_win32(JStream(trs), path / "data.cnt", chan_ids=ids)
    (path / "table.ch").write_text("\n".join(lines))


def test_win32_event_dirs_equal(tmp_path):
    """Two events, a station missing from the archive, a row whose picks lie
    outside the data (empty after the trim), an event without a directory,
    a directory with a broken archive beside a good one: the same log and
    the same files in both packages."""
    t0 = 1_577_836_800.0
    rows = []
    for i, stations in enumerate((("VOLA", "VOLB"), ("VOLA",))):
        evid = f"JMA202001{i:02d}"
        for root in ("jax", "port"):
            _event_dir(tmp_path / root / evid, t0 + i * 3600, stations, seed=i)
        for sta in stations + ("NONE",):
            rows.append({"source_id": evid, "station_code": sta,
                         "trace_p_arrival_time": JUTC(t0 + i * 3600 + 80.0).isoformat(),
                         "trace_s_arrival_time": JUTC(t0 + i * 3600 + 84.0).isoformat(),
                         "trace_name": f"{evid}_N.{sta}" if sta != "VOLB" else None})
    rows.append({"source_id": "JMA20200100", "station_code": "VOLB",
                 "trace_p_arrival_time": JUTC(t0 + 9000.0).isoformat(), "trace_s_arrival_time": None,
                 "trace_name": "late"})
    rows.append({"source_id": "MISSING", "station_code": "X", "trace_name": "MISSING_N.X"})
    for root in ("jax", "port"):
        (tmp_path / root / "JMA20200101" / "broken.cnt").write_bytes(b"\x00" * 64)
    table = pd.DataFrame(rows)
    for kw in ({}, {"cut_pre_s": 10.0, "cut_post_s": 20.0, "component_rename": {"N": "1", "E": "2"}}):
        jlog = jhin.convert_win32_event_dirs(tmp_path / "jax", table, **kw)
        plog = phin.convert_win32_event_dirs(tmp_path / "port", table, **kw)
        pd.testing.assert_frame_equal(plog, jlog)
        assert sorted(plog["error"].unique()) == ["", "EmptyAfterTrim", "NoEventDirectory", "NoStationData"]
        for name in ("win32_convert_log.csv",) + tuple(f"mseed/{n}.mseed" for n in plog.loc[
                plog["error"] == "", "trace_name"]):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_wire_format_and_geometry_equal():
    texts = [
        '[{"origin": "20200101120000", "latitude": 35.1, "longitude": 139.2, "depth": 12.5,'
        ' "magnitude": 4.2, "name": "CHIBA"}, {"origin": "20200101130000", "latitude": 36.0,'
        ' "longitude": 140.0, "depth": 5.0, "magnitude": null}, {"origin": 20200101140000,'
        ' "latitude": 36, "longitude": 140, "depth": 5, "magnitude": "-"}]',
        "origin,lat,lon,depth,mag\n20200101120000,35.1,139.2,12.5,4.2,CHIBA\n\n"
        "20200101130000,36.0,140.0,5.0,-\n20200101140000,36.0,140.0,5.0\n20200101150000,36,140,5, \n",
        "", "   \n",
    ]
    for text in texts:
        assert [vars(e) for e in pnet.parse_event_rows(text)] == [vars(e) for e in jnet.parse_event_rows(text)]
    assert len(pnet.parse_event_rows(texts[1])) == 3
    for v in (None, "", "-", " 3.5 ", -99.9, 2):
        assert pnet._parse_mag(v) == jnet._parse_mag(v)
    rng = np.random.default_rng(0)
    for lat, lon, clat, clon in rng.uniform([-90, -180, -90, -180], [90, 180, 90, 180], (200, 4)):
        assert pnet.great_circle_degrees(lat, lon, clat, clon) == jnet.great_circle_degrees(lat, lon, clat, clon)
        for r in ((None, None), (None, 40.0), (20.0, None), (10.0, 90.0)):
            assert pnet.point_inside_circular(lat, lon, clat, clon, *r) == \
                   jnet.point_inside_circular(lat, lon, clat, clon, *r)
        box = dict(minlatitude=min(lat, clat), maxlatitude=max(lat, clat) - 1, minlongitude=clon,
                   maxlongitude=None)
        assert pnet.point_inside_box(lat, lon, **box) == jnet.point_inside_box(lat, lon, **box)
    assert pnet.UNKNOWN_MAGNITUDE == jnet.UNKNOWN_MAGNITUDE
    assert pnet.UrllibWire("u", "p").endpoints == jnet.UrllibWire("u", "p").endpoints
    assert pnet.UrllibWire("u", "p", base_url="http://localhost:1/x/", endpoints={"login": "l"}).endpoints == \
           jnet.UrllibWire("u", "p", base_url="http://localhost:1/x/", endpoints={"login": "l"}).endpoints


def _events(mod):
    ev = lambda origin, **kw: mod.HinetEvent(**dict(dict(origin=origin, latitude=35.0, longitude=139.0,  # noqa: E731
                                                         depth=10.0, magnitude=4.0), **kw))
    return [ev(datetime(2020, 1, 1, 3)), ev(datetime(2020, 1, 1, 12)),
            ev(datetime(2020, 1, 1, 13), magnitude=2.0), ev(datetime(2020, 1, 1, 14), magnitude=mod.UNKNOWN_MAGNITUDE),
            ev(datetime(2020, 1, 1, 15), depth=100.0), ev(datetime(2020, 1, 1, 16), latitude=40.0),
            ev(datetime(2020, 1, 1, 17), latitude=35.9), ev(datetime(2020, 1, 1, 23))]


@pytest.mark.parametrize("kw", [{}, {"minmagnitude": 3.0, "maxmagnitude": 9.9}, {"maxdepth": 50.0, "mindepth": 1.0},
                                {"minlatitude": 34.0, "maxlatitude": 36.0, "minlongitude": 138.0},
                                {"latitude": 35.0, "longitude": 139.0, "maxradius": 0.5},
                                {"latitude": 35.0, "longitude": 139.0, "minradius": 0.5}])
def test_event_selection_equal(kw):
    t0, t1 = datetime(2020, 1, 1, 6), datetime(2020, 1, 1, 18)
    got = pnet.HinetSession.__new__(pnet.HinetSession).select_events(_events(pnet), t0, t1, **kw)
    want = jnet.HinetSession.__new__(jnet.HinetSession).select_events(_events(jnet), t0, t1, **kw)
    assert [vars(e) for e in got] == [vars(e) for e in want]


def test_fake_wire_download_loop_equal(tmp_path):
    """Three events over three days, one failing at the download, one of
    them answered by a page that is not a zip: the same directories, files
    and log in both packages; the extracted directory converts alike."""
    t_ok, t_bad, t_html = datetime(2020, 1, 1, 12), datetime(2020, 1, 2, 6), datetime(2020, 1, 3, 1)
    ts_ok = JUTC(t_ok.strftime("%Y-%m-%dT%H:%M:%S")).timestamp
    blob = ref_net._win32_zip_blob(np.random.default_rng(0), ts_ok)
    rid = {t: t.strftime("%Y%m%d%H%M%S") for t in (t_ok, t_bad, t_html)}
    out = {}
    for name, mod in (("jax", jnet), ("port", pnet)):
        wire = ref_net.FakeWire(
            events_by_day={date(2020, 1, 1): [mod.HinetEvent(t_ok, 35.0, 139.0, 10.0, 4.0)],
                           date(2020, 1, 2): [mod.HinetEvent(t_bad, 35.0, 139.0, 10.0, 4.0)],
                           date(2020, 1, 3): [mod.HinetEvent(t_html, 35.0, 139.0, 10.0, 4.0)]},
            blobs={rid[t_ok]: blob, rid[t_html]: b"<!DOCTYPE html>"}, fail_ids={rid[t_bad]})
        session = mod.HinetSession(wire, tmp_path / name, span_minutes=3)
        dirs = session.get_event_waveform(datetime(2020, 1, 1), datetime(2020, 1, 3, 23), minmagnitude=3.0)
        out[name] = ([d.name for d in dirs], wire.calls)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [rid[t_ok]]
    for f in ("hinet_event_log.csv", f"{rid[t_ok]}/data.cnt", f"{rid[t_ok]}/table.ch"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    log = pd.read_csv(tmp_path / "port" / "hinet_event_log.csv")
    assert log["error"].fillna("").tolist() == ["", "RuntimeError", "BadZipFile"]
    catalog = pd.DataFrame([{"source_id": rid[t_ok], "station_code": "VOLA",
                             "trace_p_arrival_time": JUTC(ts_ok + 60.0).isoformat(),
                             "trace_s_arrival_time": JUTC(ts_ok + 64.0).isoformat()}])
    jlog = jhin.convert_win32_event_dirs(tmp_path / "jax", catalog)
    plog = phin.convert_win32_event_dirs(tmp_path / "port", catalog)
    pd.testing.assert_frame_equal(plog, jlog)
    name = f"mseed/{rid[t_ok]}_N.VOLA.mseed"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_unified_catalog_and_zip_extraction_equal(tmp_path):
    class Wire:
        def __init__(self):
            self.calls = []

        def login(self):
            self.calls.append("login")

        def get_arrivaltime(self, start, span_days):
            self.calls.append(("cat", start, span_days))
            if start.day == 15:
                return b"<!DOCTYPE html>\n<html>error</html>\n"
            return b"one line only\n" if start.day == 22 else b"line1\nline2\n"

    out = {}
    for name, mod in (("jax", jnet), ("port", pnet)):
        t = [0.0]

        def clock(t=t):
            t[0] += 400.0
            return t[0]

        wire = Wire()
        paths = mod.download_jma_unified_catalog(wire, tmp_path / name, datetime(2020, 1, 1),
                                                 datetime(2020, 1, 31), clock=clock)
        (tmp_path / name / "subdir").mkdir()
        bad = mod.check_jma_unified_catalog(tmp_path / name)
        out[name] = ([p.name for p in paths], wire.calls, [p.name for p in bad],
                     [p.read_bytes() for p in paths])
    assert out["port"] == out["jax"]
    assert out["port"][2] == ["cat_20200115_20200121", "cat_20200122_20200128"]

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("event/data.cnt", b"\x01\x02")
        zf.writestr("../../escape.ch", b"table")
        zf.writestr("dir/", b"")
    for name, mod in (("jax", jnet), ("port", pnet)):
        mod._extract_zip(buf.getvalue(), tmp_path / f"zip_{name}")
    assert sorted(p.name for p in (tmp_path / "zip_port").iterdir()) == ["data.cnt", "escape.ch"]
    for f in ("data.cnt", "escape.ch"):
        assert (tmp_path / "zip_port" / f).read_bytes() == (tmp_path / "zip_jax" / f).read_bytes()
