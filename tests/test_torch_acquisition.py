"""The port's ``acquisition/`` catalogs and downloaders against the JAX
package's: the same inputs through both, tables compared with
``pd.testing.assert_frame_equal`` and files byte for byte.

- every module of ``volpick_tpu/acquisition`` has a counterpart at the same
  path in the port whose public top-level names cover the original's;
- ``events`` / ``catalogs``: hypoinverse (AVO), NCEDC and HVO summaries and
  the Y2000 archive, the per-station and per-pick tables, ``save_csv``,
  ``group_picks`` (``tests/test_acquisition.py`` the template);
- ``jma``: the deck parser on every record kind of ``tests/test_jma.py``,
  and the directory reader through its spawn pool against JAX's serial one;
- ``comcat``: the pick merge and ``download_phases`` through a fake client
  (``tests/test_comcat.py``);
- ``download``: the noise table, the retry filter, the log merge and the
  FDSN worker's QC branches through injected fakes
  (``tests/test_fdsn_worker.py``).
"""

import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import test_acquisition as ref_acq
import test_comcat as ref_comcat
import test_fdsn_worker as ref_fdsn
import test_jma as ref_jma
from volpick_tpu.acquisition import catalogs as jcat
from volpick_tpu.acquisition import comcat as jcom
from volpick_tpu.acquisition import download as jdl
from volpick_tpu.acquisition import events as jev
from volpick_tpu.acquisition import jma as jjma
from volpick_tpu.core.stream import UTC as JUTC
from volpick_tpu_torch.acquisition import catalogs as pcat
from volpick_tpu_torch.acquisition import comcat as pcom
from volpick_tpu_torch.acquisition import download as pdl
from volpick_tpu_torch.acquisition import events as pev
from volpick_tpu_torch.acquisition import jma as pjma
from volpick_tpu_torch.core.stream import UTC as PUTC

REPO = Path(__file__).resolve().parents[1]
MODULES = ["__init__", "events", "catalogs", "jma", "comcat", "download", "convert", "sac_convert",
           "hinet", "hinet_net"]
# private functions that other modules or the spawn workers reach by name
PRIVATE = {"download": ["_download_worker", "_phase_in_gap", "_chunk_indices"],
           "sac_convert": ["_convert_worker"], "jma": ["_read_one"], "hinet": ["_trace_name"],
           "hinet_net": ["_extract_zip", "_parse_mag"],
           "convert": ["_frequency_index_numpy", "_snr_db_numpy"]}


def _module(package: str, name: str):
    return importlib.import_module(package if name == "__init__" else f"{package}.{name}")


def _public(mod) -> set:
    return {k for k, v in vars(mod).items() if not k.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("name", MODULES)
def test_public_names_cover_the_reference(name):
    jmod, pmod = _module("volpick_tpu.acquisition", name), _module("volpick_tpu_torch.acquisition", name)
    missing = _public(jmod) - _public(pmod)
    assert not missing, f"{name}: the port lacks {sorted(missing)}"
    for fn in PRIVATE.get(name, []):
        assert callable(getattr(pmod, fn)), fn
    if name == "__init__":
        assert pmod.__all__ == jmod.__all__
    # the port's own objects, not the JAX package's
    for k in _public(pmod):
        mod_of = getattr(getattr(pmod, k), "__module__", "") or ""
        assert not mod_of.startswith("volpick_tpu."), (name, k, mod_of)


def test_acquisition_loads_without_torch():
    """In a fresh interpreter, the ten modules and what their spawn workers
    and writers import load neither torch nor JAX: a worker starts a new
    interpreter, and torch there costs seconds and buys nothing."""
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module('volpick_tpu_torch.acquisition' + ('' if name == '__init__' else '.' + name))\n"
        "import volpick_tpu_torch.io.miniseed, volpick_tpu_torch.io.win32, volpick_tpu_torch.io.stationxml\n"
        "import volpick_tpu_torch.data.writer, volpick_tpu_torch.core.geo, volpick_tpu_torch.core.rotate\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'volpick_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    # io/_native.py names the kernels' build directory itself, to load without torch
    from volpick_tpu_torch.io import _native
    from volpick_tpu_torch.ops.cuda import _build

    assert _native.BUILD_DIR == _build.BUILD_DIR


# ------------------------------------------------------------------ helpers
def _catalog_rows(cat) -> list:
    """Every field of a Catalog of either package as plain values."""
    out = []
    for ev in cat.events:
        o, m = ev.origin, ev.magnitude
        out.append((ev.event_id, o.time.timestamp, o.latitude, o.longitude, o.depth_km,
                    o.horizontal_error_km, o.vertical_error_km, m.mag, m.magnitude_type, ev.source_type,
                    [(p.network, p.station, p.location, p.channel, p.time.timestamp, p.phase, p.weight,
                      p.first_motion, p.station_id) for p in ev.picks]))
    return out


def _same_catalogs(jc, pc, tmp_path=None):
    assert len(jc) == len(pc)
    assert _catalog_rows(jc) == _catalog_rows(pc)
    for by_station in (True, False):
        pd.testing.assert_frame_equal(jc.to_dataframe(by_station=by_station),
                                      pc.to_dataframe(by_station=by_station))
    if tmp_path is not None:
        jc.save_csv(tmp_path / "j.csv")
        pc.save_csv(tmp_path / "p.csv")
        assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "p.csv").read_bytes()


def _pad(s, n):
    return (s + " " * n)[:n]


def _hvo_summary_line(event_id, etype="lp", mag=1.3, mag_type="d", time="2019/05/06 07:08:09.12",
                      lat=19.4, lon=-155.28, dep=2.5):
    """One HVO legacy summary line at the reader's columns (`catalogs.py`)."""
    line = _pad(time, 26) + _pad(f"{lat:9.4f}", 9) + _pad(f"{lon:11.4f}", 11) + _pad(f"{dep:7.2f}", 7)
    line = _pad(line, 117) + _pad(f"{mag:5.2f}", 5)
    line = _pad(line, 124) + _pad(mag_type, 3)
    line = _pad(line, 131) + _pad(event_id, 9)
    return _pad(line, 151) + etype


# ------------------------------------------------------- events / catalogs
def test_hypoinverse_summary_and_catalog_equal(hypo_files, tmp_path):
    archive, summary = hypo_files
    assert pcat.read_hypoinverse_summary(summary) == jcat.read_hypoinverse_summary(summary)
    assert pcat.read_hypoinverse_summary(summary, "av") == jcat.read_hypoinverse_summary(summary, "av")
    for kw in ({}, {"n_events": 1}, {"id_prefix": ""},
               {"min_date": "2020-01-02T03:30:00"}, {"max_date": "2020-01-02T03:30:00"}):
        pkw = {k: PUTC(v) if k.endswith("date") else v for k, v in kw.items()}
        jkw = {k: JUTC(v) if k.endswith("date") else v for k, v in kw.items()}
        _same_catalogs(jcat.read_hypoinverse_catalog(archive, summary, **jkw),
                       pcat.read_hypoinverse_catalog(archive, summary, **pkw), tmp_path)


@pytest.fixture
def hypo_files(tmp_path):
    """The JAX test's archive + summary pair with a third event whose
    archive summary line leaves the origin blank (the summary-file fallback)
    and a station line with a zero-weight P and a D first motion."""
    summary = tmp_path / "summary.txt"
    with open(summary, "w") as f:
        f.write("header1\nheader2\n")
        f.write(ref_acq.make_summary_line("1001", etype="lp") + "\n")
        f.write(ref_acq.make_summary_line("1002", etype="vt", mag=2.5) + "\n")
        f.write(ref_acq.make_summary_line("1003", etype="lp", mag=0.4) + "\n")
        f.write("\n")
    archive = tmp_path / "archive.arc"
    with open(archive, "w") as f:
        f.write(ref_acq.make_archive_summary_line("1001") + "\n")
        f.write(ref_acq.make_station_line(sta="AAAA", p_sec=7.89, s_sec=9.5) + "\n")
        f.write(ref_acq.make_station_line(sta="AAAA", cha="BHN", p_sec=None, s_sec=9.7, s_weight=1.0) + "\n")
        f.write(ref_acq.make_station_line(sta="BBBB", p_sec=8.1, s_sec=None) + "\n")
        f.write(ref_acq.make_terminator("1001") + "\n")
        f.write(ref_acq.make_archive_summary_line("1002", hh=4) + "\n")
        f.write(ref_acq.make_station_line(sta="CCCC", p_sec=3.0, s_sec=5.0, first_motion="D") + "\n")
        f.write(ref_acq.make_station_line(sta="DDDD", p_sec=3.5, p_weight=0.0, s_sec=None) + "\n")
        f.write(ref_acq.make_terminator("1002") + "\n")
        blank = " " * 16 + ref_acq.make_archive_summary_line("1003", hh=5)[16:]
        f.write(blank + "\n")
        f.write(ref_acq.make_station_line(sta="EEEE", hh=5, p_sec=1.0, s_sec=2.0) + "\n")
        f.write(ref_acq.make_terminator("1003") + "\n")
        f.write(ref_acq.make_archive_summary_line("9999") + "\n")  # not in the summary: skipped
        f.write(ref_acq.make_station_line(sta="FFFF", p_sec=1.0) + "\n")
        f.write(ref_acq.make_terminator("9999") + "\n")
    return archive, summary


def test_ncedc_and_hvo_summaries_equal(tmp_path, hypo_files):
    ncedc = tmp_path / "ncedc.csv"
    ncedc.write_text("# NCEDC export\nEventID, DateTime, Latitude, Longitude, Depth, Magnitude, MagType\n"
                     "1001,2020/01/02 03:04:05.60,61.2345,-152.1234,3.21,1.5,Md\n"
                     "1002,2020/01/02 04:04:05.60,61.3,-152.2,4.0,2.5,ML\n")
    assert pcat.read_ncedc_summary(ncedc, "nc", etype="vt") == jcat.read_ncedc_summary(ncedc, "nc", etype="vt")
    hvo = tmp_path / "hvo.txt"
    hvo.write_text("h1\nh2\n" + _hvo_summary_line("1001") + "\n" + _hvo_summary_line("1002", mag_type="Unk")
                   + "\n\n")
    got, want = pcat.read_hvo_summary(hvo, "hv"), jcat.read_hvo_summary(hvo, "hv")
    assert got == want and got["hv1002"][2] is None
    archive, _ = hypo_files
    for fmt, path in (("ncedc", ncedc), ("hvo", hvo)):
        _same_catalogs(jcat.read_hypoinverse_catalog(archive, path, summary_format=fmt, etype="vt"),
                       pcat.read_hypoinverse_catalog(archive, path, summary_format=fmt, etype="vt"), tmp_path)


def test_catalog_weighting_and_group_picks_equal(tmp_path):
    def build(m):
        t0 = m.UTC("2020-01-01T00:00:00")
        picks = [m.PhasePick("AV", "STA1", "", "BHZ", t0 + 10.0, "P", weight=1.0, first_motion="U"),
                 m.PhasePick("AV", "STA1", "", "BHN", t0 + 12.0, "P", weight=3.0),
                 m.PhasePick("AV", "STA1", "", "BHE", t0 + 15.0, "S", weight=0.5),
                 m.PhasePick("AV", "STA2", "01", "EHZ", t0 + 11.0, "P", weight=0.0),
                 m.PhasePick("AV", "STA3", "", "", t0 + 13.0, "S", weight=2.0)]
        evs = [m.Event("e1", m.Origin(t0, 60.0, -150.0, 5.0, 0.5, None), m.Magnitude(1.0, "ml"), "vt", picks),
               m.Event("e2", m.Origin(t0 + 99.0, 61.0, -151.0, 2.0), m.Magnitude(0.2), "lp", picks[:1])]
        cat = m.Catalog()
        for ev in evs:
            cat.append(ev)
        return cat

    class J:  # the JAX package's names
        UTC = JUTC
        PhasePick, Event, Origin, Magnitude, Catalog = jev.PhasePick, jev.Event, jev.Origin, jev.Magnitude, jev.Catalog

    class P:
        UTC = PUTC
        PhasePick, Event, Origin, Magnitude, Catalog = pev.PhasePick, pev.Event, pev.Origin, pev.Magnitude, pev.Catalog

    jc, pc = build(J), build(P)
    assert [ev.event_id for ev in pc] == ["e1", "e2"]
    _same_catalogs(jc, pc, tmp_path)
    df = pd.DataFrame({"network": ["AV"] * 5 + ["HV"], "station": ["A", "A", "A", "B", "B", "C"],
                       "location": [""] * 6, "phase": ["P", "P", "S", "P", "P", "S"],
                       "time": [f"2020-01-01T00:00:{s:02d}" for s in (10, 12, 15, 11, 13, 20)],
                       "weight": [1.0, 3.0, 0.5, 0.0, 0.0, 2.0]})
    pd.testing.assert_frame_equal(pcat.group_picks(df), jcat.group_picks(df))
    renamed = df.rename(columns={"time": "t", "weight": "w", "phase": "ph"})
    pd.testing.assert_frame_equal(
        pcat.group_picks(renamed, time_col="t", weight_col="w", phase_col="ph"),
        jcat.group_picks(renamed, time_col="t", weight_col="w", phase_col="ph"))


# --------------------------------------------------------------------- jma
def _deck(path, blocks):
    with open(path, "w") as fh:
        for hypo, arrivals in blocks:
            fh.write(hypo + "\n")
            for a in arrivals:
                fh.write(a + "\n")
            fh.write("E\n")


def _deck_blocks():
    h, a = ref_jma.make_hypo_line, ref_jma.make_arrival_line
    line = h()
    blank_hour = a()[:19] + "  " + a()[21:]
    second_m = a()[:27] + _pad("M", 4) + a()[31:]
    unknown_first = a()[:15] + _pad("X", 4) + a()[19:]
    return [
        (h(), [a(), a(sta="KUSA", p_sec=2.5, s_sec=6.75)]),
        (line[:52] + "A5" + line[54:], [a()]),                 # negative magnitude
        (line[:44] + "  7  " + line[49:], [a()]),              # integer-km depth
        (h(etype="9"), [a()]),                                 # unknown type: skipped
        (h(), [blank_hour, a(sta="GOOD")]),                    # bad arrival time
        (h(), [second_m, unknown_first]),                      # unknown phases
        (line[:21] + " " * 11 + line[32:], [a()]),             # empty location
        (line[:1] + "2019031X" + line[9:], [a()]),             # bad origin time
        (h(hh=23, month=4), [a(mon="04", p_hr=23)]),
    ]


@pytest.mark.parametrize("kw", [{}, {"id_prefix": "jma", "n_events": 3}, {"skip_unknown_type": False},
                                {"min_date": "2019-03-20T00:00:00"}, {"max_date": "2019-03-20T00:00:00"}])
def test_jma_catalog_equal(tmp_path, kw):
    f = tmp_path / "deck.txt"
    _deck(f, _deck_blocks())
    pkw = {k: PUTC(v) if k.endswith("date") else v for k, v in kw.items()}
    jkw = {k: JUTC(v) if k.endswith("date") else v for k, v in kw.items()}
    (jc, jskip), (pc, pskip) = jjma.read_jma_catalog(f, **jkw), pjma.read_jma_catalog(f, **pkw)
    assert pskip == jskip
    _same_catalogs(jc, pc, tmp_path)
    if not kw:
        assert len(pc) == 6 and {s["remark"] for s in pskip} >= {
            "unknown event type", "bad arrival time", "empty location", "bad origin time", "unknown phase M"}


def test_jma_catalog_dir_spawn_pool_equals_reference(tmp_path):
    """The port's spawn pool (two children that import the port alone) gives
    JAX's serial result, in file-name order."""
    d = tmp_path / "decks"
    d.mkdir()
    for m in (3, 1, 2):
        _deck(d / f"d2019{m:02d}", [(ref_jma.make_hypo_line(month=m), [ref_jma.make_arrival_line(mon=f"{m:02d}")])])
    jc, jskip = jjma.read_jma_catalog_dir(d, id_prefix="jma")
    pc, pskip = pjma.read_jma_catalog_dir(d, id_prefix="jma", num_processes=2)
    assert pskip == jskip
    _same_catalogs(jc, pc)
    assert [ev.origin.time.datetime.month for ev in pc.events] == [1, 2, 3]
    files = sorted(d.iterdir(), reverse=True)
    _same_catalogs(jjma.read_jma_catalog_dir(files)[0], pjma.read_jma_catalog_dir(files)[0])


# ------------------------------------------------------------------ comcat
def _phase_tables():
    pf = ref_comcat.phase_frame
    t = "2020-02-03T04:05:"
    return {
        "uw100": pf([("UW.AAA.EHZ.", "Pn", t + "16", "manual", 1.0),
                     ("UW.AAA.EHZ.", "Sg", t + "20", "manual", 1.0),
                     ("UW.AAA.EHN.", "P", t + "18", "manual", 3.0),
                     ("CC.BBB.BHZ.01", "P", t + "17", "automatic", 0.5),
                     ("CC.BBB.BHZ.01", "Amp", t + "17", "automatic", 0.5)]),
        "uw101": pf([("UW.CCC.HHZ.", "P", t + "18", "manual", 2.0),
                     ("UW.CCC.HHZ.", "P", t + "19", "manual", np.nan),
                     ("UW.DDD.HHZ.", "S", t + "22", "manual", np.nan),
                     ("UW.EEE.HHZ.", "P", t + "10", "manual", 0.0),
                     ("UW.EEE.HHZ.", "P", t + "12", "manual", 0.0)]),
    }


def test_group_comcat_picks_equal():
    for table in _phase_tables().values():
        got, want = pcom.group_comcat_picks(table), jcom.group_comcat_picks(table)
        assert list(got) == list(want)
        pd.testing.assert_frame_equal(pd.DataFrame(got), pd.DataFrame(want))


def test_download_phases_and_pnsn_equal(tmp_path):
    ids = ["uw100", "uw101", "uw102", "uw103"]
    frames = {}
    for name, mod in (("jax", jcom), ("port", pcom)):
        client = ref_comcat.FakeClient(_phase_tables(), missing={"uw102"}, no_arrivals={"uw103"})
        frames[name] = mod.download_phases(ref_comcat.summary(ids), client, tmp_path / name, csv_name="ph.csv")
        assert client.calls == ids
    pd.testing.assert_frame_equal(frames["port"], frames["jax"])
    assert len(frames["port"]) == 5
    for f in ("ph.csv", "events_without_picks.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    (tmp_path / "pnsn.csv").write_text(
        "Evid,Magnitude,Magnitude Type,Epoch(UTC),Time UTC,Time Local,Distance From,Lat,Lon,Depth Km,Depth Mi\n"
        "61569752,1.2,l,1581724619.6,2020/02/14 23:56:59,,\"x\",46.2,-122.18,1.5,0.9\n"
        "61569753,0.4,d,1581724719.6,2020/02/14 23:58:39,,\"y\",46.3,-122.1,-0.5,-0.3\n")
    for kw in ({}, {"id_prefix": "cc"}):
        pd.testing.assert_frame_equal(pcom.read_PNSN_events(tmp_path / "pnsn.csv", "lp", **kw),
                                      jcom.read_PNSN_events(tmp_path / "pnsn.csv", "lp", **kw))


# ---------------------------------------------------------------- download
def _noise_catalog(n_stations=3):
    rows = []
    base = JUTC("2020-01-01T00:00:00").timestamp
    for k in range(n_stations):
        t = base + 1000.0 * k
        for gap in (3600 * 48, 3600 * 2, 3600 * 30, 3600 * 26, 0):
            rows.append({"station_network_code": "AV", "station_code": f"ST{k}", "station_location_code": "",
                         "trace_channel": "BH", "source_origin_time": JUTC(t).isoformat(),
                         "trace_p_arrival_time": JUTC(t + 5).isoformat() if gap != 3600 * 26 else None,
                         "trace_s_arrival_time": JUTC(t + 9 - 20 * (gap == 3600 * 30)).isoformat()})
            t += gap + 700
    return pd.DataFrame(rows)


@pytest.mark.parametrize("kw", [{}, {"number_stations": 2, "seed": 3},
                                {"number_records_each_station": 1, "time_difference_limit": 3600.0}])
def test_noise_table_equal(kw):
    cat = _noise_catalog()
    pd.testing.assert_frame_equal(pdl.create_noise_table(cat, **kw), jdl.create_noise_table(cat, **kw))
    for row in cat.to_dict("records"):
        assert pdl.conservative_event_end(row) == jdl.conservative_event_end(row)
    # an empty catalog: both packages fail alike in pandas' row-wise join
    for mod in (jdl, pdl):
        with pytest.raises(ValueError, match="multiple columns"):
            mod.create_noise_table(cat.iloc[:0])


def test_retry_filter_and_log_merge_equal(tmp_path):
    log = pd.DataFrame({"trace_name": list("abcdef"),
                        "error": ["FDSNNoDataException", "ConnectionError", "", "Timeout", np.nan, " None "]})
    for kw in ({}, {"exclude_errors": ("Timeout",)}):
        pd.testing.assert_frame_equal(pdl.filter_failed_downloads(log, **kw), jdl.filter_failed_downloads(log, **kw))
    assert pdl.assemble_subprocess_csvlogs(tmp_path, "nothing_p*.csv", "x.csv") is None
    merged = {}
    for name, mod in (("jax", jdl), ("port", pdl)):
        d = tmp_path / name
        d.mkdir()
        for pid in (1, 0):
            log.iloc[3 * pid: 3 * pid + 3].to_csv(d / f"download_log_p{pid}.csv", index=False)
        merged[name] = mod.assemble_subprocess_csvlogs(d, "download_log_p*.csv", "download_log.csv",
                                                       delete=name == "port")
        assert (d / "download_log_p0.csv").exists() == (name == "jax")
    pd.testing.assert_frame_equal(merged["port"], merged["jax"])
    assert (tmp_path / "port" / "download_log.csv").read_bytes() == (tmp_path / "jax" / "download_log.csv").read_bytes()
    for n, k in ((10, 3), (2, 4), (0, 2)):
        assert [c.tolist() for c in pdl._chunk_indices(n, k)] == [c.tolist() for c in jdl._chunk_indices(n, k)]


def _fdsn_rows():
    T0, row = ref_fdsn.T0, ref_fdsn.catalog_row
    return [row("ok_AV.STA", "STA", p=T0 + 40, s=T0 + 44, origin=T0),
            row("ps_AV.STA", "STA", p=T0 + 44, s=T0 + 40, origin=T0),
            row("po_AV.STA", "STA", p=T0 + 10, s=T0 + 20, origin=T0 + 15),
            row("gap_AV.GAP", "GAP", p=T0 + 40, s=T0 + 50, origin=T0),
            row("out_AV.SHORT", "SHORT", p=T0 + 40, s=T0 + 90, origin=T0),
            row("no_AV.NOPE", "NOPE", p=T0 + 40, origin=T0),
            row("sonly_AV.STA", "STA", s=T0 + 44),
            row("none_AV.STA", "STA")]


def test_fdsn_worker_equal(tmp_path):
    """Every QC branch of the worker, with provider failover, through the
    JAX test's fakes: the same log and the same streams handed to the writer."""
    T0 = ref_fdsn.T0
    streams = {"STA": ref_fdsn.make_stream("STA", T0),
               "GAP": ref_fdsn.make_stream("GAP", T0, gap=(T0 + 35, T0 + 45)),
               "SHORT": ref_fdsn.make_stream("SHORT", T0, npts=6000)}
    out = {}
    for name, mod in (("jax", jdl), ("port", pdl)):
        d = tmp_path / name
        (d / "mseed").mkdir(parents=True)
        written, calls = {}, []

        def factory(provider, calls=calls):
            calls.append(provider)
            return ref_fdsn.FakeClient(provider, streams={} if provider == "BAD" else streams)

        mod._download_worker(pd.DataFrame(_fdsn_rows()), str(d), ["BAD", "GOOD"], 120.0, None, 0,
                             client_factory=factory,
                             stream_writer=lambda st, f, w=written: w.update({f.name: st}), time_cls=float)
        out[name] = ((d / "download_log_p0.csv").read_bytes(), sorted(written), calls)
    assert out["port"] == out["jax"]
    log = pd.read_csv(tmp_path / "port" / "download_log_p0.csv")["error"].fillna("").tolist()
    assert log == ["", "P_after_S", "P_before_origin", "", "phases_in_gap", "FakeFDSNException", "",
                   "ValueError"]


def test_phase_in_gap_equal():
    T0 = ref_fdsn.T0
    st = ref_fdsn.make_stream("STA", T0, npts=6000, gap=(T0 + 20, T0 + 30))
    z_only = type(st)([tr for tr in st if tr.stats.channel == "BHZ"])
    for stream in (st, z_only, type(st)()):
        for arrivals in ([], [T0 + 25], [T0 - 1], [T0 + 10, T0 + 70], [T0 + 59.99]):
            assert pdl._phase_in_gap(stream, arrivals) == jdl._phase_in_gap(stream, arrivals)
    assert pdl._phase_in_gap(z_only, [T0 + 25]) and not pdl._phase_in_gap(z_only, [T0 + 10])


def test_download_waveforms_fdsn_without_obspy_equal(tmp_path):
    """Both packages refuse the live path alike where obspy is absent (and
    run an empty table alike where it is present)."""
    outcome = {}
    for name, mod in (("jax", jdl), ("port", pdl)):
        try:
            outcome[name] = mod.download_waveforms_fdsn(_noise_catalog().iloc[:0], tmp_path / name)
        except ImportError as e:
            outcome[name] = ("ImportError", str(e))
    assert outcome["port"] == outcome["jax"]
