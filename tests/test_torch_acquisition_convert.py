"""The port's ``acquisition/convert.py`` and ``acquisition/sac_convert.py``
against the JAX package's.

- ``stream_to_array`` and ``trace_has_spikes``: exactly equal;
- the three dataset writers (``convert_catalog_to_dataset``,
  ``extract_noise_from_dataset``, ``convert_from_old_format``): equal
  metadata CSV text, and waveforms read back through the port's
  ``WaveformDataset`` equal, the split column equal for a seed (and, with no
  seed, for the same global numpy state);
- the SAC converter: miniSEED bytes equal and logs equal, the port through
  its spawn workers;
- the two faults of JAX's ``sac_convert.py`` that the port repairs, JAX's
  behaviour beside the port's: the sidecar found by replacing every ``sac``
  in the path, and the log of a worker that converted nothing.
"""

import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import test_oldformat as ref_old
from volpick_tpu.acquisition import convert as jconv
from volpick_tpu.acquisition import sac_convert as jsac
from volpick_tpu.core import sacio as jsacio
from volpick_tpu.core.stream import Stream as JStream
from volpick_tpu.core.stream import Trace as JTrace
from volpick_tpu.core.stream import UTC as JUTC
from volpick_tpu.data import WaveformDataset as JaxDataset
from volpick_tpu_torch.acquisition import convert as pconv
from volpick_tpu_torch.acquisition import sac_convert as psac
from volpick_tpu_torch.core.stream import Stream as PStream
from volpick_tpu_torch.core.stream import Trace as PTrace
from volpick_tpu_torch.core.stream import UTC as PUTC
from volpick_tpu_torch.data.dataset import WaveformDataset

T0 = "2021-05-01T10:00:00"


def _streams(seed, n=6000, parts=None):
    """A 3-component stream in both packages' types: noise, an 8 Hz burst at
    30 s; `parts` cuts the N trace into pieces (gaps between them)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 100.0
    data = rng.normal(size=(3, n)) * 0.1
    data[0] += np.sin(2 * np.pi * 8 * t) * np.exp(-((t - 30.0) ** 2)) * 3
    out = []
    for Stream, Trace, UTC in ((JStream, JTrace, JUTC), (PStream, PTrace, PUTC)):
        t0 = UTC(T0)
        trs = []
        for i, c in enumerate("ZNE"):
            hdr = dict(network="AV", station="TST", channel=f"BH{c}", sampling_rate=100.0, starttime=t0)
            if c == "N" and parts:
                for a, b in parts:
                    trs.append(Trace(data[i, a:b].copy(), dict(hdr, starttime=t0 + a / 100.0)))
            else:
                trs.append(Trace(data[i].copy(), hdr))
        out.append(Stream(trs))
    return out


@pytest.mark.parametrize("parts", [None, [(0, 2500), (3000, 6000)], [(1000, 4000)]])
def test_stream_to_array_and_spikes_equal(parts):
    js, ps = _streams(0, parts=parts)
    for order in ("ZNE", "ZN", "E"):
        (jt, jd, jc), (pt, pd_, pc) = jconv.stream_to_array(js, order), pconv.stream_to_array(ps, order)
        assert pt.timestamp == jt.timestamp and pc == jc
        np.testing.assert_array_equal(pd_, jd)
    for data in (jd, jd * 0, np.where(np.arange(jd.shape[1]) == 77, 1e6, jd)):
        for kw in ({}, {"factor": 5.0, "quantile": 0.5}):
            assert pconv.trace_has_spikes(data, **kw) == jconv.trace_has_spikes(data, **kw)
    with pytest.raises(ValueError):
        pconv.stream_to_array(PStream(), "ZNE")


def _catalog_table(n, with_noise=True):
    rows = []
    for i in range(n):
        t0 = JUTC(T0)
        rows.append({
            "source_id": f"ev{i // 2}", "source_origin_time": (t0 + 1.0).isoformat(),
            "source_latitude_deg": 60.0, "source_longitude_deg": -150.0, "source_depth_km": 4.0,
            "source_magnitude": 1.0, "source_magnitude_type": "ml", "source_type": "lp" if i % 2 else "vt",
            "station_network_code": "AV", "station_code": f"T{i}", "station_location_code": "",
            "trace_channel": "BH",
            "trace_p_arrival_time": (t0 + 30.0).isoformat() if i % 5 != 4 else None,
            "trace_s_arrival_time": (t0 + 33.0).isoformat() if i % 3 != 2 else None,
            "trace_p_max_weight": 1.0, "trace_name": f"ev{i}_AV.T{i}",
        })
        if with_noise and i % 7 == 6:
            rows[-1].update(trace_p_arrival_time=None, trace_s_arrival_time=None, source_type="noise")
    return pd.DataFrame(rows)


def _loaders(n):
    """Per package a loader of `n` streams named `ev<i>_...`: trace 1 with
    gaps, trace 2 twice as long, trace 3 spiky, trace 5 at 50 Hz; an index
    >= n raises."""
    pairs = [_streams(10 + i, n=12000 if i == 2 else 6000, parts=[(0, 2000), (2600, 6000)] if i == 1 else None)
             for i in range(n)]
    for i, pair in enumerate(pairs):
        if i == 3:
            for st in pair:
                st[1].data[1234] = 1e5
        if i == 5:
            for st in pair:
                for tr in st:
                    tr.data = tr.data[::2].copy()
                    tr.stats.sampling_rate = 50.0

    def make(k):
        def load(name):
            i = int(name.split("_")[0][2:])
            if i >= n:
                raise FileNotFoundError(name)
            return pairs[i][k].copy()
        return load

    return make(0), make(1)


def _same_written(jdir, pdir, chunk=""):
    """Equal metadata CSV text; the port's reader gives equal waveforms from
    both directories."""
    assert (pdir / f"metadata{chunk}.csv").read_text() == (jdir / f"metadata{chunk}.csv").read_text()
    jds, pds = WaveformDataset(jdir), WaveformDataset(pdir)
    assert len(jds) == len(pds) > 0
    for i in range(len(pds)):
        np.testing.assert_array_equal(pds.get_waveforms(i), jds.get_waveforms(i))
    return pds


@pytest.mark.parametrize("kw", [
    {"seed": 1},
    {"seed": 5, "check_long_traces": True, "check_long_traces_limit": 40.0, "split_prob": (0.4, 0.3, 0.3)},
    {"seed": 2, "skip_spikes": True, "cut_bounds": 5.0, "n_limit": 6, "chunk": "_c1"},
    {"seed": None},
])
def test_convert_catalog_to_dataset_equal(tmp_path, kw):
    table = _catalog_table(9)
    table.loc[8, "trace_name"] = "ev99_AV.T8"  # the loader fails: logged, skipped
    jload, pload = _loaders(9)
    state = np.random.get_state()
    if kw["seed"] is None:  # both draw from the global state: give it the same start
        np.random.seed(11)
    jconv.convert_catalog_to_dataset(table, jload, tmp_path / "jax", **kw)
    if kw["seed"] is None:
        np.random.seed(11)
    else:
        np.random.set_state(state)
    pconv.convert_catalog_to_dataset(table, pload, tmp_path / "port", **kw)
    if kw["seed"] is not None:  # the port draws from a state of its own
        after = np.random.get_state()
        assert all(np.array_equal(a, b) for a, b in zip(state, after))
    ds = _same_written(tmp_path / "jax", tmp_path / "port", kw.get("chunk", ""))
    md = ds.metadata
    assert len(md) == kw.get("n_limit", 8 - kw.get("skip_spikes", False))
    assert md["split"].isin(["train", "dev", "test"]).all()
    if kw == {"seed": 1}:
        assert md["trace_has_spikes"].sum() == 1 and md["trace_p_arrival_sample"].isna().sum() == 2


def test_extract_noise_from_dataset_equal(tmp_path):
    table = _catalog_table(21)  # three noise rows among them
    jload, pload = _loaders(21)
    jconv.convert_catalog_to_dataset(table, jload, tmp_path / "src", seed=3)
    for name, mod, reader in (("jax", jconv, JaxDataset), ("port", pconv, WaveformDataset)):
        out = mod.extract_noise_from_dataset(reader(tmp_path / "src"), tmp_path / name, n_traces=2, seed=4)
        assert out == tmp_path / name
    assert (tmp_path / "port" / "chunks").read_text() == (tmp_path / "jax" / "chunks").read_text()
    md = _same_written(tmp_path / "jax", tmp_path / "port", "_noise").metadata
    assert len(md) == 2 and (md["source_type"] == "noise").all()


def test_convert_from_old_format_equal(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "old"
    maker = ref_old.TestConvertFromOldFormat()
    maker._make_event_dir(src, "ev001", rng, rotated=True)
    maker._make_event_dir(src, "ev002", rng, rotated=False)
    maker._make_event_dir(src, "ev003", rng, rotated=False)
    (src / "ev003" / "ev003_AV.SPBG.xml").unlink()  # no inventory: left unrotated
    (src / "not_an_event.txt").write_text("ignored")
    for kw in ({"seed": 7}, {"seed": 8, "split_prob": (0.2, 0.3, 0.5), "bucket_size": 2}):
        jconv.convert_from_old_format(src, tmp_path / f"jax{kw['seed']}", **kw)
        pconv.convert_from_old_format(src, tmp_path / f"port{kw['seed']}", **kw)
        md = _same_written(tmp_path / f"jax{kw['seed']}", tmp_path / f"port{kw['seed']}").metadata
        assert len(md) == 3 and md["path_back_azimuth_deg"].notna().all()


# ------------------------------------------------------------------- SAC
def _write_folder(folder, station, seed, upper=False, start="2005-06-07T08:09:10", sidecar=None):
    """Three SAC files of one station (JAX's writer, the port's is a copy),
    with `.pick` sidecars (`.PICK` beside upper-case names) when `sidecar`."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for c in "ZNE":
        tr = JTrace(rng.normal(size=1500).astype(np.float32),
                    dict(network="HV", station=station, channel=f"HH{c}", sampling_rate=100.0,
                         starttime=JUTC(start)))
        stem = f"{station.lower()}_{c.lower()}"
        jsacio.write_sac(tr, folder / (f"{stem}.SAC" if upper else f"{stem}.sac"))
        if sidecar:
            (folder / (f"{stem}.PICK" if upper else f"{stem}.pick")).write_text(
                f"start_time: {sidecar}\nsome_other: 1 2\n")


def test_sidecar_readers_equal(tmp_path):
    d = tmp_path / "plain"
    _write_folder(d, "KIL", 0, sidecar="1999 7 8 9 10 33.25")
    (d / "bad.sac").write_bytes(b"not a SAC file")
    assert psac.read_sidecar_info(d / "kil_z.pick") == jsac.read_sidecar_info(d / "kil_z.pick")
    for off in (0.0, 1.5):
        got, want = psac.read_sac_with_sidecar(d / "kil_z.sac", off), jsac.read_sac_with_sidecar(d / "kil_z.sac", off)
        assert got.stats.starttime.timestamp == want.stats.starttime.timestamp
        assert got.stats.starttime.isoformat().startswith("1999-07-08T09:10:3")
        np.testing.assert_array_equal(got.data, want.data)
    (d / "kil_n.pick").write_text("start_time: 1999 7 8\n")  # too short: the header's time stays
    assert psac.read_sac_with_sidecar(d / "kil_n.sac").stats.starttime.isoformat().startswith("2005-06-07")
    got, want = psac.read_sac_event_folder(d), jsac.read_sac_event_folder(d)
    assert list(got) == list(want) == ["HV.KIL."]
    for a, b in zip(got["HV.KIL."], want["HV.KIL."]):
        assert a.id == b.id and a.stats.starttime.timestamp == b.stats.starttime.timestamp
        np.testing.assert_array_equal(a.data, b.data)
    assert psac.sidecar_path(d / "x.mseed") is None
    assert psac.sidecar_path(d / "x.Sac") == d / "x.pick"


def test_mseed_conversion_equal(tmp_path):
    """Two event folders (one with upper-case names) and a file that is not
    SAC: JAX serially, the port in two spawn workers; the same files, byte for
    byte, and the same merged log."""
    folders = [tmp_path / "events" / "ev001", tmp_path / "events" / "ev002"]
    _write_folder(folders[0], "KIL", 0)
    _write_folder(folders[0], "UWE", 1)
    _write_folder(folders[1], "KIL", 2, upper=True)
    (folders[1] / "broken.SAC").write_bytes(b"broken")
    jlog = jsac.convert_sac_to_mseed(folders, tmp_path / "jax")
    plog = psac.convert_sac_to_mseed(folders, tmp_path / "port", num_processes=2)
    pd.testing.assert_frame_equal(plog, jlog)
    assert len(plog) == 3 and (plog["error"].fillna("") == "").all()
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.mseed"))
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.mseed"))
    assert len(files) == 3
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert (tmp_path / "port" / "convert_log.csv").read_bytes() == (tmp_path / "jax" / "convert_log.csv").read_bytes()


def test_sidecar_fault_repaired(tmp_path):
    """JAX replaces every 'sac' of the path: under a directory named
    `*_sac_*` it looks for the sidecar in `*_pick_*` and keeps the SAC
    header's start time; beside an upper-case `.SAC` it reads the SAC file
    itself as its sidecar and raises. The port swaps the suffix alone."""
    d, u = tmp_path / "hvo_sac_archive" / "ev001", tmp_path / "archive" / "ev002"
    _write_folder(d, "KIL", 0, start="1970-01-01T00:00:00", sidecar="1999 7 8 9 10 33.25")
    _write_folder(u, "UPR", 1, upper=True, start="1970-01-01T00:00:00", sidecar="1999 7 8 9 10 33.25")
    want = JUTC("1999-07-08T09:10:33.25").timestamp
    lower, upper = d / "kil_z.sac", u / "upr_z.SAC"
    assert jsac.read_sac_with_sidecar(lower).stats.starttime.timestamp == 0.0  # sidecar not found
    with pytest.raises(UnicodeDecodeError):
        jsac.read_sac_with_sidecar(upper)
    for path, side in ((lower, d / "kil_z.pick"), (upper, u / "upr_z.PICK")):
        assert psac.sidecar_path(path) == side
        assert psac.read_sac_with_sidecar(path).stats.starttime.timestamp == want
        assert psac.read_sac_with_sidecar(path, t_offset=2.0).stats.starttime.timestamp == want + 2.0


def test_empty_event_folder_fault_repaired(tmp_path):
    """An event folder without SAC files: JAX's worker writes a log without
    columns and its merge raises; the port's merge is an empty table with the
    log's columns (and a folder with files beside it converts as before)."""
    empty = tmp_path / "ev_empty"
    empty.mkdir()
    with pytest.raises(pd.errors.EmptyDataError):
        jsac.convert_sac_to_mseed([empty], tmp_path / "jax")
    log = psac.convert_sac_to_mseed([empty], tmp_path / "port")
    assert list(log.columns) == ["event", "station", "error"] and len(log) == 0
    assert (tmp_path / "port" / "ev_empty").is_dir()
    full = tmp_path / "ev_full"
    _write_folder(full, "KIL", 0)
    log = psac.convert_sac_to_mseed([empty, full], tmp_path / "port2")
    assert list(log["station"]) == ["HV.KIL."]
    shutil.rmtree(tmp_path / "port2")
    assert len(psac.convert_sac_to_mseed([], tmp_path / "none")) == 0


# ----------------------------------------------------------------- example
def _load_example(name):
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_data_proc_example_torch_equals_the_jax_example(tmp_path):
    """The port's example writes as many traces as the JAX example, with
    the same splits and sample indices, and the same task-0 targets."""
    ds = _load_example("data_proc_example_torch").main(tmp_path / "port")
    _load_example("data_proc_example").main(str(tmp_path / "jax"))
    want = pd.read_csv(tmp_path / "jax" / "dataset" / "metadata_demo.csv")
    assert len(ds) == len(want) == 6
    for col in ("split", "trace_p_arrival_sample", "trace_s_arrival_sample", "source_type", "station_code"):
        assert ds.metadata[col].tolist() == want[col].tolist(), col
    got = sorted(p.relative_to(tmp_path / "port" / "targets") for p in (tmp_path / "port" / "targets").rglob("*"))
    assert got == sorted(p.relative_to(tmp_path / "jax" / "targets") for p in (tmp_path / "jax" / "targets").rglob("*"))
    for f in got:
        if (tmp_path / "port" / "targets" / f).is_file():
            assert (tmp_path / "port" / "targets" / f).read_bytes() == (tmp_path / "jax" / "targets" / f).read_bytes()
