"""The port's own host layer (``volpick_tpu_torch.core``) vs the JAX package's
(``volpick_tpu.core``): the same inputs give the same timestamps, traces,
streams, groups and result strings. Tolerance: none, except resampling
(float64 polyphase filter, compared at 1e-12).
"""

import datetime as dt

import numpy as np
import pytest

import volpick_tpu.core as jcore
import volpick_tpu.core.stream as jstream
import volpick_tpu_torch.core as pcore
import volpick_tpu_torch.core.stream as pstream

UTC_INPUTS = [
    0.0, 1717200000.25, 12, np.float64(3.5), np.int64(86400),
    "2024-06-01T00:00:00", "2024-06-01T12:34:56.789Z", "2024-06-01 01:02", "20240601",
    "2024-06-01", dt.datetime(2024, 6, 1, 3, 4, 5), np.datetime64("2024-06-01T00:00:01"),
]


@pytest.mark.parametrize("value", UTC_INPUTS, ids=[repr(v)[:28] for v in UTC_INPUTS])
def test_utc_matches(value):
    a, b = pcore.UTC(value), jcore.UTC(value)
    assert a.timestamp == b.timestamp
    assert a.isoformat() == b.isoformat() and repr(a) == repr(b)
    assert (a + 1.5).timestamp == (b + 1.5).timestamp
    assert (a - 2).timestamp == (b - 2).timestamp
    assert a - pcore.UTC(10.0) == b - jcore.UTC(10.0)
    assert a.datetime == b.datetime and float(a) == float(b)
    assert hash(a) == hash(b)


def test_utc_accepts_the_other_package_s_timestamps():
    theirs = jcore.UTC("2024-06-01T00:00:00")
    mine = pcore.UTC(theirs)  # read through its `timestamp` attribute
    assert mine.timestamp == theirs.timestamp and mine == theirs
    assert mine - theirs == 0.0 and mine <= theirs and not mine < theirs
    assert pcore.UTC(5.0) != jcore.UTC(6.0) and pcore.UTC(5.0) != "5.0"
    with pytest.raises(TypeError):
        pcore.UTC([1, 2])


def _traces(mod, rng):
    t0 = mod.UTC("2024-06-01T00:00:00")
    out = []
    for sta, start, n in (("A", 0.0, 500), ("A", 4.0, 300), ("B", 1.0, 400)):
        for comp in "ZNE":
            out.append(mod.Trace(rng.normal(size=n).astype(np.float32), dict(
                network="XV", station=sta, location="00", channel=f"HH{comp}",
                sampling_rate=100.0, starttime=t0 + start)))
    out.append(mod.Trace(rng.normal(size=50), dict(network="XV", station="C", channel="EHZ",
                                                    sampling_rate=50.0, starttime=t0)))
    return out


def _describe(tr):
    s = tr.stats
    return (tr.id, s.sampling_rate, s.starttime.timestamp, s.endtime.timestamp, s.npts, s.delta,
            len(tr), repr(tr), tr.data.tolist())


def test_trace_matches():
    p = _traces(pstream, np.random.default_rng(0))
    j = _traces(jstream, np.random.default_rng(0))
    for a, b in zip(p, j):
        assert _describe(a) == _describe(b)
        assert _describe(a.copy()) == _describe(b.copy())
        np.testing.assert_array_equal(a.times(), b.times())
        lo, hi = a.stats.starttime + 0.333, a.stats.starttime + 1.7
        assert _describe(a.slice(lo, hi)) == _describe(b.slice(b.stats.starttime + 0.333,
                                                               b.stats.starttime + 1.7))
        assert _describe(a.slice()) == _describe(b.slice())
        assert _describe(a.copy().detrend_demean()) == _describe(b.copy().detrend_demean())
    # a copy owns its data
    c = p[0].copy()
    c.data[0] += 1.0
    assert c.data[0] != p[0].data[0]


@pytest.mark.parametrize("rate", [100.0, 50.0, 40.0, 250.0])
def test_resample_matches(rate):
    a = _traces(pstream, np.random.default_rng(1))[0].resample(rate)
    b = _traces(jstream, np.random.default_rng(1))[0].resample(rate)
    assert a.stats.npts == b.stats.npts and a.stats.sampling_rate == b.stats.sampling_rate == rate
    np.testing.assert_allclose(a.data, b.data, atol=1e-12)


def test_stream_matches():
    p = pstream.Stream(_traces(pstream, np.random.default_rng(2)))
    j = jstream.Stream(_traces(jstream, np.random.default_rng(2)))
    assert len(p) == len(j) == 10 and repr(p) == repr(j)
    assert [t.id for t in p[2:5]] == [t.id for t in j[2:5]] and p[3].id == j[3].id
    for kw in (dict(station="A"), dict(channel="HH?"), dict(channel="*Z"),
               dict(network="XV", station="B", location="00", channel="HHN"), dict(station="Q")):
        assert [t.id for t in p.select(**kw)] == [t.id for t in j.select(**kw)]
    assert len(p + p[0]) == len(j + j[0]) == 11 and len(p + p) == 20
    assert len(p.copy().append(p[0])) == 11 and len(p) == 10

    pm, jm = p.copy().merge_overlaps(), j.copy().merge_overlaps()
    assert len(pm) == len(jm) == 7  # station A's two segments merge per component
    assert [_describe(t) for t in pm] == [_describe(t) for t in jm]
    assert [_describe(t) for t in p.copy().sort()] == [_describe(t) for t in j.copy().sort()]


def test_groups_match_and_accept_foreign_streams():
    p = pstream.Stream(_traces(pstream, np.random.default_rng(3)))
    j = jstream.Stream(_traces(jstream, np.random.default_rng(3)))
    gp = pstream.group_streams_by_instrument(p)
    gj = jstream.group_streams_by_instrument(j)
    assert list(gp) == list(gj) == ["XV.A.00.HH", "XV.B.00.HH", "XV.C..EH"]
    assert {k: [t.id for t in v] for k, v in gp.items()} == {k: [t.id for t in v] for k, v in gj.items()}
    # the port's helpers read attributes only: the JAX package's stream passes
    mixed = pstream.group_streams_by_instrument(j)
    assert {k: [t.id for t in v] for k, v in mixed.items()} == {
        k: [t.id for t in v] for k, v in gp.items()}
    merged = pstream.Stream([t.copy() for t in j]).merge_overlaps()
    assert [_describe(t) for t in merged] == [_describe(t) for t in p.copy().merge_overlaps()]


def test_pick_containers_match():
    def build(mod):
        t0 = mod.UTC("2024-06-01T00:00:00")
        picks = mod.PickList([
            mod.Pick("XV.B.00", t0 + 7.0, t0 + 8.0, t0 + 7.5, 0.91, "S"),
            mod.Pick("XV.A.00", t0 + 3.0, t0 + 4.0, t0 + 3.2, 0.5, "P"),
            mod.Pick("XV.A.00", t0 + 1.0, phase="P"),
        ] + [mod.Pick("XV.Z.00", t0 + i) for i in range(25)])
        det = [mod.Detection("XV.A.00", t0 + 1.0, t0 + 9.0, 0.7)]
        return mod.ClassifyOutput("EQTransformer", picks, det)

    a, b = build(pcore), build(jcore)
    assert str(a) == str(b) and str(a.picks) == str(b.picks)
    assert [str(p) for p in a.picks] == [str(p) for p in b.picks]
    assert str(a.detections[0]) == str(b.detections[0])
    a.picks.sort()
    b.picks.sort()
    assert [str(p) for p in a.picks] == [str(p) for p in b.picks]
    for kw in (dict(phase="P"), dict(trace_id="XV.A.00"), dict(trace_id="XV.A.00", phase="S"), {}):
        sa, sb = a.picks.select(**kw), b.picks.select(**kw)
        assert isinstance(sa, pcore.PickList) and [str(p) for p in sa] == [str(p) for p in sb]
    empty = pcore.ClassifyOutput("x")
    assert empty.picks == [] and empty.detections == []
