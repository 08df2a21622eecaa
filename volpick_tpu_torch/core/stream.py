"""Host-side waveform containers.

The reference framework passes ``obspy.Stream`` objects across its inference API
(reference `README.md:44-75`) and uses obspy for waveform I/O (reference
`volpick/data/data.py:12-55`). obspy is not a dependency of this framework; these
lightweight containers provide the same surface the picking stack needs
(traces with ids, start times, sampling rates; slicing, merging, resampling)
and convert losslessly to/from obspy objects when obspy happens to be installed.

All heavy compute stays out of this module: Trace/Stream are thin host-side
carriers of numpy arrays + metadata; the device pipeline consumes fixed-shape
batches built from them.

The port's own copy of ``volpick_tpu/core/stream.py`` (numpy only; scipy and
obspy are imported lazily where a method needs them). The helpers read
attributes and never test for these classes, so a stream built from
look-alike traces passes through unchanged.
"""

from __future__ import annotations

import datetime as _dt
import math
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional

import numpy as np

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


class UTC:
    """A UTC timestamp with float64-seconds resolution (~0.1 us in 2026).

    Minimal stand-in for ``obspy.UTCDateTime``: supports arithmetic with
    seconds, comparison, and ISO formatting. Phase picks at 100 Hz need
    10 ms resolution, so float64 epoch seconds are ample.
    """

    __slots__ = ("timestamp",)

    def __init__(self, value=0.0):
        if isinstance(value, UTC):
            self.timestamp = value.timestamp
        elif isinstance(value, (int, float, np.integer, np.floating)):
            self.timestamp = float(value)
        elif isinstance(value, str):
            self.timestamp = _parse_iso(value)
        elif isinstance(value, _dt.datetime):
            if value.tzinfo is None:
                value = value.replace(tzinfo=_dt.timezone.utc)
            self.timestamp = value.timestamp()
        elif isinstance(value, np.datetime64):
            self.timestamp = float(value.astype("datetime64[ns]").astype(np.int64)) / 1e9
        elif hasattr(value, "timestamp"):  # obspy UTCDateTime duck-typing
            ts = value.timestamp
            self.timestamp = float(ts() if callable(ts) else ts)
        else:
            raise TypeError(f"cannot construct UTC from {type(value)}")

    def __add__(self, seconds) -> "UTC":
        return UTC(self.timestamp + float(seconds))

    __radd__ = __add__

    # Another timestamp is told by its float `timestamp` attribute, not by
    # its class, so a look-alike UTC subtracts and compares like this one.
    def __sub__(self, other):
        ts = getattr(other, "timestamp", None)
        if isinstance(ts, float):
            return self.timestamp - ts
        return UTC(self.timestamp - float(other))

    def __eq__(self, other):
        ts = getattr(other, "timestamp", None)
        return isinstance(ts, float) and self.timestamp == ts

    def __lt__(self, other):
        return self.timestamp < UTC(other).timestamp

    def __le__(self, other):
        return self.timestamp <= UTC(other).timestamp

    def __gt__(self, other):
        return self.timestamp > UTC(other).timestamp

    def __ge__(self, other):
        return self.timestamp >= UTC(other).timestamp

    def __hash__(self):
        return hash(self.timestamp)

    def __float__(self):
        return self.timestamp

    @property
    def datetime(self) -> _dt.datetime:
        return _EPOCH + _dt.timedelta(seconds=self.timestamp)

    def isoformat(self) -> str:
        dt = self.datetime
        micro = dt.microsecond
        base = dt.strftime("%Y-%m-%dT%H:%M:%S")
        return f"{base}.{micro:06d}Z"

    def __repr__(self):
        return f"UTC({self.isoformat()})"

    __str__ = __repr__


def _parse_iso(s: str) -> float:
    s = s.strip().rstrip("Z")
    fmt_date = "%Y-%m-%d" if "-" in s[:8] else "%Y%m%d"
    if "T" in s or " " in s:
        sep = "T" if "T" in s else " "
        date_part, time_part = s.split(sep, 1)
        frac = 0.0
        if "." in time_part:
            time_part, frac_s = time_part.split(".", 1)
            frac = float("0." + frac_s) if frac_s else 0.0
        hms = time_part.split(":")
        while len(hms) < 3:
            hms.append("0")
        dt = _dt.datetime.strptime(date_part, fmt_date).replace(tzinfo=_dt.timezone.utc)
        return (
            dt.timestamp()
            + int(hms[0]) * 3600
            + int(hms[1]) * 60
            + float(hms[2])
            + frac
        )
    dt = _dt.datetime.strptime(s, fmt_date).replace(tzinfo=_dt.timezone.utc)
    return dt.timestamp()


@dataclass
class Stats:
    """Per-trace metadata (the subset of obspy Stats the pipeline uses)."""

    network: str = ""
    station: str = ""
    location: str = ""
    channel: str = ""
    sampling_rate: float = 100.0
    starttime: UTC = field(default_factory=UTC)
    npts: int = 0

    @property
    def delta(self) -> float:
        return 1.0 / self.sampling_rate

    @property
    def endtime(self) -> UTC:
        return self.starttime + max(self.npts - 1, 0) * self.delta


class Trace:
    """A single continuous waveform segment: numpy data + Stats."""

    def __init__(self, data: np.ndarray, header: Optional[dict] = None):
        self.data = np.asarray(data)
        header = dict(header or {})
        st = header.pop("starttime", UTC(0.0))
        self.stats = Stats(
            network=header.pop("network", ""),
            station=header.pop("station", ""),
            location=header.pop("location", ""),
            channel=header.pop("channel", ""),
            sampling_rate=float(header.pop("sampling_rate", 100.0)),
            starttime=UTC(st),
            npts=len(self.data),
        )

    @property
    def id(self) -> str:
        s = self.stats
        return f"{s.network}.{s.station}.{s.location}.{s.channel}"

    def __len__(self):
        return len(self.data)

    def copy(self) -> "Trace":
        tr = Trace(self.data.copy())
        tr.stats = Stats(**{k: getattr(self.stats, k) for k in (
            "network", "station", "location", "channel", "sampling_rate")},
            starttime=UTC(self.stats.starttime), npts=self.stats.npts)
        return tr

    def times(self) -> np.ndarray:
        return np.arange(self.stats.npts) * self.stats.delta

    def slice(self, starttime: Optional[UTC] = None, endtime: Optional[UTC] = None) -> "Trace":
        """Return a view-based sub-trace covering [starttime, endtime] (inclusive)."""
        sr = self.stats.sampling_rate
        t0 = self.stats.starttime
        i0 = 0 if starttime is None else max(0, int(math.ceil((UTC(starttime) - t0) * sr - 1e-9)))
        i1 = self.stats.npts if endtime is None else min(
            self.stats.npts, int(math.floor((UTC(endtime) - t0) * sr + 1e-9)) + 1
        )
        i1 = max(i1, i0)
        out = Trace(self.data[i0:i1])
        out.stats = Stats(
            network=self.stats.network, station=self.stats.station,
            location=self.stats.location, channel=self.stats.channel,
            sampling_rate=sr, starttime=t0 + i0 / sr, npts=i1 - i0,
        )
        return out

    def detrend_demean(self) -> "Trace":
        self.data = self.data - np.mean(self.data)
        return self

    def resample(self, sampling_rate: float) -> "Trace":
        """Polyphase (rational) resampling to `sampling_rate`.

        Mirrors the role of obspy/SeisBench resampling in the reference
        ingest path (reference `volpick/data/convert.py:122-140`): integer
        decimation when possible, rational resample_poly otherwise.
        """
        from scipy.signal import resample_poly

        old = self.stats.sampling_rate
        if abs(old - sampling_rate) < 1e-9:
            return self
        frac = _as_fraction(sampling_rate / old)
        self.data = resample_poly(np.asarray(self.data, dtype=np.float64), frac[0], frac[1])
        self.stats.sampling_rate = sampling_rate
        self.stats.npts = len(self.data)
        return self

    def __repr__(self):
        s = self.stats
        return (
            f"Trace({self.id} | {s.starttime.isoformat()} - {s.endtime.isoformat()} | "
            f"{s.sampling_rate:.1f} Hz, {s.npts} samples)"
        )


def _as_fraction(x: float, max_den: int = 1000):
    from fractions import Fraction

    f = Fraction(x).limit_denominator(max_den)
    return f.numerator, f.denominator


class Stream:
    """An ordered collection of Traces with obspy-Stream-like helpers."""

    def __init__(self, traces: Optional[Iterable[Trace]] = None):
        self.traces: List[Trace] = list(traces or [])

    def __iter__(self) -> Iterator[Trace]:
        return iter(self.traces)

    def __len__(self):
        return len(self.traces)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Stream(self.traces[i])
        return self.traces[i]

    def __add__(self, other):
        if hasattr(other, "stats"):  # one trace, of this class or a look-alike
            return Stream(self.traces + [other])
        return Stream(self.traces + list(other))

    def append(self, tr: Trace) -> "Stream":
        self.traces.append(tr)
        return self

    def copy(self) -> "Stream":
        return Stream([tr.copy() for tr in self.traces])

    def select(self, network=None, station=None, location=None, channel=None) -> "Stream":
        def ok(tr: Trace) -> bool:
            for attr, pat in (
                ("network", network), ("station", station),
                ("location", location), ("channel", channel),
            ):
                if pat is None:
                    continue
                value = getattr(tr.stats, attr)
                rex = "^" + re.escape(pat).replace(r"\*", ".*").replace(r"\?", ".") + "$"
                if not re.match(rex, value):
                    return False
            return True

        return Stream([tr for tr in self.traces if ok(tr)])

    def sort(self) -> "Stream":
        self.traces.sort(key=lambda tr: (tr.id, tr.stats.starttime.timestamp))
        return self

    def merge_overlaps(self) -> "Stream":
        """Merge traces with identical ids that abut/overlap (later wins on overlap)."""
        self.sort()
        merged: List[Trace] = []
        for tr in self.traces:
            if merged and merged[-1].id == tr.id:
                prev = merged[-1]
                sr = prev.stats.sampling_rate
                if abs(sr - tr.stats.sampling_rate) < 1e-9:
                    gap = (tr.stats.starttime - prev.stats.endtime) * sr
                    if gap <= 1.5:  # contiguous or overlapping
                        off = int(round((tr.stats.starttime - prev.stats.starttime) * sr))
                        total = max(prev.stats.npts, off + tr.stats.npts)
                        data = np.zeros(total, dtype=np.result_type(prev.data, tr.data))
                        data[: prev.stats.npts] = prev.data
                        data[off : off + tr.stats.npts] = tr.data
                        prev.data = data
                        prev.stats.npts = total
                        continue
            merged.append(tr)
        self.traces = merged
        return self

    # --- obspy interop (optional dependency) -------------------------------
    @classmethod
    def from_obspy(cls, st) -> "Stream":
        out = cls()
        for tr in st:
            t = Trace(
                np.asarray(tr.data),
                dict(
                    network=tr.stats.network, station=tr.stats.station,
                    location=tr.stats.location, channel=tr.stats.channel,
                    sampling_rate=float(tr.stats.sampling_rate),
                    starttime=UTC(float(tr.stats.starttime.timestamp)),
                ),
            )
            out.append(t)
        return out

    def to_obspy(self):
        import obspy

        traces = []
        for tr in self.traces:
            otr = obspy.Trace(tr.data)
            otr.stats.network = tr.stats.network
            otr.stats.station = tr.stats.station
            otr.stats.location = tr.stats.location
            otr.stats.channel = tr.stats.channel
            otr.stats.sampling_rate = tr.stats.sampling_rate
            otr.stats.starttime = obspy.UTCDateTime(tr.stats.starttime.timestamp)
            traces.append(otr)
        return obspy.Stream(traces)

    def __repr__(self):
        lines = [f"Stream with {len(self)} traces:"] + [f"  {tr!r}" for tr in self.traces]
        return "\n".join(lines)


def group_streams_by_instrument(stream: Stream) -> dict:
    """Group traces by network.station.location + channel band/instrument code.

    SeisBench's annotate() groups traces per "instrument" so each 3-component
    set is processed together (the reference relies on this grouping for
    multi-station classify, reference `README.md:54-62`).
    """
    groups: dict = {}
    for tr in stream:
        chan = tr.stats.channel
        inst = chan[:-1] if len(chan) >= 1 else ""
        key = f"{tr.stats.network}.{tr.stats.station}.{tr.stats.location}.{inst}"
        groups.setdefault(key, Stream()).append(tr)
    return groups
