"""Region catalog parsers (hypoinverse / NCEDC / HVO / ComCat grouping).

Fixed-width formats follow the HYPOINVERSE-2000 Y2000 archive + summary
specification; field columns match the reference's readers
(`volpick/data/data.py:2269-2569` Alaska/generic, `:3454-3482` NCEDC,
`:3498-3533` HVO) so the same observatory files parse identically.

Port of ``volpick_tpu/acquisition/catalogs.py`` (a copy over the port's
``acquisition/events.py`` and ``core/stream.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from volpick_tpu_torch.acquisition.events import Catalog, Event, Magnitude, Origin, PhasePick
from volpick_tpu_torch.core.stream import UTC


def _f(s: str, scale: float = 1.0) -> Optional[float]:
    s = s.strip()
    return float(s) / scale if s else None


# ------------------------------------------------------------ summary formats
def read_hypoinverse_summary(summary_file, id_prefix: str = "") -> Dict[str, tuple]:
    """AVO-style summary: free-ish fixed columns with trailing event type."""
    out = {}
    with open(summary_file) as f:
        f.readline()
        f.readline()
        for line in f:
            if not line.strip():
                continue
            event_id = id_prefix + line[99:108].strip()
            event_type = line.strip()[-2:]
            ev_mag = _f(line[52:57])
            mag_type = "m" + line[58:60].strip()
            org_time = line[0:25].strip().replace(" ", "T").replace("/", "-")
            out[event_id] = (
                event_type,
                ev_mag,
                mag_type,
                org_time,
                _f(line[26:34]),
                _f(line[34:44]),
                _f(line[44:50]),
            )
    return out


def read_ncedc_summary(summary_file, id_prefix: str = "", etype: str = "lp") -> Dict[str, tuple]:
    """NCEDC event CSV (EventID, DateTime, Latitude, Longitude, Depth,
    Magnitude, MagType columns); event type supplied by the caller."""
    import pandas as pd

    out = {}
    df = pd.read_csv(summary_file, skiprows=1)
    df.columns = [c.strip() for c in df.columns]
    for row in df.itertuples():
        event_id = id_prefix + str(row.EventID)
        out[event_id] = (
            etype,
            row.Magnitude,
            row.MagType,
            str(row.DateTime).replace(" ", "T").replace("/", "-"),
            row.Latitude,
            row.Longitude,
            row.Depth,
        )
    return out


def read_hvo_summary(summary_file, id_prefix: str = "") -> Dict[str, tuple]:
    """HVO legacy summary (wider fixed columns, 3-letter event type)."""
    out = {}
    with open(summary_file) as f:
        f.readline()
        f.readline()
        for line in f:
            if not line.strip():
                continue
            event_id = id_prefix + line[131:140].strip()
            event_type = line[151:154].strip()
            mag_type = line[124:127].strip()
            mag_type = None if mag_type == "Unk" else ("m" + mag_type)
            out[event_id] = (
                event_type,
                _f(line[117:122]),
                mag_type,
                line[0:25].strip().replace(" ", "T").replace("/", "-"),
                _f(line[26:35]),
                _f(line[35:46]),
                _f(line[46:53]),
            )
    return out


# -------------------------------------------------------------- archive files
def _read_archive_event(f) -> Tuple[Optional[str], List[str], Optional[str]]:
    """One Y2000 archive event: summary line + station lines + terminator
    (a line with blank station field)."""
    summary_line = f.readline()
    if not summary_line:
        return None, [], None
    station_lines: List[str] = []
    terminator = None
    line = f.readline()
    while line:
        if not line[0:6].strip():
            terminator = line
            break
        station_lines.append(line)
        line = f.readline()
    return summary_line, station_lines, terminator


def _parse_archive_origin(summary_line: str, fallback: tuple) -> Origin:
    """Origin from a Y2000 archive summary line; fields absent in the archive
    line fall back to the summary-file values."""
    _, _, _, org_time_str0, lat0, lon0, dep0 = fallback
    if summary_line[0:16].strip():
        t = (
            f"{summary_line[0:4]}-{summary_line[4:6]}-{summary_line[6:8]}"
            f"T{summary_line[8:10]}:{summary_line[10:12]}:"
            f"{summary_line[12:14]}.{summary_line[14:16]}"
        )
    else:
        t = org_time_str0
    if summary_line[16:23].strip():
        lat = float(summary_line[16:18]) + float(summary_line[19:23]) / 100.0 / 60.0
        if summary_line[18] == "S":
            lat = -lat
    else:
        lat = lat0
    if summary_line[23:31].strip():
        lon = float(summary_line[23:26]) + float(summary_line[27:31]) / 100.0 / 60.0
        if summary_line[26].isspace():
            lon = -lon
    else:
        lon = lon0
    dep = _f(summary_line[31:36], 100.0)
    dep = dep if dep is not None else dep0
    return Origin(
        time=UTC(t),
        latitude=lat,
        longitude=lon,
        depth_km=dep,
        horizontal_error_km=_f(summary_line[85:89], 100.0),
        vertical_error_km=_f(summary_line[89:93], 100.0),
    )


def _parse_station_line(line: str) -> List[PhasePick]:
    """P/S picks from one Y2000 archive station line."""
    sta = line[0:5].strip()
    net = line[5:7].strip()
    cha = line[9:12].strip()
    loc = line[111:113].strip() if len(line) > 112 else ""
    base_time = UTC(f"{line[17:21]}-{line[21:23]}-{line[23:25]}T{line[25:27]}:{line[27:29]}:00.0")
    p_remark = line[13:15].strip()
    s_remark = line[46:48].strip()
    p_first_motion = line[15].strip() or None

    picks = []
    if not line[29:34].isspace() and p_remark:
        p_time = base_time + float(line[29:34]) / 100.0
        pw = _f(line[38:41], 100.0) or 0.0
        picks.append(
            PhasePick(net, sta, loc, cha, p_time, "P", weight=pw, first_motion=p_first_motion)
        )
    if not line[41:46].isspace() and s_remark:
        s_time = base_time + float(line[41:46]) / 100.0
        sw = _f(line[63:66], 100.0) or 0.0
        picks.append(PhasePick(net, sta, loc, cha, s_time, "S", weight=sw))
    return picks


def read_hypoinverse_catalog(
    station_archive_file,
    summary_file,
    summary_format: str = "hypoinverse",
    n_events: Optional[int] = None,
    id_prefix: str = "",
    min_date: Optional[UTC] = None,
    max_date: Optional[UTC] = None,
    etype: str = "lp",
) -> Catalog:
    """Y2000 archive + summary → Catalog (one Event per archive block with
    ≥1 pick)."""
    readers = {
        "hypoinverse": read_hypoinverse_summary,
        "ncedc": lambda f, p: read_ncedc_summary(f, p, etype=etype),
        "hvo": read_hvo_summary,
    }
    summary = readers[summary_format](summary_file, id_prefix)
    cat = Catalog()
    n_max = n_events if n_events is not None else np.inf
    with open(station_archive_file) as f:
        while len(cat) < n_max:
            summary_line, station_lines, terminator = _read_archive_event(f)
            if not summary_line:
                break
            event_id = id_prefix + (terminator[62:72].strip() if terminator else "")
            if summary_line[136:146].strip():
                archive_id = id_prefix + summary_line[136:146].strip()
                if archive_id != event_id:
                    event_id = archive_id
            if event_id not in summary:
                continue
            info = summary[event_id]
            origin = _parse_archive_origin(summary_line, info)
            if min_date is not None and origin.time < min_date:
                continue
            if max_date is not None and origin.time > max_date:
                break
            picks: List[PhasePick] = []
            for line in station_lines:
                picks.extend(_parse_station_line(line))
            if picks:
                cat.append(
                    Event(
                        event_id=event_id,
                        origin=origin,
                        magnitude=Magnitude(mag=info[1], magnitude_type=info[2]),
                        source_type=info[0],
                        picks=picks,
                    )
                )
    return cat


# --------------------------------------------------------------- pick merging
def group_picks(
    picks_df: pd.DataFrame,
    time_col: str = "time",
    weight_col: str = "weight",
    phase_col: str = "phase",
    station_cols: Tuple[str, ...] = ("network", "station", "location"),
) -> pd.DataFrame:
    """Weighted multi-pick averaging per station/phase (the ComCat merge,
    reference `volpick/data/data.py:4017-4103`): picks of the same phase at
    the same station collapse to their weight-averaged time; stations whose
    weights sum to 0 are dropped; the max weight is retained."""
    import pandas as pd

    rows = []
    for keys, grp in picks_df.groupby(list(station_cols) + [phase_col]):
        w = grp[weight_col].to_numpy(dtype=float)
        t = np.array([UTC(v).timestamp for v in grp[time_col]])
        if w.sum() <= 0:
            continue
        row = dict(zip(list(station_cols) + [phase_col], keys))
        row["time"] = UTC(float(np.average(t, weights=w))).isoformat()
        row["max_weight"] = float(w.max())
        row["n_picks"] = len(grp)
        rows.append(row)
    return pd.DataFrame(rows)
