"""JMA unified-catalog (deck format) parser.

Parses the JMA "Arrival time data" file format (hypocenter records J/U/I,
arrival-time records '_', terminator 'E'; see the JMA bulletin format
documentation) into the obspy-free Catalog model. Field columns follow the
reference's reader (`volpick/data/data.py:273-870`): origin time/lat/lon from
the hypocenter record, JMA magnitude with the A/B negative codes, event type
code (1 natural, 2 insufficient, 3 artificial, 4 eruption, 5 low-frequency),
and up to two phases per arrival line with 2-digit-year expansion from the
hypocenter century.

Port of ``volpick_tpu/acquisition/jma.py`` (a copy). The spawn workers of
``read_jma_catalog_dir`` import this module alone: it needs numpy and pandas,
never torch.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

from volpick_tpu_torch.acquisition.events import Catalog, Event, Magnitude, Origin, PhasePick
from volpick_tpu_torch.core.stream import UTC

_EVENT_TYPES = {"1": "natural", "2": "insufficient", "3": "artificial", "4": "eruption", "5": "lp"}


def _phase_label(name: str) -> Optional[str]:
    name = name.strip()
    if name in ("IP", "EP", "P"):
        return "P"
    if name in ("IS", "ES", "S"):
        return "S"
    return None


def _read_event_block(f):
    hypo, arrivals = [], []
    line = f.readline()
    if not line:
        return None, None
    while line:
        if line[0] in "JUI":
            hypo.append(line)
        elif line[0] == "_":
            arrivals.append(line)
        elif line[0] == "E":
            break
        line = f.readline()
    return hypo, arrivals


def read_jma_catalog(
    path,
    id_prefix: str = "",
    n_events: Optional[int] = None,
    min_date: Optional[UTC] = None,
    max_date: Optional[UTC] = None,
    skip_unknown_type: bool = True,
) -> Tuple[Catalog, List[dict]]:
    """Returns (catalog, skipped) where skipped logs unparseable blocks."""
    cat = Catalog()
    skipped: List[dict] = []
    with open(path) as f:
        while n_events is None or len(cat) < n_events:
            hypo, arrivals = _read_event_block(f)
            if hypo is None:
                break
            if not hypo:
                continue
            s = hypo[0].rstrip("\n")
            s = s.ljust(96)
            event_id = (
                id_prefix + s[0] + s[3:17].strip() + s[21:28].replace(" ", "") + s[32:40].replace(" ", "")
            )
            try:
                origin_time = UTC(
                    f"{s[1:5]}-{s[5:7]}-{s[7:9]}T{s[9:11]}:{s[11:13]}:{s[13:15]}.{s[15:17].strip() or '0'}"
                )
            except Exception:
                skipped.append({"record": s, "remark": "bad origin time"})
                continue
            if min_date is not None and origin_time < min_date:
                continue
            if max_date is not None and origin_time > max_date:
                break
            if not s[21:28].strip() or not s[32:40].strip():
                skipped.append({"record": s, "remark": "empty location"})
                continue
            try:
                lat = float(s[21:24]) + float(s[24:28]) / 100.0 / 60.0
                lon = float(s[32:36]) + float(s[36:40]) / 100.0 / 60.0
                dep_str = s[44:49]
                dep = float(dep_str[:3]) if dep_str[3:5] == "  " else float(dep_str) / 100.0
            except Exception:
                skipped.append({"record": s, "remark": "uncertain lat/lon/dep format"})
                continue
            mag = mag_type = None
            if s[52:54].strip():
                mag = float(s[52:54].replace("A", "-1").replace("B", "-2")) / 10.0
            if s[54:55].strip():
                mag_type = s[54]
            etype = _EVENT_TYPES.get(s[60:61].strip(), "unknown")
            if etype == "unknown" and skip_unknown_type:
                skipped.append({"record": s, "remark": "unknown event type"})
                continue

            picks: List[PhasePick] = []
            century = s[1:3]
            for a in arrivals:
                a = a.rstrip("\n").ljust(96)
                sta = a[1:7].strip()
                day = a[13:15].replace(" ", "0")
                year = century + a[87:89].replace(" ", "0")
                mon = a[89:91].replace(" ", "0")

                def mk_time(hr, mn, sec_str):
                    return UTC(f"{year}-{mon}-{day}T{hr}:{mn}:00.0") + float(sec_str)

                p1 = _phase_label(a[15:19])
                if a[15:19].strip() and p1 is None:
                    skipped.append({"record": a, "remark": f"unknown phase {a[15:19].strip()}"})
                    continue
                try:
                    if p1 and a[19:27].strip():
                        t1 = mk_time(a[19:21], a[21:23], f"{a[23:25]}.{a[25:27].strip() or '0'}")
                        picks.append(PhasePick("", sta, "", "", t1, p1))
                        p2 = _phase_label(a[27:31])
                        if a[27:31].strip() and p2 is None:
                            # reference logs unknown second phases (e.g. "M"
                            # maximum-amplitude records) and keeps the first
                            # pick (`data.py:760-774`)
                            skipped.append(
                                {"record": a, "remark": f"unknown phase {a[27:31].strip()}"}
                            )
                            continue
                        if p2 and p2 != p1 and a[31:37].strip():
                            t2 = mk_time(a[19:21], a[31:33], f"{a[33:35]}.{a[35:37].strip() or '0'}")
                            picks.append(PhasePick("", sta, "", "", t2, p2))
                except Exception:
                    skipped.append({"record": a, "remark": "bad arrival time"})
                    continue
            if picks:
                cat.append(
                    Event(
                        event_id=event_id,
                        origin=Origin(origin_time, lat, lon, dep),
                        magnitude=Magnitude(mag, mag_type),
                        source_type=etype,
                        picks=picks,
                    )
                )
    return cat, skipped


def _read_one(args):
    path, kwargs = args
    return read_jma_catalog(path, **kwargs)


def read_jma_catalog_dir(
    catalog_dir: Union[str, Path, Sequence],
    id_prefix: str = "",
    num_processes: int = 1,
    **kwargs,
) -> Tuple[Catalog, List[dict]]:
    """Multi-file JMA catalog reader (monthly deck files in one directory).

    The reference fans the per-file parsing over spawn processes and merges
    per-process CSVs (`volpick/data/data.py:413-504`
    read_catalog_multiple_files); here each file parses independently and
    the (catalog, skipped) pairs merge in file-name order — identical
    output, no temp files. `num_processes > 1` parses files in parallel.
    """
    if isinstance(catalog_dir, (str, Path)):
        files = sorted(p for p in Path(catalog_dir).iterdir() if p.is_file())
    else:
        files = [Path(p) for p in catalog_dir]
    kwargs = dict(kwargs, id_prefix=id_prefix)
    if num_processes > 1 and len(files) > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ctx.Pool(min(num_processes, len(files))) as pool:
            results = pool.map(_read_one, [(f, kwargs) for f in files])
    else:
        results = [read_jma_catalog(f, **kwargs) for f in files]
    cat = Catalog()
    skipped: List[dict] = []
    for c, s in results:
        cat.events.extend(c.events)
        skipped.extend(s)
    return cat, skipped
