"""Obspy-free event/catalog model for the acquisition layer.

The reference builds obspy ``Catalog``/``Event`` objects from region catalogs
and flattens them to per-station CSV tables with SeisBench column names
(reference `volpick/data/data.py:2595-2790`). These dataclasses carry the same
information; ``Catalog.to_dataframe`` reproduces the same per-station rows
(weighted multi-pick averaging per station, max weights, first motion).

Port of ``volpick_tpu/acquisition/events.py`` (a copy over the port's
``core/stream.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from volpick_tpu_torch.core.stream import UTC


@dataclass
class PhasePick:
    network: str
    station: str
    location: str
    channel: str
    time: UTC
    phase: str  # "P" | "S"
    weight: float = 0.0
    first_motion: Optional[str] = None  # "U" | "D" | None

    @property
    def station_id(self) -> str:
        return f"{self.network}.{self.station}.{self.location}"


@dataclass
class Origin:
    time: UTC
    latitude: float
    longitude: float
    depth_km: float
    horizontal_error_km: Optional[float] = None
    vertical_error_km: Optional[float] = None


@dataclass
class Magnitude:
    mag: float
    magnitude_type: Optional[str] = None


@dataclass
class Event:
    event_id: str
    origin: Origin
    magnitude: Magnitude
    source_type: str = ""
    picks: List[PhasePick] = field(default_factory=list)


class Catalog:
    def __init__(self, events: Optional[List[Event]] = None):
        self.events: List[Event] = list(events or [])

    def __len__(self):
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def append(self, ev: Event):
        self.events.append(ev)

    def to_dataframe(self, by_station: bool = True) -> pd.DataFrame:
        """Flatten to the SeisBench-convention per-station table.

        Per (net, sta, loc): P/S pick time = weight-average of that station's
        picks of the phase (stations whose weights sum to 0 get no pick),
        plus the max weight and the first reported P polarity. One row per
        distinct channel group observed at the station."""
        import pandas as pd

        rows = []
        for ev in self.events:
            o, m = ev.origin, ev.magnitude
            base = {
                "source_id": ev.event_id,
                "source_origin_time": o.time.isoformat(),
                "source_latitude_deg": o.latitude,
                "source_longitude_deg": o.longitude,
                "source_depth_km": o.depth_km,
                "source_magnitude": m.mag,
                "source_magnitude_type": m.magnitude_type,
                "source_type": ev.source_type,
            }
            if not by_station:
                for p in ev.picks:
                    rows.append(
                        dict(
                            base,
                            station_network_code=p.network,
                            station_code=p.station,
                            station_location_code=p.location,
                            trace_channel=p.channel,
                            **{
                                f"trace_{p.phase.lower()}_arrival_time": p.time.isoformat(),
                                f"trace_{p.phase.lower()}_weight": p.weight,
                            },
                        )
                    )
                continue

            groups: Dict[str, List[PhasePick]] = {}
            cha_groups: List[str] = []
            for p in ev.picks:
                groups.setdefault(p.station_id, []).append(p)
                key = f"{p.station_id}.{p.channel[:-1] if p.channel else ''}"
                if key not in cha_groups:
                    cha_groups.append(key)

            station_stats: Dict[str, dict] = {}
            for sid, plist in groups.items():
                stats = {}
                for phase in ("P", "S"):
                    sel = [p for p in plist if p.phase == phase]
                    times = [p.time.timestamp for p in sel]
                    weights = [p.weight for p in sel]
                    if times and sum(weights) > 0:
                        stats[f"{phase}_time"] = UTC(np.average(times, weights=weights))
                        stats[f"{phase}_weight"] = max(weights)
                    else:
                        stats[f"{phase}_time"] = None
                        stats[f"{phase}_weight"] = None
                fm = None
                for p in plist:
                    if p.phase == "P" and p.first_motion:
                        fm = p.first_motion
                        break
                stats["first_motion"] = fm
                station_stats[sid] = stats

            for key in cha_groups:
                net, sta, loc, cha = (key.split(".") + [""])[:4]
                sid = f"{net}.{sta}.{loc}"
                st = station_stats[sid]
                rows.append(
                    dict(
                        base,
                        station_network_code=net,
                        station_code=sta,
                        station_location_code=loc,
                        trace_channel=cha,
                        trace_p_arrival_time=(
                            st["P_time"].isoformat() if st["P_time"] else None
                        ),
                        trace_s_arrival_time=(
                            st["S_time"].isoformat() if st["S_time"] else None
                        ),
                        trace_p_max_weight=st["P_weight"],
                        trace_s_max_weight=st["S_weight"],
                        trace_p_first_motion=st["first_motion"],
                    )
                )
        return pd.DataFrame(rows)

    def save_csv(self, path, by_station: bool = True):
        self.to_dataframe(by_station=by_station).to_csv(path, index=False)
