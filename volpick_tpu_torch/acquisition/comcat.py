"""USGS ComCat phase acquisition (PNSN/Cascades leg of the reference).

Port of `ComCatDataset` (reference `volpick/data/data.py:4002-4180`): fetch
per-event phase tables from ComCat, collapse multi-pick stations by weighted
time averaging, and emit the SeisBench-convention per-station catalog CSV.

The ComCat service is driven through an injectable `client` object instead
of a hard libcomcat dependency (not installed here; also makes the QC and
merge logic testable with a fake client). The client contract mirrors
libcomcat's two calls used by the reference:

- ``client.get_event_by_id(source_id, includesuperseded=True)`` → detail
  object with ``.id`` and ``.toDict()`` (keys ``magnitude``, ``magtype``);
  raises ``LookupError`` when the event does not exist (the reference's
  JSONDecodeError path, `data.py:4112-4116`).
- ``client.get_phase_dataframe(detail)`` → DataFrame with columns
  ``Channel`` ("NET.STA.CHA.LOC"), ``Phase``, ``Arrival Time`` (anything
  UTC() accepts), ``Status``, ``Weight``; raises ``KeyError`` when arrival
  times are unavailable (`data.py:4128-4134`).

Port of ``volpick_tpu/acquisition/comcat.py`` (a copy; it logs to the
``volpick_tpu_torch`` logger).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from volpick_tpu_torch.core.stream import UTC

logger = logging.getLogger("volpick_tpu_torch")


def group_comcat_picks(phase: pd.DataFrame) -> Dict[str, dict]:
    """Collapse a ComCat phase table to one entry per station channel-group.

    Reference `volpick/data/data.py:4017-4103`: key = "NET.STA.CHA[:-1]";
    empty location → "--"; per phase, arrival time = weight-averaged pick
    time, falling back to the plain average when every weight is 0 or NaN
    (NaN-weighted picks are dropped from the average when any positive
    weight exists); max weight = nanmax (NaN if all NaN); the last seen
    Status per phase is kept; first motions are not populated.
    """
    groups: Dict[str, dict] = {}
    for _, row in phase.iterrows():
        net, sta, cha, loc = str(row["Channel"]).split(".")
        if not loc.strip():
            loc = "--"
        key = f"{net}.{sta}.{cha[:-1]}"
        if key not in groups:
            groups[key] = {
                "p_picks": [], "p_weights": [], "s_picks": [], "s_weights": [],
                "station_network_code": net,
                "station_code": sta,
                "trace_channel": cha[:-1],
                "station_location_code": loc,
                "trace_p_status": None,
                "trace_s_status": None,
            }
        pha = str(row["Phase"]).lower()
        if pha not in ("p", "s"):
            continue
        groups[key][f"{pha}_picks"].append(UTC(row["Arrival Time"]).timestamp)
        groups[key][f"{pha}_weights"].append(row["Weight"])
        groups[key][f"trace_{pha}_status"] = row["Status"]

    for g in groups.values():
        for pha in ("p", "s"):
            g[f"trace_{pha}_first_motion"] = None
            picks = g.pop(f"{pha}_picks")
            weights = np.asarray(g.pop(f"{pha}_weights"), dtype=float)
            if not picks:
                g[f"trace_{pha}_arrival_time"] = None
                g[f"trace_{pha}_max_weight"] = None
                continue
            picks = np.asarray(picks, dtype=float)
            if np.all(np.isnan(weights)) or np.allclose(np.nan_to_num(weights), 0):
                t = float(np.mean(picks))
            else:
                if np.any(np.isnan(weights)):
                    keep = ~np.isnan(weights)
                    picks, weights = picks[keep], weights[keep]
                t = float(np.average(picks, weights=weights))
            g[f"trace_{pha}_arrival_time"] = UTC(t).isoformat()
            g[f"trace_{pha}_max_weight"] = (
                float(np.nanmax(weights)) if not np.all(np.isnan(weights)) else np.nan
            )
    return groups


_PHASE_ALIASES = {"Pn": "P", "Pg": "P", "Sn": "S", "Sg": "S"}


def download_phases(
    summary_df: pd.DataFrame,
    client,
    save_dir,
    csv_name: str = "phases.csv",
) -> pd.DataFrame:
    """Per-event ComCat phase download → per-station catalog CSV.

    summary_df needs columns id/time/latitude/longitude/depth/eventtype
    (read_PNSN_events produces this schema). Writes `<save_dir>/<csv_name>`
    plus `events_without_picks.csv` for events that had no detail or no
    arrivals (reference `data.py:4105-4162`). Returns the pick table.
    """
    import pandas as pd

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    no_picks_idx = []
    for i in range(len(summary_df)):
        ev = summary_df.iloc[i]
        source_id = ev["id"]
        try:
            detail = client.get_event_by_id(source_id, includesuperseded=True)
        except LookupError:
            logger.warning(f"cannot find the event {source_id}")
            no_picks_idx.append(i)
            continue
        detail_dict = detail.toDict()
        source_params = {
            "source_id": source_id,
            "source_origin_time": UTC(ev["time"]).isoformat(),
            "source_latitude_deg": ev["latitude"],
            "source_longitude_deg": ev["longitude"],
            "source_depth_km": ev["depth"],
            "source_magnitude": detail_dict["magnitude"],
            "source_magnitude_type": detail_dict["magtype"],
            "source_type": ev["eventtype"],
        }
        try:
            phase = client.get_phase_dataframe(detail)
        except KeyError:
            logger.warning(f"arrival time is not available for: {detail.id}")
            no_picks_idx.append(i)
            continue
        phase = phase.replace(_PHASE_ALIASES).sort_values(by=["Channel"])
        for sta in group_comcat_picks(phase).values():
            rows.append({
                **source_params,
                "station_network_code": sta["station_network_code"],
                "station_code": sta["station_code"],
                "station_location_code": sta["station_location_code"],
                "trace_channel": sta["trace_channel"],
                "trace_p_arrival_time": sta["trace_p_arrival_time"],
                "trace_s_arrival_time": sta["trace_s_arrival_time"],
                "trace_p_max_weight": sta["trace_p_max_weight"],
                "trace_s_max_weight": sta["trace_s_max_weight"],
                "trace_p_status": sta["trace_p_status"],
                "trace_s_status": sta["trace_s_status"],
                "trace_p_first_motion": sta["trace_p_first_motion"],
                "trace_s_first_motion": sta["trace_s_first_motion"],
            })
    pick_df = pd.DataFrame(rows)
    pick_df.to_csv(save_dir / csv_name, index=False)
    summary_df.iloc[no_picks_idx].to_csv(save_dir / "events_without_picks.csv", index=False)
    return pick_df


def read_PNSN_events(
    pnsn_events_export_filename, source_type: str, id_prefix: str = "uw"
) -> pd.DataFrame:
    """PNSN web-export CSV → ComCat summary schema (reference
    `data.py:4164-4180`): rename the export columns and prefix event ids
    with the network code ("uw<Evid>")."""
    import pandas as pd

    df = pd.read_csv(pnsn_events_export_filename)
    df["eventtype"] = source_type
    df = df.rename(columns={
        "Time UTC": "time",
        "Evid": "id",
        "Lat": "latitude",
        "Lon": "longitude",
        "Depth Km": "depth",
        "Magnitude": "magnitude",
        "Magnitude Type": "magtype",
    })
    df["id"] = df["id"].apply(lambda x: f"{id_prefix}{x}")
    return df
