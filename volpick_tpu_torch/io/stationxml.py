"""Minimal FDSN StationXML reader (channel orientations + coordinates).

The reference reads station inventories with obspy (`read_inventory`) to
rotate raw channels to ZNE (reference `volpick/data/convert.py:375-380`,
`data.py:3012-3060`). This parser extracts exactly what the rotation and
metadata paths need — per-channel azimuth/dip and station coordinates —
with the standard library's ElementTree, no obspy.

A copy of ``volpick_tpu/io/stationxml.py``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Tuple, Union


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _child_text(elem, name):
    for ch in elem:
        if _local(ch.tag) == name:
            return ch.text
    return None


def read_stationxml(path: Union[str, Path]) -> Dict:
    """Parse a StationXML file.

    Returns {"channels": {"NET.STA.LOC.CHA": (azimuth_deg, dip_deg)},
             "coords": {"NET.STA": (lat, lon, elev_m)}} — the orientation
    dict feeds `core.rotate.rotate_to_zne` keyed by channel code alone when
    the caller selects one station's traces."""
    root = ET.parse(str(path)).getroot()
    channels: Dict[str, Tuple[float, float]] = {}
    coords: Dict[str, Tuple[float, float, float]] = {}
    for net in root:
        if _local(net.tag) != "Network":
            continue
        net_code = net.get("code", "")
        for sta in net:
            if _local(sta.tag) != "Station":
                continue
            sta_code = sta.get("code", "")
            lat = _child_text(sta, "Latitude")
            lon = _child_text(sta, "Longitude")
            elev = _child_text(sta, "Elevation")
            if lat is not None and lon is not None:
                coords[f"{net_code}.{sta_code}"] = (
                    float(lat), float(lon), float(elev) if elev is not None else 0.0
                )
            for cha in sta:
                if _local(cha.tag) != "Channel":
                    continue
                code = cha.get("code", "")
                loc = cha.get("locationCode", "") or ""
                az = _child_text(cha, "Azimuth")
                dip = _child_text(cha, "Dip")
                if az is None or dip is None:
                    continue
                channels[f"{net_code}.{sta_code}.{loc}.{code}"] = (float(az), float(dip))
    return {"channels": channels, "coords": coords}


def channel_orientations(inv: Dict, network: str, station: str) -> Dict[str, Tuple[float, float]]:
    """One station's {channel_code: (azimuth, dip)} for rotate_to_zne."""
    out = {}
    prefix = f"{network}.{station}."
    for key, ori in inv["channels"].items():
        if key.startswith(prefix):
            out[key.rsplit(".", 1)[-1]] = ori
    return out
