"""Component rotation to ZNE (obspy's rotate_to_zne role in the download
pipeline, reference `volpick/data/data.py` `_download` → rotate_to_ZNE).

Given each channel's azimuth/dip (from a station inventory), the three
orthogonal components rotate into Z (up), N, E by inverting the direction-
cosine matrix. Dips follow the SEED convention (degrees down from
horizontal; vertical = -90).

Port of ``volpick_tpu/core/rotate.py`` (a copy on the port's own ``core.stream``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from volpick_tpu_torch.core.stream import Stream, Trace


def _direction_cosines(azimuth_deg: float, dip_deg: float) -> np.ndarray:
    """Unit vector (Z-up, N, E) of a component's positive-motion direction."""
    az = np.deg2rad(azimuth_deg)
    dip = np.deg2rad(dip_deg)
    return np.array(
        [-np.sin(dip), np.cos(dip) * np.cos(az), np.cos(dip) * np.sin(az)]
    )


def rotate_to_zne(
    stream: Stream, orientations: Dict[str, Tuple[float, float]]
) -> Stream:
    """Rotate a 3-component Stream to ZNE.

    orientations: {channel: (azimuth_deg, dip_deg)} for each input trace's
    channel (e.g. {"BH1": (30.0, 0.0), "BH2": (120.0, 0.0), "BHZ": (0, -90)}).
    Traces must share start time, length, and sampling rate. Returns a new
    Stream with channels renamed to <band><Z|N|E>.
    """
    if len(stream) != 3:
        raise ValueError(f"need exactly 3 traces, got {len(stream)}")
    trs = list(stream)
    n = trs[0].stats.npts
    for tr in trs:
        if tr.stats.npts != n:
            raise ValueError("traces must have equal length for rotation")
    m = np.stack([_direction_cosines(*orientations[tr.stats.channel]) for tr in trs])
    cond = np.linalg.cond(m)
    if cond > 1e4:
        raise ValueError(f"components are not linearly independent (cond={cond:.1e})")
    data = np.stack([np.asarray(tr.data, dtype=np.float64) for tr in trs])
    zne = np.linalg.solve(m, data)  # m @ zne = data
    out = Stream()
    band = trs[0].stats.channel[:-1]
    for i, comp in enumerate("ZNE"):
        t = Trace(
            zne[i],
            dict(
                network=trs[0].stats.network,
                station=trs[0].stats.station,
                location=trs[0].stats.location,
                channel=f"{band}{comp}",
                sampling_rate=trs[0].stats.sampling_rate,
                starttime=trs[0].stats.starttime,
            ),
        )
        out.append(t)
    return out
