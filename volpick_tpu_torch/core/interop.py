"""obspy interoperability: convert Streams/Traces in either direction.

The framework's runtime is obspy-free (native readers in `volpick_tpu_torch.io`),
but reference-stack users arrive holding obspy Streams — the reference's
own picking example starts from one (its README, "First
read data into an obspy Stream"). These converters are duck-typed on the
obspy Trace surface (`.data`, `.stats.{network,station,location,channel,
sampling_rate,starttime}` with an epoch `.timestamp`), so they need obspy
installed only when `to_obspy` constructs output objects.

Port of ``volpick_tpu/core/interop.py`` (a copy on the port's own ``core.stream``).
"""

from __future__ import annotations

import numpy as np

from volpick_tpu_torch.core.stream import Stream, Trace, UTC


def from_obspy(stream) -> Stream:
    """obspy Stream (or any iterable of obspy-like Traces) → native Stream.

    Copies data into float-preserving numpy arrays; header fields map
    one-to-one (starttime via its POSIX `.timestamp`).
    """
    out = []
    for tr in stream:
        s = tr.stats
        out.append(
            Trace(
                np.asarray(tr.data),
                dict(
                    network=getattr(s, "network", ""),
                    station=getattr(s, "station", ""),
                    location=getattr(s, "location", ""),
                    channel=getattr(s, "channel", ""),
                    sampling_rate=float(getattr(s, "sampling_rate", 100.0)),
                    starttime=UTC(float(s.starttime.timestamp)),
                ),
            )
        )
    return Stream(out)


def to_obspy(stream: Stream):
    """Native Stream → obspy Stream (requires obspy installed)."""
    import obspy  # deferred: the framework itself never needs it

    traces = []
    for tr in stream:
        s = tr.stats
        traces.append(
            obspy.Trace(
                data=np.asarray(tr.data),
                header=dict(
                    network=s.network,
                    station=s.station,
                    location=s.location,
                    channel=s.channel,
                    sampling_rate=s.sampling_rate,
                    starttime=obspy.UTCDateTime(s.starttime.timestamp),
                ),
            )
        )
    return obspy.Stream(traces)
