"""How one ``classify_arrays`` request divides into windows and forwards.

The benchmark's own copy of the window placement (SeisBench ``annotate``:
windows at i * stride, plus one flush with the stream end where the grid
does not end there) and of the picker's step plan (balanced steps of
``batch // stations`` window indices across all stations, the flush window
as one more forward of one window a station), so that counts of windows,
forwards and kernel work come from the request's shape alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Plan:
    stations: int
    padded_total: int  # samples a row after padding a short stream to one window
    starts: List[int]  # window starts a station, the flush window last
    flush: bool
    forwards: List[int]  # windows of each forward, padded windows included
    max_picks: int  # the picker's default pick slots a row

    @property
    def windows(self) -> int:
        """Real windows of the request (all stations, flush included)."""
        return self.stations * len(self.starts)


def window_starts(total: int, window: int, overlap: int) -> List[int]:
    stride = window - overlap
    if stride < 1:
        raise ValueError(f"overlap {overlap} must be < window {window}")
    if total <= window:
        return [0]
    starts = list(range(0, total - window + 1, stride))
    if starts[-1] + window < total:
        starts.append(total - window)
    return starts


def plan(stations: int, total: int, window: int, overlap: int, batch: int,
         max_picks: Optional[int] = None) -> Plan:
    stride = window - overlap
    starts = window_starts(total, window, overlap)
    padded = max(total, window)
    flush = len(starts) >= 2 and starts[-1] != (len(starts) - 1) * stride
    n_uni = len(starts) - int(flush)
    if -(-window // stride) > 64:  # the picker's gather path: chunks of `batch` windows
        n = stations * len(starts)
        forwards = [min(batch, n - j) for j in range(0, n, batch)]
    else:
        wpc = max(1, batch // stations)
        n_steps = -(-n_uni // wpc)
        wpc = max(1, -(-n_uni // n_steps))
        forwards = [wpc * stations] * n_steps + ([stations] if flush else [])
    if max_picks is None:
        max_picks = min(max(32, padded // window * 4), 4096)
    return Plan(stations, padded, starts, flush, forwards, max_picks)
