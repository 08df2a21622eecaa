"""Real-time streaming picker: feed waveform chunks, receive picks incrementally.

Port of ``volpick_tpu/picker/streaming.py``, on the port's ``core`` types and
``WaveformPicker.classify_arrays`` (so it runs where its picker runs: on the
card unless the picker was built with ``device="cpu"``).

Production-serving counterpart of classify(): per-station buffers absorb
incoming chunks; once enough unprocessed signal accumulates, the device
pipeline runs over [history | new] and picks are emitted exactly once —
a pick is released only when its peak lies far enough from the live edge that
later data cannot change it (one window of lookahead), so streamed picks
match offline classify() on the same data. The buffer's origin and the
release bound are float64 seconds on the host, advanced by the same
operations in the same order as in the JAX class: they decide
``peak_t < emitted_until``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from volpick_tpu_torch.core.picks import Pick, PickList
from volpick_tpu_torch.core.stream import UTC, Trace


class StreamingPicker:
    """``ingest(trace)`` returns the picks that became final with this chunk,
    ``flush()`` those still held back. ``thresholds`` default to the model's
    ``default_args`` (else 0.3); a VolEQTransformer's two detection heads
    share the detection threshold, as in ``WaveformPicker.classify``."""

    def __init__(
        self,
        picker,
        overlap: Optional[int] = None,
        blinding: Tuple[int, int] = (500, 500),
        thresholds: Optional[Dict[str, float]] = None,
        hop_seconds: float = 30.0,
        batch_size: int = 64,
    ):
        self.picker = picker
        self.window = picker.in_samples
        self.sr = picker.model.sampling_rate
        self.overlap = overlap if overlap is not None else self.window // 2
        self.blinding = blinding
        d = picker.model.default_args
        det = d.get("detection_threshold", 0.3)
        self.thresholds = thresholds or {
            "P": d.get("P_threshold", 0.3),
            "S": d.get("S_threshold", 0.3),
            "Detection": det,
            "Detection_rg": det,
            "Detection_lp": det,
            "N": 2.0,
        }
        self.hop = int(hop_seconds * self.sr)
        self.batch_size = batch_size
        # per-station state
        self._buf: Dict[str, np.ndarray] = {}
        self._t0: Dict[str, float] = {}  # absolute time of buffer sample 0
        self._emitted_until: Dict[str, float] = {}  # absolute time bound of released picks
        self._processed_n: Dict[str, int] = {}  # buffer length at last processing

    def _station_key(self, tr: Trace) -> str:
        chan = tr.stats.channel
        return f"{tr.stats.network}.{tr.stats.station}.{tr.stats.location}.{chan[:-1] if chan else ''}"

    def _comp_index(self, tr: Trace) -> Optional[int]:
        order = self.picker.model.component_order
        c = tr.stats.channel[-1] if tr.stats.channel else ""
        return order.index(c) if c in order else None

    def ingest(self, trace: Trace) -> PickList:
        """Append a chunk; returns newly finalized picks (possibly empty)."""
        key = self._station_key(trace)
        ci = self._comp_index(trace)
        if ci is None:
            return PickList()
        n_comp = len(self.picker.model.component_order)
        if key not in self._buf:
            self._buf[key] = np.zeros((n_comp, 0), dtype=np.float32)
            self._t0[key] = trace.stats.starttime.timestamp
            self._emitted_until[key] = -np.inf
        buf = self._buf[key]
        off = int(round((trace.stats.starttime.timestamp - self._t0[key]) * self.sr))
        end = off + trace.stats.npts
        if end > buf.shape[1]:
            grown = np.zeros((n_comp, end), dtype=np.float32)
            grown[:, : buf.shape[1]] = buf
            buf = grown
        data = np.asarray(trace.data, dtype=np.float32)
        if off < 0:
            # late packet overlapping the buffer origin: keep the in-buffer part
            data = data[-off:]
            off = 0
        if len(data):
            buf[ci, off : off + len(data)] = data
        self._buf[key] = buf
        return self._maybe_process(key)

    def _maybe_process(self, key: str, final: bool = False) -> PickList:
        buf = self._buf[key]
        n = buf.shape[1]
        if n == 0 or (not final and n < self.window):
            return PickList()
        # Release bound: a stacked-curve sample at position p is final once
        # every window that can cover it (grid starts in (p-window, p]) ends
        # within the current data, i.e. p < n - window. Padded tail windows
        # (start > n - window) only cover positions >= their start > p, so
        # released positions are untouched by future data.
        guard = 0 if final else self.window
        release_time = self._t0[key] + (n - guard) / self.sr
        if not final and (n - self._processed_n.get(key, 0)) < self.hop:
            return PickList()
        self._processed_n[key] = n

        results = self.picker.classify_arrays(
            buf[None],
            self.thresholds,
            overlap=self.overlap,
            blinding=self.blinding,
            batch_size=self.batch_size,
        )
        trace_id = key.rsplit(".", 1)[0]
        out = PickList()
        t0 = self._t0[key]
        for label, (pk, val, valid, on, off) in results.items():
            if label == "N" or label.startswith("Detection"):
                continue
            for j in np.where(valid[0])[0]:
                if on[0, j] >= n:
                    continue
                peak_t = t0 + pk[0, j] / self.sr
                # emit iff emitted_until <= peak < release (half-open ranges
                # chain without gaps or duplicates across passes)
                if peak_t < self._emitted_until[key] or peak_t >= release_time:
                    continue
                out.append(
                    Pick(
                        trace_id=trace_id,
                        start_time=UTC(t0 + on[0, j] / self.sr),
                        end_time=UTC(t0 + off[0, j] / self.sr),
                        peak_time=UTC(peak_t),
                        peak_value=float(val[0, j]),
                        phase=label,
                    )
                )
        self._emitted_until[key] = max(self._emitted_until[key], release_time)

        # drop history we no longer need, in stride multiples so the window
        # grid stays anchored to the same absolute sample phase as offline
        # classify() (an arbitrary drop would re-anchor the grid and change
        # post-trim curves)
        stride = self.window - self.overlap
        keep = self.window + guard + self.hop
        if n > keep:
            drop = ((n - keep) // stride) * stride
            if drop > 0:
                self._buf[key] = buf[:, drop:]
                self._t0[key] = t0 + drop / self.sr
                self._processed_n[key] = max(self._processed_n.get(key, 0) - drop, 0)
        out.sort()
        return out

    def flush(self) -> PickList:
        """Process all remaining buffered data and release every pick."""
        out = PickList()
        for key in list(self._buf):
            out.extend(self._maybe_process(key, final=True))
        out.sort()
        return out
