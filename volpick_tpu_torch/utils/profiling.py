"""Tracing / profiling / debugging helpers (PyTorch port of
``volpick_tpu/utils/profiling.py``).

- `trace(dir)`: context manager around a ``torch.profiler`` trace of the
  block (host ops, and the card's kernels when CUDA is available), written
  as a gzipped Chrome trace (view in Perfetto or chrome://tracing);
- `summarize_trace(dir)`: the op-level table of the newest such trace, by
  plane (the trace's processes: the host, and the card's streams);
- `StepTimer`: per-step wall-clock accounting written next to metrics.csv
  (the reference only records total running_time.txt, `train.py:209-216`);
  with a CUDA `device` it synchronises the card before reading the clock;
- `enable_nan_debugging()`: autograd's anomaly mode, so the backward op that
  first makes a NaN raises with the traceback of its forward;
- `device_memory_stats()`: ``torch.cuda.memory_stats`` of every card;
- `span(name, device=None, **counts)`: a span of the program's work, kept
  while a ``torch.profiler`` session is active (`trace(dir)` is one), and
  `spans()`: the spans kept, oldest first.
"""

from __future__ import annotations

import contextlib
import gzip
import itertools
import json
import os
import shutil
import socket
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# spans kept, oldest first: a traced request of the archive cells opens
# ~420, a second of the live cell ~400
SPAN_BUFFER = 1 << 15


@contextlib.contextmanager
def trace(log_dir):
    """Profile a block: `with trace("/tmp/torchtrace"): step(...)`. Writes
    `<host>.<pid>.<ns>.trace.json.gz` under `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    stem = log_dir / f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.trace.json"
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(str(stem))
        with open(stem, "rb") as fin, gzip.open(f"{stem}.gz", "wb") as fout:
            shutil.copyfileobj(fin, fout)
        stem.unlink()


def summarize_trace(log_dir, top: int = 40) -> Dict:
    """Op-level summary of the newest `*.trace.json.gz` under `log_dir`.

    Groups complete ('X') events by process (a plane: its ``process_name``)
    and name, and returns {plane: [{name, total_ms, count, mean_us}, ...]}
    sorted by total time, top-`top` rows per plane. Host Python-frame events
    (names starting with '$') are collapsed into one row so op rows dominate
    the report. A PyTorch trace names the host and every card after the
    program ("python3") and tells them apart by ``process_labels``; where a
    process has labels they follow its name ("python3 (CPU)", "python3
    (GPU 0)"), so the card's kernels form a plane of their own. The card's
    copies of ``record_function`` ranges (``cat`` "gpu_user_annotation": the
    program's spans) each cover the kernels they hold, and are left out, so
    that the card's plane counts no time twice. The JAX package's traces
    carry neither, and there the planes are the same."""
    from collections import defaultdict

    traces = sorted(Path(log_dir).rglob("*.trace.json.gz"), key=lambda p: p.stat().st_mtime)
    if not traces:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(traces[-1], "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    plane_names, labels = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            plane_names[e["pid"]] = e.get("args", {}).get("name", str(e["pid"]))
        elif e.get("ph") == "M" and e.get("name") == "process_labels":
            labels[e["pid"]] = e.get("args", {}).get("labels")
    for pid, label in labels.items():
        if pid in plane_names and label:
            plane_names[pid] = f"{plane_names[pid]} ({label})"
    acc: Dict = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    for e in events:
        if e.get("ph") != "X" or e.get("cat") == "gpu_user_annotation":
            continue
        plane = plane_names.get(e.get("pid"), str(e.get("pid")))
        name = e.get("name", "?")
        if name.startswith("$"):
            name = "(host python frames)"
        slot = acc[plane][name]
        slot[0] += float(e.get("dur", 0.0))  # microseconds
        slot[1] += 1
    out = {}
    for plane, names in acc.items():
        rows = [
            {
                "name": n,
                "total_ms": round(tot / 1000.0, 3),
                "count": cnt,
                "mean_us": round(tot / max(cnt, 1), 1),
            }
            for n, (tot, cnt) in names.items()
        ]
        rows.sort(key=lambda r: -r["total_ms"])
        out[plane] = rows[:top]
    return out


def enable_nan_debugging(enable: bool = True):
    torch.autograd.set_detect_anomaly(enable)


def device_memory_stats() -> Dict:
    """Per-device memory stats: ``torch.cuda.memory_stats`` of each visible
    card; on a machine without one, {"cpu": None} (the JAX package gives None
    for a backend without stats)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {str(torch.device("cuda", i)): torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


class StepTimer:
    """Accumulates per-step durations; summary() gives p50/p90/max and
    steps/s. Write to disk with save(). With a CUDA `device` the card is
    synchronised on enter and on exit, so a step's time includes its device
    work."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.durations.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict:
        import numpy as np

        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "max_s": float(d.max()),
            "steps_per_s": float(1.0 / d.mean()),
        }

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


class _NoSpan:
    """What `span` returns while nothing records: one shared context that
    does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def count(self, **counts):
        pass


_NO_SPAN = _NoSpan()
_SPANS: deque = deque(maxlen=SPAN_BUFFER)
_ids = itertools.count(1)


class _Open(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []


_open = _Open()


class Span:
    """One span of the program's work: ``name``; ``request``, the id of its
    root span (a span opened outside any other is a root, its own request);
    ``id``; ``parent``, the id of the span it was opened in (None for a
    root); ``start_ns`` / ``end_ns`` on ``time.time_ns()``, the clock of
    ``torch.profiler``'s events, taken outside its ``record_function`` so
    that the span encloses that event; ``counts`` (windows, bytes, ...).

    ``device_ms`` is None for a span on the host or on a CPU device. A span
    on a CUDA device records a CUDA event on the current stream at each end,
    and ``device_ms`` is the time between them: from where the stream
    reached the first (the end of the work before the span, or the host's
    record, whichever came later) to the end of the span's last kernel, the
    device's idle time inside included. Read it after synchronising the
    device."""

    __slots__ = ("name", "request", "id", "parent", "start_ns", "end_ns", "counts",
                 "_stream", "_start_ev", "_end_ev", "_rf")

    def __init__(self, name: str, device, counts: dict):
        self.name = name
        self.counts = counts
        self.end_ns = None
        self._stream = None
        self._start_ev = self._end_ev = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)

    def count(self, **counts):
        """Add counts known only once the span is open."""
        self.counts.update(counts)

    def __enter__(self):
        stack = _open.stack
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        if self._stream is not None:
            self._start_ev = torch.cuda.Event(enable_timing=True)
            self._start_ev.record(self._stream)
        stack.append(self)
        _SPANS.append(self)
        self.start_ns = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._rf.__exit__(exc_type, exc, tb)
        self._rf = None
        self.end_ns = time.time_ns()
        _open.stack.pop()
        if self._stream is not None:
            self._end_ev = torch.cuda.Event(enable_timing=True)
            self._end_ev.record(self._stream)
        return None

    @property
    def device_ms(self) -> Optional[float]:
        if self._end_ev is None:
            return None
        return self._start_ev.elapsed_time(self._end_ev)


def span(name: str, device=None, **counts):
    """`with span("forward", x.device, windows=n):` a span of the program's
    work, kept while a ``torch.profiler`` session is active and read back
    by `spans()`. It also enters ``torch.profiler.record_function(name)``,
    so a Chrome trace of `trace(dir)` shows it on the host and on the
    card's stream. With a CUDA `device` it times its work on the device
    (``Span.device_ms``) by CUDA events on the current stream. It never
    synchronises the device. Outside a profiler session it
    returns one shared context that does nothing, after one flag check."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return Span(name, device, counts)


def spans() -> List[Span]:
    """The closed spans kept (the last ``SPAN_BUFFER`` opened), oldest
    first. A reader takes those of its time window."""
    return [s for s in list(_SPANS) if s.end_ns is not None]
