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
- `device_memory_stats()`: ``torch.cuda.memory_stats`` of every card.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import socket
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


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
    (GPU 0)"), so the card's kernels form a plane of their own. The JAX
    package's traces carry no labels, and there the planes are the same."""
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
        if e.get("ph") != "X":
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
