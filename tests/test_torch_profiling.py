"""The port's ``utils/profiling.py`` against the JAX package's.

- ``StepTimer``: the same summary (keys and values, exactly) from the same
  durations, and the same file from ``save``;
- ``summarize_trace`` on one hand-written Chrome trace (two named planes, a
  plane without a name, Python frames, metadata and instant events) equals
  JAX's exactly, with and without a cut to the top rows; on a trace shaped
  like PyTorch's (every process named "python3", told apart by
  ``process_labels``) the card's kernels form a plane of their own, which
  leaves out the card's copies of the program's spans
  (``gpu_user_annotation``);
- ``trace`` + ``summarize_trace`` of a CPU op read back a sorted table
  (``tests/test_utils_classical.py``'s trace test as the template);
- ``device_memory_stats`` gives one None entry without a card, and
  ``enable_nan_debugging`` switches autograd's anomaly mode.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from volpick_tpu.utils import profiling as jprof
from volpick_tpu_torch.utils import profiling as pprof


def test_step_timer_matches_jax(tmp_path, monkeypatch):
    durations = list(np.random.default_rng(0).uniform(0.01, 0.2, 9))
    got, want = pprof.StepTimer(), jprof.StepTimer()
    got.durations, want.durations = list(durations), list(durations)
    assert got.summary() == want.summary()
    assert set(got.summary()) == {"steps", "mean_s", "p50_s", "p90_s", "max_s", "steps_per_s"}
    got.save(tmp_path / "p.json")
    want.save(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert pprof.StepTimer().summary() == jprof.StepTimer().summary() == {}
    t = pprof.StepTimer(device="cpu")
    for _ in range(3):
        with t:
            pass
    s = t.summary()
    assert s["steps"] == 3 and s["steps_per_s"] > 0
    # on a card it synchronises before reading the clock, on enter and on exit
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    with pprof.StepTimer(device="cuda:0") as t:
        assert len(synced) == 1
    assert synced == [torch.device("cuda", 0)] * 2 and len(t.durations) == 1


def _chrome_trace():
    ev = [
        {"ph": "M", "name": "process_name", "pid": 7, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 7, "args": {"name": "main"}},
        {"ph": "i", "name": "marker", "pid": 7, "tid": 7, "ts": 5.0},
    ]
    rng = np.random.default_rng(1)
    for pid, names in ((7, ["aten::mm", "aten::add", "$main.py:12 f", "$main.py:40 g", "cudaLaunchKernel"]),
                       (0, ["lstm_multi_kernel", "trigger_extract_kernel", "Memcpy HtoD"]),
                       (3, ["orphan"])):
        for k in range(int(rng.integers(5, 12))):
            name = names[k % len(names)]
            ev.append({"ph": "X", "name": name, "pid": pid, "tid": 1, "ts": float(k),
                       "dur": float(rng.uniform(0.5, 900.0))})
    ev.append({"ph": "X", "name": "no duration", "pid": 0, "tid": 1, "ts": 1.0})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def test_summarize_trace_matches_jax(tmp_path):
    with gzip.open(tmp_path / "h.trace.json.gz", "wt") as f:
        json.dump(_chrome_trace(), f)
    for top in (40, 2):
        got, want = pprof.summarize_trace(tmp_path, top=top), jprof.summarize_trace(tmp_path, top=top)
        assert got == want
        assert set(got) == {"python", "GPU 0", "3"}
    rows = pprof.summarize_trace(tmp_path)["python"]
    assert "(host python frames)" in [r["name"] for r in rows]
    assert not any(r["name"].startswith("$") for r in rows)
    with pytest.raises(FileNotFoundError):
        pprof.summarize_trace(tmp_path / "nothing")


def test_summarize_trace_gives_each_labelled_process_a_plane(tmp_path):
    """A PyTorch trace names the host and the card both "python3" and labels
    them "CPU" and "GPU 0" (as on the H100 machine): the labels keep the
    card's kernels in a plane of their own, where the JAX package's rule
    merges them into the host's."""
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 118, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 118, "tid": 0, "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "X", "name": "aten::mm", "pid": 118, "tid": 118, "ts": 1.0, "dur": 40.0},
        {"ph": "X", "name": "lstm_multi_kernel", "pid": 0, "tid": 7, "ts": 2.0, "dur": 11.5},
        {"ph": "X", "name": "lstm_multi_kernel", "pid": 0, "tid": 7, "ts": 20.0, "dur": 11.7},
    ]}
    with gzip.open(tmp_path / "h.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    got = pprof.summarize_trace(tmp_path)
    assert got == {"python3 (CPU)": [{"name": "aten::mm", "total_ms": 0.04, "count": 1, "mean_us": 40.0}],
                   "python3 (GPU 0)": [{"name": "lstm_multi_kernel", "total_ms": 0.023, "count": 2,
                                        "mean_us": 11.6}]}
    assert set(jprof.summarize_trace(tmp_path)) == {"python3"}


def test_summarize_trace_keeps_span_ranges_out_of_the_kernel_plane(tmp_path):
    """A CPU + CUDA session writes each ``record_function`` range (a span)
    onto the card's stream too, covering the kernels it holds: it is left
    out, so the card's plane counts no time twice and stays the one plane
    of the card."""
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "X", "cat": "kernel", "name": "lstm_multi_kernel", "pid": 0, "tid": 7, "ts": 2.0, "dur": 11.5},
        {"ph": "X", "cat": "kernel", "name": "lstm_multi_kernel", "pid": 0, "tid": 7, "ts": 20.0, "dur": 11.7},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "forward", "pid": 0, "tid": 7, "ts": 2.0,
         "dur": 29.7},
    ]}
    with gzip.open(tmp_path / "h.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    assert pprof.summarize_trace(tmp_path) == {
        "python3 (GPU 0)": [{"name": "lstm_multi_kernel", "total_ms": 0.023, "count": 2, "mean_us": 11.6}],
    }


def test_trace_summary_of_a_cpu_op(tmp_path):
    with pprof.trace(tmp_path):
        x = torch.ones((128, 128))
        (x @ x).sum()
    assert len(list(tmp_path.glob("*.trace.json.gz"))) == 1 and not list(tmp_path.glob("*.json"))
    planes = pprof.summarize_trace(tmp_path, top=10)
    assert planes, "no planes parsed"
    names = {r["name"] for rows in planes.values() for r in rows}
    assert "aten::mm" in names
    for rows in planes.values():
        assert rows and {"name", "total_ms", "count", "mean_us"} <= set(rows[0])
        assert rows == sorted(rows, key=lambda r: -r["total_ms"])


def test_memory_stats_and_nan_debugging(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pprof.device_memory_stats() == {"cpu": None}
    before = torch.is_anomaly_enabled()
    try:
        pprof.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        pprof.enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
