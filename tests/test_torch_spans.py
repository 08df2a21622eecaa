"""The port's span recorder (``utils/profiling.py::span``) in the picker and
in EQTransformer's eval forward, on the CPU.

- Outside a ``torch.profiler`` session nothing is kept, and ``span`` hands
  out one shared no-op context.
- A profiled ``classify_arrays`` of a small PhaseNet gives one root
  ``classify`` a call holding ``plan``, ``upload``, one ``step`` a forward
  (each with ``condition``, ``forward`` and ``stack``), ``triggers`` and
  ``readback``; every child lies inside its parent and carries its
  request id, and the steps' windows add up to the plan's.
- A call longer than ``max_span`` holds one child ``classify`` a segment.
- Each span encloses the ``record_function`` event it opens, on the
  profiler's clock.
- The picks are bitwise the same with spans recorded and without.
- A small EQTransformer's eval forward gives its five stages in order, and
  its train forward none.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volpick_tpu_torch.models import load_model
from volpick_tpu_torch.picker import WaveformPicker
from volpick_tpu_torch.utils import profiling

THR = {"P": 0.3, "S": 0.3}
KW = dict(overlap=1500, blinding=(250, 250), batch_size=8)


@pytest.fixture(scope="module")
def picker():
    model = load_model("phasenet", seed=3, device="cpu")
    return WaveformPicker(model, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 3, 11000)) * 0.1).astype(np.float32)
    x[:, :, 4000:4100] += 2.0 * np.hanning(100).astype(np.float32)
    return x


def recorded(fn):
    """fn() in a CPU profiler session → (its result, the spans it kept,
    the session's kineto events)."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = [s for s in profiling.spans() if s.start_ns >= t0]
    return out, got, list(prof.profiler.kineto_results.events())


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_nothing_is_kept_outside_a_session(picker, data):
    t0 = time.time_ns()
    picker.classify_arrays(data, THR, **KW)
    assert [s for s in profiling.spans() if s.start_ns >= t0] == []
    assert profiling.span("a") is profiling.span("b", torch.device("cpu"), windows=3)
    with profiling.span("a") as sp:
        sp.count(windows=1)


def test_classify_spans_nest_and_count(picker, data):
    _, got, _ = recorded(lambda: [picker.classify_arrays(data, THR, **KW) for _ in range(2)])
    roots = [s for s in got if s.parent is None]
    assert [r.name for r in roots] == ["classify", "classify"]
    assert roots[0].request != roots[1].request
    n_win = len(picker._plan_windows(data, KW["overlap"])[2])
    for root in roots:
        mine = [s for s in got if s.request == root.request]
        assert all(s.request == root.id for s in mine)
        kids = children(mine, root)
        steps = [k for k in kids if k.name == "step"]
        names = [k.name for k in kids]
        assert names == ["plan", "upload"] + ["step"] * len(steps) + ["stack", "triggers", "readback"]
        assert root.counts == {"stations": 2, "samples": data.shape[-1], "windows": 2 * n_win}
        assert sum(s.counts["windows"] for s in steps) == 2 * n_win
        assert all(s.counts["windows"] <= s.counts["slots"] for s in steps)
        assert [s.counts.get("flush", 0) for s in steps] == [0] * (len(steps) - 1) + [1]
        for st in steps:
            assert [k.name for k in children(mine, st)] == ["condition", "forward", "stack"]
        assert kids[1].counts == {"bytes": data.nbytes}
        assert kids[-1].counts["bytes"] > 0
        assert kids[-2].counts == {"rows": 4, "max_picks": 32}
        by_id = {s.id: s for s in mine}
        for s in mine:
            assert s.start_ns <= s.end_ns
            assert s.device_ms is None  # the CPU is not timed
            if s.parent is not None:
                p = by_id[s.parent]
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_long_calls_hold_a_classify_a_segment(picker, data):
    _, got, _ = recorded(lambda: picker.classify_arrays(data, THR, max_span=6000, **KW))
    root, = [s for s in got if s.parent is None]
    segs = [s for s in children(got, root) if s.name == "classify"]
    assert len(segs) == root.counts["segments"] > 1
    assert all(s.request == root.id for s in got)
    assert all([k.name for k in children(got, seg)][:2] == ["plan", "upload"] for seg in segs)


def test_each_span_encloses_its_profiler_event(picker, data):
    _, got, events = recorded(lambda: picker.classify_arrays(data, THR, **KW))
    names = {s.name for s in got}
    assert names >= {"classify", "plan", "upload", "step", "condition", "forward", "stack", "triggers",
                     "readback"}
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in got if s.name == name)
        theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if e.name() == name)
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            assert a <= c <= d <= b, name


def test_picks_are_bitwise_the_same_with_spans(picker, data):
    off = picker.classify_arrays(data, THR, **KW)
    on, got, _ = recorded(lambda: picker.classify_arrays(data, THR, **KW))
    assert got and off.keys() == on.keys()
    for lab in off:
        for a, b in zip(off[lab], on[lab]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    curves_off = picker.annotate_array(data, **KW)
    curves_on, got, _ = recorded(lambda: picker.annotate_array(data, **KW))
    assert [s.name for s in got if s.parent is None] == ["annotate"]
    assert np.array_equal(curves_off, curves_on)


def test_eqtransformer_forward_stages():
    model = load_model("eqtransformer", seed=1, in_samples=1504, lstm_blocks=1, device="cpu")
    x = torch.randn(2, 3, 1504)
    with torch.inference_mode():
        _, got, _ = recorded(lambda: model(x))
    assert [s.name for s in got] == ["eqt.encoder", "eqt.res_cnn", "eqt.bilstm", "eqt.transformer",
                                     "eqt.branches"]
    assert all(s.parent is None for s in got)
    assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
    model.train()
    _, got, _ = recorded(lambda: model(x))
    assert got == []
