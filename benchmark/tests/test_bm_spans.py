"""The six metrics that read the program's spans, on a slice and spans built
by hand: each gives the value worked out by hand below, and None with no
slice, with no spans in the slice, with a program that records none, or
(the device-time ones) where the host's calls and the device's activities
do not pair up."""

from types import SimpleNamespace

import pytest

from conftest import REPO
from benchmark import harness, spans, trace
from volpick_tpu_torch.utils import profiling

MS = 1_000_000  # ns
T0 = 1_700_000_000 * 10**9  # the trace's clock counts ns since the epoch


def at(ms: float) -> int:
    return T0 + int(ms * MS)


def sp(name, start, end, parent=None, request=1, device_ms=None, **counts):
    return SimpleNamespace(name=name, request=request, id=None, parent=parent, start_ns=at(start),
                           end_ns=at(end), counts=counts, device_ms=device_ms)


def the_slice():
    # device busy 10-30, 35-60, 70-90 ms of a 0-100 ms slice: idle 0-10,
    # 30-35, 60-70, 90-100; each activity after the call that issued it
    device = [
        ("k", at(10), at(13)), ("k", at(13), at(20)), ("k", at(20), at(30)), ("k", at(35), at(40)),
        ("Memcpy HtoD (Pageable -> Device)", at(40), at(45)), ("k", at(45), at(60)),
        ("k", at(70), at(76)), ("k", at(76), at(86)), ("Memset (Device)", at(86), at(90)),
    ]
    host = [
        ("cudaLaunchKernel", at(9), at(9.01)),  # step 1, condition: 3 ms
        ("cudaLaunchKernel", at(11), at(11.01)),  # step 1, condition: 7 ms
        ("cudaEventRecord", at(14), at(14.01)),  # not a launch
        ("cudaLaunchKernel", at(21), at(21.01)),  # step 1, stack: 10 ms
        ("cudaLaunchKernel", at(30), at(30.01)),  # between steps: 5 ms
        ("cudaMemcpyAsync", at(34), at(34.5)),  # step 2, condition: 5 ms
        ("cudaLaunchKernelExC", at(43), at(43.01)),  # step 2, stack: 15 ms
        ("cudaStreamSynchronize", at(50), at(54)),  # not a launch
        ("cuLaunchKernelEx", at(69), at(69.01)),  # step 3, condition: 6 ms
        ("cudaLaunchCooperativeKernel", at(75), at(75.01)),  # step 3, stack: 10 ms
        ("cudaMemsetAsync", at(85), at(85.01)),  # step 3, stack: 4 ms
    ]
    return trace.Slice(at(0), at(100), device, host)


def the_spans():
    return [
        sp("classify", -20, -1, request=0),  # before the slice: not read
        sp("classify", 5, 62, request=1),  # idle inside: 5 + 5 + 2 = 12 ms
        sp("plan", 5, 6, parent=1),
        sp("step", 8, 29, parent=1, windows=100, slots=128),
        sp("condition", 8, 12, parent=2, device_ms=4.0, windows=128),
        sp("stack", 20, 28, parent=2, device_ms=8.0),
        sp("step", 33, 55, parent=1, windows=50, slots=50, flush=1),
        sp("condition", 33, 41, parent=3, device_ms=8.0, windows=50),
        sp("stack", 42, 55, parent=3, device_ms=13.0),
        sp("classify", 65, 95, request=2),  # idle inside: 5 + 5 = 10 ms
        sp("classify", 66, 94, parent=4, request=2),  # a segment: not a request
        sp("step", 68, 88, parent=5, request=2, windows=70, slots=70),
        sp("condition", 68, 73, parent=6, request=2, device_ms=5.0, windows=70),
        sp("stack", 74, 88, parent=6, request=2, device_ms=14.0),
        sp("classify", 96, 99, request=3),  # idle inside: 3 ms
    ]


WANT = {
    "held_idle_ms.live": 10.0,  # median of 12, 10, 3
    "held_idle_ms.archive": 10.0,
    "held_idle_ms.archive.phasenet": 10.0,
    "launches_per_step.archive.phasenet": 8 / 3,  # 3 + 2 + 3 launches in 3 steps
    "condition_ms_per_kwin.archive": (3 + 7 + 5 + 6) / 0.22,  # 220 real windows
    "stack_ms_per_kwin.archive": (10 + 15 + 10 + 4) / 0.22,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_metric_reads_the_hand_computed_value(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", the_spans)
    read = harness.load_reader(name, REPO)
    assert read(SimpleNamespace(slice=the_slice())) == pytest.approx(WANT[name], rel=1e-12)
    assert read(SimpleNamespace(slice=None)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(SimpleNamespace(slice=the_slice())) is None
    monkeypatch.setattr(profiling, "spans", lambda: the_spans()[:1])  # none inside the slice
    assert read(SimpleNamespace(slice=the_slice())) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert read(SimpleNamespace(slice=the_slice())) is None


@pytest.mark.parametrize("name", ["condition", "stack"])
def test_device_time_is_none_where_calls_and_activities_do_not_pair(name):
    sl = the_slice()
    assert spans.device_ms_per_kwin(the_spans(), spans.issued(sl.host, sl.kernels), name) is not None
    for lost in (sl.kernels[:3] + sl.kernels[4:], sl.kernels[:4] + sl.kernels[5:], sl.kernels[:-1]):
        assert spans.issued(sl.host, lost) is None  # a kernel, a copy, a fill lost
        assert spans.device_ms_per_kwin(the_spans(), spans.issued(sl.host, lost), name) is None


def test_launch_names():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchKernel_v7000"):
        assert spans.LAUNCH.match(name), name
    for name in ("cudaMemcpy", "cudaEventRecord", "cudaStreamSynchronize", "cudaLaunchKernelX"):
        assert not spans.LAUNCH.match(name), name
