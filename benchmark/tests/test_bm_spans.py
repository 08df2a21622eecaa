"""The six metrics that read the program's spans, on a slice and spans built
by hand: each gives the value worked out by hand below, and None with no
slice, with no spans in the slice, with a program that records none, or
(the device-time ones) where the host's calls and the device's activities
do not pair up. The device's busy ms a station-hour reads the same slice."""

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
    # 30-35, 60-70, 90-100; each activity after the call that issued it,
    # both with the call's correlation id
    device = [
        ("k", at(10), at(13), 1), ("k", at(13), at(20), 2), ("k", at(20), at(30), 4), ("k", at(35), at(40), 5),
        ("Memcpy HtoD (Pageable -> Device)", at(40), at(45), 6), ("k", at(45), at(60), 7),
        ("k", at(70), at(76), 9), ("k", at(76), at(86), 10), ("Memset (Device)", at(86), at(90), 11),
    ]
    host = [
        ("cudaLaunchKernel", at(9), at(9.01), 1),  # step 1, condition: 3 ms
        ("cudaLaunchKernel", at(11), at(11.01), 2),  # step 1, condition: 7 ms
        ("cudaEventRecord", at(14), at(14.01), 3),  # not a launch
        ("cudaLaunchKernel", at(21), at(21.01), 4),  # step 1, stack: 10 ms
        ("cudaLaunchKernel", at(30), at(30.01), 5),  # between steps: 5 ms
        ("cudaMemcpyAsync", at(34), at(34.5), 6),  # step 2, condition: 5 ms
        ("cudaLaunchKernelExC", at(43), at(43.01), 7),  # step 2, stack: 15 ms
        ("cudaStreamSynchronize", at(50), at(54), 8),  # not a launch
        ("cuLaunchKernelEx", at(69), at(69.01), 9),  # step 3, condition: 6 ms
        ("cudaLaunchCooperativeKernel", at(75), at(75.01), 10),  # step 3, stack: 10 ms
        ("cudaMemsetAsync", at(85), at(85.01), 11),  # step 3, stack: 4 ms
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
    "launches_per_step.archive": 8 / 3,  # 3 + 2 + 3 launches in 3 steps
    "launches_per_step.archive.phasenet": 8 / 3,
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
    orphan = sl.kernels[:-1] + [sl.kernels[-1][:3] + (99,)]  # an activity no call issued
    assert spans.issued(sl.host, orphan) is None
    wrong_kind = [("k",) + sl.kernels[4][1:] if i == 4 else k for i, k in enumerate(sl.kernels)]
    assert spans.issued(sl.host, wrong_kind) is None  # a copy's call owning a kernel


def issue_order(host, device):
    """Pairing by issue order: the k-th call of a kind issued the k-th
    activity of that kind on one in-order stream, where each call issues
    one activity."""
    out = []
    for call, act in spans.KINDS[:3]:
        calls = sorted(t for name, t, *_ in host if call.match(name))
        acts = sorted((a, b) for name, a, b, _ in device if act(name))
        if len(calls) != len(acts):
            return None
        out += [(t, b - a) for t, (a, b) in zip(calls, acts)]
    return out


def test_correlation_ids_pair_as_issue_order_where_each_call_issues_one_activity():
    sl = the_slice()
    shuffled = sl.kernels[::-1]  # the pairing does not lean on the order of the records
    assert sorted(spans.issued(sl.host, shuffled)) == sorted(issue_order(sl.host, sl.kernels))


def graph_slice():
    """the_slice() with step 3's stack issued by one graph replay: five
    kernels, a copy and a fill at 70-90 ms, all with the replay's id."""
    sl = the_slice()
    host = [h for h in sl.host if h[1] < at(69)] + [("cudaGraphLaunch", at(74), at(74.02), 12)]
    device = [k for k in sl.kernels if k[1] < at(70)] + [
        ("k", at(70), at(72), 12), ("k", at(72), at(75), 12), ("k", at(75), at(79), 12),
        ("Memcpy DtoD (Device -> Device)", at(79), at(80), 12), ("k", at(80), at(84), 12),
        ("k", at(84), at(88), 12), ("Memset (Device)", at(88), at(90), 12)]
    return trace.Slice(at(0), at(100), device, host)


def test_a_graph_launch_owns_every_activity_of_its_replay():
    sl, sp = graph_slice(), the_spans()
    assert issue_order(sl.host, sl.kernels) is None  # no launch call of a kernel for 5 kernels
    pairs = spans.issued(sl.host, sl.kernels)
    assert len(pairs) == len(sl.kernels)
    # step 3's condition launched nothing; its stack span (74-88 ms) holds the replay: 20 ms
    assert spans.device_ms_per_kwin(sp, pairs, "stack") == pytest.approx((10 + 15 + 20) / 0.22, rel=1e-12)
    assert spans.device_ms_per_kwin(sp, pairs, "condition") == pytest.approx((3 + 7 + 5) / 0.22, rel=1e-12)


def test_a_graph_launch_counts_as_one_launch():
    sl = graph_slice()
    assert spans.launches_per_step(the_spans(), sl.host) == pytest.approx((3 + 2 + 1) / 3, rel=1e-12)


def test_launch_names():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchKernel_v7000",
                 "cudaGraphLaunch", "cudaGraphLaunch_v10000"):
        assert spans.LAUNCH.match(name), name
    for name in ("cudaMemcpy", "cudaEventRecord", "cudaStreamSynchronize", "cudaLaunchKernelX",
                 "cudaGraphInstantiate", "cudaStreamBeginCapture"):
        assert not spans.LAUNCH.match(name), name


@pytest.mark.parametrize("name", ["device_ms_per_station_h", "device_ms_per_station_h.live"])
def test_device_ms_per_station_h_is_the_slices_busy_time_a_station_hour(name):
    read = harness.load_reader(name, REPO)
    # busy 10-30, 35-60, 70-90 ms: 65 ms over 2 requests of 16 station-hours
    ctx = SimpleNamespace(slice=the_slice(), slice_requests=2, station_hours=16.0)
    assert read(ctx) == pytest.approx(65.0 / 32.0)
    assert read(SimpleNamespace(slice=None, slice_requests=0, station_hours=16.0)) is None
