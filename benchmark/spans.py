"""The program's spans in a traced slice, and the arithmetic of the metrics
that read them.

The program records a span at each boundary of its picker while a
``torch.profiler`` session is active (``volpick_tpu_torch/utils/
profiling.py::span``; the slice's session is one): a root ``classify`` a
request holding ``plan``, ``upload``, one ``step`` a forward (with
``condition``, ``forward``, ``stack``), ``triggers`` and ``readback``. A
span has ``name``, ``request``, ``id``, ``parent``, ``start_ns``,
``end_ns`` on the trace's clock and ``counts``.

A span's device work is what the host calls inside it put on the device:
each device activity goes to the host call with its correlation id
(``issued``), whatever the order of either, so that one ``cudaGraphLaunch``
owns every kernel its replay runs. That is the span's kernels' own time,
without the device's idle inside the span (its ``device_ms`` from CUDA
events has that idle, and under the profiler, which slows the host, mostly
idle).

``fetch`` is the one function that imports the program; where the program
records no spans it returns None, and so does every metric. The rest takes
plain lists, so that it can be checked on spans built by hand.
"""

from __future__ import annotations

import bisect
import re
import statistics
from typing import List, Optional, Sequence, Tuple

# the CUDA runtime and driver calls that put work on the device's queue, as
# the profiler names the host's events; a graph's replay is one call
LAUNCH = re.compile(r"^(cudaLaunchKernel(ExC)?|cudaLaunchCooperativeKernel(MultiDevice)?|"
                    r"cuLaunchKernel(Ex)?|cudaMemcpyAsync|cudaMemsetAsync|cudaGraphLaunch)(_v\d+)?$")


# a host call that puts work on the device's queue, and a test of the name
# of each activity it may put there, by kind
KINDS = (
    (re.compile(r"^(cudaLaunchKernel(ExC)?|cudaLaunchCooperativeKernel(MultiDevice)?|"
                r"cuLaunchKernel(Ex)?)(_v\d+)?$"),
     lambda name: not name.startswith(("Memcpy", "Memset"))),
    (re.compile(r"^cudaMemcpy(Async)?(_v\d+)?$"), lambda name: name.startswith("Memcpy")),
    (re.compile(r"^cudaMemset(Async)?(_v\d+)?$"), lambda name: name.startswith("Memset")),
    (re.compile(r"^cudaGraphLaunch(_v\d+)?$"), lambda name: True),  # kernels, copies and fills
)


def fetch(ctx) -> Optional[list]:
    """The program's spans inside the slice's window, or None where there is
    no slice or the program kept none there."""
    if ctx.slice is None:
        return None
    try:
        from volpick_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    return within(profiling.spans(), ctx.slice.start_ns, ctx.slice.end_ns) or None


def within(spans: Sequence, start_ns: int, end_ns: int) -> list:
    return [s for s in spans if start_ns <= s.start_ns and s.end_ns <= end_ns]


def overlap_ns(intervals: Sequence[Tuple[int, int]], a: int, b: int) -> int:
    """How much of [a, b] the disjoint intervals cover."""
    return sum(max(0, min(b, y) - max(a, x)) for x, y in intervals)


def held_idle_ms(spans: Sequence, gaps: Sequence[Tuple[int, int]]) -> Optional[float]:
    """Median over the root ``classify`` spans (one a request) of the device's
    idle time inside each, in ms: the idle the program holds the device in,
    without the client's waits between requests."""
    roots = [s for s in spans if s.name == "classify" and s.parent is None]
    if not roots:
        return None
    return statistics.median(overlap_ns(gaps, s.start_ns, s.end_ns) for s in roots) / 1e6


def _inside(intervals: Sequence[Tuple[int, int]]):
    """A test of whether time t lies in one of the sorted, disjoint intervals."""
    starts = [a for a, _ in intervals]

    def test(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= intervals[i][1]
    return test


def launches_per_step(spans: Sequence, host: Sequence[Tuple[str, int, int, int]]) -> Optional[float]:
    """Launch calls of the host (``LAUNCH``; a graph's replay is one) that
    start inside a ``step`` span, over the number of steps."""
    steps = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "step")
    if not steps:
        return None
    inside = _inside(steps)
    return sum(1 for name, t, *_ in host if inside(t) and LAUNCH.match(name)) / len(steps)


def issued(host: Sequence[Tuple[str, int, int, int]],
           device: Sequence[Tuple[str, int, int, int]]) -> Optional[List[Tuple[int, int]]]:
    """(start of the host call, ns of the activity) for every device activity:
    an activity goes to the call of ``KINDS`` with its correlation id, so a
    graph's launch owns all its replay's kernels. None where an activity has
    no such call or is not of its call's kind, or where a call owns no
    activity: the trace lost a record, and the spans' device time is unknown."""
    calls = {}
    for name, t, _, corr in host:
        for call, act in KINDS:
            if call.match(name):
                calls[corr] = (t, act)
                break
    out, owners = [], set()
    for name, a, b, corr in device:
        t, act = calls.get(corr, (None, None))
        if t is None or not act(name):
            return None
        out.append((t, b - a))
        owners.add(corr)
    return out if len(owners) == len(calls) else None


def device_ms_per_kwin(spans: Sequence, pairs: Optional[Sequence[Tuple[int, int]]], name: str) -> Optional[float]:
    """Device ms of the activities that the host's calls inside the spans
    called `name` issued (`pairs`, from ``issued``), per 1000 real windows
    (the ``windows`` counts of the ``step`` spans)."""
    timed = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
    windows = sum(s.counts.get("windows", 0) for s in spans if s.name == "step")
    if not timed or not windows or pairs is None:
        return None
    inside = _inside(timed)
    return sum(ns for t, ns in pairs if inside(t)) / 1e6 / (windows / 1000.0)


def read_held_idle_ms(ctx) -> Optional[float]:
    got = fetch(ctx)
    return None if got is None else held_idle_ms(got, ctx.slice.gaps())


def read_launches_per_step(ctx) -> Optional[float]:
    got = fetch(ctx)
    return None if got is None else launches_per_step(got, ctx.slice.host)


def read_device_ms_per_kwin(ctx, name: str) -> Optional[float]:
    got = fetch(ctx)
    return None if got is None else device_ms_per_kwin(got, issued(ctx.slice.host, ctx.slice.kernels), name)

