"""One profiled slice of requests, reduced to device intervals.

``profile_slice`` is a frozen copy of the port's padded profiler session
(``picker/stage_times.py::profile_session``): the session stays open
``PAD_S`` idle before and after the work, since device records near the
edges of a session of a few ms were lost in 8 of 1000 sessions on an H100
without the pad and in none of 1000 with 10 or 50 ms. It raises where the
session recorded no device activity.

The reduction reads the profiler's raw events (kernels, copies and fills on
the device; CUDA runtime calls on the host) on one clock, each with its
correlation id: the device's busy time is the union of its activity
intervals inside the slice, not a sum of rows, and each idle gap is named
by the shortest host event that spans its middle, what the host was doing
then.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch

PAD_S = 0.05

# (name, start_ns, end_ns, correlation id): the profiler gives a device
# activity the id of the host call that put it on the queue, and a CUDA
# graph's replay gives each of its kernels the id of its ``cudaGraphLaunch``
Event = Tuple[str, int, int, int]


@dataclasses.dataclass
class Slice:
    start_ns: int  # the slice's work, host clock of the trace
    end_ns: int
    kernels: List[Event]  # device activity
    host: List[Event]  # host events: CUDA runtime and driver calls
    waits: List[Tuple[int, int]] = dataclasses.field(default_factory=list)  # the client idle, no request due

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def matching(self, pattern) -> List[Tuple[str, int, int]]:
        return [k for k in self.kernels if pattern.search(k[0])]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the slice, sorted."""
        iv = sorted((max(a, self.start_ns), min(b, self.end_ns)) for _, a, b, _ in self.kernels)
        out: List[List[int]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle stretches of the device inside the slice."""
        out, at = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end_ns > at:
            out.append((at, self.end_ns))
        return out

    def host_at(self, t: int) -> str:
        """What the host did at time t: waiting for the next request's due
        time, else the shortest host event (a CUDA runtime call) that spans
        it; none is the host's Python and numpy work."""
        if any(a <= t <= b for a, b in self.waits):
            return "client idle, no request due"
        best = None
        for name, a, b, _ in self.host:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "python (no CUDA call)"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for name, a, b, _ in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[f"host: {self.host_at((a + b) // 2)}", (b - a) / 1e9] for a, b in gaps],
        }


def _ns(event, start: bool) -> int:
    if start:
        return int(event.start_ns())
    return int(event.start_ns() + event.duration_ns())


def profile_slice(fn: Callable[[], None]) -> Slice:
    """Run fn() once in one padded ``torch.profiler`` session of the device's
    activity (with it, the CUDA runtime calls the host makes) → its Slice.
    Host operators are not recorded: at ~640 launches a step, recording
    them slowed a slice ~3x on an H100. The slice's window is the host's
    wall clock around fn(), on the trace's clock (both count ns since the
    epoch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        start = time.time_ns()
        fn()
        torch.cuda.synchronize()
        end = time.time_ns()
        time.sleep(PAD_S)
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), _ns(e, True), _ns(e, False), int(e.correlation_id()))
        (kernels if e.device_type() == DeviceType.CUDA else host).append(item)
    if not kernels:
        raise RuntimeError(
            "torch.profiler: the slice recorded no device activity; its device time is unknown, not 0")
    return Slice(start, end, kernels, host)
