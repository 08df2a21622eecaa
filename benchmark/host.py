"""The host's speed around a run's window, for its standard error only.

A reading (``sample``) holds this process's CPU time (``/proc/self/stat``),
the least time of a fixed Python loop, the least time the host takes to
launch a tiny kernel, and the card's SM clock (``nvidia-smi``); ``describe``
turns the readings before and after the window into one line. The cells
whose host paces them read slower where the loop and the launch read
slower: on the H100 machines the loop's time moved between about 1.05 and
2.15 ms from minute to minute, run to run and within a run. None of it is
a metric. The card's machine shows no other process, no per-core counts in
``/proc/stat``, a fixed ``cpu MHz`` and no PCI device under ``/sys``, and
does not hold a process to the cores ``sched_setaffinity`` names, so the
loop is the reading of the host that there is.
"""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import time

TICK_S = 1.0 / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Reading:
    t: float  # perf_counter
    cpu_s: float  # this process's user + system time, all threads
    loop_us: float
    launch_us: float
    sm_mhz: str


def cpu_s() -> float:
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) * TICK_S  # utime, stime
    except (OSError, ValueError, IndexError):
        return math.nan


def loop_us() -> float:
    """Least µs of five runs of one fixed Python loop."""
    best = math.inf
    for _ in range(5):
        t = time.perf_counter()
        acc = 0
        for i in range(20000):
            acc += i * i
        best = min(best, time.perf_counter() - t)
    return 1e6 * best


def launch_us() -> float:
    """Least µs a launch of a tiny kernel takes the host, over three runs of
    200 launches each ended by a synchronisation."""
    import torch

    x = torch.zeros(8, device="cuda")
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            x.add_(1.0)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t) / 200)
    return 1e6 * best


def sm_mhz() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "?"


def sample(card: bool) -> Reading:
    return Reading(time.perf_counter(), cpu_s(), loop_us(), launch_us() if card else math.nan,
                   sm_mhz() if card else "-")


def describe(a: Reading, b: Reading) -> str:
    return (f"host over {b.t - a.t:.3f} s: own cpu {b.cpu_s - a.cpu_s:.2f} s; python loop us "
            f"{a.loop_us:.1f} -> {b.loop_us:.1f}; launch us {a.launch_us:.2f} -> {b.launch_us:.2f}; "
            f"sm MHz {a.sm_mhz} -> {b.sm_mhz}")
