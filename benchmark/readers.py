"""The metric readers that ``metrics/<name>.json`` files name.

Each takes the run's context and the metric file's parameters and returns a
number, or None where the run holds nothing for it to read: the harness then
leaves the metric out of the line. A share is never given as 0 for want of
data.
"""

from __future__ import annotations

import math
import re
import statistics
from typing import Optional

from benchmark import bounds


def station_hours_per_s(ctx, p) -> Optional[float]:
    """Station-hours of the requests completed in the window over its
    seconds: all the work and all the time of the window."""
    done = [r for r in ctx.requests if r.done]
    return len(done) * ctx.station_hours / ctx.window_s if done else None


def latency_percentile_ms(ctx, p) -> Optional[float]:
    """Nearest-rank percentile ``q`` of every request due in the window, from
    its due time to its picks on the host; a request never served counts as
    slower than any served, at the least the time from its due time to the
    end of the drain."""
    if not ctx.requests:
        return None
    lat = sorted(r.end - r.due if r.done else ctx.drain_end - r.due for r in ctx.requests)
    return 1e3 * lat[max(0, math.ceil(p["q"] / 100.0 * len(lat)) - 1)]


def setup_s(ctx, p) -> float:
    return ctx.setup_s


def service_ms(ctx, p) -> Optional[float]:
    """Median host-clock time from a request's start of service to its picks
    on the host, over the window's requests."""
    done = [1e3 * (r.end - r.start) for r in ctx.requests if r.done]
    return statistics.median(done) if done else None


def mfu(ctx, p) -> Optional[float]:
    """The configuration's matrix-product operations a window times the real
    windows of the window's completed requests, over its seconds, as a
    percentage of the float32 peak (TF32 off)."""
    done = sum(1 for r in ctx.requests if r.done)
    if not done or not ctx.cfg.get("flops_per_window"):
        return None
    return 100.0 * ctx.cfg["flops_per_window"] * done * ctx.plan.windows / ctx.window_s / bounds.PEAK_F32


def kernel_ms_per_kwin(ctx, p) -> Optional[float]:
    """Device ms of the slice's kernels whose names match ``match``, per 1000
    real windows of the slice's requests."""
    if ctx.slice is None:
        return None
    rows = ctx.slice.matching(re.compile(p["match"]))
    if not rows:
        return None
    ms = sum(b - a for _, a, b, _ in rows) / 1e6
    return ms / (ctx.slice_requests * ctx.plan.windows / 1000.0)


def _kernel_calls(ctx, kernel: str):
    """[(calls, (bytes, operations, special-function operations) a call)] of
    the slice's launches of `kernel`, one entry a call shape, from the
    requests' shapes; None where the configuration does not launch it."""
    spec = ctx.cfg.get("kernels", {}).get(kernel)
    if spec is None:
        return None
    n = ctx.slice_requests
    if kernel == "k1":
        rows = len(ctx.cfg["labels"]) * ctx.plan.stations
        return [(n * spec["calls_per_request"], bounds.k1_work(rows, ctx.plan.padded_total, ctx.plan.max_picks))]
    if kernel == "k2":
        return [(n * spec["calls_per_forward"], bounds.k2_work(spec["branches"], batch, spec["steps"], spec["hidden"]))
                for batch in ctx.plan.forwards]
    if kernel == "k8":  # each branch's decoder runs the configuration's layers once a forward
        per_layer = n * spec["calls_per_forward"] // len(spec["layers"])
        return [(per_layer, bounds.k8_work(batch, *layer)) for batch in ctx.plan.forwards for layer in spec["layers"]]
    raise ValueError(f"no work count for kernel {kernel!r}")


def kernel_roofline(ctx, p) -> Optional[float]:
    """The summed bounds of the slice's `kernel` launches, each launch's the
    larger of its bytes and its operations over their peaks, over the summed
    device time of their rows (names matching ``match``), in percent."""
    if ctx.slice is None:
        return None
    calls = _kernel_calls(ctx, p["kernel"])
    rows = ctx.slice.matching(re.compile(p["match"]))
    if calls is None or not rows:
        return None
    t = sum(b - a for _, a, b, _ in rows) / 1e9
    return 100.0 * sum(n * bounds.bound_s(*work)[0] for n, work in calls) / t


def device_ms_per_station_h(ctx, p) -> Optional[float]:
    """The device's busy ms in the profiled slice (the union of its kernels,
    copies and fills) per station-hour of the slice's requests: the card's
    time that a station-hour costs, whatever the host's pace."""
    if ctx.slice is None:
        return None
    return 1e3 * ctx.slice.busy_s() / (ctx.slice_requests * ctx.station_hours)


def idle_share(ctx, p) -> Optional[float]:
    """Percent of the slice's wall time in which nothing ran on the device:
    one minus the union of its activity intervals over the slice."""
    if ctx.slice is None:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s() / ctx.slice.window_s)
