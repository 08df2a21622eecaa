"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line's object.

``run(...)`` takes the device to use; ``run.py`` is what looks for the card
first. Set-up makes the weights and the request pool from the seed on the
device, builds the program's picker (``WaveformPicker`` on the port's
``load_model``) with those weights, and warms up the one request shape of
the cell's mix. The window then drives ``classify_arrays`` in the mix's loop
for ``seconds``. After it, the trace profiles a slice of requests (with
``--trace 1``, and on the card in every run of a cell with an end-to-end
metric from the device's trace); the program is freed and the reference
judges every request that completed.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import host, manifest, readers, reference, trace, traffic, weights
from benchmark.plan import Plan, plan

PROGRAM_KERNELS = {  # the port's kernels on these paths, by their device rows
    "k1": "trigger_extract_kernel",
    "k2": "lstm_multi_kernel",
    "k8": "upconv_relu_kernel",
}


@dataclasses.dataclass
class Request:
    due: float  # seconds from the window's start
    idx: int  # pool index of its input
    start: float = math.nan
    end: float = math.nan
    out: Optional[Dict[str, tuple]] = None

    @property
    def done(self) -> bool:
        return self.end == self.end


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    cfg: dict
    mix: dict
    plan: Plan
    setup_s: float
    requests: List[Request]
    window_s: float
    drain_end: float
    station_hours: float  # a request
    slice: Optional[trace.Slice] = None
    slice_requests: int = 0


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def build_program(cfg: dict, sd: dict, device: torch.device):
    """The system under test: the port's picker on the configuration's model
    with the benchmark's weights."""
    from volpick_tpu_torch.models import load_model
    from volpick_tpu_torch.picker.annotate import WaveformPicker

    model = load_model(cfg["arch"], seed=0, device=device, **cfg["model_args"], **cfg["port_args"])
    model.load_state_dict(sd)
    return WaveformPicker(model, device=device)


def classify_call(picker, cfg: dict, mix: dict) -> Callable[[np.ndarray], Dict[str, tuple]]:
    c = mix["classify"]
    return lambda data: picker.classify_arrays(
        data, cfg["thresholds"], overlap=c["overlap"], blinding=tuple(c["blinding"]),
        stacking=c["stacking"], batch_size=c["batch_size"], max_picks=c["max_picks"])


def _wait_until(t: float) -> None:
    """Sleep, then spin, until perf_counter() reaches t."""
    left = t - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.001)
    while time.perf_counter() < t:
        pass


def closed_loop(call, pool, order: List[int], seconds: float) -> List[Request]:
    """Back-to-back requests while the window is open; the window ends with
    the last request started in it."""
    reqs: List[Request] = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        r = Request(due=time.perf_counter() - t0, idx=order[len(reqs) % len(order)])
        r.start = r.due
        r.out = call(pool[r.idx])
        r.end = time.perf_counter() - t0
        reqs.append(r)
    return reqs


def open_loop(call, pool, schedule, last_start: float, waits: Optional[list] = None) -> List[Request]:
    """Requests due at the schedule's times, served in order by one client;
    one not started by `last_start` seconds is never served. `waits`, where
    given, gains the (start, end) epoch ns of each wait for a due time."""
    reqs = [Request(due=d, idx=i) for d, i in schedule]
    t0 = time.perf_counter()
    for r in reqs:
        if waits is None:
            _wait_until(t0 + r.due)
        else:
            w0 = time.time_ns()
            _wait_until(t0 + r.due)
            waits.append((w0, time.time_ns()))
        now = time.perf_counter() - t0
        if now > last_start:
            break
        r.start = now
        r.out = call(pool[r.idx])
        r.end = time.perf_counter() - t0
    return reqs


def generator_late_ms(reqs: List[Request]) -> float:
    """How late the generator started requests that found the client idle."""
    late, prev_end = 0.0, -math.inf
    for r in reqs:
        if r.done and prev_end <= r.due:
            late = max(late, r.start - r.due)
        if r.done:
            prev_end = r.end
    return 1e3 * late


def load_reader(name: str, root: Path):
    """The metric's reader: ``metrics/<name>.py``'s ``read(ctx)``, or the
    ``readers.py`` function its ``.json`` names, with the file's parameters."""
    path = manifest.metric_file(name, root)
    if path.suffix == ".py":
        spec = importlib.util.spec_from_file_location(f"bm_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    params = json.loads(path.read_text())
    fn = getattr(readers, params["reader"])
    return lambda ctx: fn(ctx, params)


def judge(cfg: dict, mix: dict, sd: dict, pool, reqs: List[Request], device, limit) -> dict:
    """Every completed request's picks against the reference's curves of its
    input; one reference pass a pool entry, one judgement a distinct answer."""
    model = reference.build_model(cfg, device)
    model.load_state_dict(sd)
    by_idx: Dict[int, Dict[str, List[Request]]] = {}
    for r in reqs:
        if r.done:
            h = hashlib.sha1()
            for lab in cfg["labels"]:
                for a in r.out[lab]:
                    h.update(np.ascontiguousarray(a).tobytes())
            by_idx.setdefault(r.idx, {}).setdefault(h.hexdigest(), []).append(r)
    gap, picks, judged, distinct, wrong = 0.0, 0, 0, 0, 0
    with reference.tf32(False):
        for idx, answers in sorted(by_idx.items()):
            cur = reference.curves(cfg, model, torch.as_tensor(pool[idx], device=device),
                                   mix["classify"]).cpu().numpy()
            for group in answers.values():
                g, n = reference.pick_gap(cfg, cur, group[0].out)
                gap, picks = max(gap, g), picks + n * len(group)
                judged += len(group)
                distinct += 1
                wrong += len(group) if limit is None or not g <= limit else 0
    return {"pick_gap": gap, "picks": picks, "judged": judged, "distinct": distinct, "wrong": wrong}


def smi(fields: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def make_inputs(cfg: dict, mix: dict, pl: Plan, seed: int, dev: torch.device):
    """(state dict, request pool) of `seed`: the weights drawn on `dev`, the
    heads stretched on the first request, the requests as numpy."""
    window = cfg["model_args"]["in_samples"]
    c = mix["classify"]
    ref_model = reference.build_model(cfg, dev)
    sd = weights.seeded_state_dict(ref_model, seed, dev)
    if weights.state_dict_elements(sd) != cfg["state_dict_elements"]:
        raise RuntimeError(f"{cfg['name']}: {weights.state_dict_elements(sd)} state-dict elements, "
                           f"the configuration states {cfg['state_dict_elements']}")
    pool = traffic.make_pool(mix, seed, dev)
    # the heads' calibration: whole stations of the first request, as many
    # as give ``calibration_windows`` windows on the uniform grid
    stride = window - c["overlap"]
    grid = [st for st in pl.starts if st % stride == 0]
    n_rows = min(pl.stations, -(-cfg["heads"]["calibration_windows"] // len(grid)))
    rows = torch.as_tensor(pool[0][:n_rows], device=dev)
    with reference.tf32(False):
        frames = reference.condition(torch.stack([rows[:, :, st : st + window] for st in grid]),
                                     cfg["conditioning"]["detrend"], cfg["conditioning"]["eps"])
        sd = weights.stretch_heads(cfg, ref_model, sd, frames, stride, c["blinding"])
    return sd, pool


def run(workload: str, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, root: Path = manifest.REPO) -> dict:
    """One run of `workload`: the result line's object (``check`` last)."""
    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    cfg = manifest.config(man, cell["config"], root)
    mix = manifest.mix(cell["traffic"], root)
    dev = torch.device(device)
    c = mix["classify"]
    window = cfg["model_args"]["in_samples"]
    pl = plan(mix["stations"], mix["samples"], window, c["overlap"], c["batch_size"], c["max_picks"])

    # ---- set-up: weights and requests from the seed, the program, warm-up
    marks = [("imports", time.perf_counter())]
    sd, pool = make_inputs(cfg, mix, pl, seed, dev)
    marks.append(("weights, pool, heads", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    picker = build_program(cfg, sd, dev)
    call = classify_call(picker, cfg, mix)
    marks.append(("program", time.perf_counter()))
    for i in range(2):  # the cell's one request shape: the first builds and loads, the second runs warm
        call(pool[i % len(pool)])
        marks.append((f"warm-up {i + 1}", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    at = t_start
    steps = []
    for name, t in marks:
        steps.append(f"{name} {t - at:.3f}")
        at = t
    log("set-up by step (s): " + ", ".join(steps))
    log(f"set-up {setup_s:.3f} s: {workload} = {cfg['name']} x {cell['traffic']}, "
        f"{pl.windows} windows a request in {len(pl.forwards)} forwards of {sorted(set(pl.forwards))}")

    # ---- the window
    before = host.sample(dev.type == "cuda")
    if mix["loop"] == "closed":
        reqs = closed_loop(call, pool, traffic.closed_order(mix, seed, mix["pool"]), seconds)
        window_s = reqs[-1].end
        drain_end = window_s
    else:
        drain_end = seconds + mix["drain_s"]
        reqs = open_loop(call, pool, traffic.open_schedule(mix, seed, seconds), drain_end)
        window_s = seconds
        log(f"open loop: {len(reqs)} requests due at {mix['rate_per_s']}/s, the generator at most "
            f"{generator_late_ms(reqs):.3f} ms late; the last done "
            f"{max((r.end for r in reqs if r.done), default=0.0) - seconds:.3f} s after the window")
    log(host.describe(before, host.sample(dev.type == "cuda")))
    served = sorted(1e3 * (r.end - r.start) for r in reqs if r.done)
    if served:
        log(f"window {window_s:.3f} s: {len(served)} requests served, service ms p10 "
            f"{served[len(served) // 10]:.3f} p50 {served[len(served) // 2]:.3f} "
            f"p90 {served[9 * len(served) // 10]:.3f}")
        fifths = [sorted(1e3 * (r.end - r.start) for r in reqs
                         if r.done and k * window_s <= 5 * r.start < (k + 1) * window_s) for k in range(5)]
        log("service ms p50 by fifth of the window: "
            + " ".join(f"{f[len(f) // 2]:.3f}" if f else "-" for f in fifths))
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    station_hours = mix["stations"] * mix["samples"] / mix["sampling_rate"] / 3600.0
    ctx = Context(cfg, mix, pl, setup_s, reqs, window_s, drain_end, station_hours)
    if served:  # the window's host-clock readings, whichever of them the cell reports
        log(f"window readings: {readers.station_hours_per_s(ctx, {}):.6f} station-h/s; from due time "
            f"to picks ms p50 {readers.latency_percentile_ms(ctx, {'q': 50}):.3f} "
            f"p95 {readers.latency_percentile_ms(ctx, {'q': 95}):.3f}")

    # ---- the traced slice: the per-layer metrics read it, and so do the
    # end-to-end metrics taken from the device's trace (on the card)
    from_trace = any(m["source"] == "device_trace" for m in manifest.metrics_of(man, workload, "end_to_end"))
    if traced or (from_trace and dev.type == "cuda"):
        t_slice = time.perf_counter()
        if mix["loop"] == "closed":
            order = traffic.closed_order(mix, seed, mix["pool"])
            n = mix["trace_requests"]
            fn = lambda: [call(pool[order[i % len(order)]]) for i in range(n)]
        else:
            sched = [s for s in traffic.open_schedule(mix, seed + 1, seconds) if s[0] < mix["trace_seconds"]]
            n = len(sched)
            fn = lambda: open_loop(call, pool, sched, math.inf, waits)
        waits: list = []
        ctx.slice = trace.profile_slice(fn)
        ctx.slice.waits = waits
        ctx.slice_requests = n
        for kernel, pattern in PROGRAM_KERNELS.items():
            spec = cfg["kernels"].get(kernel)
            if spec is None:
                continue
            want = n * (spec.get("calls_per_request", 0)
                        + spec.get("calls_per_forward", 0) * len(pl.forwards))
            got = sum(1 for k in ctx.slice.kernels if pattern in k[0])
            if got < want:
                raise RuntimeError(f"the traced slice holds {got} {kernel} launches of the {want} "
                                   f"its {n} requests make: the trace lost device records")
        log(f"traced slice: {n} requests, busy {ctx.slice.busy_s():.6f} s of {ctx.slice.window_s:.6f} s, "
            f"{len(ctx.slice.kernels)} device records; profiled and read in {time.perf_counter() - t_slice:.3f} s")

    results = {}
    for m in manifest.metrics_of(man, workload, "per_layer" if traced else "end_to_end"):
        v = load_reader(m["name"], root)(ctx)
        if v is not None:
            results[m["name"]] = {"value": float(v), "unit": m["unit"]}
    power = smi("name,power.limit") if dev.type == "cuda" else ""

    # ---- the check, with the program freed
    del picker, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    limit = cfg["check"]["pick_gap"]
    verdict = judge(cfg, mix, sd, pool, reqs, dev, limit)
    unanswered = sum(1 for r in reqs if not r.done)
    correct = bool(verdict["judged"] > 0 and unanswered == 0 and limit is not None
                   and verdict["pick_gap"] <= limit)
    log(f"check took {time.perf_counter() - t_check:.3f} s: {verdict['judged']} requests judged "
        f"({verdict['distinct']} distinct answers, {verdict['picks']} picks), {unanswered} never served")

    out = {
        "correct": correct,
        "attempted": len(reqs),
        "failed": unanswered + verdict["wrong"],
        "metrics": results,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(memory_peak),
            "power": power,
        },
    }
    if traced:
        out["device"]["busy_s"] = ctx.slice.busy_s()
        out["device"]["window_s"] = ctx.slice.window_s
        out["breakdown"] = ctx.slice.breakdown()
    out["check"] = {"pick_gap": {"value": verdict["pick_gap"], "limit": limit},
                    "never_served": {"value": unanswered, "limit": 0}}
    return out
