"""Where the time of one classify goes, on one CUDA device.

    python -m volpick_tpu_torch.picker.stage_times [--optin] [--repeats 10] [--out FILE]

Runs the bench workload (8 stations x 20 min x 3 components at 100 Hz,
window 6000, overlap 5500, blinding (500, 500), avg stacking, batch 256)
through ``WaveformPicker.classify_arrays`` with a seeded random-init
EQTransformer at the published width, float32, and prints:

- the host-clock time of classify_arrays (median of `repeats` after one
  warm-up), with the card's name, power limit, SM clock and power draw;
- one classify_arrays under ``torch.profiler``: its summed kernel time, the
  program's spans of that call by name (count, host ms, device ms and the
  summed counts: windows, slots, bytes, rows, ...) of the picker's plan,
  upload, steps, conditioning, forward, stacking, triggers, read-back and
  the EQT forward's stages (``utils/profiling.py::span``), and the top
  kernels (the full table goes to `--out`).

``--optin`` takes EQTransformer's opt-in kernel route instead of the default
one: ``fused="plstm+bandattn+pattn"`` (additive-attention kernel),
``WaveformPicker(use_pallas=True)`` (framing + conditioning kernel) and
``VOLPICK_TRIGGER_METHOD=pallas`` (scan kernel + emission in PyTorch).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from volpick_tpu_torch.models import load_model
from volpick_tpu_torch.picker.annotate import WaveformPicker
from volpick_tpu_torch.utils import profiling

STATIONS, MINUTES, SR = 8, 20, 100.0
WINDOW, OVERLAP, BLINDING, BATCH = 6000, 5500, (500, 500), 256
# idle seconds a profiler session is held open before and after the work it
# times: sessions of a few ms held open for none lost some or all of their
# device records in 8 of 1000 on an H100, with 10 or 50 ms none of 1000 each
# (scripts/profiler_probe.py --sessions 3000 --pads-ms 0,10,50)
PROFILE_PAD_S = 0.05


def bench_stream_array(seed: int = 0) -> np.ndarray:
    """(8, 3, 120000) float32: noise plus two P/S-like events per station
    (the bench workload of ``bench.py``)."""
    rng = np.random.default_rng(seed)
    n = int(MINUTES * 60 * SR)
    data = rng.normal(size=(STATIONS, 3, n)).astype(np.float32) * 0.1
    t = np.arange(n) / SR
    for s in range(STATIONS):
        for p_at in (100.0 + 97 * s, 380.0 + 41 * s):
            env = np.where(t >= p_at, np.exp(-(t - p_at) / 2.0), 0.0)
            data[s, 0] += np.sin(2 * np.pi * 8 * t) * env * 2
            env_s = np.where(t >= p_at + 4, np.exp(-(t - p_at - 4) / 3.0), 0.0)
            data[s, 1] += np.sin(2 * np.pi * 4 * t) * env_s * 3
            data[s, 2] += np.sin(2 * np.pi * 4 * t) * env_s * 2.5
    return data


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def self_device_us(event) -> float:
    """Device time (us) of a ``key_averages()`` row itself, excluding children."""
    v = getattr(event, "self_device_time_total", None)
    return float(v if v is not None else event.self_cuda_time_total)


def device_rows(events) -> list:
    """The device-side rows of ``key_averages()``: kernels, copies, fills;
    not the card's copies of ``record_function`` ranges (the program's
    spans), which would count their kernels' time again."""
    return [e for e in events
            if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)]


def profile_session(fn, pad_s: float = PROFILE_PAD_S):
    """Run fn() once in one ``torch.profiler`` session → (host-clock ms with
    the profiler on, ``key_averages()``), whatever the session recorded; the
    session stays open `pad_s` seconds idle before and after fn()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(pad_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(pad_s)
    return wall, prof.key_averages()


def profiled(fn):
    """Run fn() once under ``torch.profiler`` → (host-clock ms with the
    profiler on, summed kernel ms, ``key_averages()``).

    fn must run on the card: a session that recorded no device row measured
    nothing, and raises ``RuntimeError`` rather than report 0 ms. The session
    is held open ``PROFILE_PAD_S`` idle around fn(), so that no device
    record near its edges is lost."""
    wall, events = profile_session(fn)
    rows = device_rows(events)
    if not rows:
        raise RuntimeError(
            "torch.profiler: the session recorded no device activity (no CUDA row in "
            f"key_averages(), {len(events)} host rows); its kernel time is unknown, not 0")
    # sum over the device-side kernel rows only: an op's row repeats the
    # time of the kernels it launched
    return wall, sum(self_device_us(e) for e in rows) / 1e3, events


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--optin", action="store_true", help="EQTransformer's opt-in kernel route")
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/stage_times.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_times needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}")

    if args.optin:
        os.environ["VOLPICK_TRIGGER_METHOD"] = "pallas"
    model = load_model("eqtransformer", seed=0, device=dev,
                       fused="plstm+bandattn+pattn" if args.optin else None)
    picker = WaveformPicker(model, device=dev, use_pallas=args.optin)
    print(f"route: fused={model.fused!r}, use_pallas={picker.use_pallas}, trigger method "
          f"{os.environ.get('VOLPICK_TRIGGER_METHOD', 'pallas_full')!r}")
    data = bench_stream_array()
    kw = dict(overlap=OVERLAP, blinding=BLINDING, batch_size=BATCH)
    curves = picker.annotate_array(data, **kw)
    thr = {lab: float(np.percentile(curves[:, k], 99.9)) for k, lab in enumerate(["Detection", "P", "S"])}
    stride = WINDOW - OVERLAP
    n_uni = len(range(0, data.shape[-1] - WINDOW + 1, stride))  # no flush window here
    n_windows = STATIONS * n_uni

    # ---- host clock around classify_arrays
    picker.classify_arrays(data, thr, **kw)
    times = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        picker.classify_arrays(data, thr, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    print(f"classify_arrays on {card}: ms x{args.repeats} {[round(t, 2) for t in times]}; "
          f"median {med:.2f} ms = {n_windows / med * 1e3:.1f} windows/s ({n_windows} windows)")
    print(f"nvidia-smi after the timed runs (clocks.sm, power.draw, temperature): "
          f"{smi('clocks.sm,power.draw,temperature.gpu')}")

    # ---- one classify_arrays under the profiler, with the program's spans
    t0 = time.time_ns()
    wall, device_ms, events = profiled(lambda: picker.classify_arrays(data, thr, **kw))
    print(f"profiled classify_arrays: wall {wall:.2f} ms (profiler on), summed kernel time "
          f"{device_ms:.2f} ms")
    by_name = {}  # name: [count, host ms, device ms or None, summed counts]
    for sp in profiling.spans():
        if sp.start_ns >= t0:
            row = by_name.setdefault(sp.name, [0, 0.0, None, {}])
            row[0] += 1
            row[1] += (sp.end_ns - sp.start_ns) / 1e6
            if sp.device_ms is not None:
                row[2] = (row[2] or 0.0) + sp.device_ms
            for k, v in sp.counts.items():
                row[3][k] = row[3].get(k, 0) + v
    print("spans of that call (name, count, host ms, device ms, summed counts; "
          "step windows / slots is the share of the forwards' batch that is real windows):")
    for name, (n, host_ms, dev_ms, counts) in by_name.items():
        print(f"  {name:16s} {n:5d} {host_ms:10.3f} {'-' if dev_ms is None else f'{dev_ms:10.3f}':>10s} "
              + " ".join(f"{k}={v}" for k, v in counts.items()))
    table = events.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=80)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"card: {card}\n{table}\n")
    print("\n".join(table.splitlines()[:14]))
    print(f"full table: {args.out}")


if __name__ == "__main__":
    main()
