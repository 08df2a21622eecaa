"""The rate sweep of an open-loop cell: the highest rate it sustains.

    python3 benchmark/sweep.py --workload eqt.live --rates 10-60:5 --seconds 30 --seed 7

One set-up, then for each offered rate one window of the cell's mix at that
rate: its p50 and p95 latency over every request due in the window, and
whether the backlog grew. A rate is sustained where every request due in
the window finished within the window plus one median service time. The
cell's mix file then fixes its rate at 0.8 of the highest rate sustained
on the slowest card host swept, since the host paces the requests and a
check may run on any host. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rates(text: str) -> list:
    a, _, step = text.partition(":")
    lo, _, hi = a.partition("-")
    if not hi:
        return [float(v) for v in a.split(",")]
    out, r = [], float(lo)
    while r <= float(hi) + 1e-9:
        out.append(r)
        r += float(step)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=rates, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    t_start = time.perf_counter()
    # the checkout's root in place of this script's folder, whose trace.py
    # would otherwise shadow the standard library's module of that name
    sys.path[0] = str(ROOT)
    from benchmark.run import pin_process

    pin_process()  # as the cell's runs are
    import torch

    from benchmark import harness, manifest, traffic
    from benchmark.plan import plan

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    mix = manifest.mix(cell["traffic"], ROOT)
    if mix["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    c = mix["classify"]
    pl = plan(mix["stations"], mix["samples"], cfg["model_args"]["in_samples"], c["overlap"],
              c["batch_size"], c["max_picks"])
    dev = torch.device("cuda:0")
    sd, pool = harness.make_inputs(cfg, mix, pl, args.seed, dev)
    call = harness.classify_call(harness.build_program(cfg, sd, dev), cfg, mix)
    for i in range(2):
        call(pool[i])
    print(json.dumps({"setup_s": round(time.perf_counter() - t_start, 3)}), flush=True)
    for rate in args.rates:
        m = dict(mix, rate_per_s=rate)
        reqs = harness.open_loop(call, pool, traffic.open_schedule(m, args.seed, args.seconds),
                                 args.seconds + mix["drain_s"])
        done = [r for r in reqs if r.done]
        service = statistics.median(r.end - r.start for r in done)
        lat = sorted((r.end - r.due) if r.done else float("inf") for r in reqs)
        q = lambda p: lat[max(0, -(-len(lat) * p // 100) - 1)] * 1e3
        last = max(r.end for r in done)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(reqs), "p50_ms": q(50), "p95_ms": q(95),
            "service_p50_ms": service * 1e3, "last_done_after_window_s": last - args.seconds,
            "sustained": len(done) == len(reqs) and last <= args.seconds + service,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
