"""Readings for the limit of ``pick_gap``: the program's over many seeds and
the control's over a few, in one process, at a cell's own sizes.

    python3 benchmark/control.py --workload eqt.archive --seeds 1-12 --control-seeds 1-3

For each seed: the cell's weights and request pool, as a run makes them;
the program's answer to every pool entry; the gap of each against the
reference's float32 curves (what a run's check reads, as a run judges every
entry it serves). For each control seed besides: the control, which is the
reference put in the program's place and run with TF32 on (the precision
below the configuration's float32 with TF32 off), its own pick buffers
judged against the same float32 curves. The benchmark's runs never run
this; it needs the card, since TF32 exists only there.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def readings(cfg: dict, mix: dict, seed_list, control_seeds, dev):
    """One row a seed: the program's largest gap over the pool (seeds of
    `seed_list`) and the control's (seeds of `control_seeds`)."""
    import numpy as np
    import torch

    from benchmark import harness, reference
    from benchmark.plan import plan

    c = mix["classify"]
    pl = plan(mix["stations"], mix["samples"], cfg["model_args"]["in_samples"], c["overlap"],
              c["batch_size"], c["max_picks"])
    for seed in sorted(set(seed_list) | set(control_seeds)):
        t0 = time.perf_counter()
        sd, pool = harness.make_inputs(cfg, mix, pl, seed, dev)
        picker = harness.build_program(cfg, sd, dev)
        call = harness.classify_call(picker, cfg, mix)
        answers = [call(x) for x in pool] if seed in seed_list else []
        del picker, call
        gc.collect()
        model = reference.build_model(cfg, dev)
        model.load_state_dict(sd)
        row = {"seed": seed, "program": None, "control": None, "picks": 0}
        prog, ctrl = [], []
        for i, x in enumerate(pool):
            data = torch.as_tensor(x, device=dev)
            with reference.tf32(False):
                cur = reference.curves(cfg, model, data, c).cpu().numpy()
            if answers:
                g, n = reference.pick_gap(cfg, cur, answers[i])
                prog.append(g)
                row["picks"] += n
            if seed in control_seeds:
                with reference.tf32(True):
                    low = reference.curves(cfg, model, data, c).cpu().numpy()
                ctrl.append(reference.pick_gap(cfg, cur, reference.reference_result(
                    cfg, low, pl.max_picks))[0])
                row["curve_gap_tf32"] = max(row.get("curve_gap_tf32", 0.0), float(np.abs(low - cur).max()))
        row["program"] = max(prog) if prog else None
        row["control"] = max(ctrl) if ctrl else None
        row["seconds"] = round(time.perf_counter() - t0, 3)
        del model
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    # the checkout's root in place of this script's folder, whose trace.py
    # would otherwise shadow the standard library's module of that name
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import manifest

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    mix = manifest.mix(cell["traffic"], ROOT)
    rows = []
    for row in readings(cfg, mix, args.seeds, args.control_seeds, torch.device(args.device)):
        rows.append(row)
        print(json.dumps(row), flush=True)
    prog = [r["program"] for r in rows if r["program"] is not None]
    ctrl = [r["control"] for r in rows if r["control"] is not None]
    print(json.dumps({"workload": args.workload, "lower_reading": max(prog) if prog else None,
                      "upper_reading": min(ctrl) if ctrl else None,
                      "program": prog, "control": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
