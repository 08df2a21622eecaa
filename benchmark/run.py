"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository. The program under test is
the checkout's ``volpick_tpu_torch``; its kernel library is built on first
use into the checkout's ``build/volpick_tpu_torch/`` and loaded from there
after. Without a CUDA device, with fewer cards than the cell asks for, or
without the program in the checkout, it exits non-zero and prints no
result. With ``--trace 0`` the line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy time in a
profiled slice and a breakdown. The numbers compared with the reference are
the last lines on standard error and the line's last key, ``check``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "volpick_tpu")
# the process runs on two fixed cores with one CPU thread a pool: its host
# work (Python, launches, copies) then keeps to one place, and a request's
# service time spread ~2% from run to run on an H100 machine of 8 cores
# against ~4% unpinned, which the open loop's tail multiplies
CORES = 2


def loaded_forbidden() -> list:
    """Modules in this process whose top-level name, compared whole, is JAX's,
    Flax's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def pin_process() -> None:
    """Keep this process on ``CORES`` fixed cores (the 3rd and 4th where
    there are 4 or more), with one thread a CPU pool. Before torch loads."""
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, allowed[CORES : 2 * CORES] if len(allowed) >= 2 * CORES else allowed)
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    pin_process()
    os.environ.setdefault("USE_FLAX", "0")
    # the checkout's root in place of this script's folder, whose trace.py
    # would otherwise shadow the standard library's module of that name
    sys.path[0] = str(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    from benchmark import harness, manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    try:
        import volpick_tpu_torch
    except ImportError as e:
        print(f"bench: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    if Path(volpick_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"bench: volpick_tpu_torch resolves to {volpick_tpu_torch.__file__}, outside the checkout "
              f"{ROOT}", file=sys.stderr)
        return 2

    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, ROOT)
    bad = loaded_forbidden()
    if bad:
        print(f"bench: the process holds JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        if not math.isfinite(c["value"]):
            print(f"bench: check {name}: the program's buffers are malformed (reads inf)", file=sys.stderr)
            c["value"] = 1e30
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
