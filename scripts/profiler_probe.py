"""How often a torch.profiler session records no device row, in fresh
processes on one CUDA device.

    python3 scripts/profiler_probe.py [--processes 20] [--sessions 0] [--pads-ms 0] [--out chiprun_out/profiler_probe]

Starts fresh Python processes one after another, `--processes` of each kind,
the kinds in turns:

- "k2": two bf16 ``lstm_branches`` calls at x (232, 64, 47), H 16, the
  second branch reversed (K2's bf16 body, launched through ctypes, as
  tests/test_torch_cuda.py's case runs it), then three profiler sessions of
  ten such calls each;
- "torch": the same, but the three sessions time ten ``torch.matmul`` calls
  (a PyTorch library kernel), which tells a ctypes launch from any launch;
- "warm": one session of a single K2 call first, then as "k2";
- "long" (with `--sessions N` > 0, one process, after the others): N
  sessions in a row, each of ten float32 ``lstm_branches`` calls at x (232,
  16, 47) (a bmm and the recurrence kernel a call: 20 launches), as
  ``chip_smoke.py``'s K2 phase times them, with the twin's many small kernels
  run between two sessions, each session held open idle for the next of
  `--pads-ms` (in turns) before and after its calls; for each session its
  pad, host rows, device rows, the launches they count, its host-clock ms and
  its start (seconds since the first), so that a session after an empty one
  shows whether the empty one's records arrived late or never, and the
  losses can be set against time and pad.

Every session is ``stage_times.profile_session``, the session that
``profiled`` wraps, held open idle for `--pads-ms` (the first value for the
fresh-process kinds; ``profiled`` holds ``stage_times.PROFILE_PAD_S``). A child prints one JSON line, for each session its device
rows (name: count); its stderr is kept in OUT/<kind>_<i>.err. The parent
prints the card's name and power limit, then the count of empty sessions by
kind and session, also written to OUT/summary.json. Needs nvcc.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from volpick_tpu_torch.ops.cuda import _build  # noqa: E402
from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402
from volpick_tpu_torch.picker.stage_times import device_rows, profile_session, smi  # noqa: E402

KINDS = ("k2", "torch", "warm")
B, C, H, T = 232, 64, 16, 47
SESSIONS = 3


def long_child(n: int, pads_ms) -> None:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(B, 16, T)).astype(np.float32), device=dev)
    w = [torch.as_tensor((rng.normal(size=s) * 0.2).astype(np.float32), device=dev)
         for s in ((2, 4 * H, 16), (2, 4 * H, H), (2, 4 * H))]
    rev = (False, True)
    rows, t_first = [], time.perf_counter()
    for i in range(n):
        cuda_lstm.lstm_branches_reference(x, *w, rev)
        torch.cuda.synchronize()
        pad = pads_ms[i % len(pads_ms)]
        t = time.perf_counter() - t_first
        wall, events = profile_session(lambda: [cuda_lstm.lstm_branches(x, *w, rev) for _ in range(10)],
                                       pad / 1e3)
        dev_rows = device_rows(events)
        rows.append([pad, len(events) - len(dev_rows), len(dev_rows), sum(e.count for e in dev_rows),
                     round(wall, 3), round(t, 3)])
    print(json.dumps({"kind": "long", "torch": torch.__version__, "sessions": rows}))


def child(kind: str, pad_s: float) -> None:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(B, C, T)).astype(np.float32), device=dev).to(torch.bfloat16)
    w = [torch.as_tensor((rng.normal(size=s) * 0.2).astype(np.float32), device=dev).to(torch.bfloat16)
         for s in ((2, 4 * H, C), (2, 4 * H, H), (2, 4 * H))]
    k2 = lambda: cuda_lstm.lstm_branches(x, *w, reverse=(False, True))  # noqa: E731
    a = torch.randn(512, 512, device=dev)
    for _ in range(2):
        k2()
    torch.cuda.synchronize()
    if kind == "warm":
        profile_session(k2, pad_s)
    sessions = []
    for _ in range(SESSIONS):
        fn = (lambda: [a @ a for _ in range(10)]) if kind == "torch" else (lambda: [k2() for _ in range(10)])
        _, events = profile_session(fn, pad_s)
        sessions.append({e.key: e.count for e in device_rows(events)})
    print(json.dumps({"kind": kind, "torch": torch.__version__, "sessions": sessions}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/profiler_probe")
    ap.add_argument("--sessions", type=int, default=0)
    ap.add_argument("--pads-ms", default="0", help="comma-separated idle ms held around each session (the long kind takes them in turns)")
    ap.add_argument("--child", choices=KINDS + ("long",))
    args = ap.parse_args()
    pads_ms = [float(v) for v in args.pads_ms.split(",")]
    if args.child == "long":
        return long_child(args.sessions, pads_ms)
    if args.child:
        return child(args.child, pads_ms[0] / 1e3)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe needs a CUDA device")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"card: {smi('name,power.limit')}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build()  # once, so that no child builds
    empty = {k: [0] * SESSIONS for k in KINDS}
    failed, rows = {k: 0 for k in KINDS}, []
    t0 = time.perf_counter()
    for i in range(args.processes):
        for kind in KINDS:
            r = subprocess.run([sys.executable, __file__, "--child", kind, "--pads-ms", args.pads_ms],
                               capture_output=True, text=True, timeout=300)
            (out / f"{kind}_{i}.err").write_text(r.stderr)
            if r.returncode != 0:
                failed[kind] += 1
                print(f"{kind} {i}: exit {r.returncode}; stderr in {out / f'{kind}_{i}.err'}")
                continue
            got = json.loads(r.stdout.strip().splitlines()[-1])
            rows.append(dict(got, process=i))
            for s, sess in enumerate(got["sessions"]):
                empty[kind][s] += not sess
            if not all(got["sessions"]):
                print(f"{kind} {i}: sessions {got['sessions']}")
    long_rows = []
    if args.sessions:
        r = subprocess.run([sys.executable, __file__, "--child", "long", "--sessions", str(args.sessions),
                            "--pads-ms", args.pads_ms], capture_output=True, text=True, timeout=3000)
        (out / "long.err").write_text(r.stderr)
        if r.returncode != 0:
            failed["long"] = 1
        else:
            long_rows = json.loads(r.stdout.strip().splitlines()[-1])["sessions"]
            rows.append({"kind": "long", "sessions": long_rows})
    full = max((r[3] for r in long_rows), default=0)  # the launches of a session that lost none
    summary = {"processes": args.processes, "empty_sessions": empty, "failed": failed,
               "long": {"sessions": len(long_rows), "launches_a_session": full,
                        "by_pad_ms": {p: {"sessions": sum(r[0] == p for r in long_rows),
                                          "empty": sum(r[0] == p and r[2] == 0 for r in long_rows),
                                          "short_of_launches": sum(r[0] == p and r[3] < full for r in long_rows)}
                                      for p in pads_ms},
                        "lossy": [r for r in long_rows if r[3] < full]},
               "seconds": time.perf_counter() - t0,
               "stderr_lines": sorted({ln for p in out.glob("*.err") for ln in p.read_text().splitlines()})}
    (out / "summary.json").write_text(json.dumps(dict(summary, children=rows), indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
