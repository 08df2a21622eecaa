"""K3 (``trigger_scan.cu``) and K5 (``addattn.cu``) on a CUDA GPU: how the
work is split, and the kernels of an earlier checkout beside the present ones.

    python3 scripts/k3_k5_designs.py [--before DIR]

Every time is the kernels' own rows under ``torch.profiler`` (device time, a
mean over 20 calls), because a launch of either is shorter than its Python
wrapper; K3 also by CUDA events around whole calls. Shapes are the main
path's: K5 at x (232, 16, 47), U 32, K3 at (24, 120000), and K3's many short
rows (3000, 6000). Prints the card's name and power limit first.

1. K5 with 1, 2 and 4 windows a CTA at most (``MAX_WINDOWS_PER_CTA``), both
   entries: 232 CTAs of one window, or 116 of two (what the wrapper picks on
   132 SMs).
2. K3 with the split of a row aimed at 1056 ... 16896 warps
   (``SCAN_TARGET_WARPS``), each with its two launches apart.
3. K5 by phase: the machine has no profiler that sees inside a launch, so
   ``addattn.cu`` is built several times with a phase compiled out
   (``-DADDATTN_SKIP=<bits>``: 1 energies, 2 softmax, 4 values, 8 the
   projections; such a build computes nothing right); a phase costs the full
   kernel's time less the time of the build without it, "staging" is the
   build with all of them out.
4. ``--before DIR``: DIR is a checkout of an earlier commit (for example
   ``git archive <commit> | tar -x -C DIR``) whose kernels take
   ``addattn_f32(x, q, k, wa, out, b, c, t, u, eps, stream)`` and
   ``trigger_scan_f32(prob, t1, t2, b, w, onset, max, argmax, stream)``. Its
   two sources are built into ``build/k3_k5_designs/`` and timed in turns
   with the present kernels (before, after, after, before), each held to the
   present twin first.

Needs ``nvcc``.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from volpick_tpu_torch.ops.cuda import _build  # noqa: E402
from volpick_tpu_torch.ops.cuda import addattn as cuda_addattn  # noqa: E402
from volpick_tpu_torch.ops.cuda import triggers as cuda_trig  # noqa: E402
from volpick_tpu_torch.picker.stage_times import cuda_ms, profiled, self_device_us, smi  # noqa: E402

ATT_B, ATT_C, ATT_T, ATT_U = 232, 16, 47, 32
CALLS = 20
OUT_DIR = REPO / "build" / "k3_k5_designs"
QUIET_FLAGS = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
PHASES = {"full": 0, "no energies": 1, "no softmax": 2, "no values": 4, "no projections": 8,
          "staging only": 15}


def kernel_rows(fn, needle: str) -> dict:
    """Kernel name -> mean device ms a call, for the kernels whose name holds `needle`."""
    fn()
    _, _, events = profiled(lambda: [fn() for _ in range(CALLS)])
    return {e.key: self_device_us(e) / CALLS / 1e3 for e in events if needle in e.key}


def kernel_ms(fn, needle: str) -> float:
    return sum(kernel_rows(fn, needle).values())


def start_phase_builds() -> dict:
    """One nvcc for each build of ``addattn.cu`` with phases compiled out, all started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    return {name: (OUT_DIR / f"addattn_skip{bits}.so", subprocess.Popen(
        [_build._nvcc(), *QUIET_FLAGS, f"-DADDATTN_SKIP={bits}", "-shared", "-o",
         str(OUT_DIR / f"addattn_skip{bits}.so"), str(_build.CSRC_DIR / "addattn.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for name, bits in PHASES.items()}


def build_before(root: Path) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    csrc = root / "volpick_tpu_torch" / "csrc"
    lib = OUT_DIR / "before.so"
    done = subprocess.run(
        [_build._nvcc(), *QUIET_FLAGS, "-shared", "-o", str(lib), str(csrc / "addattn.cu"),
         str(csrc / "trigger_scan.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {csrc}:\n{done.stdout}")
    before = ctypes.CDLL(str(lib))
    before.addattn_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    before.trigger_scan_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    return before


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, help="checkout of an earlier commit to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_k5_designs needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}")
    phase_builds = start_phase_builds()
    _build.library()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    # ---- K5
    x = tensor(rng.normal(size=(ATT_B, ATT_C, ATT_T)))
    q, k = (tensor(rng.normal(size=(ATT_B, ATT_T, ATT_U)) * 0.5) for _ in range(2))
    wt, wx = (tensor(rng.normal(size=(ATT_C, ATT_U)) * 0.125) for _ in range(2))
    bh, wa = tensor(rng.normal(size=ATT_U) * 0.05), tensor(rng.uniform(-0.3, 0.3, ATT_U))
    twin = cuda_addattn.addattn_reference(x, q, k, wa)
    for most in (1, 2, 4):
        cuda_addattn.MAX_WINDOWS_PER_CTA = most
        g = cuda_addattn.windows_per_cta(ATT_B, ATT_C, ATT_T, ATT_U, n_sm, True)
        err = float((cuda_addattn.addattn(x, q, k, wa) - twin).abs().max())
        print(f"K5 at most {most} windows a CTA ({g} taken, {-(-ATT_B // g)} CTAs) on {card}: addattn_x "
              f"{kernel_ms(lambda: cuda_addattn.addattn_x(x, wt, bh, wx, wa), 'addattn_kernel'):.4f} "
              f"ms, addattn {kernel_ms(lambda: cuda_addattn.addattn(x, q, k, wa), 'addattn_kernel'):.4f} "
              f"ms (max abs err vs twin {err:.2e})")
    cuda_addattn.MAX_WINDOWS_PER_CTA = 4

    # ---- K3
    def curves(b, w):
        p = torch.rand(1, b, w, device=dev, generator=torch.Generator(dev).manual_seed(b))
        p = torch.nn.functional.avg_pool1d(p, 25, stride=1, padding=12)[0]
        lo, hi = p.amin(1, keepdim=True), p.amax(1, keepdim=True)
        t1 = tensor(rng.uniform(0.3, 0.8, b))
        return ((p - lo) / (hi - lo)).contiguous(), t1, t1 / 2

    def scan_line(args_):
        rows = kernel_rows(lambda: cuda_trig.trigger_scan(*args_), "trigger_scan_kernel")
        first = sum(ms_ for key, ms_ in rows.items() if "summaries" in key)
        return (f"{sum(rows.values()):.4f} ms of kernel time (of it the summaries' launch {first:.4f}), "
                f"{cuda_ms(lambda: cuda_trig.trigger_scan(*args_)):.4f} ms by CUDA events")

    long_rows, short_rows = curves(24, 120000), curves(3000, 6000)
    want = cuda_trig.trigger_scan_reference(*long_rows)
    target = cuda_trig.SCAN_TARGET_WARPS
    for rows_, name in ((long_rows, "(24, 120000)"), (short_rows, "(3000, 6000)")):
        want_ = cuda_trig.trigger_scan_reference(*rows_)
        for aim in (1056, 2112, 4224, 8448, 16896):
            cuda_trig.SCAN_TARGET_WARPS = aim
            piece, n = cuda_trig.scan_plan(*rows_[0].shape)
            if not all(torch.equal(g_, w_) for g_, w_ in zip(cuda_trig.trigger_scan(*rows_), want_)):
                raise SystemExit(f"trigger_scan differs from its twin at a target of {aim} warps")
            print(f"K3 {name} aimed at {aim} warps ({n} pieces of {piece} a row = "
                  f"{rows_[0].shape[0] * n} warps) on {card}: {scan_line(rows_)}")
        del want_
    cuda_trig.SCAN_TARGET_WARPS = target

    # ---- K5 by phase, two windows a CTA
    out = torch.empty_like(x)
    ms = {}
    for name, (lib_path, proc) in phase_builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        lib.addattn_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        lib.addattn_x_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]

        def run_xqk():
            if lib.addattn_f32(x.data_ptr(), q.data_ptr(), k.data_ptr(), wa.data_ptr(), out.data_ptr(),
                               ATT_B, ATT_C, ATT_T, ATT_U, 2, 1e-5, stream):
                raise SystemExit(f"{name}: addattn_f32 failed to launch")

        def run_x():
            if lib.addattn_x_f32(x.data_ptr(), wt.data_ptr(), bh.data_ptr(), wx.data_ptr(), wa.data_ptr(),
                                 out.data_ptr(), ATT_B, ATT_C, ATT_T, ATT_U, 2, 1e-5, stream):
                raise SystemExit(f"{name}: addattn_x_f32 failed to launch")

        ms[name] = (kernel_ms(run_x, "addattn_kernel"), kernel_ms(run_xqk, "addattn_kernel"))
        print(f"K5 {name}: addattn_x {ms[name][0]:.4f} ms, addattn {ms[name][1]:.4f} ms on {card}")
    for col, entry in enumerate(("addattn_x", "addattn")):
        full = ms["full"][col]
        parts = ", ".join(f"{name[3:]} {full - ms[name][col]:.4f}" for name in PHASES if name.startswith("no "))
        print(f"K5 {entry} on {card}: full {full:.4f} ms = staging {ms['staging only'][col]:.4f} + "
              f"phases (full less the build without each): {parts}")

    # ---- the kernels of an earlier checkout, in turns with the present ones
    if args.before is None:
        return
    before = build_before(args.before)
    long_outs, short_outs = (
        (torch.empty(p.shape, dtype=torch.int32, device=dev), torch.empty_like(p),
         torch.empty(p.shape, dtype=torch.int32, device=dev)) for p, _, _ in (long_rows, short_rows))

    def addattn_before():
        if before.addattn_f32(x.data_ptr(), q.data_ptr(), k.data_ptr(), wa.data_ptr(), out.data_ptr(),
                              ATT_B, ATT_C, ATT_T, ATT_U, 1e-5, stream):
            raise SystemExit("the earlier addattn_f32 failed to launch")

    def scan_before(rows, o):
        p, t1, t2 = rows
        if before.trigger_scan_f32(p.data_ptr(), t1.data_ptr(), t2.data_ptr(), p.shape[0], p.shape[1],
                                   o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(), stream):
            raise SystemExit("the earlier trigger_scan_f32 failed to launch")

    addattn_before()
    scan_before(long_rows, long_outs)
    torch.cuda.synchronize()
    if not float((out - twin).abs().max()) <= 1e-5 or not all(
            torch.equal(g_, w_) for g_, w_ in zip(long_outs, want)):
        raise SystemExit("an earlier kernel disagrees with the present twin")
    runs = {
        "K5 addattn (q, k given)": ("addattn_kernel", addattn_before,
                                    lambda: cuda_addattn.addattn(x, q, k, wa)),
        "K5 addattn_x (before: none)": ("addattn_kernel", None,
                                        lambda: cuda_addattn.addattn_x(x, wt, bh, wx, wa)),
        "K3 (24, 120000)": ("trigger_scan_kernel", lambda: scan_before(long_rows, long_outs),
                            lambda: cuda_trig.trigger_scan(*long_rows)),
        "K3 (3000, 6000)": ("trigger_scan_kernel", lambda: scan_before(short_rows, short_outs),
                            lambda: cuda_trig.trigger_scan(*short_rows)),
    }
    for name, (needle, old, new) in runs.items():
        turns = [kernel_ms(fn, needle) if fn else float("nan") for fn in (old, new, new, old)]
        print(f"{name} on {card}, kernel ms under torch.profiler, before / after / after / before: "
              + " / ".join(f"{t:.4f}" for t in turns))


if __name__ == "__main__":
    main()
