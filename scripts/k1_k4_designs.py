"""K1 (``trigger_extract.cu``) and K4 (``conditioning.cu``) on a CUDA GPU: the
forms each kernel can take, and the kernels of an earlier checkout beside the
present ones.

    python3 scripts/k1_k4_designs.py [--before DIR]

Every time is the kernels' own rows under ``torch.profiler`` (device time, a
mean over 20 calls), because a launch of either is shorter than its Python
wrapper; CUDA events around whole calls are printed beside them. Shapes are
the main path's: K1 at (24, 120000), K = 80, and many short rows (3000, 6000),
K = 64; K4 at (232, 3, 6000) in all four detrend x norm modes, at
(2000, 3, 6000), where a CTA's ring goes round, and at PhaseNet's
(256, 3, 3001), whose rows cannot move by bulk copies. Prints the card's name and
power limit first.

1. K1 in two launches and as one cooperative launch (``EXTRACT_COOPERATIVE``;
   taken only where the card holds every CTA at once), over the split of a row
   (``SCAN_TARGET_WARPS`` 1056 ... 8448), each held to the twin first; the
   cooperative launch is also captured in a CUDA graph and replayed.
2. K4 with 1, 2 and 3 row buffers (``RING_BUFFERS``) and 1 ... 4 CTAs an SM
   (``CTAS_PER_SM``), each held to the twin first.
3. K3 (``trigger_scan.cu``), which shares K1's header, at both shapes.
4. ``--before DIR``: DIR is a checkout of an earlier commit (for example
   ``git archive <commit> | tar -x -C DIR``) whose kernels take
   ``trigger_extract_f32(prob, t1, t2, b, w, k, 5 outputs, stream)``,
   ``condition_windows_f32(x, out, rows, w, detrend, norm_peak, eps, stream)``
   and ``trigger_scan_f32`` as it is today. Its three sources are built into
   ``build/k1_k4_designs/`` and timed in turns with the present kernels
   (before, after, after, before; a mean over 100 calls each), each held to
   the present twin first.

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
from volpick_tpu_torch.ops.cuda import conditioning as cuda_cond  # noqa: E402
from volpick_tpu_torch.ops.cuda import triggers as cuda_trig  # noqa: E402
from volpick_tpu_torch.picker.stage_times import cuda_ms, profiled, self_device_us, smi  # noqa: E402

CALLS = 20
OUT_DIR = REPO / "build" / "k1_k4_designs"
QUIET_FLAGS = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
MODES = [(True, "peak"), (True, "std"), (False, "peak"), (False, "std")]


def kernel_rows(fn, needle: str, calls: int = CALLS) -> dict:
    """Kernel name -> mean device ms a call, for the kernels whose name holds `needle`."""
    def run():
        for _ in range(calls):  # nothing kept: the allocator hands each call the same blocks
            fn()

    run()
    _, _, events = profiled(run)
    return {e.key: self_device_us(e) / calls / 1e3 for e in events if needle in e.key}


def kernel_ms(fn, needle: str, calls: int = CALLS) -> float:
    return sum(kernel_rows(fn, needle, calls).values())


def build_before(root: Path) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    csrc = root / "volpick_tpu_torch" / "csrc"
    lib = OUT_DIR / "before.so"
    done = subprocess.run(
        [_build._nvcc(), *QUIET_FLAGS, "-shared", "-o", str(lib), str(csrc / "trigger_extract.cu"),
         str(csrc / "conditioning.cu"), str(csrc / "trigger_scan.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {csrc}:\n{done.stdout}")
    before = ctypes.CDLL(str(lib))
    before.trigger_extract_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
    before.condition_windows_f32.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    before.trigger_scan_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    return before


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, help="checkout of an earlier commit to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_k4_designs needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}")
    _build.library()
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def curves(b, w):
        p = torch.rand(1, b, w, device=dev, generator=torch.Generator(dev).manual_seed(b))
        p = torch.nn.functional.avg_pool1d(p, 25, stride=1, padding=12)[0]
        lo, hi = p.amin(1, keepdim=True), p.amax(1, keepdim=True)
        t1 = tensor(rng.uniform(0.3, 0.8, b))
        return ((p - lo) / (hi - lo)).contiguous(), t1, t1 / 2

    def equal(got, want):
        return all(g.dtype == w_.dtype and torch.equal(g, w_) for g, w_ in zip(got, want))

    # ---- K1
    shapes = {"(24, 120000) K=80": (curves(24, 120000), 80), "(3000, 6000) K=64": (curves(3000, 6000), 64)}
    wants = {name: cuda_trig.trigger_extract_reference(*rows, k) for name, (rows, k) in shapes.items()}
    target = cuda_trig.SCAN_TARGET_WARPS

    def extract_line(rows, k):
        rows_ = kernel_rows(lambda: cuda_trig.trigger_extract(*rows, k), "trigger_extract_kernel")
        parts = ", ".join(f"{key.split('(')[0].replace('trigger_extract_kernel', 'kernel')} {ms_:.4f}"
                          for key, ms_ in rows_.items())
        return (f"{sum(rows_.values()):.4f} ms of kernel time ({parts}), "
                f"{cuda_ms(lambda: cuda_trig.trigger_extract(*rows, k)):.4f} ms by CUDA events")

    for name, (rows, k) in shapes.items():
        for aim in (1056, 2112, 4224, 8448):
            cuda_trig.SCAN_TARGET_WARPS = aim
            piece, n = cuda_trig.scan_plan(*rows[0].shape)
            for coop in (False, True):
                if coop and n == 1:
                    continue  # one piece a row is one plain launch whatever is asked
                cuda_trig.EXTRACT_COOPERATIVE = coop
                if not equal(cuda_trig.trigger_extract(*rows, k), wants[name]):
                    raise SystemExit(f"trigger_extract {name} cooperative={coop} at a target of "
                                     f"{aim} warps differs from its twin")
                form = "one cooperative launch where resident" if coop else "plain launches"
                print(f"K1 {name} aimed at {aim} warps ({n} pieces of {piece} a row), {form}, on "
                      f"{card}: {extract_line(rows, k)}")
    cuda_trig.SCAN_TARGET_WARPS, cuda_trig.EXTRACT_COOPERATIVE = target, True

    def graph_experiment():
        """The cooperative launch captured in a CUDA graph and replayed (last: a refused
        capture may leave the process unfit for more)."""
        rows, k = shapes["(24, 120000) K=80"]
        try:
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                cuda_trig.trigger_extract(*rows, k)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    captured = cuda_trig.trigger_extract(*rows, k)
            graph.replay()
            torch.cuda.synchronize()
            print(f"K1 cooperative launch captured in a CUDA graph and replayed: "
                  f"{'equal to twin' if equal(captured, wants['(24, 120000) K=80']) else 'DIFFERS from twin'}")
        except RuntimeError as e:
            print(f"K1 cooperative launch in a CUDA graph: refused ({str(e).splitlines()[0]})")

    # ---- K4
    def rows_of(n):
        t = np.linspace(-1.0, 1.0, 6000)
        x = rng.normal(size=(n, 3, 6000))
        x += rng.uniform(-20, 20, (n, 3, 1)) + rng.uniform(-30, 30, (n, 3, 1)) * t
        return tensor(x)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = cuda_cond.RING_BUFFERS, cuda_cond.CTAS_PER_SM
    xs = {"(232, 3, 6000)": rows_of(232), "(2000, 3, 6000)": rows_of(2000)}
    twins = {(name, m): cuda_cond.condition_windows_reference(x, detrend=m[0], norm=m[1])
             for name, x in xs.items() for m in MODES[:1]}
    for name, x in xs.items():
        for n_buf in (1, 2, 3):
            for per_sm in (1, 2, 3, 4):
                cuda_cond.RING_BUFFERS, cuda_cond.CTAS_PER_SM = n_buf, per_sm
                ctas, _ = cuda_cond.ring_plan(x.shape[0] * 3, 6000, n_sm)
                if per_sm * (n_buf * 4 * 6000 + cuda_cond._SMEM_PER_CTA) > cuda_cond._SMEM_PER_SM:
                    continue  # shared memory does not hold this form
                err = float((cuda_cond.condition_windows(x, detrend=True, norm="peak")
                             - twins[name, MODES[0]]).abs().max())
                if not err <= 2e-5:
                    raise SystemExit(f"condition_windows {name} {n_buf} buffers, {per_sm} CTAs an SM: "
                                     f"max abs err {err}")
                ms_ = kernel_ms(lambda: cuda_cond.condition_windows(x, detrend=True, norm="peak"),
                                "condition_kernel")
                print(f"K4 {name} detrend + peak, {n_buf} buffers, at most {per_sm} CTAs an SM "
                      f"({ctas} CTAs), on {card}: {ms_:.4f} ms of kernel time")
    cuda_cond.RING_BUFFERS, cuda_cond.CTAS_PER_SM = saved
    x = xs["(232, 3, 6000)"]
    for detrend, norm in MODES:
        call = lambda: cuda_cond.condition_windows(x, detrend=detrend, norm=norm)  # noqa: E731
        print(f"K4 (232, 3, 6000) detrend={detrend} norm={norm} as shipped ({saved[0]} buffers, at most "
              f"{saved[1]} CTAs an SM) on {card}: "
              f"{kernel_ms(call, 'condition_kernel'):.4f} ms of kernel time, {cuda_ms(call):.4f} ms by CUDA events")

    # ---- K3, which shares trigger_monoid.cuh with K1
    def scan_ms(rows_):
        return kernel_ms(lambda: cuda_trig.trigger_scan(*rows_), "trigger_scan_kernel")

    for name, (rows, _) in shapes.items():
        print(f"K3 {name.split(' K')[0]} on {card}: {scan_ms(rows):.4f} ms of kernel time")

    # ---- the kernels of an earlier checkout, in turns with the present ones
    if args.before is None:
        graph_experiment()
        return
    before = build_before(args.before)

    def extract_before(rows_, k_, outs):
        p, t1, t2 = rows_
        if before.trigger_extract_f32(p.data_ptr(), t1.data_ptr(), t2.data_ptr(), p.shape[0], p.shape[1],
                                      k_, *(o.data_ptr() for o in outs), stream):
            raise SystemExit("the earlier trigger_extract_f32 failed to launch")

    _build.function("trigger_scan_f32", before.trigger_scan_f32.argtypes)

    def scan_before(rows_, outs, lib=before):
        p, t1, t2 = rows_
        piece, n = cuda_trig.scan_plan(*p.shape)
        summ = torch.empty((p.shape[0], max(n - 1, 1), 4), dtype=torch.int32, device=dev)
        if lib.trigger_scan_f32(p.data_ptr(), t1.data_ptr(), t2.data_ptr(), p.shape[0], p.shape[1],
                                   piece, n, summ.data_ptr(), *(o.data_ptr() for o in outs), stream):
            raise SystemExit("trigger_scan_f32 failed to launch")

    def cond_before(x_, out_, detrend, norm):
        if before.condition_windows_f32(x_.data_ptr(), out_.data_ptr(), x_.shape[0] * 3, 6000,
                                        int(detrend), int(norm == "peak"), 1e-10, stream):
            raise SystemExit("the earlier condition_windows_f32 failed to launch")

    runs = {}
    for name, (rows, k) in shapes.items():
        outs = [torch.empty_like(w_) for w_ in wants[name]]
        extract_before(rows, k, outs)
        torch.cuda.synchronize()
        if not equal(outs, wants[name]):
            raise SystemExit(f"the earlier trigger_extract disagrees with the present twin at {name}")
        runs[f"K1 {name}"] = ("trigger_extract_kernel",
                              lambda rows=rows, k=k, outs=outs: extract_before(rows, k, outs),
                              lambda rows=rows, k=k: cuda_trig.trigger_extract(*rows, k))
        p = rows[0]
        souts = (torch.empty(p.shape, dtype=torch.int32, device=dev), torch.empty_like(p),
                 torch.empty(p.shape, dtype=torch.int32, device=dev))
        # the present K3 by the same raw call on the same buffers: its wrapper
        # allocates three (B, W) outputs a call, the earlier library's caller here none
        runs[f"K3 {name.split(' K')[0]}"] = (
            "trigger_scan_kernel", lambda rows=rows, souts=souts: scan_before(rows, souts),
            lambda rows=rows, souts=souts: scan_before(rows, souts, _build.library()))
    out = torch.empty_like(x)
    for detrend, norm in MODES:
        cond_before(x, out, detrend, norm)
        err = float((out - cuda_cond.condition_windows_reference(x, detrend=detrend, norm=norm)).abs().max())
        if not err <= 2e-5:
            raise SystemExit(f"the earlier condition_windows disagrees with the present twin: {err}")
        runs[f"K4 (232, 3, 6000) detrend={detrend} norm={norm}"] = (
            "condition_kernel", lambda d=detrend, n=norm: cond_before(x, out, d, n),
            lambda d=detrend, n=norm: cuda_cond.condition_windows(x, detrend=d, norm=n))
    big, big_out = xs["(2000, 3, 6000)"], torch.empty_like(xs["(2000, 3, 6000)"])
    runs["K4 (2000, 3, 6000) detrend=True norm=peak"] = (
        "condition_kernel", lambda: cond_before(big, big_out, True, "peak"),
        lambda: cuda_cond.condition_windows(big, detrend=True, norm="peak"))
    # PhaseNet's windows: a width that is no multiple of 4, plain loads and stores
    odd = tensor(rng.normal(size=(256, 3, 3001)) + rng.uniform(-20, 20, (256, 3, 1)))
    odd_out = torch.empty_like(odd)

    def odd_before():
        if before.condition_windows_f32(odd.data_ptr(), odd_out.data_ptr(), 768, 3001, 0, 1, 1e-10, stream):
            raise SystemExit("the earlier condition_windows_f32 failed to launch")

    runs["K4 (256, 3, 3001) detrend=False norm=peak"] = (
        "condition_kernel", odd_before, lambda: cuda_cond.condition_windows(odd, detrend=False, norm="peak"))
    for name, (needle, old, new) in runs.items():
        turns = [kernel_ms(fn, needle, 100) for fn in (old, new, new, old)]
        events = [cuda_ms(fn) for fn in (old, new)]
        print(f"{name} on {card}, kernel ms under torch.profiler, before / after / after / before: "
              + " / ".join(f"{t:.4f}" for t in turns)
              + f"; by CUDA events before {events[0]:.4f}, after {events[1]:.4f}")
    graph_experiment()


if __name__ == "__main__":
    main()
