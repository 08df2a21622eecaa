"""K6 (``rescnn.cu``) on a CUDA GPU: the forms the kernel can take, its phases,
and the kernel of an earlier checkout beside the present one.

    python3 scripts/k6_designs.py [--before DIR]

Shapes are the main path's: x (232, 64, 47), 7 blocks (EQTransformer's res-CNN
section for one step of 232 windows), BatchNorm statistics away from (0, 1).
A launch is 60 ... 200 us, long enough for CUDA events around back-to-back
calls (they include the gap between two launches); the kernel's row under
``torch.profiler`` is printed beside them.
Prints the card's name and power limit first.

1. The present kernel against its twin (3e-4) at the main shape and at the
   edges of its plan and limits (B 1, 2, 131, 233; C 16; T 1, 12, 48; 1
   block), with what ``ptxas -v`` says of its registers and spills.
2. Windows a CTA (``WINDOWS_PER_CTA`` 1, 2, 4 against ``rescnn_plan``'s own
   choice), each held to the twin first.
3. Builds of ``rescnn.cu`` alone into ``build/k6_designs/``: ``-DRESCNN_CO=2``
   (2 output channels a thread, twice the threads) and ``-DRESCNN_UNROLL=<n>``
   (input channels a loop body; the source's default is 2), each held to the
   twin, and ``-DRESCNN_SKIP=<bits>`` with a phase compiled out (1 the
   multiply-adds, 2 the operand loads from shared memory, 4 the staging of
   weights, 8 the stores of relu(affine(.)); the result is wrong, only the
   time is read). The SM clock with launches queued and the SASS of every
   build (``chiprun_out/rescnn*.sass``, with its FFMA / LDS / STS counts) follow.
4. ``--before DIR``: DIR is a checkout of an earlier commit (for example
   ``git archive <commit> | tar -x -C DIR``) whose kernel takes
   ``rescnn_f32(x, 8 packed arrays, out, b, c, t, nb, stream)``. It is built
   into ``build/k6_designs/`` and timed in turns with the present kernel
   (before, after, after, before; a mean over 100 calls each), held to the
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
from volpick_tpu_torch.ops.cuda import rescnn as cuda_rescnn  # noqa: E402
from volpick_tpu_torch.picker.stage_times import cuda_ms, profiled, self_device_us, smi  # noqa: E402

OUT_DIR = REPO / "build" / "k6_designs"
QUIET_FLAGS = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
B, C, T, NB = 232, 64, 47, 7
TOL = 3e-4
KEYS = ("w1", "w2", "cb1", "cb2", "g1", "b1", "g2", "b2")
PHASES = {1: "no multiply-adds", 2: "no operand loads", 3: "no multiply-adds, no operand loads",
          4: "no staging of weights", 8: "no affine + relu stores", 15: "all four compiled out"}


def kernel_ms(fn, calls: int = 20) -> float:
    """Mean device ms a call of the rescnn kernel's rows under torch.profiler."""
    def run():
        for _ in range(calls):
            fn()

    run()
    _, _, events = profiled(run)
    return sum(self_device_us(e) for e in events if "rescnn_kernel" in e.key) / calls / 1e3


def build_variant(name: str, source: Path, defines=()) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"{name}.so"
    done = subprocess.run(
        [_build._nvcc(), *QUIET_FLAGS, *defines, "-shared", "-o", str(lib), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {source} {defines}:\n{done.stdout}")
    return ctypes.CDLL(str(lib))


def packed_params(rng, c: int, nb: int, dev) -> dict:
    """Folded parameters as ``fold_res_cnn_params`` lays them out, drawn directly:
    conv weights at the model's init scale, the last block a kernel-2 conv."""
    bound = (6.0 / (c * 3)) ** 0.5
    p = {k: rng.uniform(-bound, bound, (nb, 3, c, c)) for k in ("w1", "w2")}
    p["w1"][-1, 0] = p["w2"][-1, 0] = 0.0
    for k in ("cb1", "cb2", "b1", "b2"):
        p[k] = rng.normal(size=(nb, c)) * 0.1
    for k in ("g1", "g2"):
        p[k] = (rng.normal(size=(nb, c)) * 0.5 + 1) / np.sqrt(rng.random((nb, c)) * 2 + 0.5)
    return {k: torch.as_tensor(v.astype(np.float32), device=dev).contiguous() for k, v in p.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, help="checkout of an earlier commit to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_designs needs a CUDA device")
    dev = torch.device("cuda", 0)
    # the twin's convolutions in full float32: cuDNN takes TF32 otherwise
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    print(f"card: {card}")
    _build.library()
    keep = False
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line:
            keep = "rescnn" in line
        if keep and ("Compiling entry" in line or "Used" in line or "spill" in line):
            print("  " + line.strip())
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def tensor(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    # ---- 1. the present kernel against its twin
    for b, c, t, nb in [(B, C, T, NB), (1, C, T, NB), (2, C, T, NB), (131, C, T, NB), (233, C, T, NB),
                        (5, 16, T, NB), (3, 20, 12, 2), (4, C, 1, NB), (4, C, 12, 1), (7, C, 48, NB)]:
        x, p = tensor(b, c, t), packed_params(rng, c, nb, dev)
        err = float((cuda_rescnn.res_cnn_stack(x, p) - cuda_rescnn.res_cnn_stack_reference(x, p)).abs().max())
        torch.cuda.synchronize()
        print(f"K6 ({b}, {c}, {t}) x {nb} blocks, plan {cuda_rescnn.rescnn_plan(b, n_sm)}: "
              f"max abs err {err:.3e} vs twin (tol {TOL})")
        if not err <= TOL:
            raise SystemExit(f"res_cnn_stack ({b}, {c}, {t}) x {nb} differs from its twin by {err}")
    x, packed = tensor(B, C, T), packed_params(rng, C, NB, dev)
    want = cuda_rescnn.res_cnn_stack_reference(x, packed)
    flops = 2 * 3 * C * C * 2 * NB * B * T
    print(f"K6 ({B}, {C}, {T}) x {NB}: {flops / 1e9:.3f} GFLOP in the convs, "
          f"{flops / 67e12 * 1e3:.4f} ms at 67 TFLOP/s")

    # ---- 2. windows a CTA
    for wpc in (None, 1, 2, 4):
        cuda_rescnn.WINDOWS_PER_CTA = wpc
        err = float((cuda_rescnn.res_cnn_stack(x, packed) - want).abs().max())
        if not err <= TOL:
            raise SystemExit(f"res_cnn_stack with {wpc} windows a CTA differs from its twin by {err}")
        call = lambda: cuda_rescnn.res_cnn_stack(x, packed)  # noqa: E731
        plan = cuda_rescnn.rescnn_plan(B, n_sm, wpc)
        print(f"K6 {'the plan: ' if wpc is None else ''}{plan[0]} windows a CTA ({plan[1]} CTAs, "
              f"{plan[2]} bytes of shared memory) on {card}: {kernel_ms(call):.4f} ms of kernel time "
              f"under torch.profiler, {cuda_ms(call):.4f} ms by CUDA events")
    cuda_rescnn.WINDOWS_PER_CTA = None
    wpc = cuda_rescnn.rescnn_plan(B, n_sm)[0]

    # ---- 3. other builds of the same source
    source = _build.CSRC_DIR / "rescnn.cu"
    out = torch.empty_like(x)
    argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    def raw(lib, windows):
        lib.rescnn_f32.argtypes = argtypes

        def call():
            if lib.rescnn_f32(x.data_ptr(), *(packed[k].data_ptr() for k in KEYS), out.data_ptr(),
                              B, C, T, NB, windows, stream):
                raise SystemExit("rescnn_f32 failed to launch")
        return call

    for windows in (1, 2):  # 128 and 256 threads a CTA
        call = raw(build_variant("co2", source, ["-DRESCNN_CO=2"]), windows)
        call()
        err = float((out - want).abs().max())
        if not err <= TOL:
            raise SystemExit(f"the -DRESCNN_CO=2 build differs from the twin by {err}")
        print(f"K6 -DRESCNN_CO=2 (2 channels x 12 steps a thread), {windows} windows a CTA, on {card}: "
              f"{kernel_ms(call):.4f} ms of kernel time, {cuda_ms(call):.4f} ms by CUDA events")
    for name_, defines in [("unroll1", ["-DRESCNN_UNROLL=1"]), ("unroll4", ["-DRESCNN_UNROLL=4"]),
                           ("unroll8", ["-DRESCNN_UNROLL=8"]),
                           ("co2_unroll4", ["-DRESCNN_CO=2", "-DRESCNN_UNROLL=4"])]:
        call = raw(build_variant(name_, source, defines), wpc)
        call()
        err = float((out - want).abs().max())
        print(f"K6 {' '.join(defines)}, {wpc} windows a CTA, on {card}: max abs err {err:.2e}, "
              f"{kernel_ms(call):.4f} ms of kernel time, {cuda_ms(call, iters=200):.4f} / "
              f"{cuda_ms(call, iters=200):.4f} ms by CUDA events (200 calls, twice)")
    for bits, what in PHASES.items():
        call = raw(build_variant(f"skip{bits}", source, [f"-DRESCNN_SKIP={bits}"]), wpc)
        print(f"K6 -DRESCNN_SKIP={bits} ({what}), {wpc} windows a CTA, on {card}: "
              f"{kernel_ms(call):.4f} ms of kernel time, {cuda_ms(call):.4f} ms by CUDA events")
    torch.cuda.synchronize()
    # the SM clock while the kernel runs: the launches are queued, then read
    for _ in range(3000):
        cuda_rescnn.res_cnn_stack(x, packed)
    print(f"nvidia-smi with 3000 launches queued (clocks.sm, clocks.max.sm, power.draw): "
          f"{smi('clocks.sm,clocks.max.sm,power.draw')}")
    torch.cuda.synchronize()
    def sass_of(lib_path, bulk_only=True):
        """SASS of the rescnn kernels in a library (the bulk instantiation alone)."""
        text = subprocess.run(["cuobjdump", "-sass", str(lib_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True).stdout
        keep, lines = False, []
        for line in text.splitlines():
            if "Function :" in line:
                keep = "rescnn_kernel" in line and (not bulk_only or "ILb1E" in line)
            if keep:
                lines.append(line)
        return "\n".join(lines)

    (REPO / "chiprun_out").mkdir(exist_ok=True)
    for name_, path_ in [("rescnn", _build.library_path())] + [
            (f"rescnn_skip{bits}", OUT_DIR / f"skip{bits}.so") for bits in PHASES]:
        sass = sass_of(path_)
        (REPO / "chiprun_out" / f"{name_}.sass").write_text(sass)
        print(f"SASS of the bulk instantiation, chiprun_out/{name_}.sass: {sass.count(chr(10))} lines, "
              + ", ".join(f"{sass.count(op)} {op}" for op in ("FFMA", "LDS", "STS", "BAR.SYNC", "FMNMX")))

    # ---- 4. the kernel of an earlier checkout, in turns with the present one
    if args.before is None:
        return
    before = build_variant("before", args.before / "volpick_tpu_torch" / "csrc" / "rescnn.cu")
    before.rescnn_f32.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

    def old():
        if before.rescnn_f32(x.data_ptr(), *(packed[k].data_ptr() for k in KEYS), out.data_ptr(),
                             B, C, T, NB, stream):
            raise SystemExit("the earlier rescnn_f32 failed to launch")

    old()
    err = float((out - want).abs().max())
    if not err <= TOL:
        raise SystemExit(f"the earlier res_cnn_stack disagrees with the present twin: {err}")
    new = lambda: cuda_rescnn.res_cnn_stack(x, packed)  # noqa: E731
    turns = [kernel_ms(fn, 100) for fn in (old, new, new, old)]
    events = [cuda_ms(fn, iters=100) for fn in (old, new, new, old)]
    print(f"K6 ({B}, {C}, {T}) x {NB} on {card}, before / after / after / before: kernel ms under "
          "torch.profiler " + " / ".join(f"{v:.4f}" for v in turns)
          + "; by CUDA events " + " / ".join(f"{v:.4f}" for v in events))


if __name__ == "__main__":
    main()
