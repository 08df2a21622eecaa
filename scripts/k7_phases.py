"""Where the time of K7's float32 body (``volpick_tpu_torch/csrc/mha.cu``,
``mha_kernel``) goes, on a CUDA GPU.

    python3 scripts/k7_phases.py

It times the float32 entries only: ``-DMHA_SKIP`` compiles phases out of the
float32 body, not of the bf16 tensor-core body (``mha_kernel_bf16``), whose
time ``chip_smoke.py`` phase 3 reads from its profiler row. The machine has
no kernel profiler that sees inside a launch, so the kernel is built several
times with one phase compiled out (``-DMHA_SKIP=<bits>``: 1
QK^T, 2 softmax, 4 PV; such a build computes nothing right) and each build is
timed with CUDA events on TPUPickNet's batch-128 step, B 128, H 4, Dh 32,
T 94, in both layouts. What a phase costs is the full kernel's time less the
time of the build without it; "staging" is the build with all three out
(cp.async staging, zero fill, barriers, write-back). Prints the card's name
and power limit first. Needs ``nvcc``; writes its libraries to
``build/k7_phases/``.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from volpick_tpu_torch.ops.cuda import _build  # noqa: E402
from volpick_tpu_torch.ops.cuda import attention as cuda_attn  # noqa: E402
from volpick_tpu_torch.picker.stage_times import cuda_ms, smi  # noqa: E402

B, T, H, DH = 128, 94, 4, 32
BUILDS = {"full": 0, "no QK^T": 1, "no softmax": 2, "no PV": 4, "staging only": 7}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k7_phases needs a CUDA device")
    out_dir = REPO / "build" / "k7_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC_DIR / "mha.cu"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {
        name: subprocess.Popen(
            [_build._nvcc(), *flags, f"-DMHA_SKIP={bits}", "-shared", "-o",
             str(out_dir / f"mha_skip{bits}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, bits in BUILDS.items()
    }
    card = smi("name,power.limit")
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    qkv = torch.randn(B, T, 3, H, DH, device=dev, generator=torch.Generator(dev).manual_seed(0))
    scale = DH ** -0.5
    q, k, v = (a.permute(0, 2, 3, 1).reshape(B, H * DH, T).contiguous() for a in qkv.unbind(2))
    q = q * scale
    out = torch.empty(B, T, H * DH, device=dev)
    out_hm = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = {}
    for name, bits in BUILDS.items():
        log = procs[name].communicate()[0]
        if procs[name].returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"mha_skip{bits}.so"))
        in_place, head_major = lib.mha_qkv_f32, lib.mha_f32
        in_place.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        head_major.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def run_in_place():
            if in_place(qkv.data_ptr(), out.data_ptr(), B, H, DH, T, scale, stream):
                raise SystemExit(f"{name}: mha_qkv_f32 failed to launch")

        def run_head_major():
            if head_major(q.data_ptr(), k.data_ptr(), v.data_ptr(), out_hm.data_ptr(), B, H, DH, T, stream):
                raise SystemExit(f"{name}: mha_f32 failed to launch")

        run_in_place()
        torch.cuda.synchronize()
        if bits == 0:
            err = float((out - cuda_attn.mha_qkv_reference(qkv, scale)).abs().max())
            if not err <= 1e-5:
                raise SystemExit(f"the full build disagrees with its twin: {err}")
        ms[name] = (cuda_ms(run_in_place, iters=200), cuda_ms(run_head_major, iters=200))
        print(f"{name}: mha_qkv {ms[name][0]:.4f} ms, mha {ms[name][1]:.4f} ms on {card}")
    for col, entry in enumerate(("mha_qkv", "mha")):
        full = ms["full"][col]
        parts = ", ".join(f"{name[3:]} {full - ms[name][col]:.4f}" for name in BUILDS if name.startswith("no "))
        print(f"{entry} on {card}: full {full:.4f} ms = staging {ms['staging only'][col]:.4f} + phases "
              f"(full less the build without each): {parts}")


if __name__ == "__main__":
    main()
