"""The bf16 bodies of K2 (``lstm_multi.cu``) and K5 (``addattn.cu``) on a
CUDA GPU: their phases, K5's tanh, and the card's special-function rates.

    python3 scripts/k2_k5_bf16_designs.py

Every kernel time is the kernel's own row under ``torch.profiler`` (device
time, a mean over 20 calls), each build timed in turns with the package's
(present, variant, variant, present). Shapes are the main path's: K2
``lstm_branches`` at x (232, C, 47), C 64 and 16, H 16, the second branch
reversed; K5 ``addattn_x`` at x (232, 16, 47), U 32. Prints the card's name
and power limit first.

1. K2 and K5 by phase: the machine has no profiler that sees inside a launch,
   so each source is built with a phase compiled out (K2 ``-DLSTM_SKIP``: 1
   the projection, 2 the recurrence; K5 ``-DADDATTN_SKIP``: 1 energies, 2
   softmax, 4 values, 8 the projections; such a build computes nothing
   right); a phase costs the full kernel's time less the time of the build
   without it, "staging" is the build with all of them out.
2. K5's tanh: the package's body (``tanh.approx.f32`` rounded to bf16)
   against a copy of ``addattn.cu`` whose energies take
   ``tanh.approx.bf16x2`` instead (two tanh an instruction; the source's one
   line swapped in the build directory): times, and each build's elements
   beyond one bf16 ulp of the twin and mean |d| from float64.
3. The special-function units: a loop of ``tanh.approx.bf16x2``,
   ``tanh.approx.f32`` or ``ex2.approx.ftz.f32`` alone (8 CTAs of 256
   threads an SM, 8 independent chains a thread, timed by CUDA events), as
   results a second and instructions a clock an SM at the card's largest SM
   clock.
4. Both tanh forms on every finite bf16 value against the correctly rounded
   tanh (float64, rounded to bf16): how many results differ and by how much.

Needs ``nvcc``.
"""

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
from volpick_tpu_torch.ops.cuda import lstm as cuda_lstm  # noqa: E402
from volpick_tpu_torch.picker.stage_times import profiled, self_device_us, smi  # noqa: E402

B, T, H, ATT_C, ATT_U = 232, 47, 16, 16, 32
CALLS = 20
SFU_ITERS = 4096
OUT_DIR = REPO / "build" / "k2_k5_bf16_designs"
QUIET_FLAGS = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
K2_BUILDS = {"no projection": ["-DLSTM_SKIP=1"], "no recurrence": ["-DLSTM_SKIP=2"],
             "staging only": ["-DLSTM_SKIP=3"]}
K5_BUILDS = {"no energies": 1, "no softmax": 2, "no values": 4, "no projections": 8, "staging only": 15}
# K5's energies with tanh.approx.bf16x2: the line the copy swaps, and what it puts there
K5_TANH_LINE = "const unsigned hh = tanh_pair(add_bf16x2(q2[4 * i + p], k4[p]));"
K5_TANH_BF16X2 = ('unsigned hh; asm("tanh.approx.bf16x2 %0, %1;" : "=r"(hh) : '
                  '"r"(add_bf16x2(q2[4 * i + p], k4[p])));')
SFU_OPS = {"tanh.approx.bf16x2": 2, "tanh.approx.f32": 1, "ex2.approx.ftz.f32": 1}  # name: results an instruction
SFU_PROBE = r"""
#include <cuda_bf16.h>
template <int kOp> __global__ void sfu_loop(unsigned* out, int iters) {
  unsigned r[8];
  float f[8];
  for (int i = 0; i < 8; ++i) r[i] = 0x3f003f00u + threadIdx.x + i, f[i] = 0.5f + 1e-3f * (threadIdx.x + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kOp == 0) asm volatile("tanh.approx.bf16x2 %0, %0;" : "+r"(r[i]));
      if (kOp == 1) asm volatile("tanh.approx.f32 %0, %0;" : "+f"(f[i]));
      if (kOp == 2) asm volatile("ex2.approx.ftz.f32 %0, %0;" : "+f"(f[i]));
    }
  }
  unsigned acc = 0;
  for (int i = 0; i < 8; ++i) acc ^= r[i] ^ __float_as_uint(f[i]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int sfu_probe(int op, unsigned* out, int blocks, int iters) {
  if (op == 0) sfu_loop<0><<<blocks, 256>>>(out, iters);
  if (op == 1) sfu_loop<1><<<blocks, 256>>>(out, iters);
  if (op == 2) sfu_loop<2><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
// bf16 tanh of every 16-bit pattern: op 0 tanh.approx.bf16x2, 1 tanh.approx.f32 rounded to bf16
__global__ void tanh_table(const unsigned short* in, unsigned short* out, int op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned z = in[i];
  if (op == 0) {
    unsigned d;
    asm("tanh.approx.bf16x2 %0, %1;" : "=r"(d) : "r"(z | (z << 16)));
    out[i] = d & 0xffffu;
  } else {
    float h;
    asm("tanh.approx.f32 %0, %1;" : "=f"(h) : "f"(__uint_as_float(z << 16)));
    out[i] = __bfloat16_as_ushort(__float2bfloat16_rn(h));
  }
}
extern "C" int tanh_probe(int op, const unsigned short* in, unsigned short* out) {
  tanh_table<<<256, 256>>>(in, out, op);
  return (int)cudaGetLastError();
}
"""


def row_ms(fn, needle: str) -> float:
    _, _, events = profiled(lambda: [fn() for _ in range(CALLS)])
    return sum(self_device_us(e) for e in events if needle in e.key) / (1e3 * CALLS)


def build_all() -> dict:
    """Every variant's library, built in parallel beside the package's."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "sfu_probe.cu").write_text(SFU_PROBE)
    src = (_build.CSRC_DIR / "addattn.cu").read_text()
    if src.count(K5_TANH_LINE) != 1:
        raise SystemExit("addattn.cu no longer has the energies line this script swaps")
    (OUT_DIR / "addattn_tanh_bf16x2.cu").write_text(src.replace(K5_TANH_LINE, K5_TANH_BF16X2))
    jobs = {"sfu": (OUT_DIR / "sfu_probe.cu", []),
            "k5 tanh.approx.bf16x2": (OUT_DIR / "addattn_tanh_bf16x2.cu", ["-I", str(_build.CSRC_DIR)])}
    jobs.update({f"k2 {n}": (_build.CSRC_DIR / "lstm_multi.cu", d) for n, d in K2_BUILDS.items()})
    jobs.update({f"k5 {n}": (_build.CSRC_DIR / "addattn.cu", [f"-DADDATTN_SKIP={b}"])
                 for n, b in K5_BUILDS.items()})
    procs = {}
    for i, (name, (src_path, defs)) in enumerate(jobs.items()):
        so = OUT_DIR / f"variant{i}.so"
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *QUIET_FLAGS, *defs, "-shared", "-o", str(so),
                                             str(src_path)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.library()
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def k2_phases(libs, rng, dev, stream) -> None:
    bf = torch.bfloat16
    for c in (64, 16):
        x = torch.as_tensor(rng.normal(size=(B, c, T)).astype(np.float32), device=dev).to(bf)
        w = [torch.as_tensor(a.astype(np.float32), device=dev).to(bf) for a in (
            rng.uniform(-0.25, 0.25, (2, 4 * H, c)), rng.uniform(-0.25, 0.25, (2, 4 * H, H)),
            rng.normal(size=(2, 4 * H)) * 0.1)]
        out = torch.empty(B, 2 * H, T, device=dev, dtype=bf)
        present = lambda: cuda_lstm.lstm_branches(x, *w, (False, True))  # noqa: E731
        times = {}
        for name in K2_BUILDS:
            fn = libs[f"k2 {name}"].lstm_multi_bf16
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_uint,
                                                                                                  ctypes.c_void_p]
            variant = lambda fn=fn: fn(x.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), w[2].data_ptr(),  # noqa: E731
                                       out.data_ptr(), 2, B, c, T, H, 0, H * T, 2 * H * T, 2, stream)
            times[name] = [row_ms(f, "lstm_multi_kernel_bf16") for f in (present, variant, variant, present)]
        full = float(np.mean([t for v in times.values() for t in (v[0], v[3])]))
        print(f"K2 bf16 lstm_branches C={c}: present {full:.4f} ms; "
              + "; ".join(f"{n} {v[1]:.4f} / {v[2]:.4f}" for n, v in times.items()))
        print(f"  by phase: projection {full - np.mean(times['no projection'][1:3]):.4f} ms, recurrence "
              f"{full - np.mean(times['no recurrence'][1:3]):.4f}, staging and start "
              f"{np.mean(times['staging only'][1:3]):.4f}", flush=True)


def k5_phases_and_tanh(libs, rng, dev, stream) -> None:
    bf = torch.bfloat16
    x = torch.as_tensor(rng.normal(size=(B, ATT_C, T)).astype(np.float32), device=dev).to(bf)
    wt, wx = (torch.as_tensor((rng.normal(size=(ATT_C, ATT_U)) * 0.125).astype(np.float32), device=dev).to(bf)
              for _ in range(2))
    bh = torch.as_tensor((rng.normal(size=ATT_U) * 0.05).astype(np.float32), device=dev).to(bf)
    wa = torch.as_tensor(rng.uniform(-0.3, 0.3, ATT_U).astype(np.float32), device=dev).to(bf)
    out = torch.empty_like(x)
    g = cuda_addattn.windows_per_cta(B, ATT_C, T, ATT_U, torch.cuda.get_device_properties(dev).multi_processor_count,
                                     True, True)
    present = lambda: cuda_addattn.addattn_x(x, wt, bh, wx, wa)  # noqa: E731

    def variant_of(name):
        fn = libs[name].addattn_x_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        return lambda: fn(x.data_ptr(), wt.data_ptr(), bh.data_ptr(), wx.data_ptr(), wa.data_ptr(),
                          out.data_ptr(), B, ATT_C, T, ATT_U, g, 1e-5, stream)

    times = {n: [row_ms(f, "addattn_kernel_bf16") for f in (present, variant_of(f"k5 {n}"),
                                                               variant_of(f"k5 {n}"), present)]
             for n in K5_BUILDS}
    full = float(np.mean([t for v in times.values() for t in (v[0], v[3])]))
    print(f"K5 bf16 addattn_x: present {full:.4f} ms; by phase: "
          + ", ".join(f"{n[3:] if n.startswith('no ') else n} "
                      f"{(full - np.mean(v[1:3])) if n.startswith('no ') else np.mean(v[1:3]):.4f}"
                      for n, v in times.items()), flush=True)

    bf16x2 = variant_of("k5 tanh.approx.bf16x2")
    t = [row_ms(f, "addattn_kernel_bf16") for f in (present, bf16x2, bf16x2, present)]
    twin = cuda_addattn.addattn_x_reference(x, wt, bh, wx, wa)
    f64 = cuda_addattn.addattn_x_reference(*(a.double() for a in (x, wt, bh, wx, wa)))
    bf16x2()
    torch.cuda.synchronize()
    for name, y in (("tanh.approx.f32 rounded (the package)", present()), ("tanh.approx.bf16x2", out)):
        d = (y.float() - twin.float()).abs()
        beyond = int((d > 2.0 ** -7 * twin.float().abs() + 1e-6).sum())
        print(f"K5 bf16 with {name}: {beyond} of {y.numel()} elements beyond one bf16 ulp of the twin, mean |d| "
              f"from float64 {float((y.double() - f64).abs().mean()):.3e}")
    print(f"  addattn_x time: package {t[0]:.4f} / {t[3]:.4f} ms, tanh.approx.bf16x2 {t[1]:.4f} / {t[2]:.4f} ms",
          flush=True)


def sfu_rates(libs, dev) -> None:
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    probe = libs["sfu"].sfu_probe
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    blocks = 8 * n_sm
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    for op, (name, per) in enumerate(SFU_OPS.items()):
        if probe(op, out.data_ptr(), blocks, 64):
            raise SystemExit(f"sfu probe {name} failed to launch")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        probe(op, out.data_ptr(), blocks, SFU_ITERS)
        end.record()
        torch.cuda.synchronize()
        s = start.elapsed_time(end) / 1e3
        n = blocks * 256 * SFU_ITERS * 8
        print(f"SFU {name}: {n / s / 1e12:.3f} T instructions/s, {per * n / s / 1e12:.3f} T results/s, "
              f"{n / s / n_sm / clock_hz:.2f} instructions a clock an SM at {clock_hz / 1e6:.0f} MHz", flush=True)


def tanh_tables(libs, dev) -> None:
    probe = libs["sfu"].tanh_probe
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    bits = torch.arange(65536, dtype=torch.int32, device=dev).to(torch.int16)
    z = bits.view(torch.bfloat16)
    finite = torch.isfinite(z.float())
    want = torch.tanh(z.double()).to(torch.bfloat16).float()
    mid = finite & (z.float().abs() > 0.05) & (z.float().abs() < 4)
    for op, name in enumerate(("tanh.approx.bf16x2", "tanh.approx.f32 rounded to bf16")):
        got = torch.empty_like(bits)
        if probe(op, bits.data_ptr(), got.data_ptr()):
            raise SystemExit("tanh probe failed to launch")
        torch.cuda.synchronize()
        have = got.view(torch.bfloat16).float()
        d = (have - want).abs()
        ulp = 2.0 ** -7 * want.abs()
        print(f"{name} on {int(finite.sum())} finite bf16 inputs: {int((d[finite] > 0).sum())} differ from the "
              f"correctly rounded tanh, {int((d[finite] > ulp[finite]).sum())} by more than one bf16 ulp (largest "
              f"|d| {float(d[finite].max()):.3e}); for 0.05 < |z| < 4: {int((d[mid] > 0).sum())} of "
              f"{int(mid.sum())} differ")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)} ({smi('name,power.limit')})", flush=True)
    libs = build_all()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    k2_phases(libs, rng, dev, stream)
    k5_phases_and_tanh(libs, rng, dev, stream)
    sfu_rates(libs, dev)
    tanh_tables(libs, dev)


if __name__ == "__main__":
    main()
