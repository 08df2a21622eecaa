// G independent LSTM recurrences (gate order i, f, g, o; zero initial state)
// in one launch, each scanning time forward or, by a per-branch flag,
// backward.
//
// Replaces: volpick_tpu/ops/pallas/lstm.py::lstm_multi_pallas (_kernel). As
// there, the input projection x_t . W_ih^T for all T steps is one large
// matrix product computed by the caller (ops/cuda/lstm.py); this kernel adds
// the bias and runs the recurrence gates_t = xp_t + b + W_hh . h_{t-1}.
//
// What bounds it on an H100: the latency of a dependent chain. On
// EQTransformer's main path (G = 2, H = 16, T = 47, B = 232 windows) the
// bytes (xp 5.6 MB) and operations (~0.2 MFLOP a step) are worth 1.4-3.4 us,
// but step t cannot start before step t-1 has ended: 47 times an exchange of
// h, a matvec and two rounds of transcendentals, a few hundred cycles each,
// are 4-7 us on their own whatever the width of the card. So the design
// takes everything off that chain that need not be on it.
//
// Design: the chain lives in a warp. One thread per (window, unit); a window
// is a group of HP lanes (H rounded up to 8, 16 or 32; lanes past H carry
// zeros), a warp holds 32 / HP windows and is a CTA of its own, so 232
// windows x 2 branches at H = 16 are 232 CTAs over the card's 132 SMs and no
// block barrier exists. A thread keeps its four rows of W_hh (4H floats) and
// its bias in registers for all T steps, c in a register, and h goes round
// the window by __shfl_sync; each gate sums W_hh . h in two partial sums, so
// the dependent FMA chain is H / 2 long. xp is unit-major (..., H, 4): a
// thread's four gate inputs are one 16-byte cp.async into a ring in shared
// memory, kDepth steps ahead, and the next step's inputs are read from the
// ring while this step's gates compute. (A ring of registers does not do:
// its loads do not stay in flight, a step waits for the one started the step
// before.) Gates use __expf and __fdividef (sigmoid(x) = 1 / (1 + e^-x),
// tanh(x) = 1 - 2 / (1 + e^2x)): absolute error some 1e-7, against the 1e-5
// parity the recurrence is held to; the single instruction tanh.approx.f32
// (5e-4) would not do. Each h_t goes straight to device memory (a 4-byte
// store a thread, off the chain): collecting steps in a shared tile to write
// rows of consecutive floats costs more in the flush than the strided stores
// do. xp and the output are addressed by strides, so one body serves the
// (G, B, H, T) contract of lstm_multi and the (B, G*H, T) output of
// lstm_branches, whose reversed branches read and write time T-1-t (no
// flipped copies of x or h).
//
// Two element types, one body (template parameter T): float, and bf16 for
// the picker's bfloat16 mode. The bf16 instantiation does what the Pallas
// kernel does on bf16 operands: xp, W_hh and the bias come in as bf16 (xp
// from a bf16 matrix product), are widened to float32 where they are read
// (W_hh and the bias once, into registers; xp a step as an 8-byte cp.async
// of the four gates), h and c are carried and the gates computed in float32,
// and each h_t is rounded to bf16 on its store. The launch plan is the same
// for both types, and the float instantiation's code is the one it was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDepth = 8;  // steps of xp in flight ahead of the one being computed

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// What the body needs of an element type: the vector of a unit's four gate
// inputs (one cp.async), its widening to float4, and the widening and
// narrowing of one element.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Gates = float4;
  static __device__ __forceinline__ float4 gates(const float4& v) { return v; }
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  using Gates = uint2;  // four bf16, gate i in the low half of .x
  static __device__ __forceinline__ float4 gates(const uint2& v) {
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16(v); }
};

// xp: four T (i, f, g, o) at g*sxg + b*sxb + time*sxt + 4u; whh (G, 4H, H);
// bias (G, 4H); out at g*sog + b*sob + u*T + time. grid (ceil(B / (32/HP)), G),
// one warp a CTA. Bit g of reverse_mask makes branch g scan time backward.
template <typename T, int HP>
__global__ void __launch_bounds__(kLanes)
lstm_multi_kernel(const T* __restrict__ xp, const T* __restrict__ whh,
                  const T* __restrict__ bias, T* __restrict__ out, int b_total,
                  int t_steps, int h, long long sxg, long long sxb, long long sxt, long long sog,
                  long long sob, unsigned reverse_mask) {
  using E = Elem<T>;
  using Gates = typename E::Gates;
  constexpr int kGateBytes = sizeof(Gates);
  constexpr int kWin = kLanes / HP;  // windows a warp
  // slot s % (kDepth + 1) holds step s: the slot a copy lands in is never the
  // one the step being computed reads
  __shared__ Gates ring[kDepth + 1][kLanes];

  const int lane = threadIdx.x;
  const int u = lane % HP;
  const int g = blockIdx.y;
  const int b = blockIdx.x * kWin + lane / HP;
  const bool live = b < b_total && u < h;
  const bool rev = g < 32 && ((reverse_mask >> g) & 1u);

  const T* xrow = xp + g * sxg + (live ? b * sxb + 4 * u : 0);
  T* orow = out + g * sog + (live ? b * sob + static_cast<long long>(u) * t_steps : 0);
  // one cp.async (16 bytes, 8 for bf16) a thread a step and one commit group a step, also
  // where nothing is copied, so that "all but the newest kDepth - 1 groups
  // have landed" always means "step s has landed"
  auto prefetch = [&](int step) {
    if (live && step < t_steps) {
      const int time = rev ? t_steps - 1 - step : step;
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(&ring[step % (kDepth + 1)][lane]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(xrow + time * sxt),
                   "n"(kGateBytes)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int d = 0; d < kDepth; ++d) prefetch(d);

  // this unit's rows of W_hh[g] and its bias, in registers for the whole scan
  float w[4][HP];
  float bs[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
    const long long row = (static_cast<long long>(g) * 4 + gate) * h + u;
    bs[gate] = live ? E::load(bias[row]) : 0.0f;
#pragma unroll
    for (int v = 0; v < HP; ++v) w[gate][v] = (live && v < h) ? E::load(whh[row * h + v]) : 0.0f;
  }

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
  float4 x = live ? E::gates(ring[0][lane]) : zero;  // a thread reads only what it copied itself
  float c = 0.0f, hv = 0.0f;
  for (int s = 0; s < t_steps; ++s) {
    // W_hh . h_{t-1}: two partial sums a gate halve the dependent chain
    float acc[4][2];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) acc[gate][0] = acc[gate][1] = 0.0f;
#pragma unroll
    for (int v = 0; v < HP; ++v) {
      const float hprev = __shfl_sync(kFull, hv, v, HP);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        acc[gate][v & 1] = fmaf(w[gate][v], hprev, acc[gate][v & 1]);
    }
    const float ai = (x.x + bs[0]) + (acc[0][0] + acc[0][1]);
    const float af = (x.y + bs[1]) + (acc[1][0] + acc[1][1]);
    const float ag = (x.z + bs[2]) + (acc[2][0] + acc[2][1]);
    const float ao = (x.w + bs[3]) + (acc[3][0] + acc[3][1]);
    // the next step's inputs leave shared memory while the gates compute
    prefetch(s + kDepth);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
    x = (live && s + 1 < t_steps) ? E::gates(ring[(s + 1) % (kDepth + 1)][lane]) : zero;
    c = sigmoid_fast(af) * c + sigmoid_fast(ai) * tanh_fast(ag);
    hv = live ? sigmoid_fast(ao) * tanh_fast(c) : 0.0f;
    if (live) orow[rev ? t_steps - 1 - s : s] = E::store(hv);
  }
}

template <typename T>
int launch(const T* xp, const T* whh, const T* bias, T* out, int g, int b, int t, int h,
           long long sxg, long long sxb, long long sxt, long long sog, long long sob,
           unsigned reverse_mask, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = h <= 8 ? 8 : (h <= 16 ? 16 : 32);
  const dim3 grid((b + kLanes / hp - 1) / (kLanes / hp), g);
  if (hp == 8) {
    lstm_multi_kernel<T, 8><<<grid, kLanes, 0, s>>>(xp, whh, bias, out, b, t, h, sxg, sxb, sxt,
                                                    sog, sob, reverse_mask);
  } else if (hp == 16) {
    lstm_multi_kernel<T, 16><<<grid, kLanes, 0, s>>>(xp, whh, bias, out, b, t, h, sxg, sxb, sxt,
                                                     sog, sob, reverse_mask);
  } else {
    lstm_multi_kernel<T, 32><<<grid, kLanes, 0, s>>>(xp, whh, bias, out, b, t, h, sxg, sxb, sxt,
                                                     sog, sob, reverse_mask);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xp, whh (G, 4H, H), bias (G, 4H), out: float32 on the device, addressed as
// the kernel's note says (strides in elements; xp 16-byte aligned, sx*
// multiples of 4); H <= 32. Returns the launch's cudaGetLastError().
extern "C" int lstm_multi_f32(const float* xp, const float* whh, const float* bias, float* out,
                              int g, int b, int t, int h, long long sxg, long long sxb,
                              long long sxt, long long sog, long long sob, unsigned reverse_mask,
                              void* stream) {
  return launch(xp, whh, bias, out, g, b, t, h, sxg, sxb, sxt, sog, sob, reverse_mask, stream);
}

// As lstm_multi_f32 on bf16 operands and output (xp 8-byte aligned); h, c and
// the gates in float32.
extern "C" int lstm_multi_bf16(const __nv_bfloat16* xp, const __nv_bfloat16* whh,
                               const __nv_bfloat16* bias, __nv_bfloat16* out, int g, int b, int t,
                               int h, long long sxg, long long sxb, long long sxt, long long sog,
                               long long sob, unsigned reverse_mask, void* stream) {
  return launch(xp, whh, bias, out, g, b, t, h, sxg, sxb, sxt, sog, sob, reverse_mask, stream);
}
