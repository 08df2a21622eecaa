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
// This body is templated on the element type, but the package builds only
// its float instantiation. bf16 (the picker's bfloat16 mode) has a body of its
// own, lstm_multi_kernel_bf16, which projects inside the kernel; see the note
// above it. The bf16 instantiation of this body (xp, W_hh and the bias widened
// from bf16 where read, h_t rounded on its store) is the earlier bf16 design,
// built only by scripts/k2_bf16_before.cu as a yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---- bf16: lstm_multi_kernel_bf16, the projection inside the kernel
//
// What it computes: what lstm_multi_pallas computes on bf16 operands. Its
// caller forms the gate inputs as bf16(bf16(x . W_ih) + b) (a bf16 product
// with float32 sums, rounded, and the bias added in bf16); the recurrence
// widens them and W_hh to float32, carries h and c in float32 and rounds each
// h_t to bf16 on its store.
//
// What bounds it on an H100: as the float body, the 47-step chain (4-7 us at
// T = 47); the projection (232 windows x 2 branches x 47 x 64 x C at C 64:
// 90 MFLOP) is 0.1 us at the tensor cores' bf16 rate. Before this body a bf16
// call was three launches (the unit-major W_ih copy, a bf16 bmm and the
// recurrence) with the projection's 2.8 MB going through device memory.
//
// Design: the float body's launch plan and chain (a window's units across the
// lanes of one warp, W_hh in registers, h exchanged by __shfl_sync), in a CTA
// of eight warps that stage and project together; warp 0 then runs the
// recurrence and the other seven end. (One warp alone was a third slower,
// four warps 1-2% slower; PERF.md has the numbers.)
// - Staging: W_ih of the CTA's branch goes to shared memory with its rows
//   reordered unit-major (row 4u + gate), by 16-byte cp.async pieces a row
//   where C % 8 == 0 and W_ih is 16-byte aligned, else by plain loads; rows of
//   units past H and columns past C up to a multiple of 16 are zero. The x of
//   the CTA's windows ((C, T) each, consecutive in memory) goes flat, 16-byte
//   cp.async pieces from an aligned start, the rest by plain loads. Warp 0's
//   rows of W_hh are loaded into registers first, so they arrive meanwhile.
// - Projection: mma.sync m16n8k16, bf16 operands, float32 accumulators; a
//   task is (window, 16 steps, half of the 4H columns). A is x^T (time x
//   channel), gathered from the flat x by 2-byte loads (zeros past T and C);
//   B is W_ih by ldmatrix.x4 from its unit-major rows. The epilogue rounds as
//   the Pallas kernel's caller does, bf16(bf16(acc) + b), and writes the
//   window's gate inputs to shared memory, (T, 4H) unit-major with a row
//   stride of 4H + 8 (the 8 rows of a fragment's stores fall on 8 distinct
//   bank groups). xp never reaches device memory.
// - Recurrence: a thread reads its unit's four gate inputs of step s + 1 from
//   shared memory (one 8-byte load) while step s computes: no ring of
//   cp.async from device memory is needed any more. The gates and the chain
//   are the float body's, unchanged: two partial sums a gate, __expf /
//   __fdividef. The chain takes most of a call (by phase, PERF.md).

using bf16 = __nv_bfloat16;

// Phases of the bf16 body compiled out, for timing only (a build with
// -DLSTM_SKIP=<bits>; the results are then wrong): 1 the projection, 2 the
// recurrence.
#ifndef LSTM_SKIP
#define LSTM_SKIP 0
#endif
constexpr int kSkip = LSTM_SKIP;
// warps that stage and project; warp 0 also runs the recurrence
constexpr int kPrologueWarps = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b over a 16 x 8 tile, k = 16: bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register, lo in the low half
__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte offsets of a CTA's shared arrays: W_ih unit-major (4 HP rows of
// ldw = CP + 8 elements, CP = C rounded up to 16), the windows' x flat, and
// their gate inputs (T rows of ldx = 4 HP + 8 elements a window).
struct FusedLayout {
  int cp, ldw, ldx;
  int x, xp, bias, total;
};

__host__ __device__ inline FusedLayout fused_layout(int c, int t, int hp) {
  FusedLayout l;
  l.cp = (c + 15) / 16 * 16;
  l.ldw = l.cp + 8;
  l.ldx = 4 * hp + 8;
  const int win = kLanes / hp;
  l.x = 4 * hp * l.ldw * 2;
  l.xp = l.x + (win * c * t * 2 + 15) / 16 * 16;
  l.bias = l.xp + win * t * l.ldx * 2;
  l.total = l.bias + 4 * hp * 4;
  return l;
}

// x: window n of branch g at g*sxg + n*C*T, (C, T); wih (G, 4H, C), whh
// (G, 4H, H), bias (G, 4H), gate-major; out at g*sog + n*sob + u*T + time.
// grid (ceil(B / (32/HP)), G), kPrologueWarps warps a CTA, dynamic shared
// memory fused_layout(C, T, HP).total bytes. All warps stage and project; warp
// 0 runs the recurrence of the CTA's windows, the others end after the
// projection.
template <int HP>
__global__ void __launch_bounds__(kPrologueWarps * kLanes)
lstm_multi_kernel_bf16(const bf16* __restrict__ x, const bf16* __restrict__ wih,
                       const bf16* __restrict__ whh, const bf16* __restrict__ bias,
                       bf16* __restrict__ out, int b_total, int c, int t_steps, int h,
                       long long sxg, long long sog, long long sob, unsigned reverse_mask) {
  constexpr int kWin = kLanes / HP;  // windows a warp
  constexpr int kN = 4 * HP;         // gate inputs of a window and step, column 4u + gate
  constexpr int kHalf = kN / 16;     // n-tiles of 8 columns in a projection task
  extern __shared__ __align__(16) unsigned char smem[];
  const FusedLayout l = fused_layout(c, t_steps, HP);
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + l.x);
  bf16* xps = reinterpret_cast<bf16*>(smem + l.xp);
  float* sbias = reinterpret_cast<float*>(smem + l.bias);

  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  constexpr int kThreads = kPrologueWarps * kLanes;
  const int g = blockIdx.y;
  const int w0 = blockIdx.x * kWin;
  const int gw = min(kWin, b_total - w0);  // this CTA's windows
  const int ct = c * t_steps;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // warp 0's unit of the recurrence, and its rows of W_hh[g], loaded first so
  // that they arrive while the CTA stages and projects
  const int u = lane % HP;
  const int wl = lane / HP;
  const bool live = warp == 0 && wl < gw && u < h;
  float w[4][HP];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
    const long long row = (static_cast<long long>(g) * 4 + gate) * h + u;
#pragma unroll
    for (int v = 0; v < HP; ++v) w[gate][v] = (live && v < h) ? __bfloat162float(whh[row * h + v]) : 0.0f;
  }

  // ---- staging
  const bf16* wg = wih + static_cast<long long>(g) * 4 * h * c;
  if (c % 8 == 0 && reinterpret_cast<uintptr_t>(wg) % 16 == 0) {
    const int per = c / 8;
    for (int i = tid; i < 4 * h * per; i += kThreads) {
      const int row = i / per, col = (i - row * per) * 8;  // row = gate * H + u
      const int gate = row / h, uu = row - gate * h;
      cp_async16(ws + (4 * uu + gate) * l.ldw + col, wg + static_cast<long long>(row) * c + col);
    }
  } else {
    for (int i = tid; i < 4 * h * c; i += kThreads) {
      const int row = i / c, col = i - row * c;
      const int gate = row / h, uu = row - gate * h;
      ws[(4 * uu + gate) * l.ldw + col] = wg[i];
    }
  }
  const int padc = l.cp - c;
  for (int i = tid; i < 4 * h * padc; i += kThreads) ws[(i / padc) * l.ldw + c + i % padc] = zero;
  for (int i = 4 * h * l.cp + tid; i < kN * l.cp; i += kThreads)
    ws[(i / l.cp) * l.ldw + i % l.cp] = zero;

  const bf16* xb = x + g * sxg + static_cast<long long>(w0) * ct;
  const int nx = gw * ct;
  const int head = reinterpret_cast<uintptr_t>(xb) % 16 == 0 ? nx / 8 * 8 : 0;
  for (int i = tid * 8; i < head; i += kThreads * 8) cp_async16(xs + i, xb + i);
  for (int i = head + tid; i < nx; i += kThreads) xs[i] = xb[i];
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // the bias unit-major: column n = 4u + gate, zero past H
  const bf16* bg = bias + static_cast<long long>(g) * 4 * h;
  for (int n = tid; n < kN; n += kThreads)
    sbias[n] = n / 4 < h ? __bfloat162float(bg[(n % 4) * h + n / 4]) : 0.0f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- projection: xp[w][time][n] = bf16(bf16(sum_c x[c][time] W_ih[row n][c]) + b[row n]).
  // Task (window, 16 rows of time, half of the columns), spread over the warps.
  const int tq = lane & 3, gq = lane >> 2;
  auto xat = [&](const bf16* xw, int ch, int time) {
    return ch < c && time < t_steps ? xw[ch * t_steps + time] : zero;
  };
  const int mtiles = (t_steps + 15) / 16;
  for (int task = warp; task < gw * mtiles * 2 && !(kSkip & 1); task += kPrologueWarps) {
    const int wi = task % gw, rest = task / gw;
    const int m0 = (rest >> 1) * 16, n0 = (rest & 1) * (kN / 2);
    const bf16* xw = xs + wi * ct;
    float acc[kHalf][4];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    for (int k0 = 0; k0 < l.cp; k0 += 16) {
      // A[time][channel]: rows m0 + gq (+8), columns k0 + 2 tq (+1) (+8)
      unsigned a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int time = m0 + gq + (r & 1) * 8, ch = k0 + 2 * tq + (r >> 1) * 8;
        a[r] = pack2(xat(xw, ch, time), xat(xw, ch + 1, time));
      }
#pragma unroll
      for (int j2 = 0; j2 < kHalf / 2; ++j2) {
        unsigned bw[4];  // columns n0 + 16 j2 .. + 15, channels k0 .. k0 + 15
        ldsm_x4(bw, ws + (n0 + 16 * j2 + (lane & 7) + (lane >> 4) * 8) * l.ldw + k0 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * j2], a, bw[0], bw[1]);
        mma_bf16(acc[2 * j2 + 1], a, bw[2], bw[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      const float2 bv = *reinterpret_cast<const float2*>(sbias + n);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int time = m0 + gq + half * 8;
        if (time < t_steps)
          *reinterpret_cast<__nv_bfloat162*>(xps + (wi * t_steps + time) * l.ldx + n) =
              __floats2bfloat162_rn(round_bf16(acc[j][2 * half]) + bv.x,
                                    round_bf16(acc[j][2 * half + 1]) + bv.y);
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- the recurrence, as the float body's
  const bool rev = g < 32 && ((reverse_mask >> g) & 1u);
  bf16* orow = out + g * sog + (live ? (w0 + wl) * sob + static_cast<long long>(u) * t_steps : 0);
  const bf16* xrow = xps + (live ? wl * t_steps * l.ldx + 4 * u : 0);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto gates_at = [&](int step) {
    const int time = rev ? t_steps - 1 - step : step;
    return Elem<bf16>::gates(*reinterpret_cast<const uint2*>(xrow + time * l.ldx));
  };
  float4 xv = live ? gates_at(0) : zero4;
  float cell = 0.0f, hv = 0.0f;
  for (int s = 0; s < t_steps && !(kSkip & 2); ++s) {
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
    const float ai = xv.x + (acc[0][0] + acc[0][1]);
    const float af = xv.y + (acc[1][0] + acc[1][1]);
    const float ag = xv.z + (acc[2][0] + acc[2][1]);
    const float ao = xv.w + (acc[3][0] + acc[3][1]);
    xv = (live && s + 1 < t_steps) ? gates_at(s + 1) : zero4;
    cell = sigmoid_fast(af) * cell + sigmoid_fast(ai) * tanh_fast(ag);
    hv = live ? sigmoid_fast(ao) * tanh_fast(cell) : 0.0f;
    if (live) orow[rev ? t_steps - 1 - s : s] = __float2bfloat16_rn(hv);
  }
}

template <int HP>
int launch_bf16(const bf16* x, const bf16* wih, const bf16* whh, const bf16* bias, bf16* out, int g,
                int b, int c, int t, int h, long long sxg, long long sog, long long sob,
                unsigned reverse_mask, cudaStream_t stream) {
  const int smem = fused_layout(c, t, HP).total;
  auto kernel = lstm_multi_kernel_bf16<HP>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch has to opt in; the attribute is per function and device
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((b + kLanes / HP - 1) / (kLanes / HP), g);
  kernel<<<grid, kPrologueWarps * kLanes, smem, stream>>>(x, wih, whh, bias, out, b, c, t, h, sxg, sog, sob,
                                         reverse_mask);
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

// The bf16 body, projection included: x (window n of branch g at g*sxg +
// n*C*T, (C, T) contiguous), wih (G, 4H, C), whh (G, 4H, H), bias (G, 4H)
// and out (at g*sog + n*sob + u*T + time), bf16, contiguous on the device;
// H <= 32. Returns the launch's cudaGetLastError().
extern "C" int lstm_multi_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wih,
                               const __nv_bfloat16* whh, const __nv_bfloat16* bias,
                               __nv_bfloat16* out, int g, int b, int c, int t, int h, long long sxg,
                               long long sog, long long sob, unsigned reverse_mask, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 8) return launch_bf16<8>(x, wih, whh, bias, out, g, b, c, t, h, sxg, sog, sob, reverse_mask, s);
  if (h <= 16) return launch_bf16<16>(x, wih, whh, bias, out, g, b, c, t, h, sxg, sog, sob, reverse_mask, s);
  return launch_bf16<32>(x, wih, whh, bias, out, g, b, c, t, h, sxg, sog, sob, reverse_mask, s);
}
