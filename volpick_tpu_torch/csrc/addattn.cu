// Dense additive (Bahdanau) self-attention, a few windows per CTA.
//
// Replaces: volpick_tpu/ops/pallas/addattn.py::seq_self_attention_pallas
// (_kernel). With q = x^T Wt + bh and k = x^T Wx,
//   e[t, s]   = sum_u Wa[u] * tanh(q[t, u] + k[s, u])
//   a[t, s]   = exp(e[t, s] - max_s e[t, :]) / (sum_s exp(...) + eps)
//   out[c, t] = sum_s x[c, s] * a[t, s]
// The scalar energy offset `ba` is left out, as in the Pallas kernel: a
// constant shift of every energy cancels under the max-subtracted softmax.
// Two entries share the kernel body: addattn_f32 takes q and k projected by
// the caller (the Pallas kernel's contract), addattn_x_f32 takes x and the
// weights, projects q and k in shared memory and never writes them to device
// memory (what the model calls: one launch a block).
//
// What bounds it on an H100: operations, not bytes. At the EQTransformer step
// (B 232, T 47, U 32, C 16) it evaluates B*T*T*U = 16.4 M tanh for about
// 4.2 MB of traffic, and the tanh go through the special-function units, 16
// results a clock an SM.
//
// Design:
// - tanh(a) = 1 - 2 / (exp(2a) + 1) from ex2.approx and rcp.approx: two
//   special-function operations and five FMA-pipe operations, no branch, abs
//   error about 2e-7. It saturates cleanly: exp -> inf gives 1, exp -> 0 gives
//   -1, never NaN. (IEEE tanhf is some tens of instructions; tanh.approx is 5e-4
//   off and fails the 1e-5 parity.) The softmax keeps IEEE expf and division.
// - A lane owns one query row: q[t, :] and Wa sit in registers, the lane walks
//   s and reads k[s, :] as float4 from shared memory, all lanes of a warp the
//   same address (a broadcast): a quarter of a shared load a tanh. Rows are
//   padded to kU units (8, 16 or 32, the template instance; wider U goes in
//   slabs of 32) with Wa = 0 there.
// - Query rows of g windows are laid end to end, so that at T = 47 two
//   windows fill 94 of 96 lanes of three warps (one window alone 47 of 64).
//   Each 32-row group is cut along s into `ss` stretches, one warp each: g = 2
//   at B = 232 gives 116 CTAs of 12 warps, at most one a SM, three warps a
//   scheduler doing 12 of the 47 steps each, and every SM ends together.
// - q, k (or x and the weights) and, in a second group that is waited for
//   only before the values, x are staged with 16-byte cp.async. Row strides of
//   q and k are kU-multiples plus 4 floats, so that the float4 loads of a
//   quarter-warp's eight rows hit eight different bank groups.
// - The phases around the energies keep the lane-a-row mapping, so that none
//   of them needs a shuffle or waits on a chain across lanes. Projections (in
//   addattn_x): a lane holds 8 units of its row of q or k and reads the
//   weights' rows as broadcast float4. Softmax: each warp leaves the max of
//   its stretch beside the energies, then turns its stretch into exp(e - row
//   max) with IEEE expf and leaves its share of the sum. Values: a lane holds
//   4 channels of its row, x[c, s] is a broadcast, and the division by
//   (sum + eps) comes once an output instead of once a weight. The energies'
//   row stride T | 1 is odd, so lanes along rows never conflict.
//
// This body is templated on the element type, but the package builds only
// its float instantiations. bf16 (the picker's bfloat16 mode) has a body of
// its own, addattn_kernel_bf16; see the note above it. The bf16
// instantiation of this body (x, q, k or the weights widened to float32 on
// plain loads, everything in float32, each output rounded to bf16) is the
// earlier bf16 design, built only by scripts/k5_bf16_before.cu as a yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 16;
constexpr float kTwoLog2e = 2.8853900817779268f;  // 2 / ln 2

// Phases compiled out, for timing only (scripts/k3_k5_designs.py builds the
// file with -DADDATTN_SKIP=<bits>; the results are then wrong): 1 energies,
// 2 softmax, 4 values, 8 the projections of addattn_x.
#ifndef ADDATTN_SKIP
#define ADDATTN_SKIP 0
#endif
constexpr int kSkip = ADDATTN_SKIP;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// tanh(a) = 1 - 2 / (exp(2a) + 1), exp(2a) as 2^(a * 2 log2(e)): inf gives 1,
// 0 gives -1. The sum q + k is formed first, as the plain version forms it, so
// that a large q and k of opposite signs cancel before any scaling rounds them.
__device__ __forceinline__ float tanh_of(float a) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a * kTwoLog2e));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.0f));
  return fmaf(-2.0f, r, 1.0f);
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

template <typename T>
constexpr bool kIsBf16 = std::is_same_v<T, __nv_bfloat16>;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_float(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_float(float v, __nv_bfloat16*) {
  return __float2bfloat16(v);
}

// Four consecutive bf16 (8 bytes) widened to float4.
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* src) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// How many stretches the s axis of a 32-row group is cut into, one warp
// each: a power of two, at most T, as many as keep the CTA within kMaxWarps.
__host__ __device__ inline int stretches(int t, int g) {
  const int row_groups = (g * t + kLanes - 1) / kLanes;
  int ss = 1;
  while (row_groups * ss * 2 <= kMaxWarps && ss * 2 <= t) ss *= 2;
  return ss;
}

// Offsets (in floats, each a multiple of 4) of a CTA's shared arrays for g
// windows of (C, T) with U units padded to `up`.
struct Layout {
  int up, us, es, ps;                       // padded U, row strides of q / k, energies, pm / pd
  int q, k, e, x, pm, pd, wa, wt, wx, bh;   // offsets
  int total;                                // floats in all
};

__host__ __device__ inline Layout layout(int c, int t, int u, int g, int ku, bool project) {
  Layout l;
  l.up = (u + ku - 1) / ku * ku;
  l.us = l.up + 4;
  l.es = t | 1;
  const int rows = g * t;
  l.ps = round4(rows);
  l.q = 0;
  l.k = l.q + rows * l.us;
  l.e = l.k + rows * l.us;
  l.x = l.e + round4(rows * l.es);
  l.pm = l.x + round4(g * c * t);
  l.pd = l.pm + stretches(t, g) * l.ps;
  l.wa = l.pd + stretches(t, g) * l.ps;
  l.wt = l.wa + l.up;
  l.wx = l.wt + (project ? c * l.up : 0);
  l.bh = l.wx + (project ? c * l.up : 0);
  l.total = l.bh + (project ? l.up : 0);
  return l;
}

// Copies n contiguous floats with cp.async, 16 bytes a piece where `vec`
// (n % 4 == 0, both sides 16-byte aligned); bf16 by plain loads widened to
// float, 8 bytes a piece where `vec` (n % 4 == 0, 8-byte aligned).
template <typename T>
__device__ __forceinline__ void stage_flat(float* dst, const T* src, int n, bool vec) {
  if constexpr (kIsBf16<T>) {
    if (vec) {
      for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4)
        *reinterpret_cast<float4*>(dst + i) = widen4(src + i);
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = to_float(src[i]);
    }
  } else if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  }
}

// Copies `rows` rows of u elements to float rows of stride us (bf16 widened
// as in stage_flat).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int rows, int u, int us,
                                           bool vec) {
  if (vec) {
    const int n4 = u / 4;
    for (int i = threadIdx.x; i < rows * n4; i += blockDim.x) {
      const int r = i / n4, col = (i - r * n4) * 4;
      if constexpr (kIsBf16<T>) {
        *reinterpret_cast<float4*>(dst + r * us + col) = widen4(src + r * u + col);
      } else {
        cp_async16(dst + r * us + col, src + r * u + col);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * u; i += blockDim.x) {
      const int r = i / u, col = i - r * u;
      if constexpr (kIsBf16<T>) {
        dst[r * us + col] = to_float(src[r * u + col]);
      } else {
        cp_async4(dst + r * us + col, src + r * u + col);
      }
    }
  }
}

// Copies a (rows, u) weight to rows of `up` floats, zeros past u.
template <typename T>
__device__ __forceinline__ void load_padded(float* dst, const T* src, int rows, int u, int up) {
  for (int i = threadIdx.x; i < rows * up; i += blockDim.x) {
    const int r = i / up, col = i - r * up;
    dst[i] = col < u ? to_float(src[r * u + col]) : 0.0f;
  }
}

// grid ceil(B / g); blockDim a whole number of warps, at most kMaxWarps;
// dynamic shared memory layout(c, t, u, g, kU, kProject).total floats.
// kProject: `qw` is Wt (C, U), `kw` is Wx (C, U), `bh` (U,); else `qw` is
// q (B, T, U), `kw` is k (B, T, U) and `bh` is not read.
template <typename T, int kU, bool kProject>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
addattn_kernel(const T* __restrict__ x, const T* __restrict__ qw,
               const T* __restrict__ kw, const T* __restrict__ bh,
               const T* __restrict__ wa, T* __restrict__ out, int b, int c, int t,
               int u, int g, int ss, int vec_rows, int vec_x, float eps) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const Layout l = layout(c, t, u, g, kU, kProject);
  float* sq = sh + l.q;
  float* sk = sh + l.k;
  float* se = sh + l.e;
  float* sx = sh + l.x;
  float* swa = sh + l.wa;

  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int n_warps = blockDim.x / kLanes;
  const int w0 = blockIdx.x * g;        // first window of this CTA
  const int gw = min(g, b - w0);        // its windows
  const int rows = gw * t;              // its query rows, window after window
  const T* xb = x + static_cast<size_t>(w0) * c * t;

  // ---- staging
  if (kProject) {
    stage_flat(sx, xb, gw * c * t, vec_x);
    cp_async_commit();
    cp_async_commit();
    load_padded(sh + l.wt, qw, c, u, l.up);
    load_padded(sh + l.wx, kw, c, u, l.up);
    load_padded(sh + l.bh, bh, 1, u, l.up);
  } else {
    stage_rows(sq, qw + static_cast<size_t>(w0) * t * u, rows, u, l.us, vec_rows);
    stage_rows(sk, kw + static_cast<size_t>(w0) * t * u, rows, u, l.us, vec_rows);
    cp_async_commit();
    stage_flat(sx, xb, gw * c * t, vec_x);
    cp_async_commit();
    const int pad = l.up - u;  // zeros in the padded units
    for (int i = tid; i < rows * pad; i += blockDim.x) {
      const int at = (i / pad) * l.us + u + i % pad;
      sq[at] = sk[at] = 0.0f;
    }
  }
  load_padded(swa, wa, 1, u, l.up);
  cp_async_wait<1>();
  __syncthreads();

  const int row_groups = (rows + kLanes - 1) / kLanes;

  if (kProject && !(kSkip & 8)) {
    // q = x^T Wt + bh, k = x^T Wx. Task (rg, which, slab): a lane owns one row
    // and 8 units of q or of k in registers; the weights' rows are read as
    // float4, every lane the same address.
    const int slabs = l.up / 8;
    for (int task = warp; task < row_groups * 2 * slabs; task += n_warps) {
      const int rg = task % row_groups, rest = task / row_groups;
      const int which = rest % 2, u0 = (rest / 2) * 8;
      const int r = rg * kLanes + lane;
      const int rr = min(r, rows - 1);
      const int gi = rr / t;
      const float* xc = sx + gi * c * t + (rr - gi * t);
      const float* sw = sh + (which ? l.wx : l.wt) + u0;
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int ch = 0; ch < c; ++ch) {
        const float xv = xc[ch * t];
        const float4 wlo = *reinterpret_cast<const float4*>(sw + ch * l.up);
        const float4 whi = *reinterpret_cast<const float4*>(sw + ch * l.up + 4);
        acc[0] = fmaf(xv, wlo.x, acc[0]), acc[1] = fmaf(xv, wlo.y, acc[1]);
        acc[2] = fmaf(xv, wlo.z, acc[2]), acc[3] = fmaf(xv, wlo.w, acc[3]);
        acc[4] = fmaf(xv, whi.x, acc[4]), acc[5] = fmaf(xv, whi.y, acc[5]);
        acc[6] = fmaf(xv, whi.z, acc[6]), acc[7] = fmaf(xv, whi.w, acc[7]);
      }
      if (r < rows) {
        float* dst = (which ? sk : sq) + r * l.us + u0;
        if (which == 0) {
          const float* sbh = sh + l.bh + u0;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += sbh[i];
        }
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
    }
    __syncthreads();
  }

  // ---- 1: energies. Task (rg, j): the 32 query rows of group rg against the
  // j-th stretch of s; a lane keeps its row of q and Wa in registers, and the
  // max of its stretch for the softmax.
  float* pm = sh + l.pm;  // (ss, rows): max of row r over stretch j
  float* pd = sh + l.pd;  // (ss, rows): sum of exp(e - row max) over stretch j
  const int stretch = (t + ss - 1) / ss;
  for (int task = warp; task < row_groups * ss && !(kSkip & 1); task += n_warps) {
    const int rg = task % row_groups, j = task / row_groups;
    const int r = rg * kLanes + lane;
    const int rr = min(r, rows - 1);  // lanes past the last row repeat it and store nothing
    const float* kbase = sk + (rr / t) * t * l.us;
    const int s_lo = j * stretch, s_hi = min(t, s_lo + stretch);
    float m = -INFINITY;
    for (int u0 = 0; u0 < l.up; u0 += kU) {
      float qreg[kU], wreg[kU];
#pragma unroll
      for (int i = 0; i < kU; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + rr * l.us + u0 + i);
        const float4 wv = *reinterpret_cast<const float4*>(swa + u0 + i);
        qreg[i] = qv.x, qreg[i + 1] = qv.y, qreg[i + 2] = qv.z, qreg[i + 3] = qv.w;
        wreg[i] = wv.x, wreg[i + 1] = wv.y, wreg[i + 2] = wv.z, wreg[i + 3] = wv.w;
      }
      m = -INFINITY;  // of the sums over all units: the last slab's
      for (int s = s_lo; s < s_hi; ++s) {
        const float* kr = kbase + s * l.us + u0;
        float e0 = u0 ? se[rr * l.es + s] : 0.0f, e1 = 0.0f;
#pragma unroll
        for (int i = 0; i < kU; i += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + i);
          e0 = fmaf(wreg[i], tanh_of(qreg[i] + kv.x), e0);
          e1 = fmaf(wreg[i + 1], tanh_of(qreg[i + 1] + kv.y), e1);
          e0 = fmaf(wreg[i + 2], tanh_of(qreg[i + 2] + kv.z), e0);
          e1 = fmaf(wreg[i + 3], tanh_of(qreg[i + 3] + kv.w), e1);
        }
        const float e = e0 + e1;
        m = fmaxf(m, e);
        if (r < rows) se[r * l.es + s] = e;
      }
    }
    if (r < rows) pm[j * l.ps + r] = m;
  }
  __syncthreads();

  // ---- 2: exp(e - row max), same tasks: the energies become the softmax's
  // numerators in place, and each stretch leaves its share of the denominator
  for (int task = warp; task < row_groups * ss && !(kSkip & 2); task += n_warps) {
    const int rg = task % row_groups, j = task / row_groups;
    const int r = rg * kLanes + lane;
    if (r < rows) {
      float m = pm[r];
      for (int jj = 1; jj < ss; ++jj) m = fmaxf(m, pm[jj * l.ps + r]);
      float* er = se + r * l.es;
      float sum = 0.0f;
      for (int s = j * stretch; s < min(t, (j + 1) * stretch); ++s) {
        const float v = expf(er[s] - m);
        er[s] = v;
        sum += v;
      }
      pd[j * l.ps + r] = sum;
    }
  }
  cp_async_wait<0>();  // x
  __syncthreads();

  // ---- 3: values. Task (rg, cg): a lane owns one row and 4 channels; x[c, s]
  // is one address for all lanes of a window; the division by the denominator
  // comes last, once an output. Written coalesced along t.
  const int ch_groups = (c + 3) / 4;
  T* ob = out + static_cast<size_t>(w0) * c * t;
  for (int task = warp; task < row_groups * ch_groups && !(kSkip & 4); task += n_warps) {
    const int rg = task % row_groups, c0 = (task / row_groups) * 4;
    const int r = rg * kLanes + lane;
    const int rr = min(r, rows - 1);
    const int gi = rr / t;
    const float* ar = se + rr * l.es;
    const float* x0 = sx + gi * c * t + c0 * t;
    // channels past C read the last one and store nothing
    const float* x1 = x0 + min(1, c - 1 - c0) * t;
    const float* x2 = x0 + min(2, c - 1 - c0) * t;
    const float* x3 = x0 + min(3, c - 1 - c0) * t;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int s = 0; s < t; ++s) {
      const float pv = ar[s];
      a0 = fmaf(x0[s], pv, a0);
      a1 = fmaf(x1[s], pv, a1);
      a2 = fmaf(x2[s], pv, a2);
      a3 = fmaf(x3[s], pv, a3);
    }
    if (r < rows) {
      float denom = eps;
      for (int jj = 0; jj < ss; ++jj) denom += pd[jj * l.ps + r];
      T* o = ob + gi * c * t + c0 * t + (r - gi * t);
      o[0] = from_float(a0 / denom, o);
      if (c0 + 1 < c) o[t] = from_float(a1 / denom, o);
      if (c0 + 2 < c) o[2 * t] = from_float(a2 / denom, o);
      if (c0 + 3 < c) o[3 * t] = from_float(a3 / denom, o);
    }
  }
}

template <typename T, int kU, bool kProject>
int launch_instance(const T* x, const T* qw, const T* kw, const T* bh,
                    const T* wa, T* out, int b, int c, int t, int u, int g, int ss,
                    int threads, int vec_rows, int vec_x, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(layout(c, t, u, g, kU, kProject).total) * sizeof(float);
  auto kernel = addattn_kernel<T, kU, kProject>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch has to opt in; the attribute is per function and device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(b + g - 1) / g, threads, smem, stream>>>(x, qw, kw, bh, wa, out, b, c, t, u, g, ss,
                                                     vec_rows, vec_x, eps);
  return static_cast<int>(cudaGetLastError());
}

// 16 bytes for cp.async of floats, 8 for four bf16
template <typename T>
bool aligned4(const T* p) { return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0; }

template <bool kProject, typename T>
int launch(const T* x, const T* qw, const T* kw, const T* bh, const T* wa,
           T* out, int b, int c, int t, int u, int g, float eps, void* stream) {
  if (b < 1 || c < 1 || t < 1 || u < 1 || g < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int row_groups = (g * t + kLanes - 1) / kLanes;
  const int ss = stretches(t, g);
  const int warps = row_groups * ss < kMaxWarps ? row_groups * ss : kMaxWarps;
  const int vec_rows = !kProject && u % 4 == 0 && aligned4(qw) && aligned4(kw);
  const int vec_x = (c * t) % 4 == 0 && aligned4(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = warps * kLanes;
  if (u <= 8) {
    return launch_instance<T, 8, kProject>(x, qw, kw, bh, wa, out, b, c, t, u, g, ss, threads,
                                        vec_rows, vec_x, eps, s);
  }
  if (u <= 16) {
    return launch_instance<T, 16, kProject>(x, qw, kw, bh, wa, out, b, c, t, u, g, ss, threads,
                                         vec_rows, vec_x, eps, s);
  }
  return launch_instance<T, 32, kProject>(x, qw, kw, bh, wa, out, b, c, t, u, g, ss, threads,
                                       vec_rows, vec_x, eps, s);
}

// ---- bf16: addattn_kernel_bf16
//
// What it computes (the twins in ops/cuda/addattn.py do the same): q =
// bf16(bf16(x^T Wt) + bh) and k = bf16(x^T Wx), as seq_self_attention_pallas
// forms them in bf16 (addattn takes them given); z = bf16(q + k) and h =
// bf16(tanh z), at the Pallas kernel's own rounding points; e = Wa . h and the
// softmax in float32 (IEEE expf and division by sum + eps); the value product
// x a with float32 sums, rounded to bf16. The probabilities are not rounded to
// bf16 before the product as the Pallas kernel's are: rounded, they put the
// result farther from JAX's bf16 than 2^-7 of its largest output at a scale
// that saturates tanh (tests/test_torch_addattn.py's rule), so p goes into
// the product as two bf16 terms, p = hi + lo, exact to 2^-16 of p.
//
// What bounds it on an H100: the special-function units. At the
// EQTransformer step (B 232, T 47, U 32, C 16) it evaluates 16.4 M tanh, 4.0
// us at one special-function operation a tanh (16 a clock an SM). Each tanh
// is tanh.approx.f32 on the bf16 value, rounded to bf16: that is the
// correctly rounded tanh on every finite bf16 input, so the kernel rounds
// exactly where its twin does. tanh.approx.bf16x2 gives two a instruction
// but issues at half the rate (8 a clock an SM), so it is no faster per
// tanh, and it is one bf16 ulp off the correctly rounded tanh on 2,086
// inputs; the body with it ran 1-2% faster and put 13% of the outputs
// beyond one bf16 ulp of the twin (scripts/k2_k5_bf16_designs.py times and
// counts both; PERF.md has the numbers). The float body's ex2 + rcp take
// two operations a tanh.
//
// Design: the float body's launch plan (g windows a CTA, rows end to end, the
// s axis of a 32-row group cut into stretches, one warp each) with bf16 tiles
// and the products on the tensor cores:
// - Staging: x flat and (addattn) q, k rows by 16-byte cp.async pieces where
//   aligned, else plain loads; the weights transposed (rows u) and padded
//   with zeros by plain loads.
// - Projections (addattn_x): mma.sync m16n8k16, bf16 -> float32. A is x^T
//   gathered by 2-byte loads from the flat x, B a pair of 4-byte loads from
//   the transposed weight; a task is (window, q or k, 16 rows). q and k land
//   in shared memory as bf16 rows of U + 8 elements.
// - Energies: a lane owns one query row, holds it as bf16x2 registers and Wa
//   in float32, reads k[s, :] as 16-byte broadcasts; per pair of units one
//   add.rn.bf16x2, two tanh.approx.f32, one cvt.rn.bf16x2 and two float32
//   FMAs.
// - Softmax: as the float body (IEEE expf, a stretch's share of the sum);
//   p is written split, hi and lo, as bf16 (T rows of ceil16(T) + 8).
// - Values: out^T = p x^T on mma.sync, a task (window, 16 rows, 8 channels):
//   A = p hi and lo by ldmatrix.x4, B = x by 2-byte loads from the flat x;
//   the division by the row's sum + eps comes once an output, as in the float
//   body.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16b(void* dst, const void* src) {
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

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float lo_f(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float tanh_approx(float a) {
  float d;
  asm("tanh.approx.f32 %0, %1;" : "=f"(d) : "f"(a));
  return d;
}

// bf16(tanh z) of both halves of a bf16 pair, correctly rounded
__device__ __forceinline__ unsigned tanh_pair(unsigned z) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(tanh_approx(lo_f(z)), tanh_approx(hi_f(z)));
  return *reinterpret_cast<const unsigned*>(&h);
}

// Byte offsets of a CTA's shared arrays for g windows of (C, T) with U <= 32
// units padded to up (16 or 32): x flat; q and k, a row of up + 8 bf16 for
// each of the g*T rows; p hi and lo, ceil16(T) rows of ceil16(T) + 8 bf16 a
// window; the energies (float rows of T | 1); the stretches' max and sum; Wa
// and (addattn_x) bh as float; Wt and Wx transposed, up rows of ceil16(C) + 8.
struct Layout16 {
  int up, cp, tp, ldq, ldp, ldw, es, ps;
  int q, k, ph, pl, e, pm, pd, wa, bh, wt, wx, total;
};

__host__ __device__ inline Layout16 layout_bf16(int c, int t, int u, int g, bool project) {
  Layout16 l;
  l.up = u <= 16 ? 16 : 32;
  l.cp = (c + 15) / 16 * 16;
  l.tp = (t + 15) / 16 * 16;
  l.ldq = l.up + 8;
  l.ldp = l.tp + 8;
  l.ldw = l.cp + 8;
  l.es = t | 1;
  const int rows = g * t;
  l.ps = round4(rows);
  const int ss = stretches(t, g);
  l.q = (g * c * t * 2 + 15) / 16 * 16;
  l.k = l.q + (rows * l.ldq * 2 + 15) / 16 * 16;
  l.ph = l.k + (rows * l.ldq * 2 + 15) / 16 * 16;
  l.pl = l.ph + g * l.tp * l.ldp * 2;
  l.e = l.pl + g * l.tp * l.ldp * 2;
  l.pm = l.e + (rows * l.es * 4 + 15) / 16 * 16;
  l.pd = l.pm + ss * l.ps * 4;
  l.wa = l.pd + ss * l.ps * 4;
  l.bh = l.wa + l.up * 4;
  l.wt = l.bh + (project ? l.up * 4 : 0);
  l.wx = l.wt + (project ? l.up * l.ldw * 2 : 0);
  l.total = l.wx + (project ? l.up * l.ldw * 2 : 0);
  return l;
}

// Copies n contiguous bf16: 16-byte cp.async pieces from a 16-byte aligned
// start, the rest (or all, where the start is not aligned) by plain loads.
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int n) {
  const int head = reinterpret_cast<uintptr_t>(src) % 16 == 0 ? n / 8 * 8 : 0;
  for (int i = threadIdx.x * 8; i < head; i += blockDim.x * 8) cp_async16b(dst + i, src + i);
  for (int i = head + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// grid ceil(B / g); blockDim a whole number of warps, at most kMaxWarps;
// dynamic shared memory layout_bf16(c, t, u, g, kProject).total bytes; U <= kUP.
// kProject: `qw` is Wt (C, U), `kw` is Wx (C, U), `bh` (U,); else `qw` is q
// (B, T, U), `kw` is k (B, T, U) and `bh` is not read.
template <int kUP, bool kProject>
__global__ void __launch_bounds__(kMaxWarps * kLanes, 1)
addattn_kernel_bf16(const bf16* __restrict__ x, const bf16* __restrict__ qw,
                    const bf16* __restrict__ kw, const bf16* __restrict__ bh,
                    const bf16* __restrict__ wa, bf16* __restrict__ out, int b, int c, int t,
                    int u, int g, int ss, float eps) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const Layout16 l = layout_bf16(c, t, u, g, kProject);
  bf16* sx = reinterpret_cast<bf16*>(sm);
  bf16* sq = reinterpret_cast<bf16*>(sm + l.q);
  bf16* sk = reinterpret_cast<bf16*>(sm + l.k);
  bf16* sph = reinterpret_cast<bf16*>(sm + l.ph);
  bf16* spl = reinterpret_cast<bf16*>(sm + l.pl);
  float* se = reinterpret_cast<float*>(sm + l.e);
  float* pm = reinterpret_cast<float*>(sm + l.pm);  // (ss, rows): max of row r over stretch j
  float* pd = reinterpret_cast<float*>(sm + l.pd);  // (ss, rows): sum of exp(e - row max) over stretch j
  float* swa = reinterpret_cast<float*>(sm + l.wa);
  float* sbh = reinterpret_cast<float*>(sm + l.bh);
  bf16* swt = reinterpret_cast<bf16*>(sm + l.wt);
  bf16* swx = reinterpret_cast<bf16*>(sm + l.wx);

  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const int n_warps = blockDim.x / kLanes;
  const int w0 = blockIdx.x * g;   // first window of this CTA
  const int gw = min(g, b - w0);   // its windows
  const int rows = gw * t;         // its query rows, window after window
  const int tq = lane & 3, gq = lane >> 2;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // ---- staging
  stage_bf16(sx, x + static_cast<size_t>(w0) * c * t, gw * c * t);
  if (!kProject) {
    const bf16* qs = qw + static_cast<size_t>(w0) * t * u;
    const bf16* ks = kw + static_cast<size_t>(w0) * t * u;
    if (u % 8 == 0 && reinterpret_cast<uintptr_t>(qs) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(ks) % 16 == 0) {
      const int n8 = u / 8;
      for (int i = tid; i < rows * n8; i += blockDim.x) {
        const int r = i / n8, col = (i - r * n8) * 8;
        cp_async16b(sq + r * l.ldq + col, qs + r * u + col);
        cp_async16b(sk + r * l.ldq + col, ks + r * u + col);
      }
    } else {
      for (int i = tid; i < rows * u; i += blockDim.x) {
        const int r = i / u, col = i - r * u;
        sq[r * l.ldq + col] = qs[i];
        sk[r * l.ldq + col] = ks[i];
      }
    }
    const int pad = kUP - u;  // zeros in the padded units
    for (int i = tid; i < rows * pad; i += blockDim.x) {
      const int at = (i / pad) * l.ldq + u + i % pad;
      sq[at] = sk[at] = zero;
    }
  } else {
    // Wt and Wx transposed: row uu holds channels 0 .. cp, zeros past C and U
    for (int i = tid; i < kUP * l.cp; i += blockDim.x) {
      const int uu = i / l.cp, cc = i - uu * l.cp;
      const bool in = uu < u && cc < c;
      swt[uu * l.ldw + cc] = in ? qw[cc * u + uu] : zero;
      swx[uu * l.ldw + cc] = in ? kw[cc * u + uu] : zero;
    }
    for (int i = tid; i < kUP; i += blockDim.x) sbh[i] = i < u ? __bfloat162float(bh[i]) : 0.0f;
  }
  for (int i = tid; i < kUP; i += blockDim.x) swa[i] = i < u ? __bfloat162float(wa[i]) : 0.0f;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // x[ch][time] of one window, zero past C and T
  auto xat = [&](const bf16* xw, int ch, int time) {
    return ch < c && time < t ? xw[ch * t + time] : zero;
  };
  const int mtiles = (t + 15) / 16;

  if (kProject && !(kSkip & 8)) {
    // q = bf16(bf16(x^T Wt) + bh), k = bf16(x^T Wx). Task (window, q or k,
    // 16 rows); n-tiles of 8 units, k-steps of 16 channels
    for (int task = warp; task < gw * 2 * mtiles; task += n_warps) {
      const int gi = task % gw, rest = task / gw;
      const int which = rest & 1, m0 = (rest >> 1) * 16;
      const bf16* xw = sx + gi * c * t;
      const bf16* wtr = which ? swx : swt;
      bf16* dst = (which ? sk : sq) + gi * t * l.ldq;
      float acc[kUP / 8][4];
#pragma unroll
      for (int j = 0; j < kUP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      for (int k0 = 0; k0 < l.cp; k0 += 16) {
        unsigned a[4];  // A[time][channel]: rows m0 + gq (+8), columns k0 + 2 tq (+1) (+8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int time = m0 + gq + (r & 1) * 8, ch = k0 + 2 * tq + (r >> 1) * 8;
          a[r] = pack2(xat(xw, ch, time), xat(xw, ch + 1, time));
        }
#pragma unroll
        for (int j = 0; j < kUP / 8; ++j) {
          // B[channel][unit] from the transposed weight: unit 8j + gq, channels k0 + 2 tq (+1) (+8)
          const bf16* wr = wtr + (8 * j + gq) * l.ldw + k0 + 2 * tq;
          mma_bf16(acc[j], a, *reinterpret_cast<const unsigned*>(wr),
                   *reinterpret_cast<const unsigned*>(wr + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < kUP / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int time = m0 + gq + half * 8, n = 8 * j + 2 * tq;
          if (time < t) {
            float v0 = __bfloat162float(__float2bfloat16_rn(acc[j][2 * half]));
            float v1 = __bfloat162float(__float2bfloat16_rn(acc[j][2 * half + 1]));
            if (which == 0) v0 += sbh[n], v1 += sbh[n + 1];
            *reinterpret_cast<__nv_bfloat162*>(dst + time * l.ldq + n) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- 1: energies. Task (rg, j): the 32 query rows of group rg against the
  // j-th stretch of s; a lane keeps its row of q (bf16 pairs) and Wa (float)
  // in registers, and the max of its stretch for the softmax.
  const int row_groups = (rows + kLanes - 1) / kLanes;
  const int stretch = (t + ss - 1) / ss;
  float wreg[kUP];
#pragma unroll
  for (int i = 0; i < kUP; i += 4) {
    const float4 wv = *reinterpret_cast<const float4*>(swa + i);
    wreg[i] = wv.x, wreg[i + 1] = wv.y, wreg[i + 2] = wv.z, wreg[i + 3] = wv.w;
  }
  for (int task = warp; task < row_groups * ss && !(kSkip & 1); task += n_warps) {
    const int rg = task % row_groups, j = task / row_groups;
    const int r = rg * kLanes + lane;
    const int rr = min(r, rows - 1);  // lanes past the last row repeat it and store nothing
    unsigned q2[kUP / 2];
#pragma unroll
    for (int i = 0; i < kUP / 8; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(sq + rr * l.ldq + 8 * i);
      q2[4 * i] = v.x, q2[4 * i + 1] = v.y, q2[4 * i + 2] = v.z, q2[4 * i + 3] = v.w;
    }
    const bf16* kbase = sk + (rr / t) * t * l.ldq;
    const int s_lo = j * stretch, s_hi = min(t, s_lo + stretch);
    float m = -INFINITY;
    for (int s = s_lo; s < s_hi; ++s) {
      float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
      for (int i = 0; i < kUP / 8; ++i) {
        const uint4 kv = *reinterpret_cast<const uint4*>(kbase + s * l.ldq + 8 * i);
        const unsigned k4[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const unsigned hh = tanh_pair(add_bf16x2(q2[4 * i + p], k4[p]));
          e0 = fmaf(wreg[8 * i + 2 * p], lo_f(hh), e0);
          e1 = fmaf(wreg[8 * i + 2 * p + 1], hi_f(hh), e1);
        }
      }
      const float e = e0 + e1;
      m = fmaxf(m, e);
      if (r < rows) se[r * l.es + s] = e;
    }
    if (r < rows) pm[j * l.ps + r] = m;
  }
  __syncthreads();

  // ---- 2: p = exp(e - row max), same tasks, written split as bf16 hi + lo
  // into the window's (T, ceil16(T)) tiles; each stretch leaves its share of
  // the denominator. Columns T .. ceil16(T) are zero (they meet x's zeros).
  for (int task = warp; task < row_groups * ss && !(kSkip & 2); task += n_warps) {
    const int rg = task % row_groups, j = task / row_groups;
    const int r = rg * kLanes + lane;
    if (r < rows) {
      float m = pm[r];
      for (int jj = 1; jj < ss; ++jj) m = fmaxf(m, pm[jj * l.ps + r]);
      const int gi = r / t;
      const int at = (gi * l.tp + r - gi * t) * l.ldp;
      const float* er = se + r * l.es;
      float sum = 0.0f;
      for (int s = j * stretch; s < min(t, (j + 1) * stretch); ++s) {
        const float v = expf(er[s] - m);
        sum += v;
        const bf16 hi = __float2bfloat16_rn(v);
        sph[at + s] = hi;
        spl[at + s] = __float2bfloat16_rn(v - __bfloat162float(hi));
      }
      if (j == ss - 1)
        for (int s = t; s < l.tp; ++s) sph[at + s] = spl[at + s] = zero;
      pd[j * l.ps + r] = sum;
    }
  }
  __syncthreads();

  // ---- 3: values, out^T = p x^T. Task (window, 16 rows of t, 8 channels);
  // k-steps of 16 keys, p's hi and lo terms into one accumulator.
  bf16* ob = out + static_cast<size_t>(w0) * c * t;
  const int ntiles = l.cp / 8;
  for (int task = warp; task < gw * mtiles * ntiles && !(kSkip & 4); task += n_warps) {
    const int gi = task % gw, rest = task / gw;
    const int m0 = (rest % mtiles) * 16, n0 = (rest / mtiles) * 8;
    const bf16* xw = sx + gi * c * t;
    const int frag = (gi * l.tp + m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * l.ldp + (lane >> 4) * 8;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < l.tp; k0 += 16) {
      unsigned ah[4], al[4];
      ldsm_x4(ah, sph + frag + k0);
      ldsm_x4(al, spl + frag + k0);
      // B[key][channel] = x[channel][key]: channel n0 + gq, keys k0 + 2 tq (+1) (+8)
      const int ch = n0 + gq, s0 = k0 + 2 * tq;
      const unsigned b0 = pack2(xat(xw, ch, s0), xat(xw, ch, s0 + 1));
      const unsigned b1 = pack2(xat(xw, ch, s0 + 8), xat(xw, ch, s0 + 9));
      mma_bf16(acc, ah, b0, b1);
      mma_bf16(acc, al, b0, b1);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int time = m0 + gq + half * 8, ch = n0 + 2 * tq;
      if (time < t) {
        float den = eps;  // the row's sum + eps
        for (int jj = 0; jj < ss; ++jj) den += pd[jj * l.ps + gi * t + time];
        bf16* o = ob + (static_cast<size_t>(gi) * c + ch) * t + time;
        if (ch < c) o[0] = __float2bfloat16_rn(acc[2 * half] / den);
        if (ch + 1 < c) o[t] = __float2bfloat16_rn(acc[2 * half + 1] / den);
      }
    }
  }
}

template <int kUP, bool kProject>
int launch_bf16_instance(const bf16* x, const bf16* qw, const bf16* kw, const bf16* bh,
                         const bf16* wa, bf16* out, int b, int c, int t, int u, int g, int ss,
                         int threads, float eps, cudaStream_t stream) {
  const int smem = layout_bf16(c, t, u, g, kProject).total;
  auto kernel = addattn_kernel_bf16<kUP, kProject>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(b + g - 1) / g, threads, smem, stream>>>(x, qw, kw, bh, wa, out, b, c, t, u, g, ss, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kProject>
int launch_bf16(const bf16* x, const bf16* qw, const bf16* kw, const bf16* bh, const bf16* wa,
                bf16* out, int b, int c, int t, int u, int g, float eps, void* stream) {
  if (b < 1 || c < 1 || t < 1 || u < 1 || u > 32 || g < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_groups = (g * t + kLanes - 1) / kLanes;
  const int ss = stretches(t, g);
  const int warps = row_groups * ss < kMaxWarps ? row_groups * ss : kMaxWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u <= 16)
    return launch_bf16_instance<16, kProject>(x, qw, kw, bh, wa, out, b, c, t, u, g, ss,
                                              warps * kLanes, eps, s);
  return launch_bf16_instance<32, kProject>(x, qw, kw, bh, wa, out, b, c, t, u, g, ss,
                                            warps * kLanes, eps, s);
}

}  // namespace

// Shared memory in bytes of one CTA that holds g windows, for either entry;
// the wrapper (ops/cuda/addattn.py) sizes g with it and refuses a window that
// exceeds the card's 227 KB.
extern "C" int addattn_smem_bytes(int c, int t, int u, int g, int project) {
  const int ku = u <= 8 ? 8 : (u <= 16 ? 16 : 32);
  return layout(c, t, u, g, ku, project != 0).total * static_cast<int>(sizeof(float));
}

// x (B, C, T), q and k (B, T, U), wa (U,), out (B, C, T): float32, contiguous
// on the device; g windows a CTA. Returns the launch's cudaGetLastError().
extern "C" int addattn_f32(const float* x, const float* q, const float* k, const float* wa,
                           float* out, int b, int c, int t, int u, int g, float eps,
                           void* stream) {
  return launch<false>(x, q, k, static_cast<const float*>(nullptr), wa, out, b, c, t, u, g, eps,
                       stream);
}

// As addattn_f32 with q = x^T Wt + bh and k = x^T Wx computed in shared
// memory: wt and wx (C, U), bh and wa (U,).
extern "C" int addattn_x_f32(const float* x, const float* wt, const float* bh, const float* wx,
                             const float* wa, float* out, int b, int c, int t, int u, int g,
                             float eps, void* stream) {
  return launch<true>(x, wt, wx, bh, wa, out, b, c, t, u, g, eps, stream);
}

// Shared memory in bytes of one CTA of the bf16 body that holds g windows
// (U <= 32), for either entry.
extern "C" int addattn_bf16_smem_bytes(int c, int t, int u, int g, int project) {
  return layout_bf16(c, t, u, g, project != 0).total;
}

// x (B, C, T), q and k (B, T, U), wa (U,), out (B, C, T): bf16, contiguous on
// the device; U <= 32; g windows a CTA. The bf16 body.
extern "C" int addattn_bf16(const __nv_bfloat16* x, const __nv_bfloat16* q,
                            const __nv_bfloat16* k, const __nv_bfloat16* wa, __nv_bfloat16* out,
                            int b, int c, int t, int u, int g, float eps, void* stream) {
  return launch_bf16<false>(x, q, k, static_cast<const __nv_bfloat16*>(nullptr), wa, out, b, c,
                            t, u, g, eps, stream);
}

// As addattn_bf16 with q and k projected inside: wt and wx (C, U), bh and wa
// (U,). The bf16 body.
extern "C" int addattn_x_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wt,
                              const __nv_bfloat16* bh, const __nv_bfloat16* wx,
                              const __nv_bfloat16* wa, __nv_bfloat16* out, int b, int c, int t,
                              int u, int g, float eps, void* stream) {
  return launch_bf16<true>(x, wt, wx, bh, wa, out, b, c, t, u, g, eps, stream);
}
