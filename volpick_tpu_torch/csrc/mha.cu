// Softmax multi-head self-attention: per window b and head h,
// out_h = softmax_s(q_h^T k_h) v_h, the row max subtracted and the
// exponentials divided by their plain sum (no eps).
//
// Replaces: volpick_tpu/ops/pallas/attention.py::mha_pallas (_kernel). As
// there, one window's attention never leaves on-chip memory.
//
// The float32 body, mha_kernel. What bounds it on an H100: float32 operations
// outside the tensor cores (a single-pass TF32 or bf16 product does not hold
// the 1e-5 parity). On
// TPUPickNet's path (B = 128 windows a step, H = 4, Dh = 32, T = 94) one
// launch does 2 x 128 x 4 x 94^2 x 32 = 290 M FMAs (QK^T and PV), ~9 us at
// the card's 67 TFLOP/s, against ~7 us for its 24.6 MB of device-memory
// traffic. In practice the shared-memory load pipe sets the pace: a 16-byte
// load costs a warp 4 cycles of it unless the 8 lanes of a quarter-warp read
// one address, so the design is about FMAs per load, and the softmax between
// the two products is bound by its instruction count.
//
// Design: one kernel body, two layouts, told apart by strides.
// - mha_f32 keeps the JAX package's head-major (B, H*Dh, T) contract.
// - mha_qkv_f32 reads q, k, v in place from the model's projection
//   (B, T, 3, H, Dh), multiplies the scale into q while staging (one float32
//   multiply an element) and writes (B, T, H*Dh): no packing copy, no scale
//   pass, no transpose around the launch. A head's row of a token is Dh
//   contiguous floats there, so staging and write-back move 16 bytes a thread.
// One CTA per (window, head). q and k go to shared memory with cp.async in
// one commit group and v in a second that is waited for only before PV, so
// the v load hides behind QK^T. All three tiles are token-major (T, Dh) with
// a row stride that is a multiple of 4 floats whose quarter is odd: float4
// loads along Dh stay aligned and consecutive rows start 4 banks apart.
// QK^T: each thread owns an 8 x 4 block of scores (rows strided by ceil(T/8),
// columns by ceil(T/4), so the lanes of a warp read consecutive rows) and
// feeds 128 FMAs from 12 float4 loads. The scores go to shared memory once
// (about 80 KB a CTA with q, k, v at T = 94: above 48 KB, so the launch opts
// in to large dynamic shared memory; two CTAs an SM, also by registers). One
// warp a row, four rows at a time so that their shuffles, exponentials and
// divisions overlap, turns them into probabilities in place with IEEE expf
// and division, in the order of the plain twin. PV is a second
// register-tiled product: a thread owns up to 4 rows x 4 channels and feeds
// 64 FMAs from 8 float4 loads.
//
// bf16 (the picker's bfloat16 mode) has a body of its own, mha_kernel_bf16,
// designed for Hopper's tensor cores; see the note above it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8;     // score rows a thread owns in QK^T
constexpr int kCols = 4;     // score columns a thread owns in QK^T
constexpr int kPvRows = 4;   // output rows a thread owns in PV
constexpr int kPerLane = 4;  // scores of a row a lane holds in the softmax: T <= 128
constexpr int kSmRows = 4;   // rows a warp takes through the softmax together
constexpr int kMaxThreads = 512;

// Phases compiled out, for timing only (scripts/k7_phases.py builds the file
// with -DMHA_SKIP=<bits>; the results are then wrong): 1 QK^T, 2 softmax, 4 PV.
// The float32 body only.
#ifndef MHA_SKIP
#define MHA_SKIP 0
#endif
constexpr int kSkip = MHA_SKIP;

// element strides of a (window, head, token, channel) view
struct Strides {
  long long b;
  int h, t, c;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// Row stride of the (T, Dh) shared tiles: Dh rounded up to a multiple of 4,
// plus 4 where that leaves an even number of float4s (see the note above).
__host__ __device__ inline int padded_dh(int dh) {
  const int d4 = (dh + 3) / 4 * 4;
  return ((d4 / 4) & 1) ? d4 : d4 + 4;
}

// Calls f(token, channel) once for each piece of a (T, Dh) tile that this
// thread moves: float4 pieces along Dh where kVec (channel stride 1,
// Dh % 4 == 0), else single floats, 8 tokens x 4 channels a warp, so that both
// a token-contiguous and a channel-contiguous side see whole 32-byte sectors
// and the shared side sees 32 banks.
template <bool kVec, class F>
__device__ __forceinline__ void for_each_piece(int t, int dh, F f) {
  if (kVec) {
    const int nch = dh / 4;
    for (int e = threadIdx.x; e < t * nch; e += blockDim.x) {
      const int row = e / nch;
      f(row, (e - row * nch) * 4);
    }
  } else {
    const int nd4 = (dh + 3) / 4;
    const int n = nd4 * ((t + 7) / 8) * kLanes;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int blk = e / kLanes, l = e % kLanes;
      const int d = (blk % nd4) * 4 + l / 8;
      const int tok = (blk / nd4) * 8 + l % 8;
      if (d < dh && tok < t) f(tok, d);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void stage(float* dst, const float* src, int st, int sc, int t, int dh,
                                      int dp) {
  for_each_piece<kVec>(t, dh, [&](int tok, int d) {
    if (kVec) {
      cp_async16(dst + tok * dp + d, src + static_cast<long long>(tok) * st + d);
    } else {
      cp_async4(dst + tok * dp + d, src + static_cast<long long>(tok) * st + static_cast<long long>(d) * sc);
    }
  });
}

// grid B*H; blockDim = ceil(T/8) * ceil(T/4) rounded up to whole warps;
// dynamic shared memory (3 * TP * DP + TP * PP) floats with TP = 8 ceil(T/8),
// DP = padded_dh(Dh), PP = 4 ceil(T/4) + 4. Dh <= 32, T <= 128.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ out, Strides in, Strides os, int n_heads, int dh, int t,
           float scale) {
  extern __shared__ float4 smem4[];
  const int n8 = (t + kRows - 1) / kRows, n4 = (t + kCols - 1) / kCols;
  const int tp = n8 * kRows, tp4 = n4 * kCols;
  const int dp = padded_dh(dh), dh4 = (dh + 3) / 4 * 4, pp = tp4 + 4;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + tp * dp;
  float* vs = ks + tp * dp;
  float* ps = vs + tp * dp;
  const int tid = threadIdx.x;

  const int wb = blockIdx.x / n_heads, wh = blockIdx.x % n_heads;
  const long long base = wb * in.b + static_cast<long long>(wh) * in.h;
  stage<kVec>(qs, q + base, in.t, in.c, t, dh, dp);
  stage<kVec>(ks, k + base, in.t, in.c, t, dh, dp);
  cp_async_commit();
  stage<kVec>(vs, v + base, in.t, in.c, t, dh, dp);
  cp_async_commit();

  // zeros where the products read past T or Dh
  for (int e = t * dp + tid; e < tp * dp; e += blockDim.x) qs[e] = ks[e] = vs[e] = 0.0f;
  const int padc = dp - dh;
  for (int e = tid; e < t * padc; e += blockDim.x) {
    const int i = (e / padc) * dp + dh + e % padc;
    qs[i] = ks[i] = vs[i] = 0.0f;
  }

  cp_async_wait<1>();  // this thread's pieces of q and k have landed
  if (scale != 1.0f) {
    for_each_piece<kVec>(t, dh, [&](int tok, int d) {
      if (kVec) {
        float4* p = reinterpret_cast<float4*>(qs + tok * dp + d);
        float4 x = *p;
        x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
        *p = x;
      } else {
        qs[tok * dp + d] *= scale;
      }
    });
  }
  __syncthreads();

  // ---- scores: rows ti + n8 * a, columns tj + n4 * c
  if (!(kSkip & 1) && tid < n8 * n4) {
    const int ti = tid / n4, tj = tid % n4;
    float acc[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;
    for (int d = 0; d < dh4; d += 4) {
      float4 kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + (tj + n4 * c) * dp + d);
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (ti + n8 * a) * dp + d);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float s = acc[a][c];
          s = fmaf(qv.x, kv[c].x, s);
          s = fmaf(qv.y, kv[c].y, s);
          s = fmaf(qv.z, kv[c].z, s);
          s = fmaf(qv.w, kv[c].w, s);
          acc[a][c] = s;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = ti + n8 * a;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = tj + n4 * c;
        if (i < t && j < t) ps[i * pp + j] = acc[a][c];
      }
    }
  }
  __syncthreads();

  // ---- softmax in place, one warp a row and kSmRows rows at a time, so that
  // the shuffles, exponentials and divisions of independent rows overlap;
  // zeros in columns T .. tp4 - 1
  const int warp = tid / kLanes, lane = tid % kLanes;
  for (int r0 = warp * kSmRows; r0 < t && !(kSkip & 2); r0 += (blockDim.x / kLanes) * kSmRows) {
    float s[kSmRows][kPerLane], m[kSmRows], sum[kSmRows];
#pragma unroll
    for (int r = 0; r < kSmRows; ++r) {
      const float* pr = ps + min(r0 + r, t - 1) * pp;
      m[r] = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = i * kLanes + lane;
        s[r][i] = j < t ? pr[j] : -INFINITY;
        m[r] = fmaxf(m[r], s[r][i]);
      }
    }
    for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kSmRows; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], off));
#pragma unroll
    for (int r = 0; r < kSmRows; ++r) {
      sum[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (i * kLanes < t) {  // the same on every lane
          s[r][i] = (i * kLanes + lane < t) ? expf(s[r][i] - m[r]) : 0.0f;
          sum[r] += s[r][i];
        }
      }
    }
    for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < kSmRows; ++r) sum[r] += __shfl_xor_sync(kFull, sum[r], off);
#pragma unroll
    for (int r = 0; r < kSmRows; ++r) {
      if (r0 + r < t) {
        float* pr = ps + (r0 + r) * pp;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int j = i * kLanes + lane;
          if (j < t) {
            pr[j] = s[r][i] / sum[r];
          } else if (j < tp4) {
            pr[j] = 0.0f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // v
  __syncthreads();

  // ---- PV: thread (row group rg, channel group dg) owns rows rg + nrg * a
  // and channels 4 dg .. 4 dg + 3
  const int ndg = dh4 / 4;
  const int nrg = blockDim.x / ndg;
  const int dg = tid % ndg, rg = tid / ndg;
  float* obase = out + wb * os.b + static_cast<long long>(wh) * os.h;
  for (int r0 = rg; r0 < t && rg < nrg && !(kSkip & 4); r0 += kPvRows * nrg) {
    float4 acc[kPvRows];
#pragma unroll
    for (int a = 0; a < kPvRows; ++a) acc[a] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < tp4; j += 4) {
      float4 vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vv[e] = *reinterpret_cast<const float4*>(vs + (j + e) * dp + dg * 4);
#pragma unroll
      for (int a = 0; a < kPvRows; ++a) {
        const int i = r0 + a * nrg;
        if (i < t) {
          const float4 p = *reinterpret_cast<const float4*>(ps + i * pp + j);
          const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[a].x = fmaf(pe[e], vv[e].x, acc[a].x);
            acc[a].y = fmaf(pe[e], vv[e].y, acc[a].y);
            acc[a].z = fmaf(pe[e], vv[e].z, acc[a].z);
            acc[a].w = fmaf(pe[e], vv[e].w, acc[a].w);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kPvRows; ++a) {
      const int i = r0 + a * nrg;
      if (i < t) {
        // token-major output: 16 bytes a thread straight to device memory;
        // otherwise through the q tile, which nothing reads any more
        if (kVec) {
          *reinterpret_cast<float4*>(obase + static_cast<long long>(i) * os.t + dg * 4) = acc[a];
        } else {
          *reinterpret_cast<float4*>(qs + i * dp + dg * 4) = acc[a];
        }
      }
    }
  }
  if (!kVec) {
    __syncthreads();
    for_each_piece<false>(t, dh, [&](int tok, int d) {
      obase[static_cast<long long>(tok) * os.t + static_cast<long long>(d) * os.c] = qs[tok * dp + d];
    });
  }
}

int launch(const float* q, const float* k, const float* v, float* out, Strides in, Strides os,
           int b, int h, int dh, int t, float scale, bool vec, cudaStream_t stream) {
  const int n8 = (t + kRows - 1) / kRows, n4 = (t + kCols - 1) / kCols;
  const int threads = (n8 * n4 + kLanes - 1) / kLanes * kLanes;
  const int tp = n8 * kRows;
  const size_t smem = static_cast<size_t>(3 * tp * padded_dh(dh) + tp * (n4 * kCols + 4)) * sizeof(float);
  auto kernel = vec ? mha_kernel<true> : mha_kernel<false>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch has to opt in; the attribute is per function and device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<b * h, threads, smem, stream>>>(q, k, v, out, in, os, h, dh, t, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: mha_kernel_bf16, on the tensor cores
//
// The Pallas kernel's arithmetic: bf16 q and k multiplied with float32 sums,
// the row max subtracted, expf, division by the plain sum, the probabilities
// cast to bf16, bf16 p v summed in float32 and the output rounded to bf16.
// mha_qkv_bf16 hands it q as the JAX model hands it to that kernel:
// bf16(q * bf16(scale)) (ops/cuda/attention.py says why).
//
// What bounds it on an H100: bytes. At TPUPickNet's step (B 128, H 4, Dh 32,
// T 94) a launch reads 9.24 MB of projection and writes 3.08 MB, 3.7 us at
// 3.35 TB/s; its 579 MFLOP of products take 0.6 us on the tensor cores and
// its 4.5 M exponentials about 1.1 us on the special-function units.
//
// Design: one CTA per (window, head), ceil(T/16) warps, a warp 16 query rows
// (kTiles = ceil(T/16) is a template parameter that sizes every register
// array: 6 at T = 94).
// - Staging: q, k and v stay bf16 in shared memory as token-major (., 32)
//   tiles whose row stride is 40 elements (80 bytes: the 8 rows an ldmatrix
//   reads fall on 8 distinct 16-byte bank groups). From the projection,
//   16-byte cp.async pieces, 4 a row at Dh 32; q and k in one commit group,
//   v in a second that is waited for only before PV. Each thread then scales
//   and rounds the q pieces it copied. Rows past T up to the next multiple of
//   16 and channels past Dh up to 32 are zero. Where Dh % 8 != 0 or a pointer
//   is not 16-byte aligned, and for the head-major entry, plain 2-byte loads
//   (the head-major entry transposes on the way in, tokens along the lanes).
// - QK^T: mma.sync m16n8k16, bf16 operands, float32 accumulators; A (q) and
//   B (k, not transposed) fragments by ldmatrix.x4. The scores stay in
//   registers: 2 kTiles n-tiles x 4 floats a lane.
// - Softmax in registers: keys >= T masked to -inf; the quad of lanes that
//   shares a row reduces its max and its sum with two shuffles each; expf and
//   IEEE division as in the twin. p is rounded to bf16 and packed straight
//   into the A fragments of PV: the accumulator layout of two adjacent m16n8
//   tiles is the m16n8k16 A layout. No score goes to shared memory.
// - PV: v is the B operand, by ldmatrix.x4.trans, float32 accumulators; the
//   output is rounded to bf16 into the warp's own q rows (only this warp reads
//   them) and written out by the warp: 16 bytes a lane token-major, or
//   transposed to (B, H*Dh, T) with the tokens along the lanes.
// Why mma.sync and not wgmma: wgmma takes 64-row tiles (T = 94 would pad to
// 128) and whole warpgroups, and at this size the bytes outweigh the
// products at either instruction's rate.

using bf16 = __nv_bfloat16;
constexpr int kDk = 32;       // channels of a head in the products: Dh zero-padded
constexpr int kLd = kDk + 8;  // row stride of the bf16 tiles, in elements

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// grid B*H, blockDim kTiles * 32, static shared memory 3 * 16 kTiles * kLd
// bf16 (at most 30,720 bytes). Dh <= 32, T <= 16 kTiles.
template <int kTiles, bool kVec>
__global__ void __launch_bounds__(kTiles * kLanes)
mha_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                bf16* __restrict__ out, Strides in, Strides os, int n_heads, int dh, int t,
                float scale) {
  constexpr int kRowsP = kTiles * 16;
  constexpr int kThreads = kTiles * kLanes;
  __shared__ __align__(16) bf16 tiles[3 * kRowsP * kLd];
  bf16* qs = tiles;
  bf16* ks = qs + kRowsP * kLd;
  bf16* vs = ks + kRowsP * kLd;
  const int tid = threadIdx.x;
  const int wb = blockIdx.x / n_heads, wh = blockIdx.x % n_heads;
  const long long base = wb * in.b + static_cast<long long>(wh) * in.h;
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale));

  if (kVec) {
    const int n8 = dh / 8;
    for (int e = tid; e < t * n8; e += kThreads) {
      const int row = e / n8, c = (e - row * n8) * 8;
      const long long g = base + static_cast<long long>(row) * in.t + c;
      cp_async16(qs + row * kLd + c, q + g);
      cp_async16(ks + row * kLd + c, k + g);
    }
    cp_async_commit();
    for (int e = tid; e < t * n8; e += kThreads) {
      const int row = e / n8, c = (e - row * n8) * 8;
      cp_async16(vs + row * kLd + c, v + base + static_cast<long long>(row) * in.t + c);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < t * dh; e += kThreads) {
      int row, c;
      if (in.t == 1) {  // channel-major: tokens along the threads
        c = e / t;
        row = e - c * t;
      } else {
        row = e / dh;
        c = e - row * dh;
      }
      const long long g = base + static_cast<long long>(row) * in.t + static_cast<long long>(c) * in.c;
      qs[row * kLd + c] = __float2bfloat16_rn(__bfloat162float(q[g]) * qscale);
      ks[row * kLd + c] = k[g];
      vs[row * kLd + c] = v[g];
    }
  }

  // zeros where the products read past T or Dh
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int e = t * kDk + tid; e < kRowsP * kDk; e += kThreads) {
    const int i = (e / kDk) * kLd + e % kDk;
    qs[i] = ks[i] = vs[i] = zero;
  }
  const int padc = kDk - dh;
  for (int e = tid; e < t * padc; e += kThreads) {
    const int i = (e / padc) * kLd + dh + e % padc;
    qs[i] = ks[i] = vs[i] = zero;
  }

  cp_async_wait<1>();  // this thread's pieces of q and k have landed
  if (kVec && qscale != 1.0f) {
    const int n8 = dh / 8;
    for (int e = tid; e < t * n8; e += kThreads) {
      const int row = e / n8, c = (e - row * n8) * 8;
      uint4* p = reinterpret_cast<uint4*>(qs + row * kLd + c);
      uint4 x = *p;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        h2[i] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
      *p = x;
    }
  }
  __syncthreads();

  // ---- scores of this warp's 16 rows: n-tile n holds keys 8n .. 8n + 7; a
  // lane holds rows g, g + 8 and columns 2 tq, 2 tq + 1 of each
  const int warp = tid / kLanes, lane = tid % kLanes;
  const int tq = lane & 3, g = lane >> 2;
  const int r0 = warp * 16;
  const int ksteps = dh > 16 ? 2 : 1;  // 16 channels a step
  unsigned qa[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
    if (s < ksteps)
      ldsm_x4(qa[s], qs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + s * 16 + (lane >> 4) * 8);
  float sc[2 * kTiles][4];
#pragma unroll
  for (int n = 0; n < 2 * kTiles; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
  for (int p = 0; p < kTiles; ++p) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s < ksteps) {
        unsigned kb[4];  // keys 16p .. 16p + 15, channels 16s .. 16s + 15
        ldsm_x4(kb, ks + (p * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + s * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * p], qa[s], kb[0], kb[1]);
        mma_bf16(sc[2 * p + 1], qa[s], kb[2], kb[3]);
      }
    }
  }

  // ---- softmax of rows g (m[0], sum[0]) and g + 8 (m[1], sum[1])
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * kTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (n * 8 + 2 * tq + e >= t) sc[n][e] = sc[n][2 + e] = -INFINITY;
      m[0] = fmaxf(m[0], sc[n][e]);
      m[1] = fmaxf(m[1], sc[n][2 + e]);
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
  }
#pragma unroll
  for (int n = 0; n < 2 * kTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = expf(sc[n][e] - m[e >> 1]);  // a masked key: expf(-inf) = 0
      sum[e >> 1] += sc[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
  }
  // p as the A fragments of PV: keys 16p .. 16p + 15 are n-tiles 2p and 2p + 1
  unsigned pa[kTiles][4];
#pragma unroll
  for (int p = 0; p < kTiles; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * p + h;
      pa[p][2 * h] = pack_bf16(sc[n][0] / sum[0], sc[n][1] / sum[0]);
      pa[p][2 * h + 1] = pack_bf16(sc[n][2] / sum[1], sc[n][3] / sum[1]);
    }
  }

  // ---- PV: n-tile n holds channels 8n .. 8n + 7
  cp_async_wait<0>();  // v
  __syncthreads();
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
  for (int p = 0; p < kTiles; ++p) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c < ksteps) {
        unsigned vb[4];  // keys 16p .. 16p + 15, channels 16c .. 16c + 15
        ldsm_x4_trans(vb, vs + (p * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + c * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * c], pa[p], vb[0], vb[1]);
        mma_bf16(o[2 * c + 1], pa[p], vb[2], vb[3]);
      }
    }
  }

  // ---- the output, rounded to bf16, through this warp's q rows
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<unsigned*>(qs + (r0 + g) * kLd + n * 8 + 2 * tq) = pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<unsigned*>(qs + (r0 + g + 8) * kLd + n * 8 + 2 * tq) = pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  bf16* ob = out + wb * os.b + static_cast<long long>(wh) * os.h;
  const int rows = min(16, t - r0);
  if (kVec) {
    const int n8 = dh / 8;
    for (int e = lane; e < rows * n8; e += kLanes) {
      const int r = e / n8, c = (e - r * n8) * 8;
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r0 + r) * os.t + c) =
          *reinterpret_cast<const uint4*>(qs + (r0 + r) * kLd + c);
    }
  } else {
    for (int e = lane; e < rows * dh; e += kLanes) {
      int r, c;
      if (os.t == 1) {  // channel-major: tokens along the lanes
        c = e / rows;
        r = e - c * rows;
      } else {
        r = e / dh;
        c = e - r * dh;
      }
      ob[static_cast<long long>(r0 + r) * os.t + static_cast<long long>(c) * os.c] = qs[(r0 + r) * kLd + c];
    }
  }
}

template <int kTiles>
int launch_bf16_tiles(const bf16* q, const bf16* k, const bf16* v, bf16* out, Strides in,
                      Strides os, int b, int h, int dh, int t, float scale, bool vec,
                      cudaStream_t stream) {
  auto kernel = vec ? mha_kernel_bf16<kTiles, true> : mha_kernel_bf16<kTiles, false>;
  kernel<<<b * h, kTiles * kLanes, 0, stream>>>(q, k, v, out, in, os, h, dh, t, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, Strides in, Strides os,
                int b, int h, int dh, int t, float scale, bool vec, cudaStream_t stream) {
  switch ((t + 15) / 16) {
    case 1: return launch_bf16_tiles<1>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    case 2: return launch_bf16_tiles<2>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    case 3: return launch_bf16_tiles<3>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    case 4: return launch_bf16_tiles<4>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    case 5: return launch_bf16_tiles<5>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    case 6: return launch_bf16_tiles<6>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    case 7: return launch_bf16_tiles<7>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    case 8: return launch_bf16_tiles<8>(q, k, v, out, in, os, b, h, dh, t, scale, vec, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out (B, H*Dh, T) float32, contiguous on the device, any scale
// already in q; Dh <= 32, T <= 128 (checked by the caller,
// ops/cuda/attention.py). Returns the launch's cudaGetLastError().
extern "C" int mha_f32(const float* q, const float* k, const float* v, float* out, int b, int h,
                       int dh, int t, void* stream) {
  const Strides s{static_cast<long long>(h) * dh * t, dh * t, 1, t};
  return launch(q, k, v, out, s, s, b, h, dh, t, 1.0f, false, static_cast<cudaStream_t>(stream));
}

// qkv (B, T, 3, H, Dh) float32, contiguous: q, k, v read in place, q
// multiplied by `scale` on its way to shared memory; out (B, T, H*Dh).
extern "C" int mha_qkv_f32(const float* qkv, float* out, int b, int h, int dh, int t, float scale,
                           void* stream) {
  const int d = h * dh;
  const Strides in{static_cast<long long>(t) * 3 * d, dh, 3 * d, 1};
  const Strides os{static_cast<long long>(t) * d, dh, d, 1};
  const bool vec = dh % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return launch(qkv, qkv + d, qkv + 2 * d, out, in, os, b, h, dh, t, scale, vec,
                static_cast<cudaStream_t>(stream));
}


// q, k, v, out (B, H*Dh, T) bf16, contiguous, any scale already in q; Dh <= 32,
// T <= 128. The tensor-core body.
extern "C" int mha_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        __nv_bfloat16* out, int b, int h, int dh, int t, void* stream) {
  const Strides s{static_cast<long long>(h) * dh * t, dh * t, 1, t};
  return launch_bf16(q, k, v, out, s, s, b, h, dh, t, 1.0f, false, static_cast<cudaStream_t>(stream));
}

// qkv (B, T, 3, H, Dh) bf16, contiguous: q, k, v read in place (16-byte pieces
// where Dh % 8 == 0 and both pointers are 16-byte aligned), q scaled as
// bf16(q * bf16(scale)); out (B, T, H*Dh). The tensor-core body.
extern "C" int mha_qkv_bf16(const __nv_bfloat16* qkv, __nv_bfloat16* out, int b, int h, int dh,
                            int t, float scale, void* stream) {
  const int d = h * dh;
  const Strides in{static_cast<long long>(t) * 3 * d, dh, 3 * d, 1};
  const Strides os{static_cast<long long>(t) * d, dh, d, 1};
  const bool vec = dh % 8 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return launch_bf16(qkv, qkv + d, qkv + 2 * d, out, in, os, b, h, dh, t, scale, vec,
                     static_cast<cudaStream_t>(stream));
}
