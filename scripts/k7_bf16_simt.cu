// The earlier design of K7's bf16 entries, kept only as a yardstick: the
// float32 SIMT kernel of volpick_tpu_torch/csrc/mha.cu instantiated on bf16
// (q, k, v widened to float32 on plain loads, float32 FMAs in both products,
// the scores through shared memory, q scaled in float32). The tensor-core body
// in csrc/mha.cu replaced it; nothing in the package builds or calls this
// file. chip_smoke.py (phase 3) builds it into a library of its own and times
// its profiler row beside the present kernel's in the same process.
//
// Entries: mha_qkv_bf16_simt and mha_bf16_simt, with the arguments of
// mha_qkv_bf16 and mha_bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8;     // score rows a thread owns in QK^T
constexpr int kCols = 4;     // score columns a thread owns in QK^T
constexpr int kPvRows = 4;   // output rows a thread owns in PV
constexpr int kPerLane = 4;  // scores of a row a lane holds in the softmax: T <= 128
constexpr int kSmRows = 4;   // rows a warp takes through the softmax together
constexpr int kMaxThreads = 512;

// Phases compiled out, for timing only (-DMHA_SKIP=<bits>; the results are
// then wrong): 1 QK^T, 2 softmax, 4 PV.
#ifndef MHA_SKIP
#define MHA_SKIP 0
#endif
constexpr int kSkip = MHA_SKIP;

// element strides of a (window, head, token, channel) view
struct Strides {
  long long b;
  int h, t, c;
};

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

// Four consecutive bf16 (8 bytes) widened to float4, and back.
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* src) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void narrow4(__nv_bfloat16* dst, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// A probability as the PV product reads it: as computed, or rounded to bf16.
template <typename T>
__device__ __forceinline__ float prob(float p) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16(p));
  } else {
    return p;
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void stage(float* dst, const T* src, int st, int sc, int t, int dh,
                                      int dp) {
  for_each_piece<kVec>(t, dh, [&](int tok, int d) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      // bf16: plain loads, widened into the float tile
      if (kVec) {
        *reinterpret_cast<float4*>(dst + tok * dp + d) =
            widen4(src + static_cast<long long>(tok) * st + d);
      } else {
        dst[tok * dp + d] =
            to_float(src[static_cast<long long>(tok) * st + static_cast<long long>(d) * sc]);
      }
    } else if (kVec) {
      cp_async16(dst + tok * dp + d, src + static_cast<long long>(tok) * st + d);
    } else {
      cp_async4(dst + tok * dp + d, src + static_cast<long long>(tok) * st + static_cast<long long>(d) * sc);
    }
  });
}

// grid B*H; blockDim = ceil(T/8) * ceil(T/4) rounded up to whole warps;
// dynamic shared memory (3 * TP * DP + TP * PP) floats with TP = 8 ceil(T/8),
// DP = padded_dh(Dh), PP = 4 ceil(T/4) + 4. Dh <= 32, T <= 128.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, Strides in, Strides os, int n_heads, int dh, int t,
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
  stage<T, kVec>(qs, q + base, in.t, in.c, t, dh, dp);
  stage<T, kVec>(ks, k + base, in.t, in.c, t, dh, dp);
  cp_async_commit();
  stage<T, kVec>(vs, v + base, in.t, in.c, t, dh, dp);
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
            pr[j] = prob<T>(s[r][i] / sum[r]);
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
  T* obase = out + wb * os.b + static_cast<long long>(wh) * os.h;
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
        // token-major output: 16 bytes (8 in bf16) a thread straight to
        // device memory; otherwise through the q tile, which nothing reads any more
        if (kVec) {
          T* dst = obase + static_cast<long long>(i) * os.t + dg * 4;
          if constexpr (std::is_same_v<T, __nv_bfloat16>) {
            narrow4(dst, acc[a]);
          } else {
            *reinterpret_cast<float4*>(dst) = acc[a];
          }
        } else {
          *reinterpret_cast<float4*>(qs + i * dp + dg * 4) = acc[a];
        }
      }
    }
  }
  if (!kVec) {
    __syncthreads();
    for_each_piece<false>(t, dh, [&](int tok, int d) {
      const float o = qs[tok * dp + d];
      T* dst = obase + static_cast<long long>(tok) * os.t + static_cast<long long>(d) * os.c;
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        *dst = __float2bfloat16(o);
      } else {
        *dst = o;
      }
    });
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, Strides in, Strides os,
           int b, int h, int dh, int t, float scale, bool vec, cudaStream_t stream) {
  const int n8 = (t + kRows - 1) / kRows, n4 = (t + kCols - 1) / kCols;
  const int threads = (n8 * n4 + kLanes - 1) / kLanes * kLanes;
  const int tp = n8 * kRows;
  const size_t smem = static_cast<size_t>(3 * tp * padded_dh(dh) + tp * (n4 * kCols + 4)) * sizeof(float);
  auto kernel = vec ? mha_kernel<T, true> : mha_kernel<T, false>;
  if (smem > 48 * 1024) {
    // above 48 KB a launch has to opt in; the attribute is per function and device
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<b * h, threads, smem, stream>>>(q, k, v, out, in, os, h, dh, t, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out (B, H*Dh, T) bf16, contiguous; float32 inside.
extern "C" int mha_bf16_simt(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                        __nv_bfloat16* out, int b, int h, int dh, int t, void* stream) {
  const Strides s{static_cast<long long>(h) * dh * t, dh * t, 1, t};
  return launch(q, k, v, out, s, s, b, h, dh, t, 1.0f, false, static_cast<cudaStream_t>(stream));
}

// qkv (B, T, 3, H, Dh) bf16, contiguous, q scaled in float32; out (B, T, H*Dh)
// (8-byte pieces where Dh % 4 == 0 and both are 8-byte aligned).
extern "C" int mha_qkv_bf16_simt(const __nv_bfloat16* qkv, __nv_bfloat16* out, int b, int h, int dh,
                            int t, float scale, void* stream) {
  const int d = h * dh;
  const Strides in{static_cast<long long>(t) * 3 * d, dh, 3 * d, 1};
  const Strides os{static_cast<long long>(t) * d, dh, d, 1};
  const bool vec = dh % 4 == 0 && reinterpret_cast<uintptr_t>(qkv) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return launch(qkv, qkv + d, qkv + 2 * d, out, in, os, b, h, dh, t, scale, vec,
                static_cast<cudaStream_t>(stream));
}
