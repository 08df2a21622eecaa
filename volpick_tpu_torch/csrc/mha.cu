// Softmax multi-head self-attention over head-major packed (B, H*Dh, T)
// float32 tensors: per window b and head h, out_h = softmax_s(q_h^T k_h) v_h,
// the scale already folded into q, the row max subtracted and the
// exponentials divided by their plain sum.
//
// Replaces: volpick_tpu/ops/pallas/attention.py::mha_pallas (_kernel). As
// there, one window's attention never leaves on-chip memory: the scores and
// probabilities of a query row live in registers, q/k/v of the head in
// shared memory.
//
// What bounds it on an H100: latency and launch, not bytes or FLOPs. On
// TPUPickNet's path (B = 128 windows a step, H = 4, Dh = 32, T = 94) one
// launch reads 3 x 6.2 MB and writes 6.2 MB (~7 us of HBM traffic), and
// does 2 x 128 x 4 x 94^2 x 32 = 290 M float32 FMAs (QK^T and PV), ~9 us at
// the card's 67 TFLOP/s outside the tensor cores.
//
// Design: one CTA per (window, head), 512 CTAs a step, 8 warps each. The
// head's q, k and v slices are contiguous Dh x T blocks of the packed layout;
// they are staged into dynamic shared memory (3 x 32 x 95 x 4 B = 36.5 KB at
// the path's shapes, under the 48 KB a launch may use without opting in)
// with an odd row stride, so a warp reading one column (32 rows) of a tile
// hits 32 banks. One warp owns a query row at a time: lane l holds the
// scores of keys l, l + 32, l + 64, l + 96 in registers, warp shuffles give
// the row max and sum, and then lane d accumulates output channel d,
// taking each probability from the lane that holds it by shuffle. The
// finished row is written over the q column it came from (no other warp
// reads that column), and the block copies the tile out coalesced.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kLanes = 32;
constexpr int kPerLane = 4;  // scores per lane: T <= 128
constexpr unsigned kFull = 0xffffffffu;

// q, k, v, out (B, H*Dh, T) contiguous; grid B*H; blockDim kWarps*32;
// dynamic shared memory 3 * Dh * (T | 1) floats. Dh <= 32, T <= 128.
__global__ void __launch_bounds__(kWarps * kLanes)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ out, int dh, int t) {
  extern __shared__ float smem[];
  const int ld = t | 1;
  float* qs = smem;
  float* ks = qs + dh * ld;
  float* vs = ks + dh * ld;
  // block = b * H + h: the head's rows h*Dh .. h*Dh+Dh-1 of window b are
  // one contiguous Dh x T block
  const size_t base = static_cast<size_t>(blockIdx.x) * dh * t;
  const int n = dh * t;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / t;
    const int c = i - r * t;
    qs[r * ld + c] = q[base + i];
    ks[r * ld + c] = k[base + i];
    vs[r * ld + c] = v[base + i];
  }
  __syncthreads();

  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const float* vrow = vs + (lane < dh ? lane : 0) * ld;
  for (int row = warp; row < t; row += kWarps) {
    float s[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = i * kLanes + lane;
      float acc = -INFINITY;
      if (j < t) {
        acc = 0.0f;
        for (int d = 0; d < dh; ++d) acc = fmaf(qs[d * ld + row], ks[d * ld + j], acc);
      }
      s[i] = acc;
      m = fmaxf(m, acc);
    }
    for (int off = kLanes / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      s[i] = (i * kLanes + lane < t) ? expf(s[i] - m) : 0.0f;
      sum += s[i];
    }
    for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s[i] = s[i] / sum;

    float o = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j0 = i * kLanes;
      const int cnt = min(kLanes, t - j0);  // the same on every lane
      for (int src = 0; src < cnt; ++src) {
        o = fmaf(__shfl_sync(kFull, s[i], src), vrow[j0 + src], o);
      }
    }
    // every lane finished reading column `row` of q before the shuffles above
    if (lane < dh) qs[lane * ld + row] = o;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / t;
    out[base + i] = qs[r * ld + (i - r * t)];
  }
}

}  // namespace

// q, k, v, out (B, H*Dh, T) float32, contiguous on the device; Dh <= 32,
// T <= 128 and 3 * Dh * (T | 1) * 4 bytes <= 48 KB (checked by the caller,
// ops/cuda/attention.py). Returns the launch's cudaGetLastError().
extern "C" int mha_f32(const float* q, const float* k, const float* v, float* out, int b, int h,
                       int dh, int t, void* stream) {
  const size_t smem = static_cast<size_t>(3 * dh * (t | 1)) * sizeof(float);
  mha_kernel<<<b * h, kWarps * kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, dh, t);
  return static_cast<int>(cudaGetLastError());
}
