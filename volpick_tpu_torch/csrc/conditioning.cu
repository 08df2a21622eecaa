// Per-window conditioning: demean or linear detrend, then peak or std
// normalisation, one CTA per (window, channel) row.
//
// Replaces: volpick_tpu/ops/pallas/conditioning.py::condition_windows_pallas
// (_kernel). For every row x of W samples, in the Pallas kernel's order of
// arithmetic (two-pass, not raw moments):
//   mean  = sum(x) / W
//   slope = sum((x - mean) * t) / (W (W^2 - 1) / 12),  t = i - (W - 1) / 2
//   y     = x - mean - slope * t        (detrend)   or   x - mean
//   scale = max |y|                     (peak)      or   std(y), ddof 0
//   out   = y / (scale + eps)
//
// What bounds it on an H100: bytes. 232 x 3 rows of 6000 floats are 16.7 MB
// in and 16.7 MB out, about 10 us at the 3.35 TB/s of the H100 SXM data
// sheet; the arithmetic is a few operations a sample.
//
// Design: the Pallas kernel takes a tile of 8 windows into VMEM. Here a CTA
// loads one row into shared memory (24 KB at W = 6000; rows above 48 KB are
// refused by the wrapper), so device memory is read once and written once
// and the three or four reductions run from shared memory. A reduction is a
// per-thread partial over a strided set of samples, a shuffle tree in each
// warp and one more over the warps' results.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Sum {
  __device__ static float op(float a, float b) { return a + b; }
};
struct Max {
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};

// Block-wide reduction of one value a thread; every thread gets the result.
// `red` holds kWarps floats; `init` is the operation's identity.
template <typename Op>
__device__ float block_reduce(float v, float* red, float init) {
  for (int d = 16; d > 0; d >>= 1) v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, d));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's readers are done with `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : init;
  for (int d = 16; d > 0; d >>= 1) v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__global__ void __launch_bounds__(kThreads)
condition_kernel(const float* __restrict__ x, int w, bool detrend, bool peak, float eps,
                 float* __restrict__ out) {
  extern __shared__ float row[];
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * w;

  float part = 0.0f;
  for (int i = tid; i < w; i += kThreads) {
    const float v = x[row0 + i];
    row[i] = v;
    part += v;
  }
  const float mean = block_reduce<Sum>(part, red, 0.0f) / static_cast<float>(w);

  const float centre = (w - 1) / 2.0f;
  float slope = 0.0f;
  if (detrend) {
    part = 0.0f;
    for (int i = tid; i < w; i += kThreads) part += (row[i] - mean) * (i - centre);
    // sum of t^2 over centred integer coordinates, rounded once to float
    const double wd = static_cast<double>(w);
    const float var_t = static_cast<float>(wd * (wd * wd - 1.0) / 12.0);
    slope = block_reduce<Sum>(part, red, 0.0f) / var_t;
  }

  // y overwrites the row; each thread touches only its own samples
  float scale;
  if (peak) {
    part = 0.0f;
    for (int i = tid; i < w; i += kThreads) {
      const float y = detrend ? row[i] - mean - slope * (i - centre) : row[i] - mean;
      row[i] = y;
      part = fmaxf(part, fabsf(y));
    }
    scale = block_reduce<Max>(part, red, 0.0f);
  } else {
    part = 0.0f;
    for (int i = tid; i < w; i += kThreads) {
      const float y = detrend ? row[i] - mean - slope * (i - centre) : row[i] - mean;
      row[i] = y;
      part += y;
    }
    const float ymean = block_reduce<Sum>(part, red, 0.0f) / static_cast<float>(w);
    part = 0.0f;
    for (int i = tid; i < w; i += kThreads) {
      const float d = row[i] - ymean;
      part += d * d;
    }
    scale = sqrtf(block_reduce<Sum>(part, red, 0.0f) / static_cast<float>(w));
  }

  const float denom = scale + eps;
  for (int i = tid; i < w; i += kThreads) out[row0 + i] = row[i] / denom;
}

}  // namespace

// x and out (rows, W) float32, contiguous on the device; norm_peak 1 for the
// peak of |y|, 0 for its std. Returns the launch's cudaGetLastError().
extern "C" int condition_windows_f32(const float* x, float* out, int rows, int w, int detrend,
                                     int norm_peak, float eps, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(w);
  condition_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, detrend != 0, norm_peak != 0, eps, out);
  return static_cast<int>(cudaGetLastError());
}
