// Per-window conditioning: demean or linear detrend, then peak or std
// normalisation. Persistent CTAs stream (window, channel) rows through a ring
// of buffers in shared memory.
//
// Replaces: volpick_tpu/ops/pallas/conditioning.py::condition_windows_pallas
// (_kernel). For every row x of W samples, in the Pallas kernel's order of
// arithmetic (two-pass, not raw moments: an offset 20 times the signal would
// cost sum(x * t) its digits):
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
// Design: the Pallas kernel takes a tile of 8 windows into VMEM. A row has to
// be whole in fast memory here too (three or four reductions before the first
// output), so the question is what device memory does meanwhile. With one CTA
// a row, all resident at once, the CTAs march in step: all read, all reduce,
// all write. Here a launch is a few CTAs an SM (the caller's `ctas`), each
// walks rows blockIdx.x, + gridDim.x, ..., and holds a ring of `n_buf` row
// buffers. One thread asks for a later row as a 1-D bulk copy
// (cp.async.bulk, completion on an mbarrier a buffer) while the CTA reduces
// the present one, and the finished row leaves as a bulk copy from shared
// memory too, so reads, reductions and writes of different rows overlap
// inside an SM. The request
// for row i + n_buf - 1 goes out after row i's first reduction: the buffer it
// lands in is the one row i - 1 left from, and by then that store has read it
// (cp.async.bulk.wait_group.read) without anybody waiting. With one buffer a
// row is asked for, awaited, reduced and stored in turn.
// The reductions read shared memory as float4: a per-thread partial over a
// strided set of quads, a shuffle tree in each warp and one more over the
// warps' results.
// Bulk copies need 16-byte addresses and sizes. A row width that is not a
// multiple of 4, or an x / out that is not 16-byte aligned, takes plain loads
// and stores and scalar reductions: the same kernel and the same persistent
// walk, instantiated without the ring, with one buffer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuffers = 3;

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

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(bar)) : "memory");
}

// Spins until the barrier's phase of the given parity is complete.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_address(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: `bytes` from device memory into shared memory, completion on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = shared_address(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// One thread: `bytes` from shared memory to device memory, as a group of its own.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(shared_address(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until every bulk store of this thread has read its shared memory.
__device__ __forceinline__ void bulk_stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's writes to shared memory before a later bulk copy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A strided pass over the row in shared memory: f(i, value) for each sample
// this thread owns, 4 neighbouring ones at a time where kVec; `write` stores
// what f returns back into the row.
template <bool kVec, bool kWrite, typename F>
__device__ __forceinline__ void each_sample(float* row, int w, F f) {
  if (kVec) {
    float4* quads = reinterpret_cast<float4*>(row);
    for (int q = threadIdx.x; q < w / 4; q += kThreads) {
      float4 v = quads[q];
      v.x = f(4 * q, v.x), v.y = f(4 * q + 1, v.y), v.z = f(4 * q + 2, v.z),
      v.w = f(4 * q + 3, v.w);
      if (kWrite) quads[q] = v;
    }
  } else {
    for (int i = threadIdx.x; i < w; i += kThreads) {
      const float v = f(i, row[i]);
      if (kWrite) row[i] = v;
    }
  }
}

// Turns the row in shared memory into y and returns scale + eps, the divisor
// of the output. `mean` is the row's mean, already reduced.
template <bool kVec>
__device__ __forceinline__ float condition_row(float* row, int w, float mean, bool detrend,
                                               bool peak, float eps, float* red) {
  const float centre = (w - 1) / 2.0f;
  float slope = 0.0f;
  float part = 0.0f;
  if (detrend) {
    each_sample<kVec, false>(row, w, [&](int i, float v) {
      part += (v - mean) * (i - centre);
      return v;
    });
    // sum of t^2 over centred integer coordinates, rounded once to float
    const double wd = static_cast<double>(w);
    const float var_t = static_cast<float>(wd * (wd * wd - 1.0) / 12.0);
    slope = block_reduce<Sum>(part, red, 0.0f) / var_t;
  }

  // y overwrites the row; each thread touches only its own samples
  float scale;
  part = 0.0f;
  if (peak) {
    each_sample<kVec, true>(row, w, [&](int i, float v) {
      const float y = detrend ? v - mean - slope * (i - centre) : v - mean;
      part = fmaxf(part, fabsf(y));
      return y;
    });
    scale = block_reduce<Max>(part, red, 0.0f);
  } else {
    each_sample<kVec, true>(row, w, [&](int i, float v) {
      const float y = detrend ? v - mean - slope * (i - centre) : v - mean;
      part += y;
      return y;
    });
    const float ymean = block_reduce<Sum>(part, red, 0.0f) / static_cast<float>(w);
    part = 0.0f;
    each_sample<kVec, false>(row, w, [&](int, float y) {
      const float d = y - ymean;
      part += d * d;
      return y;
    });
    scale = sqrtf(block_reduce<Sum>(part, red, 0.0f) / static_cast<float>(w));
  }
  return scale + eps;
}

// Rows blockIdx.x, + gridDim.x, ... of x (rows, w). kBulk: w is a multiple of
// 4 and x and out are 16-byte aligned, rows move by bulk copies through n_buf
// buffers of w floats in dynamic shared memory; else one buffer, plain loads
// and stores and scalar passes (an instantiation of its own: it needs half
// the registers, so twice the CTAs fit an SM).
template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
condition_kernel(const float* __restrict__ x, int rows, int w, bool detrend, bool peak, float eps,
                 int n_buf, float* __restrict__ out) {
  extern __shared__ __align__(128) float ring[];
  __shared__ float red[kWarps];
  __shared__ __align__(8) uint64_t full[kMaxBuffers];
  const int tid = threadIdx.x;
  const int n_mine = (rows - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x);
  const auto row_at = [&](int it) {
    return (static_cast<size_t>(blockIdx.x) + static_cast<size_t>(it) * gridDim.x) * w;
  };

  if (!kBulk) {
    for (int it = 0; it < n_mine; ++it) {
      const size_t row0 = row_at(it);
      float part = 0.0f;
      for (int i = tid; i < w; i += kThreads) {
        const float v = x[row0 + i];
        ring[i] = v;
        part += v;
      }
      const float mean = block_reduce<Sum>(part, red, 0.0f) / static_cast<float>(w);
      const float denom = condition_row<false>(ring, w, mean, detrend, peak, eps, red);
      for (int i = tid; i < w; i += kThreads) out[row0 + i] = ring[i] / denom;
      __syncthreads();  // the row is read before the next one overwrites it
    }
    return;
  }

  const uint32_t bytes = static_cast<uint32_t>(w) * sizeof(float);
  const int ahead = n_buf - 1;  // rows asked for beyond the present one
  if (tid == 0) {
    for (int b = 0; b < n_buf; ++b) barrier_init(&full[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < min(ahead, n_mine); ++it) {
      bulk_load(ring + static_cast<size_t>(it) * w, x + row_at(it), bytes, &full[it]);
    }
  }
  __syncthreads();

  for (int it = 0; it < n_mine; ++it) {
    const int b = it % n_buf;
    float* row = ring + static_cast<size_t>(b) * w;
    if (ahead == 0 && tid == 0) {
      bulk_stores_read();  // the one buffer: row it - 1 has left it
      bulk_load(row, x + row_at(it), bytes, &full[0]);
    }
    barrier_wait(&full[b], (it / n_buf) & 1);

    float part = 0.0f;
    each_sample<true, false>(row, w, [&](int, float v) {
      part += v;
      return v;
    });
    const float mean = block_reduce<Sum>(part, red, 0.0f) / static_cast<float>(w);
    if (ahead > 0 && tid == 0 && it + ahead < n_mine) {
      // into the buffer that row it - 1 used: every thread is past that row
      // (the barriers of this reduction), and its bulk store has read it
      bulk_stores_read();
      const int nb = (it + ahead) % n_buf;
      bulk_load(ring + static_cast<size_t>(nb) * w, x + row_at(it + ahead), bytes, &full[nb]);
    }
    const float denom = condition_row<true>(row, w, mean, detrend, peak, eps, red);

    each_sample<true, true>(row, w, [&](int, float y) { return y / denom; });
    fence_async_proxy();
    __syncthreads();
    if (tid == 0) bulk_store(out + row_at(it), row, bytes);
  }
  if (tid == 0) bulk_stores_read();  // shared memory outlives its readers
}

}  // namespace

// x and out (rows, W) float32, contiguous on the device; norm_peak 1 for the
// peak of |y|, 0 for its std. `ctas` persistent CTAs (at most `rows`), each
// with `n_buf` (1 .. 3) row buffers of W floats in shared memory. Rows that
// cannot move by bulk copies (W % 4 != 0, x or out not 16-byte aligned) take plain loads and
// stores and one buffer. Returns cudaErrorInvalidValue (1) for ctas or n_buf
// out of range, else the launch's error.
extern "C" int condition_windows_f32(const float* x, float* out, int rows, int w, int detrend,
                                     int norm_peak, float eps, int ctas, int n_buf,
                                     void* stream) {
  if (rows < 1 || w < 1 || ctas < 1 || ctas > rows || n_buf < 1 || n_buf > kMaxBuffers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bulk = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!bulk) n_buf = 1;
  const size_t smem = sizeof(float) * static_cast<size_t>(w) * n_buf;
  // beside the ring the kernel has some static shared memory; past 48 KB in
  // all a launch needs the opt-in
  constexpr size_t kStatic = 256;
  static size_t allowed = 48 * 1024;  // shared memory both instantiations may take so far
  if (smem + kStatic > allowed) {
    const int most = static_cast<int>(smem + kStatic);
    cudaError_t err = cudaFuncSetAttribute(condition_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(condition_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem + kStatic;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk) {
    condition_kernel<true><<<ctas, kThreads, smem, s>>>(x, rows, w, detrend != 0, norm_peak != 0,
                                                        eps, n_buf, out);
  } else {
    condition_kernel<false><<<ctas, kThreads, smem, s>>>(x, rows, w, detrend != 0, norm_peak != 0,
                                                         eps, 1, out);
  }
  return static_cast<int>(cudaGetLastError());
}
