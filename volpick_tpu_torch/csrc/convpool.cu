// One encoder layer of EQTransformer: a 'same' convolution of kernel K with
// zero padding, bias, ReLU and a max-pool of 2 (keras 'same' pooling), in one
// pass:
//   y[o, t] = b[o] + sum_i sum_k w[o, i, k] x[i, t + k - pl],  pl = (K - 1) / 2,
//             x zero outside [0, L)  (K // 2 zeros on the right, odd or even K)
//   out[o, j] = relu(max(y[o, t] for t in {2j - q, 2j + 1 - q}, 0 <= t < L)),
//   q = L % 2, j < (L + q) / 2
// The pooling pads -inf on both sides of an odd-length y, which shifts the
// pairs by one: (y[2j - 1], y[2j]), and out[0] = y[0]. ReLU is monotone, so
// it commutes with the max and is applied once, after it; so is the bias
// (rounding is monotone), which is added to the larger of the two sums.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions and pools
// to XLA. On the card the same layer was four or five passes: a pad copy,
// cuDNN's float32 implicit sgemm, a ReLU pass, for odd lengths a -inf pad
// copy, and the pooling pass; the conv output went to device memory at full
// resolution, and half of it was thrown away by the pool straight after.
//
// What bounds it on an H100: both. The encoder is 30.8 MFLOP a window against
// ~0.76 MB read once and written once; float32 at 67 TFLOP/s and 3.35 TB/s
// make the long first layers (few channels) about as much bytes as operations
// and the short last ones (64 channels) operations. Float32 with TF32 off is
// the stated precision, so the multiply-adds are FFMA on the SIMT pipes.
//
// Design (the mirror of csrc/upconv.cu, which reads half resolution and
// writes full; this one reads full and writes half):
// - A CTA stages the weights of its block of output channels and every input
//   channel once, as [i][k][o] in shared memory, then walks work items
//   blockIdx.x, + gridDim.x, ...: an item is one window and one tile of M
//   pooled outputs (2M conv outputs).
// - An item's input rows, with the K - 1 halo its taps read, are copied into
//   shared memory by 4-byte cp.async; the zero padding is made by the index
//   (src-size 0 writes a zero), not by a copy.
// - A thread owns kCO = 8 output channels x kTP = 4 pooled outputs, both conv
//   outputs of each pair: 64 sums in registers. For one input channel it
//   reads its 2 kTP + K - 1 inputs as 16-byte loads once, and each tap's 8
//   weights as two 16-byte loads that every lane of a channel group shares (a
//   broadcast): 64 K multiply-adds for 2 K + (K + 10) / 4 loads.
// - The epilogue takes each pair's max, adds the bias, applies ReLU and
//   stores only the pooled value: a thread's 4 consecutive outputs a channel
//   as one 16-byte store where the row is 16-byte aligned (8-byte or 4-byte
//   stores otherwise). Neither y nor a padded copy reaches device memory.
// The wrapper (ops/cuda/convpool.py::convpool_plan) picks the tile, the
// threads and the channel blocks from the shape; this file checks nothing of
// them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kCO = 8;          // output channels a thread owns
constexpr int kTP = 4;          // pooled outputs a thread owns (8 conv outputs)
constexpr int kMaxThreads = 256;

template <int K>
struct Taps {
  static constexpr int pl = (K - 1) / 2;             // zeros on the left of x
  static constexpr int span = 2 * kTP + K - 1;       // inputs a thread reads a channel
  static constexpr int nin4 = (span + 3) / 4;        // as 16-byte loads
};

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes into shared memory; src_bytes 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_address(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The larger of a and b; NaN if either is (as max_pool1d propagates it).
__device__ __forceinline__ float max_nan(float a, float b) { return (b > a || b != b) ? b : a; }

// x (B, I, L), w (O, I, K), bias (O,), y (B, O, Lp), Lp = (L + L % 2) / 2. A
// CTA has gc * nt threads (gc channel groups of kCO, nt time lanes of kTP
// pooled outputs), covers channels [blockIdx.y * gc * kCO, ...) and items
// blockIdx.x, + gridDim.x, ... of n_items = B * n_tiles. Shared memory: the
// weights (I x K x gc kCO) and the input tile (I x row_words).
template <int K>
__global__ void __launch_bounds__(kMaxThreads, 2)
convpool_relu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y, int I, int O, int L, int nt,
                     int n_tiles, int n_items, int gc, int row_words) {
  using Tp = Taps<K>;
  extern __shared__ __align__(16) float smem[];
  const int opc = gc * kCO;  // channels of the CTA's block, padded to whole groups
  const int o0 = blockIdx.y * opc;
  float* ws = smem;                // [i][k][oc]
  float* xs = ws + I * K * opc;    // [i][col], col c <-> input step 2 j0 - q - pl + c
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tl = tid % nt, g = tid / nt;
  const int q = L & 1;
  const int Lp = (L + q) >> 1;
  const int M = nt * kTP;

  // ---- the block's weights, once: read in w's order, stored channel-fastest
  const int ik = I * K;
  for (int idx = tid; idx < opc * ik; idx += nthreads) {
    const int oc = idx / ik, r = idx - oc * ik, o = o0 + oc;
    ws[r * opc + oc] = o < O ? __ldg(w + static_cast<size_t>(o) * ik + r) : 0.f;
  }

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / n_tiles;
    const int j0 = (item - b * n_tiles) * M;
    const int s0 = 2 * j0 - q - Tp::pl;
    const float* xb = x + static_cast<size_t>(b) * I * L;
    __syncthreads();  // the last item's readers are done with xs
    for (int idx = tid; idx < I * row_words; idx += nthreads) {
      const int i = idx / row_words;
      const int s = s0 + (idx - i * row_words);
      const bool in = s >= 0 && s < L;
      cp_async4(xs + idx, xb + static_cast<size_t>(i) * L + (in ? s : 0), in ? 4 : 0);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- 64 sums a thread: kCO channels x kTP pairs x 2 conv outputs
    float acc[kCO][kTP][2];
#pragma unroll
    for (int c = 0; c < kCO; ++c)
#pragma unroll
      for (int m = 0; m < kTP; ++m) acc[c][m][0] = acc[c][m][1] = 0.f;
    const float* xrow = xs + tl * 2 * kTP;
    const float* wrow = ws + g * kCO;
#pragma unroll 1
    for (int i = 0; i < I; ++i) {
      float xin[Tp::nin4 * 4];
#pragma unroll
      for (int v = 0; v < Tp::nin4; ++v)
        *reinterpret_cast<float4*>(xin + 4 * v) = *reinterpret_cast<const float4*>(xrow + i * row_words + 4 * v);
      const float* wi = wrow + i * K * opc;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float wv[kCO];
#pragma unroll
        for (int v = 0; v < kCO / 4; ++v)
          *reinterpret_cast<float4*>(wv + 4 * v) = *reinterpret_cast<const float4*>(wi + k * opc + 4 * v);
#pragma unroll
        for (int c = 0; c < kCO; ++c)
#pragma unroll
          for (int m = 0; m < kTP; ++m) {
            acc[c][m][0] = fmaf(wv[c], xin[2 * m + k], acc[c][m][0]);
            acc[c][m][1] = fmaf(wv[c], xin[2 * m + 1 + k], acc[c][m][1]);
          }
      }
    }

    // ---- each pair's max, bias, ReLU; 4 consecutive pooled outputs a channel
    const int jt = j0 + tl * kTP;
    if (jt < Lp) {
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const int o = o0 + g * kCO + c;
        if (o >= O) continue;
        const float bo = __ldg(bias + o);
        float v[kTP];
#pragma unroll
        for (int m = 0; m < kTP; ++m) {
          // conv output 2j - q is -inf padding only at j = 0 of an odd length
          float a = (jt + m == 0 && q) ? acc[c][m][1] : max_nan(acc[c][m][0], acc[c][m][1]);
          a += bo;
          v[m] = a < 0.f ? 0.f : a;  // NaN stays NaN, as in F.relu
        }
        float* yr = y + (static_cast<size_t>(b) * O + o) * Lp + jt;
        const uintptr_t addr = reinterpret_cast<uintptr_t>(yr);
        if (jt + kTP <= Lp && addr % 16 == 0) {
          *reinterpret_cast<float4*>(yr) = make_float4(v[0], v[1], v[2], v[3]);
        } else if (jt + kTP <= Lp && addr % 8 == 0) {
          reinterpret_cast<float2*>(yr)[0] = make_float2(v[0], v[1]);
          reinterpret_cast<float2*>(yr)[1] = make_float2(v[2], v[3]);
        } else {
#pragma unroll
          for (int m = 0; m < kTP; ++m)
            if (jt + m < Lp) yr[m] = v[m];
        }
      }
    }
  }
}

template <int K>
int launch(const float* x, const float* w, const float* b, float* y, int B, int I, int O, int L, int nt,
           int n_tiles, int cblocks, int n_sm, cudaStream_t s) {
  using Tp = Taps<K>;
  const int groups = (O + kCO - 1) / kCO;
  const int gc = (groups + cblocks - 1) / cblocks;
  const int threads = gc * nt;
  const int row_words = (nt - 1) * 2 * kTP + Tp::nin4 * 4;
  const size_t smem = sizeof(float) * (static_cast<size_t>(I) * K * gc * kCO + static_cast<size_t>(I) * row_words);
  static std::once_flag opted;
  static cudaError_t opt_err = cudaSuccess;
  std::call_once(opted, [] {
    opt_err = cudaFuncSetAttribute(convpool_relu_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   232448);
  });
  if (opt_err != cudaSuccess) return static_cast<int>(opt_err);
  // CTAs an SM can hold at this size, asked once a (threads, shared memory)
  static std::mutex lock;
  static std::unordered_map<uint64_t, int> resident;
  const uint64_t key = (static_cast<uint64_t>(threads) << 32) | smem;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> guard(lock);
    auto it = resident.find(key);
    if (it == resident.end()) {
      const cudaError_t err =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, convpool_relu_kernel<K>, threads, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      resident.emplace(key, per_sm);
    } else {
      per_sm = it->second;
    }
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_items = B * n_tiles;
  const int ctas = n_items < n_sm * per_sm ? n_items : n_sm * per_sm;
  const dim3 grid(ctas, cblocks);
  convpool_relu_kernel<K><<<grid, threads, smem, s>>>(x, w, b, y, I, O, L, nt, n_tiles, n_items, gc, row_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Words of dynamic shared memory a CTA takes for kernel size k (1 ... 13), I
// input channels, gc channel groups and nt time lanes; -1 for another k.
extern "C" long long convpool_shared_words(int k, int i, int gc, int nt) {
  if (k < 1 || k > 13) return -1;
  const int nin4 = (2 * kTP + k - 1 + 3) / 4;
  return static_cast<long long>(i) * k * gc * kCO + static_cast<long long>(i) * ((nt - 1) * 2 * kTP + nin4 * 4);
}

// x (B, I, L), w (O, I, K), b (O,), y (B, O, (L + L % 2) / 2): float32,
// contiguous on the device; K 1 ... 13, odd or even; nt a multiple of 8; the
// plan (nt, n_tiles, cblocks) from the wrapper. Returns cudaErrorInvalidValue
// (1) for a K the file has no instantiation of, else the launch's error.
extern "C" int convpool_relu_f32(const float* x, const float* w, const float* b, float* y, int B, int I, int O,
                                 int L, int K, int nt, int n_tiles, int cblocks, int n_sm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 2: return launch<2>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 3: return launch<3>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 4: return launch<4>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 5: return launch<5>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 6: return launch<6>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 7: return launch<7>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 8: return launch<8>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 9: return launch<9>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 10: return launch<10>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 11: return launch<11>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 12: return launch<12>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    case 13: return launch<13>(x, w, b, y, B, I, O, L, nt, n_tiles, cblocks, n_sm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
