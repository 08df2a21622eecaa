// One decoder layer of EQTransformer: 2x nearest upsampling (the last copy
// cropped where the encoder padded), a 'same' convolution of odd kernel K with
// zero padding, bias, ReLU, in one pass:
//   u = upsample_nearest(x, 2)[..., :N],  N = 2T - crop  (crop 0 or 1)
//   y[o, t] = relu(b[o] + sum_i sum_j w[o, i, j] u[i, t + j - p]),  p = (K - 1) / 2
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (its "polyup" route re-associates them in plain jnp). On the card the same
// layer was four passes: a strided copy for the upsampling, a crop, a pad copy
// and cuDNN's float32 implicit sgemm, then a ReLU pass.
//
// Folded taps. Output t = 2m + r (parity r) reads u at s = t + j - p, which is
// x[floor(s / 2)] = x[m + d] with d = floor((r + j - p) / 2): two neighbouring
// taps land on the same input sample and are summed in the weights. Parity r
// keeps P = p + 1 taps, d = D0_r ... D0_r + p:
//   Wf_r[d] = w[2d + p - r] + w[2d + p - r + 1]   (each term where 0 <= j < K)
// with D0_0 = floor(-p / 2) and D0_1 = floor((1 - p) / 2), one more than D0_0
// for odd p. Zero padding of u at s < 0 and s >= 2T is zero padding of x at
// d < 0 and d >= T, so the folded form is exact there. The crop is not: u at
// s = 2T - 1 is padding, but x[T - 1] is not, so the last p outputs
// t = 2T - 1 - p + q (q < p) took w[o, i, 2p - q] x[i, T - 1] too much; the
// kernel subtracts it (the JAX package's polyup correction).
//
// What bounds it on an H100: both. Folded, a decoder of EQTransformer is
// 38.8 MFLOP a window against ~1.2 MB read once and written once; float32 at
// 67 TFLOP/s and 3.35 TB/s make the two bounds of each layer about equal
// (~20 operations a byte). Float32 with TF32 off is the stated precision, so
// the multiply-adds are FFMA on the SIMT pipes, no tensor cores.
//
// Design:
// - A CTA stages the folded weights of its block of output channels once, as
//   [i][r][d][o] in shared memory (folded from the raw (O, I, K) tensor while
//   staging: no host-side folding, no cache), then walks work items
//   blockIdx.x, + gridDim.x, ...: an item is one window and one tile of M input
//   steps (2M outputs).
// - An item's input rows, with the halo the taps read, are copied into shared
//   memory at input resolution by 4-byte cp.async, zero-filled outside
//   [0, T), so the taps need no bounds checks.
// - A thread owns kCO = 8 output channels x 4 input steps, both parities (the
//   two read the same inputs, shifted by one step at most, and their 8
//   outputs a channel are contiguous): 64 sums in registers. For one input
//   channel it reads its 4 + span - 1 inputs
//   as three or fewer 16-byte loads (the 8 lanes of a quarter warp read 32
//   consecutive words: no bank conflict) and each tap's 8 weights as two
//   16-byte loads that every lane of a channel group shares (a broadcast):
//   64 P multiply-adds for 4 P + 3 loads or fewer.
// - The epilogue adds the bias, applies ReLU and stores a thread's 8
//   consecutive outputs a channel, parities interleaved in registers, as two
//   16-byte stores where the row is 16-byte aligned (8-byte or 4-byte stores
//   otherwise). The crop's corrections are computed by the CTA beside the
//   staging of the item that holds them.
// The wrapper (ops/cuda/upconv.py::upconv_plan) picks the tile, the threads
// and the channel blocks from the shape; this file checks nothing of them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kCO = 8;          // output channels a thread owns
constexpr int kTT = 4;          // input steps a thread owns (8 outputs)
constexpr int kMaxThreads = 256;

template <int K>
struct Taps {
  static constexpr int p = (K - 1) / 2;
  static constexpr int P = p + 1;              // folded taps a parity
  static constexpr int odd = p & 1;            // D0_1 - D0_0
  static constexpr int D0 = -((p + 1) / 2);    // floor(-p / 2)
  static constexpr int span = P + odd;         // input steps both parities read around one
  static constexpr int nin4 = (kTT + span - 1 + 3) / 4;  // 16-byte loads of a thread's inputs
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

// x (B, I, T), w (O, I, K), bias (O,), y (B, O, N), N = 2T - crop. A CTA has
// gc * nt threads (gc channel groups of kCO, nt time lanes of kTT steps),
// covers channels [blockIdx.y * gc * kCO, ...) and items blockIdx.x, +
// gridDim.x, ... of n_items = B * n_tiles. Shared memory: the folded weights
// (I x 2 x P x gc kCO), the input tile (I x row_words) and the crop's
// corrections (p x gc kCO).
template <int K>
__global__ void __launch_bounds__(kMaxThreads, 2)
upconv_relu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y, int I, int O, int T,
                   int crop, int nt, int n_tiles, int n_items, int gc, int row_words) {
  using Tp = Taps<K>;
  constexpr int p = Tp::p, P = Tp::P, D0 = Tp::D0;
  extern __shared__ __align__(16) float smem[];
  const int opc = gc * kCO;  // channels of the CTA's block, padded to whole groups
  const int o0 = blockIdx.y * opc;
  float* ws = smem;                      // [i][r][d][oc]
  float* xs = ws + I * 2 * P * opc;      // [i][col], col c <-> input step m0 + D0 + c
  float* cs = xs + I * row_words;        // [q][oc]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tl = tid % nt, g = tid / nt;
  const int N = 2 * T - crop;
  const int M = nt * kTT;

  // ---- the folded weights of the block, once
  for (int idx = tid; idx < I * opc; idx += nthreads) {
    const int i = idx / opc, oc = idx - i * opc, o = o0 + oc;
    float raw[K];
    const float* wr = w + (static_cast<size_t>(o) * I + i) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) raw[j] = o < O ? __ldg(wr + j) : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int dd = 0; dd < P; ++dd) {
        const int j0 = 2 * (dd + D0 + (r ? Tp::odd : 0)) + p - r;
        float s = 0.f;
        if (j0 >= 0 && j0 < K) s += raw[j0];
        if (j0 + 1 >= 0 && j0 + 1 < K) s += raw[j0 + 1];
        ws[((i * 2 + r) * P + dd) * opc + oc] = s;
      }
    }
  }

  // outputs t >= crop_from took a phantom copy of x[T - 1] (crop only)
  const int crop_from = crop ? 2 * T - 1 - p : N;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / n_tiles;
    const int m0 = (item - b * n_tiles) * M;
    const float* xb = x + static_cast<size_t>(b) * I * T;
    __syncthreads();  // the last item's readers are done with xs and cs
    for (int idx = tid; idx < I * row_words; idx += nthreads) {
      const int i = idx / row_words;
      const int s = m0 + D0 + (idx - i * row_words);
      const bool in = s >= 0 && s < T;
      cp_async4(xs + idx, xb + static_cast<size_t>(i) * T + (in ? s : 0), in ? 4 : 0);
    }
    if (crop_from < N && m0 + M > crop_from / 2) {
      for (int idx = tid; idx < p * opc; idx += nthreads) {
        const int q = idx / opc, oc = idx - q * opc, o = o0 + oc;
        float s = 0.f;
        if (o < O) {
          const float* wr = w + static_cast<size_t>(o) * I * K + (2 * p - q);
          for (int i = 0; i < I; ++i) s = fmaf(__ldg(wr + i * K), __ldg(xb + static_cast<size_t>(i) * T + T - 1), s);
        }
        cs[idx] = s;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- 64 sums a thread: kCO channels x kTT steps x 2 parities
    float acc[kCO][kTT][2];
#pragma unroll
    for (int c = 0; c < kCO; ++c)
#pragma unroll
      for (int q = 0; q < kTT; ++q) acc[c][q][0] = acc[c][q][1] = 0.f;
    const float* xrow = xs + tl * kTT;
    const float* wrow = ws + g * kCO;
    // not unrolled: two channels a pass spill at 128 registers and ran 11%
    // slower a decoder on the H100
#pragma unroll 1
    for (int i = 0; i < I; ++i) {
      float xin[Tp::nin4 * 4];
#pragma unroll
      for (int v = 0; v < Tp::nin4; ++v)
        *reinterpret_cast<float4*>(xin + 4 * v) = *reinterpret_cast<const float4*>(xrow + i * row_words + 4 * v);
      const float* wi = wrow + i * 2 * P * opc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int roff = r ? Tp::odd : 0;
#pragma unroll
        for (int dd = 0; dd < P; ++dd) {
          float wv[kCO];
#pragma unroll
          for (int v = 0; v < kCO / 4; ++v)
            *reinterpret_cast<float4*>(wv + 4 * v) = *reinterpret_cast<const float4*>(wi + (r * P + dd) * opc + 4 * v);
#pragma unroll
          for (int c = 0; c < kCO; ++c)
#pragma unroll
            for (int q = 0; q < kTT; ++q) acc[c][q][r] = fmaf(wv[c], xin[q + roff + dd], acc[c][q][r]);
        }
      }
    }

    // ---- bias, crop correction, ReLU; 8 consecutive outputs a channel
    const int t0 = 2 * (m0 + tl * kTT);
    if (t0 < N) {
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const int oc = g * kCO + c, o = o0 + oc;
        if (o >= O) continue;
        const float bo = __ldg(bias + o);
        float v[2 * kTT];
#pragma unroll
        for (int q = 0; q < kTT; ++q) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = t0 + 2 * q + r;
            float a = acc[c][q][r];
            if (t >= crop_from && t < N) a -= cs[(t - crop_from) * opc + oc];
            a += bo;
            v[2 * q + r] = a < 0.f ? 0.f : a;  // NaN stays NaN, as in F.relu
          }
        }
        float* yr = y + (static_cast<size_t>(b) * O + o) * N + t0;
        const uintptr_t addr = reinterpret_cast<uintptr_t>(yr);
        if (t0 + 2 * kTT <= N && addr % 16 == 0) {
          reinterpret_cast<float4*>(yr)[0] = make_float4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<float4*>(yr)[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else if (t0 + 2 * kTT <= N && addr % 8 == 0) {
#pragma unroll
          for (int k = 0; k < kTT; ++k) reinterpret_cast<float2*>(yr)[k] = make_float2(v[2 * k], v[2 * k + 1]);
        } else {
#pragma unroll
          for (int k = 0; k < 2 * kTT; ++k)
            if (t0 + k < N) yr[k] = v[k];
        }
      }
    }
  }
}

template <int K>
int launch(const float* x, const float* w, const float* b, float* y, int B, int I, int O, int T,
           int crop, int nt, int n_tiles, int cblocks, int n_sm, cudaStream_t s) {
  using Tp = Taps<K>;
  const int groups = (O + kCO - 1) / kCO;
  const int gc = (groups + cblocks - 1) / cblocks;
  const int threads = gc * nt;
  const int row_words = (nt - 1 + Tp::nin4) * kTT;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(I) * 2 * Tp::P * gc * kCO + static_cast<size_t>(I) * row_words +
                       static_cast<size_t>(Tp::p) * gc * kCO);
  static std::once_flag opted;
  static cudaError_t opt_err = cudaSuccess;
  std::call_once(opted, [] {
    opt_err = cudaFuncSetAttribute(upconv_relu_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, upconv_relu_kernel<K>, threads, smem);
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
  upconv_relu_kernel<K><<<grid, threads, smem, s>>>(x, w, b, y, I, O, T, crop, nt, n_tiles, n_items, gc,
                                                    row_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Words of dynamic shared memory a CTA takes for kernel size k (odd, <= 13),
// I input channels, gc channel groups and nt time lanes; -1 for another k.
extern "C" long long upconv_shared_words(int k, int i, int gc, int nt) {
  int p = (k - 1) / 2, P = p + 1, span = P + (p & 1), nin4 = (kTT + span - 1 + 3) / 4;
  if (k < 1 || k > 13 || k % 2 == 0) return -1;
  return static_cast<long long>(i) * 2 * P * gc * kCO + static_cast<long long>(i) * (nt - 1 + nin4) * kTT +
         static_cast<long long>(p) * gc * kCO;
}

// x (B, I, T), w (O, I, K), b (O,), y (B, O, 2T - crop): float32, contiguous
// on the device; K odd, 1 ... 13; crop 0 or 1; nt a multiple of 8; the plan
// (nt, n_tiles, cblocks) from the wrapper. Returns cudaErrorInvalidValue (1)
// for a K the file has no instantiation of, else the launch's error.
extern "C" int upconv_relu_f32(const float* x, const float* w, const float* b, float* y, int B, int I,
                               int O, int T, int K, int crop, int nt, int n_tiles, int cblocks, int n_sm,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(x, w, b, y, B, I, O, T, crop, nt, n_tiles, cblocks, n_sm, s);
    case 3: return launch<3>(x, w, b, y, B, I, O, T, crop, nt, n_tiles, cblocks, n_sm, s);
    case 5: return launch<5>(x, w, b, y, B, I, O, T, crop, nt, n_tiles, cblocks, n_sm, s);
    case 7: return launch<7>(x, w, b, y, B, I, O, T, crop, nt, n_tiles, cblocks, n_sm, s);
    case 9: return launch<9>(x, w, b, y, B, I, O, T, crop, nt, n_tiles, cblocks, n_sm, s);
    case 11: return launch<11>(x, w, b, y, B, I, O, T, crop, nt, n_tiles, cblocks, n_sm, s);
    case 13: return launch<13>(x, w, b, y, B, I, O, T, crop, nt, n_tiles, cblocks, n_sm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
