// EQTransformer's residual CNN stack, one window per CTA, the activation
// resident on the SM across all blocks.
//
// Replaces: volpick_tpu/ops/pallas/rescnn.py::res_cnn_stack_pallas (_kernel).
// For each of the NB pre-activation residual blocks, with eval-mode
// BatchNorm folded to per-channel affines (g, b) by the wrapper:
//   y = conv1(relu(x * g1 + b1)) + cb1
//   y = conv2(relu(y * g2 + b2)) + cb2
//   x = x + y
// Every conv is three taps over offsets (-1, 0, +1) with zero padding,
// w[tap][in][out]; a kernel-2 conv arrives as taps (0, +1) with a zero -1 tap.
//
// What bounds it on an H100: operations. At the EQTransformer step (B 232,
// C 64, T 47, NB 7) the 42 tap products are 232 x 47 x 42 x 64 x 64 x 2 =
// 3.7 GFLOP of float32 (about 56 us at the 67 TFLOP/s the H100 SXM data sheet
// gives outside the tensor cores; float32 parity rules TF32 / bf16 mma out),
// against 5.6 MB of activations in and out and 0.69 MB of weights that stay
// in L2.
//
// Design: the Pallas kernel tiles 64 windows and unrolls 42 MXU products.
// Here one CTA owns one window. Thread (o, g) owns output channel o and the
// kTT = 12 consecutive time steps of group g for every conv (4 groups: T <=
// 48), so the residual x lives in its registers from the first block to the
// last and device memory is read once and written once. The conv input
// relu(affine(.)) lives in one shared (C, kRow) buffer with a zero column
// each side of the T valid ones, so taps -1 and +1 need no branch. Per input
// channel a thread loads its kTT + 2 inputs once (the lanes of a warp share
// g: one broadcast word each) and three weights (lanes along o: coalesced,
// served by L1 / L2), and does 3 kTT multiply-adds.

#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 4;        // time groups of a CTA
constexpr int kTT = 12;           // time steps a thread owns
constexpr int kMaxChannels = 64;  // threads = kGroups * kMaxChannels
// shared row: a zero column each side of the kGroups * kTT time steps, one
// more to make the stride odd (lanes along the channel hit different banks)
constexpr int kRow = kGroups * kTT + 3;

// One conv of the stack: acc[j] = bias[o] + sum_i sum_tap w[tap][i][o] * a[i][t0 + j + tap - 1].
__device__ __forceinline__ void conv3(const float* __restrict__ w, const float* __restrict__ bias,
                                      const float* act, int c, int o, int t0, float (&acc)[kTT]) {
  const float b = bias[o];
#pragma unroll
  for (int j = 0; j < kTT; ++j) acc[j] = b;
  for (int i = 0; i < c; ++i) {
    const float w0 = w[(0 * c + i) * c + o];
    const float w1 = w[(1 * c + i) * c + o];
    const float w2 = w[(2 * c + i) * c + o];
    const float* a = act + i * kRow + t0;  // a[0] is input t0 - 1
    float prev = a[0], cur = a[1];
#pragma unroll
    for (int j = 0; j < kTT; ++j) {
      const float next = a[j + 2];
      acc[j] += w0 * prev;
      acc[j] += w1 * cur;
      acc[j] += w2 * next;
      prev = cur;
      cur = next;
    }
  }
}

__global__ void __launch_bounds__(kGroups * kMaxChannels)
rescnn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ w2, const float* __restrict__ cb1,
              const float* __restrict__ cb2, const float* __restrict__ g1,
              const float* __restrict__ b1, const float* __restrict__ g2,
              const float* __restrict__ b2, int c, int t, int nb, float* __restrict__ out) {
  extern __shared__ float act[];  // (C, kRow)
  const int tid = threadIdx.x;
  const int o = tid % kMaxChannels;
  const int t0 = (tid / kMaxChannels) * kTT;
  const bool live = o < c;
  const size_t base = static_cast<size_t>(blockIdx.x) * c * t;

  // the window, coalesced, into the buffer's valid columns; zeros elsewhere
  for (int i = tid; i < c * kRow; i += blockDim.x) {
    const int ch = i / kRow, col = i - ch * kRow;
    act[i] = (col >= 1 && col <= t) ? x[base + ch * t + col - 1] : 0.0f;
  }
  __syncthreads();
  float res[kTT], acc[kTT];
#pragma unroll
  for (int j = 0; j < kTT; ++j) res[j] = live ? act[o * kRow + 1 + t0 + j] : 0.0f;
  __syncthreads();

  // writes relu(v[j] * g[o] + b[o]) into this thread's columns; columns past
  // T stay zero (they are the right-hand padding of the last valid column)
  auto put = [&](const float (&v)[kTT], const float* g, const float* b) {
    if (!live) return;
    const float gg = g[o], bb = b[o];
#pragma unroll
    for (int j = 0; j < kTT; ++j) {
      if (t0 + j < t) act[o * kRow + 1 + t0 + j] = fmaxf(v[j] * gg + bb, 0.0f);
    }
  };

  for (int blk = 0; blk < nb; ++blk) {
    const size_t wofs = static_cast<size_t>(blk) * 3 * c * c;
    put(res, g1 + blk * c, b1 + blk * c);
    __syncthreads();
    if (live) conv3(w1 + wofs, cb1 + blk * c, act, c, o, t0, acc);
    __syncthreads();  // every reader of the conv input is done
    put(acc, g2 + blk * c, b2 + blk * c);
    __syncthreads();
    if (live) conv3(w2 + wofs, cb2 + blk * c, act, c, o, t0, acc);
#pragma unroll
    for (int j = 0; j < kTT; ++j) res[j] += acc[j];
    __syncthreads();
  }

  // back through shared memory for a coalesced store
  if (live) {
#pragma unroll
    for (int j = 0; j < kTT; ++j) {
      if (t0 + j < t) act[o * kRow + 1 + t0 + j] = res[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < c * t; i += blockDim.x) {
    const int ch = i / t, col = i - ch * t;
    out[base + i] = act[ch * kRow + 1 + col];
  }
}

}  // namespace

// x and out (B, C, T); w1, w2 (NB, 3, C, C) as [block][tap][in][out]; cb1, cb2,
// g1, b1, g2, b2 (NB, C): float32, contiguous on the device. C <= 64 and
// T <= 48 (the wrapper checks). Returns the launch's cudaGetLastError().
extern "C" int rescnn_f32(const float* x, const float* w1, const float* w2, const float* cb1,
                          const float* cb2, const float* g1, const float* b1, const float* g2,
                          const float* b2, float* out, int b, int c, int t, int nb,
                          void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(c) * kRow;
  rescnn_kernel<<<b, kGroups * kMaxChannels, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w1, w2, cb1, cb2, g1, b1, g2, b2, c, t, nb, out);
  return static_cast<int>(cudaGetLastError());
}
