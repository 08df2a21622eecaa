// G independent LSTM recurrences (gate order i, f, g, o; zero initial state)
// in one launch.
//
// Replaces: volpick_tpu/ops/pallas/lstm.py::lstm_multi_pallas (_kernel). As
// there, the input projection x_t . W_ih^T + b for all T steps is one large
// matrix product computed by the caller (ops/cuda/lstm.py); this kernel runs
// only the recurrence gates_t = xp_t + W_hh . h_{t-1}.
//
// What bounds it on an H100: latency. On EQTransformer's main path
// (G = 2, H = 16, T = 47, B = 232 windows) each step is a 64 x 16 by 16 x B
// product per branch: ~0.2 MFLOP per step against a 47-step dependent chain.
// Bytes are small too (xp is 2 x 47 x 232 x 64 floats = 5.6 MB, read once).
//
// Design: one CTA per (branch g, tile of kTileB windows), one thread per
// (window, hidden unit). W_hh[g] (4H x H floats, 4 KB at H = 16) is staged
// once into shared memory, transposed so that the threads of one window read
// consecutive addresses; h lives in shared memory (each unit needs the whole
// previous h of its window) and c in a register for all T steps, so the only
// device-memory traffic per step is the projected input and the output h.
// The TPU kernel's block-diagonal gate-major W_hh packing served the 128-wide
// MXU tile and has no use here. Reverse directions are the caller's time
// flip, as in volpick_tpu/models/layers.py::bilstm.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileB = 8;  // windows per CTA: 128 threads at H = 16

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// xp (G, T, B, 4H), whh (G, 4H, H), out (G, B, H, T); blockDim = kTileB * H;
// dynamic shared memory = (4H*H + kTileB*H) floats.
__global__ void lstm_multi_kernel(const float* __restrict__ xp, const float* __restrict__ whh,
                                  float* __restrict__ out, int b_total, int t_steps, int h) {
  extern __shared__ float smem[];
  const int four_h = 4 * h;
  float* w_t = smem;                // (H, 4H): w_t[v * 4H + r] = W_hh[g][r][v]
  float* hs = smem + four_h * h;    // (kTileB, H) previous hidden state

  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lb = tid / h;
  const int u = tid % h;
  const int b = blockIdx.x * kTileB + lb;
  const bool active = b < b_total;

  const float* w = whh + static_cast<size_t>(g) * four_h * h;
  for (int i = tid; i < four_h * h; i += blockDim.x) {
    const int r = i / h;
    const int v = i % h;
    w_t[v * four_h + r] = w[i];
  }
  hs[tid] = 0.0f;
  float c = 0.0f;
  __syncthreads();

  const float* h_prev = hs + lb * h;
  for (int t = 0; t < t_steps; ++t) {
    float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
    if (active) {
      for (int v = 0; v < h; ++v) {
        const float hv = h_prev[v];
        const float* wr = w_t + v * four_h;
        ai = fmaf(wr[u], hv, ai);
        af = fmaf(wr[h + u], hv, af);
        ag = fmaf(wr[2 * h + u], hv, ag);
        ao = fmaf(wr[3 * h + u], hv, ao);
      }
    }
    __syncthreads();  // every thread has read h_{t-1}
    if (active) {
      const float* x = xp + ((static_cast<size_t>(g) * t_steps + t) * b_total + b) * four_h;
      const float i_gate = sigmoid(x[u] + ai);
      const float f_gate = sigmoid(x[h + u] + af);
      const float g_gate = tanhf(x[2 * h + u] + ag);
      const float o_gate = sigmoid(x[3 * h + u] + ao);
      c = f_gate * c + i_gate * g_gate;
      const float hn = o_gate * tanhf(c);
      hs[tid] = hn;
      out[((static_cast<size_t>(g) * b_total + b) * h + u) * t_steps + t] = hn;
    }
    __syncthreads();  // h_t complete before the next step reads it
  }
}

}  // namespace

// xp (G, T, B, 4H), whh (G, 4H, H), out (G, B, H, T), float32, contiguous on
// the device. Returns the launch's cudaGetLastError().
extern "C" int lstm_multi_f32(const float* xp, const float* whh, float* out, int g, int b,
                              int t, int h, void* stream) {
  const dim3 grid((b + kTileB - 1) / kTileB, g);
  const int threads = kTileB * h;
  const size_t smem = static_cast<size_t>(4 * h * h + kTileB * h) * sizeof(float);
  lstm_multi_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, whh, out, b, t, h);
  return static_cast<int>(cudaGetLastError());
}
