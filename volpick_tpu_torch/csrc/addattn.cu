// Dense additive (Bahdanau) self-attention of one window per CTA.
//
// Replaces: volpick_tpu/ops/pallas/addattn.py::seq_self_attention_pallas
// (_kernel). With q = x^T Wt + bh and k = x^T Wx projected by the caller,
//   e[t, s]   = sum_u Wa[u] * tanh(q[t, u] + k[s, u])
//   a[t, s]   = exp(e[t, s] - max_s e[t, :]) / (sum_s exp(...) + eps)
//   out[c, t] = sum_s x[c, s] * a[t, s]
// The scalar energy offset `ba` is left out, as in the Pallas kernel: a
// constant shift of every energy cancels under the max-subtracted softmax.
//
// What bounds it on an H100: operations, not bytes. At the EQTransformer step
// (B 232, T 47, U 32, C 16) it evaluates B*T*T*U = 16.4 M tanhf for about
// 4.2 MB of traffic; IEEE tanhf (no --use_fast_math) is some tens of
// operations each.
//
// Design: the Pallas kernel lays the (T, U, T) tanh tensor out for 128 lanes
// and loops over 8 windows a grid step. Here one CTA owns one window and
// keeps q, k, x, Wa and the (T, T) energies in shared memory, so device
// memory is read once and written once:
//   1. the T*T (t, s) pairs are spread evenly over the threads; each loops
//      over u. q and k rows have stride U + 1, so lanes that differ in s hit
//      different banks and lanes that share t read one broadcast word;
//   2. one warp per row t takes the row max and the sum with shuffles and
//      overwrites the energies by the weights;
//   3. the C*T outputs are spread over the threads, lanes along t (the
//      energies' row stride T | 1 is odd: no bank conflicts), and written
//      coalesced.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
addattn_kernel(const float* __restrict__ x, const float* __restrict__ q,
               const float* __restrict__ k, const float* __restrict__ wa, int c, int t, int u,
               float eps, float* __restrict__ out) {
  extern __shared__ float sh[];
  const int us = u + 1;   // q / k row stride
  const int es = t | 1;   // energy row stride
  float* sq = sh;                 // (T, U + 1)
  float* sk = sq + t * us;        // (T, U + 1)
  float* se = sk + t * us;        // (T, T | 1)
  float* sx = se + t * es;        // (C, T)
  float* swa = sx + c * t;        // (U,)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* qb = q + static_cast<size_t>(b) * t * u;
  const float* kb = k + static_cast<size_t>(b) * t * u;
  const float* xb = x + static_cast<size_t>(b) * c * t;
  for (int i = tid; i < t * u; i += kThreads) {
    const int r = i / u, col = i - r * u;
    sq[r * us + col] = qb[i];
    sk[r * us + col] = kb[i];
  }
  for (int i = tid; i < c * t; i += kThreads) sx[i] = xb[i];
  for (int i = tid; i < u; i += kThreads) swa[i] = wa[i];
  __syncthreads();

  // 1: energies
  for (int p = tid; p < t * t; p += kThreads) {
    const int qt = p / t, s = p - qt * t;
    const float* qr = sq + qt * us;
    const float* kr = sk + s * us;
    float e = 0.0f;
    for (int j = 0; j < u; ++j) e += swa[j] * tanhf(qr[j] + kr[j]);
    se[qt * es + s] = e;
  }
  __syncthreads();

  // 2: softmax over s with the full-row max and eps on the denominator
  const int lane = tid & 31, warp = tid >> 5;
  for (int qt = warp; qt < t; qt += kThreads / 32) {
    float* er = se + qt * es;
    float m = -INFINITY;
    for (int s = lane; s < t; s += 32) m = fmaxf(m, er[s]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int s = lane; s < t; s += 32) {
      const float v = expf(er[s] - m);
      er[s] = v;
      sum += v;
    }
    const float denom = warp_sum(sum) + eps;
    for (int s = lane; s < t; s += 32) er[s] = er[s] / denom;
  }
  __syncthreads();

  // 3: values
  float* ob = out + static_cast<size_t>(b) * c * t;
  for (int i = tid; i < c * t; i += kThreads) {
    const int ch = i / t, qt = i - ch * t;
    const float* xr = sx + ch * t;
    const float* ar = se + qt * es;
    float acc = 0.0f;
    for (int s = 0; s < t; ++s) acc += xr[s] * ar[s];
    ob[i] = acc;
  }
}

// Shared memory of one CTA in bytes; the wrapper refuses what exceeds 48 KB.
int smem_bytes(int c, int t, int u) {
  return static_cast<int>(sizeof(float)) * (2 * t * (u + 1) + t * (t | 1) + c * t + u);
}

}  // namespace

// x (B, C, T), q and k (B, T, U), wa (U,), out (B, C, T): float32, contiguous
// on the device. Returns the launch's cudaGetLastError().
extern "C" int addattn_f32(const float* x, const float* q, const float* k, const float* wa,
                           float* out, int b, int c, int t, int u, float eps, void* stream) {
  addattn_kernel<<<b, kThreads, smem_bytes(c, t, u), static_cast<cudaStream_t>(stream)>>>(
      x, q, k, wa, c, t, u, eps, out);
  return static_cast<int>(cudaGetLastError());
}
