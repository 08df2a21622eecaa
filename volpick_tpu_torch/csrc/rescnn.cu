// EQTransformer's residual CNN stack: a few windows per CTA, the activation
// resident on the SM across all blocks, every conv's weights staged in shared
// memory by one bulk copy while the conv before it runs.
//
// Replaces: volpick_tpu/ops/pallas/rescnn.py::res_cnn_stack_pallas (_kernel).
// For each of the NB pre-activation residual blocks, with eval-mode
// BatchNorm folded to per-channel affines (g, b) by the wrapper:
//   y = conv1(relu(x * g1 + b1)) + cb1
//   y = conv2(relu(y * g2 + b2)) + cb2
//   x = x + y
// Every conv is three taps over offsets (-1, 0, +1) with zero padding,
// w[tap][in][out]; a kernel-2 conv arrives as taps (0, +1) with a zero -1 tap.
// A sum runs over the input channels in order and, inside one, over taps
// -1, 0, +1.
//
// What bounds it on an H100: operations. At the EQTransformer step (B 232,
// C 64, T 47, NB 7) the 42 tap products are 232 x 47 x 42 x 64 x 64 x 2 =
// 3.7 GFLOP of float32 (about 56 us at the 67 TFLOP/s the H100 SXM data sheet
// gives outside the tensor cores; float32 parity rules plain TF32 / bf16 mma
// out), against 5.6 MB of activations in and out and 0.69 MB of weights.
//
// Design. Seen as a product, one conv is (windows x T) rows by 64 columns
// over a depth of 3 x 64. What the multiply-add pipe has to wait for is
// operands, so the design is about loads for each multiply-add:
// - A thread owns kCO output channels x kTT = 12 consecutive time steps of one
//   window, kCO x 12 sums in registers. For one input channel it reads the 14
//   inputs around its steps (two words and three 16-byte loads, the same
//   address for every lane of its time group) and, for each tap, its kCO
//   weights in one 8- or 16-byte load: 8 loads feed 36 kCO multiply-adds.
//   The operands of the next input channel are loaded while this one's
//   multiply-adds are issued.
// - A conv's weights, 48 KB as [tap][in][out], lie in shared memory. Two such
//   buffers: one thread asks for the weights of the conv after next
//   (cp.async.bulk, completion on an mbarrier a buffer) as soon as every
//   thread has left the buffer they go to.
// - The residual stays in registers from the first block to the last. The
//   conv input relu(affine(.)) alternates between two buffers a window, so a
//   conv's output is written (conv 1 -> buffer B, conv 2 -> buffer A) while
//   other warps still read its input: two __syncthreads() a block.
// - A row of a buffer is one channel: kRow = 56 words, time step t at column
//   t + 4, zeros at columns 3 and T + 4 ... 52 (taps -1 and +1 need no
//   branch), so that a thread's own 12 columns are three aligned 16-byte
//   stores. Row ch starts 4 (ch / kCO) words late: the rows that the lanes of
//   a quarter warp store to then fall into different banks.
// - The folded affines and conv biases of a block, 6 x 64 floats, are read a
//   block ahead into registers and handed over in shared memory.
// - A CTA takes `wpc` windows (the caller's plan: as few as give every SM at
//   most one CTA, so the staged weights serve all of an SM's windows), four
//   time groups x 64 / kCO threads a window.
// - The CTA's windows are contiguous in device memory: one bulk copy brings
//   them into the second weight buffer (free until the second conv), one
//   takes the result out of the first.
// C < 64 (or arrays that are not 16-byte aligned) takes the instantiation
// that copies each conv's weights with plain loads into one padded buffer.
//
// -DRESCNN_CO=2 halves a thread's channels (twice the threads a window);
// -DRESCNN_UNROLL=<n> sets how many input channels the loop body holds.
// -DRESCNN_SKIP=<bits> compiles a phase out, for timing only (the result is
// wrong): 1 the multiply-adds, 2 the operand loads from shared memory, 4 the
// staging of weights, 8 the stores of relu(affine(.)).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RESCNN_CO
#define RESCNN_CO 4
#endif
#ifndef RESCNN_SKIP
#define RESCNN_SKIP 0
#endif
#ifndef RESCNN_UNROLL
#define RESCNN_UNROLL 2
#endif
#define RESCNN_PRAGMA(x) _Pragma(#x)
#define RESCNN_UNROLL_BY(n) RESCNN_PRAGMA(unroll n)

namespace {

constexpr int kCO = RESCNN_CO;     // output channels a thread owns
constexpr int kTT = 12;            // time steps a thread owns
constexpr int kGroups = 4;         // time groups of a window (T <= 48)
constexpr int kMaxChannels = 64;
constexpr int kLanes = kMaxChannels / kCO;  // threads of a time group
constexpr int kWinThreads = kGroups * kLanes;
constexpr int kMaxWindows = 4;     // windows a CTA
constexpr int kRow = 56;           // words of a channel's row
constexpr int kCol0 = 4;           // column of time step 0
constexpr int kActWords = kMaxChannels * kRow + 4 * kLanes;  // one buffer of one window
constexpr int kWeightWords = 3 * kMaxChannels * kMaxChannels;
constexpr int kParamWords = 6 * kMaxChannels;  // g1, b1, g2, b2, cb1, cb2 of a block
constexpr int kParamLoads = (kParamWords + kWinThreads - 1) / kWinThreads;

static_assert(kCO == 2 || kCO == 4, "a thread's weights of a tap are one 8- or 16-byte load");

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

// Start of channel ch's row in an activation buffer.
__device__ __forceinline__ int row_at(int ch) { return ch * kRow + 4 * (ch / kCO); }

// What a thread needs of one input channel: its 14 inputs and 3 x kCO weights.
struct Operands {
  float in[kTT + 2];
  float w[3][kCO];
};

// `a` points at column 3 + first step of the thread in row 0, `w` at the
// thread's first output channel of tap 0, input channel 0.
__device__ __forceinline__ void load_operands(Operands& op, const float* a, const float* w, int i) {
#if RESCNN_SKIP & 2
  // whatever the registers hold, opaque to the compiler: no instruction
#pragma unroll
  for (int j = 0; j < kTT + 2; ++j) asm volatile("" : "=f"(op.in[j]));
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
    for (int k = 0; k < kCO; ++k) asm volatile("" : "=f"(op.w[tap][k]));
  }
#else
  const float* row = a + row_at(i);
  op.in[0] = row[0];
#pragma unroll
  for (int q = 0; q < kTT / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(row + 1 + 4 * q);
    op.in[1 + 4 * q] = v.x, op.in[2 + 4 * q] = v.y, op.in[3 + 4 * q] = v.z, op.in[4 + 4 * q] = v.w;
  }
  op.in[kTT + 1] = row[kTT + 1];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    const float* wp = w + (tap * kMaxChannels + i) * kMaxChannels;
    if (kCO == 4) {
      const float4 v = *reinterpret_cast<const float4*>(wp);
      op.w[tap][0] = v.x, op.w[tap][1] = v.y, op.w[tap][2 % kCO] = v.z, op.w[tap][3 % kCO] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(wp);
      op.w[tap][0] = v.x, op.w[tap][1] = v.y;
    }
  }
#endif
}

// The multiply-adds of one input channel: acc[k][j] += w[tap][k] * in[j + tap].
__device__ __forceinline__ void multiply_add(const Operands& cur, float (&acc)[kCO][kTT]) {
#if RESCNN_SKIP & 1
  // the operands are wanted in registers, and nothing is done with them
#pragma unroll
  for (int j = 0; j < kTT + 2; ++j) asm volatile("" ::"f"(cur.in[j]));
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
    for (int k = 0; k < kCO; ++k) asm volatile("" ::"f"(cur.w[tap][k]));
  }
#else
#pragma unroll
  for (int j = 0; j < kTT; ++j) {
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
      for (int k = 0; k < kCO; ++k) acc[k][j] += cur.w[tap][k] * cur.in[j + tap];
    }
  }
#endif
}

// One conv of the stack for this thread's tile:
// acc[k][j] = bias[k] + sum_i sum_tap w[tap][i][oc0 + k] * input[i][t0 + j + tap - 1].
__device__ __forceinline__ void conv3(const float* a, const float* w, const float* bias, int c,
                                      float (&acc)[kCO][kTT]) {
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
#pragma unroll
    for (int j = 0; j < kTT; ++j) acc[k][j] = bias[k];
  }
  Operands cur, nxt;
  load_operands(cur, a, w, 0);
RESCNN_UNROLL_BY(RESCNN_UNROLL)
  for (int i = 0; i < c; ++i) {
    load_operands(nxt, a, w, min(i + 1, c - 1));
    multiply_add(cur, acc);
    cur = nxt;
  }
}

// relu(v * g + b) of the thread's tile into its columns of `dst` (the start of
// its first channel's columns); the steps past T are written as zeros, the
// right-hand padding of the last valid one.
__device__ __forceinline__ void put(float* dst, const float (&v)[kCO][kTT], const float* g,
                                    const float* b, int t0, int t) {
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
    float r[kTT];
#pragma unroll
    for (int j = 0; j < kTT; ++j) r[j] = t0 + j < t ? fmaxf(v[k][j] * g[k] + b[k], 0.0f) : 0.0f;
#if RESCNN_SKIP & 8
    if (t >= 0) continue;  // always: the values are computed and not stored
#endif
#pragma unroll
    for (int q = 0; q < kTT / 4; ++q) {
      *reinterpret_cast<float4*>(dst + k * kRow + 4 * q) =
          make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    }
  }
}

struct Params {
  const float* p[6];  // g1, b1, g2, b2, cb1, cb2, each (NB, C)
};

// kBulk: C == 64 and 16-byte aligned arrays: weights staged two convs ahead
// by bulk copies, the CTA's windows in and out by one bulk copy each; else
// every conv's weights are copied by all threads into buffer 0, padded to
// 64 x 64 with zeros, and the windows move by plain loads and stores.
template <bool kBulk>
__global__ void __launch_bounds__(kMaxWindows * kWinThreads)
rescnn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ w2, Params params, int b, int c, int t, int nb,
              float* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[3];  // a weight buffer each, and the windows
  const int wpc = blockDim.x / kWinThreads;
  float* wbuf = smem;                                 // [2][kWeightWords]
  float* pbuf = wbuf + 2 * kWeightWords;              // [2][kParamWords]
  float* act = pbuf + 2 * kParamWords;                // [wpc][2][kActWords]

  const int tid = threadIdx.x;
  const int og = tid % kLanes;
  const int tg = (tid / kLanes) % kGroups;
  const int win = tid / kWinThreads;
  const int oc0 = og * kCO;
  const int t0 = tg * kTT;
  const int first = blockIdx.x * wpc;  // the CTA's first window
  const int n_win = min(wpc, b - first);
  const size_t ct = static_cast<size_t>(c) * t;

  float* buf_a = act + (2 * win) * kActWords;
  float* buf_b = buf_a + kActWords;
  // the thread's own columns (stores) and what it reads of row 0 (loads)
  const int own = row_at(oc0) + kCol0 + t0;
  const int rd = kCol0 - 1 + t0;
  const float* wmine = wbuf + oc0;

  const auto weights_of = [&](int n) {
    return (n & 1 ? w2 : w1) + static_cast<size_t>(n >> 1) * 3 * c * c;
  };
  // element e of block blk's parameters (zero for a channel past C)
  const auto param = [&](int blk, int e) {
    const int ch = e % kMaxChannels;
    return ch < c ? params.p[e / kMaxChannels][blk * c + ch] : 0.0f;
  };

  // ---- set-up: barriers; the first conv's weights and the CTA's windows on
  // their way (the windows, contiguous in x, into the second weight buffer);
  // zeros in the activation buffers; block 0's parameters; the windows into
  // buffer B; then the second conv's weights
  const int n_conv = 2 * nb;
  constexpr uint32_t kWeightBytes = kWeightWords * sizeof(float);
  const uint32_t win_bytes = static_cast<uint32_t>(n_win * ct * sizeof(float));
  float* raw = wbuf + kWeightWords;  // (n_win, C, T) as in device memory
  if (kBulk && tid == 0) {
    barrier_init(&full[0]);
    barrier_init(&full[1]);
    barrier_init(&full[2]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (!(RESCNN_SKIP & 4)) bulk_load(wbuf, weights_of(0), kWeightBytes, &full[0]);
    bulk_load(raw, x + static_cast<size_t>(first) * ct, win_bytes, &full[2]);
  }
  for (int i = tid; i < wpc * 2 * kActWords; i += blockDim.x) act[i] = 0.0f;
  for (int e = tid; e < kParamWords; e += blockDim.x) pbuf[e] = param(0, e);
  __syncthreads();
  if (kBulk) {
    barrier_wait(&full[2], 0);
    // a (window, channel) row a thread: lanes read T words apart
    for (int r = tid; r < n_win * kMaxChannels; r += blockDim.x) {
      const float* src = raw + r * t;
      float* dst = act + (2 * (r / kMaxChannels) + 1) * kActWords + row_at(r % kMaxChannels) + kCol0;
      for (int col = 0; col < t; ++col) dst[col] = src[col];
    }
  } else {
    const float* src = x + static_cast<size_t>(first) * ct;
    for (int e = tid; e < n_win * static_cast<int>(ct); e += blockDim.x) {
      const int wi = e / static_cast<int>(ct), r = e - wi * static_cast<int>(ct);
      const int ch = r / t, col = r - ch * t;
      act[(2 * wi + 1) * kActWords + row_at(ch) + kCol0 + col] = src[e];
    }
  }
  __syncthreads();
  if (kBulk && !(RESCNN_SKIP & 4) && tid == 0 && n_conv > 1) {
    bulk_load(raw, weights_of(1), kWeightBytes, &full[1]);  // the windows have left the buffer
  }
  float res[kCO][kTT], acc[kCO][kTT];
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
#pragma unroll
    for (int j = 0; j < kTT; ++j) res[k][j] = buf_b[own + k * kRow + j];
  }
  // the parameters of the block after this one, on their way through registers
  float pre[kParamLoads];
  const auto fetch = [&](int blk) {
#pragma unroll
    for (int q = 0; q < kParamLoads; ++q) {
      const int e = tid + q * blockDim.x;
      pre[q] = (blk < nb && e < kParamWords) ? param(blk, e) : 0.0f;
    }
  };
  fetch(1);

  // conv n reads its weights from buffer n % 2 (kBulk) or 0
  const auto stage = [&](int n) -> const float* {
    if (RESCNN_SKIP & 4) return wmine;
    if (kBulk) {
      barrier_wait(&full[n & 1], (n >> 1) & 1);
      return wmine + (n & 1) * kWeightWords;
    }
    const float* src = weights_of(n);
    __syncthreads();  // the conv before this one has read the buffer
    for (int e = tid; e < kWeightWords; e += blockDim.x) {
      const int o = e % kMaxChannels, ti = e / kMaxChannels;
      const int i = ti % kMaxChannels, tap = ti / kMaxChannels;
      wbuf[e] = (o < c && i < c) ? src[(tap * c + i) * c + o] : 0.0f;
    }
    __syncthreads();
    return wmine;
  };
  // every thread is past conv n: its buffer takes the weights of conv n + 2
  const auto refill = [&](int n) {
    if (kBulk && !(RESCNN_SKIP & 4) && tid == 0 && n >= 0 && n + 2 < n_conv) {
      bulk_load(wbuf + (n & 1) * kWeightWords, weights_of(n + 2), kWeightBytes, &full[n & 1]);
    }
  };

  for (int blk = 0; blk < nb; ++blk) {
    const float* pb = pbuf + (blk & 1) * kParamWords + oc0;
    put(buf_a + own, res, pb, pb + kMaxChannels, t0, t);
    __syncthreads();  // buffer A is whole; conv 2 of the block before is read
    refill(2 * blk - 1);
    {
      // nobody reads the other parameter buffer any more (block blk - 1's)
      float* next = pbuf + ((blk + 1) & 1) * kParamWords;
#pragma unroll
      for (int q = 0; q < kParamLoads; ++q) {
        const int e = tid + q * blockDim.x;
        if (e < kParamWords) next[e] = pre[q];
      }
    }
    conv3(buf_a + rd, stage(2 * blk), pb + 4 * kMaxChannels, c, acc);
    put(buf_b + own, acc, pb + 2 * kMaxChannels, pb + 3 * kMaxChannels, t0, t);
    __syncthreads();  // buffer B is whole; conv 1 is read
    refill(2 * blk);
    fetch(blk + 2);
    conv3(buf_b + rd, stage(2 * blk + 1), pb + 5 * kMaxChannels, c, acc);
#pragma unroll
    for (int k = 0; k < kCO; ++k) {
#pragma unroll
      for (int j = 0; j < kTT; ++j) res[k][j] += acc[k][j];
    }
  }

  if (kBulk) {
    // out through the first weight buffer, laid out as in device memory, in
    // one bulk copy: the last conv read the second buffer, and every thread
    // has left the first (the barrier of the last block)
#pragma unroll
    for (int k = 0; k < kCO; ++k) {
      float* dst = wbuf + (win * kMaxChannels + oc0 + k) * t + t0;
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
        if (t0 + j < t) dst[j] = res[k][j];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                       out + static_cast<size_t>(first) * ct),
                   "r"(shared_address(wbuf)), "r"(win_bytes)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // shared memory outlives its reader
    }
    return;
  }
  // back through buffer A for a coalesced store (buffer A: conv 2 may still
  // be reading B in another warp)
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
#pragma unroll
    for (int q = 0; q < kTT / 4; ++q) {
      *reinterpret_cast<float4*>(buf_a + own + k * kRow + 4 * q) =
          make_float4(res[k][4 * q], res[k][4 * q + 1], res[k][4 * q + 2], res[k][4 * q + 3]);
    }
  }
  __syncthreads();
  {
    float* dst = out + static_cast<size_t>(first) * ct;
    for (int e = tid; e < n_win * static_cast<int>(ct); e += blockDim.x) {
      const int wi = e / static_cast<int>(ct), r = e - wi * static_cast<int>(ct);
      const int ch = r / t, col = r - ch * t;
      dst[e] = act[(2 * wi) * kActWords + row_at(ch) + kCol0 + col];
    }
  }
}

size_t shared_bytes(int wpc) {
  return sizeof(float) *
         (2 * kWeightWords + 2 * kParamWords + static_cast<size_t>(wpc) * 2 * kActWords);
}

}  // namespace

// Dynamic shared memory of a launch with `wpc` windows a CTA; what the
// wrapper's plan reports.
extern "C" int rescnn_shared_bytes(int wpc) { return static_cast<int>(shared_bytes(wpc)); }

// Output channels a thread owns in this build (RESCNN_CO).
extern "C" int rescnn_channels_per_thread() { return kCO; }

// x and out (B, C, T); w1, w2 (NB, 3, C, C) as [block][tap][in][out]; cb1, cb2,
// g1, b1, g2, b2 (NB, C): float32, contiguous on the device. C <= 64 and
// T <= 48 (the wrapper checks); `wpc` windows a CTA, 1 ... 4. Returns
// cudaErrorInvalidValue (1) for a wpc out of range, else the launch's error.
extern "C" int rescnn_f32(const float* x, const float* w1, const float* w2, const float* cb1,
                          const float* cb2, const float* g1, const float* b1, const float* g2,
                          const float* b2, float* out, int b, int c, int t, int nb, int wpc,
                          void* stream) {
  if (wpc < 1 || wpc > kMaxWindows || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // both instantiations may take the largest launch's shared memory
  if (!opted_in) {
    const int most = static_cast<int>(shared_bytes(kMaxWindows));
    cudaError_t err = cudaFuncSetAttribute(rescnn_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(rescnn_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const Params params = {{g1, b1, g2, b2, cb1, cb2}};
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool bulk = c == kMaxChannels && aligned(w1) && aligned(w2) && aligned(x) && aligned(out);
  const int ctas = (b + wpc - 1) / wpc;
  const size_t smem = shared_bytes(wpc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk) {
    rescnn_kernel<true><<<ctas, wpc * kWinThreads, smem, s>>>(x, w1, w2, params, b, c, t, nb, out);
  } else {
    rescnn_kernel<false><<<ctas, wpc * kWinThreads, smem, s>>>(x, w1, w2, params, b, c, t, nb, out);
  }
  return static_cast<int>(cudaGetLastError());
}
