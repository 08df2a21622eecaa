// Two-threshold trigger scan: the scanned state at every position of every
// curve, no pick emission. A row is split into pieces, one warp a piece.
//
// Replaces: volpick_tpu/ops/pallas/triggers.py::trigger_scan_pallas_raw
// (_kernel). For prob (B, W) and per-row thresholds t1/t2 it writes, at
// every position i, the inclusive segmented scan of the trigger monoid over
// x[0..i]: onset (first > t1 index of the current > t2 run, INT32_MAX while
// the run has not crossed t1), max and argmax (first occurrence) of the run.
// The caller reads picks off at run ends. Positions outside a run keep the
// state of the last run before them; before the first run of a row they hold
// (INT32_MAX, -3.4e38, 0), the Pallas kernel's finite stand-in for -inf.
//
// What bounds it on an H100: bytes. It reads the curves once and writes three
// arrays of their size: 4 x 11.5 MB for 24 x 120000 floats, about 14 us at
// the 3.35 TB/s of the H100 SXM data sheet. The scan itself is a few compares
// and selects a sample, but they add up: at some tens of instructions a sample the
// instruction issue, not the memory, sets the pace, so the design also counts
// instructions.
//
// Design: the Pallas kernel carries the scan state in VMEM scratch from one
// column chunk to the next, which relies on the TPU running the grid in
// order. CUDA blocks run in no order, so the carry between the pieces of a
// row goes through device memory, in two launches:
//   1. trigger_scan_kernel_summaries (rows of more than one piece only): a
//      warp folds every piece but a row's last into one 16-byte summary. A
//      lane folds a contiguous 1/32 of the piece sample by sample (its loads
//      four quads ahead, or their latency sets the pace) and one warp scan
//      joins the 32 stretches: a third of the instructions of the scan below,
//      which has to keep neighbouring lanes on neighbouring bytes;
//   2. trigger_scan_kernel: a warp folds the summaries on the left of its
//      piece into its carry (32 a step, by warp scan), then walks its piece in
//      steps of 128 samples from that carry and writes the three outputs. The
//      second read of the curves comes from the 50 MB L2 at the main path's
//      size.
// The caller picks the piece length (a multiple of the step) so that a few
// thousand warps are in flight whether the rows are few and long (24 x
// 120000: 86 pieces of 1408 a row) or many and short (3000 x 6000: one piece
// a row, and then only launch 2).
// A warp shares nothing with the other warps of its CTA: no shared memory, no
// barrier. A decoupled look-back in one launch would save the second read; it
// was not taken, because a spin on a neighbour's flag needs that neighbour to
// be resident, which a launch does not promise.
// In a step a lane loads 4 neighbouring samples as one float4, folds them
// (fold_quad), the warp scans its 32 stretches with shuffles (warp_prefix) and
// the lane stores its four states as int4 / float4 / int4: neighbouring lanes
// on neighbouring 16 bytes, in loads and stores. The next step's samples are
// loaded before the present step is scanned. A row whose start is not 16-byte
// aligned (W not a multiple of 4) is walked on a grid shifted left by
// (row * W) mod 4 samples, so that its quads are aligned all the same; the
// quads that stick out of the row at its head and tail take the scalar path,
// as does every quad when one of the four arrays is itself not 16-byte aligned.
// A sample's state needs to know whether its left neighbour lies above t2:
// that sample comes from the lane on the left by shuffle, and lane 0 reads it
// from device memory, so step and piece boundaries need no halo.

#include "trigger_monoid.cuh"

namespace {

constexpr float kOutside = -3.4e38f;  // max of a stretch outside any run
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kBatch = 4;  // launch 1: quads a lane loads before it folds them

// Launch 1: warp `wid` of B * (n_pieces - 1) folds piece wid % (n_pieces - 1)
// of row wid / (n_pieces - 1) into summaries[wid]. `piece` is a multiple of
// kStep; `vec`: all four arrays of the scan are 16-byte aligned.
__global__ void __launch_bounds__(kScanThreads)
trigger_scan_kernel_summaries(const float* __restrict__ prob, const float* __restrict__ t1s,
                              const float* __restrict__ t2s, int w, int piece, int n_pieces,
                              long long n_warps, int vec, int4* __restrict__ summaries) {
  const int lane = threadIdx.x & 31;
  const long long wid = static_cast<long long>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  if (wid >= n_warps) return;
  const int row = static_cast<int>(wid / (n_pieces - 1));
  const int p = static_cast<int>(wid - static_cast<long long>(row) * (n_pieces - 1));
  const long long row0 = static_cast<long long>(row) * w;
  const float* x = prob + row0;
  const float t1 = t1s[row];
  const float t2 = t2s[row];
  const int shift = vec ? static_cast<int>(row0 & 3) : 0;  // sample i sits at i + shift
  const int per = piece / 32;                              // samples a lane folds, a multiple of 4
  const int first = p * piece + lane * per - shift;        // this lane's first sample in the row

  State acc = identity(kOutside);
  float prev = load_prev(x, first, w);
  const int end = min(first + per, w);
  for (int base = first; base < end; base += 4 * kBatch) {
    float v[kBatch][4];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (base + 4 * k < end) load_quad(x, base + 4 * k, w, vec, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (base + 4 * k < end) {
        State st[4];
        fold_quad(v[k], prev, base + 4 * k, w, t1, t2, kOutside, st);
        acc = combine(acc, st[3]);
        prev = v[k][3];
      }
    }
  }
  acc = warp_scan(acc);
  if (lane == 31) summaries[wid] = make_int4(acc.flag, acc.on, __float_as_int(acc.m), acc.am);
}

// Launch 2: warp `wid` of B * n_pieces scans piece wid % n_pieces of row
// wid / n_pieces from the summaries on its left and writes the outputs.
__global__ void __launch_bounds__(kScanThreads)
trigger_scan_kernel(const float* __restrict__ prob, const float* __restrict__ t1s,
                    const float* __restrict__ t2s, int w, int piece, int n_pieces,
                    long long n_warps, int vec, const int4* __restrict__ summaries,
                    int* __restrict__ onset, float* __restrict__ run_max,
                    int* __restrict__ run_argmax) {
  const int lane = threadIdx.x & 31;
  const long long wid = static_cast<long long>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  if (wid >= n_warps) return;
  const int row = static_cast<int>(wid / n_pieces);
  const int p = static_cast<int>(wid - static_cast<long long>(row) * n_pieces);
  const long long row0 = static_cast<long long>(row) * w;
  const float* x = prob + row0;
  const float t1 = t1s[row];
  const float t2 = t2s[row];
  const int shift = vec ? static_cast<int>(row0 & 3) : 0;  // sample i sits at i + shift
  const int lo = p * piece;
  const int hi = min(lo + piece, w + shift);

  State carry = identity(kOutside);
  const int4* left = summaries + static_cast<long long>(row) * (n_pieces - 1);
  for (int j0 = 0; j0 < p; j0 += 32) {
    State s = identity(kOutside);
    if (j0 + lane < p) {
      const int4 q = left[j0 + lane];
      s.flag = q.x, s.on = q.y, s.m = __int_as_float(q.z), s.am = q.w;
    }
    carry = combine(carry, shfl_state(warp_scan(s), 31));
  }

  float next[4];
  load_quad(x, lo + lane * 4 - shift, w, vec, next);
  float next_prev = lane == 0 ? load_prev(x, lo - shift, w) : 0.0f;
  for (int t0 = lo; t0 < hi; t0 += kStep) {
    const int i0 = t0 + lane * 4 - shift;  // this lane's first sample in the row
    const float v[4] = {next[0], next[1], next[2], next[3]};
    float prev = __shfl_up_sync(kFullMask, v[3], 1);
    if (lane == 0) prev = next_prev;
    if (t0 + kStep < hi) {  // in flight while this step is scanned
      load_quad(x, i0 + kStep, w, vec, next);
      if (lane == 0) next_prev = load_prev(x, i0 + kStep, w);
    }

    State st[4];
    fold_quad(v, prev, i0, w, t1, t2, kOutside, st);
    const State before = warp_prefix(st[3], carry, kOutside);
    int on[4], am[4];
    float m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const State o = combine(before, st[j]);
      on[j] = o.on, m[j] = o.m, am[j] = o.am;
    }
    if (vec && i0 >= 0 && i0 + 4 <= w) {
      *reinterpret_cast<int4*>(onset + row0 + i0) = make_int4(on[0], on[1], on[2], on[3]);
      *reinterpret_cast<float4*>(run_max + row0 + i0) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<int4*>(run_argmax + row0 + i0) = make_int4(am[0], am[1], am[2], am[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j >= 0 && i0 + j < w) {
          onset[row0 + i0 + j] = on[j];
          run_max[row0 + i0 + j] = m[j];
          run_argmax[row0 + i0 + j] = am[j];
        }
      }
    }
  }
}

}  // namespace

// prob (B, W), t1/t2 (B,) float32, contiguous on the device; outputs (B, W)
// int32 / float32 / int32. `piece` (a multiple of 128) and `n_pieces` (with
// n_pieces * piece >= W, and >= W + 3 where W is not a multiple of 4: room for
// the shifted grid) are the caller's split of a row; `summaries` is scratch of
// B * (n_pieces - 1) * 16 bytes, 16-byte aligned, not read when n_pieces is 1.
// Returns cudaErrorInvalidValue (1) for a split that does not cover the row,
// else the last launch's cudaGetLastError().
extern "C" int trigger_scan_f32(const float* prob, const float* t1, const float* t2, int b,
                                int w, int piece, int n_pieces, void* summaries, int* onset,
                                float* run_max, int* run_argmax, void* stream) {
  const long long n_warps = static_cast<long long>(b) * n_pieces;
  if (piece < kStep || piece % kStep != 0 || n_pieces < 1 ||
      static_cast<long long>(piece) * n_pieces < static_cast<long long>(w) + (w % 4 ? 3 : 0) ||
      n_warps / kScanWarps >= 2147483647LL ||
      (n_pieces > 1 && reinterpret_cast<uintptr_t>(summaries) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(prob) | reinterpret_cast<uintptr_t>(onset) |
                         reinterpret_cast<uintptr_t>(run_max) |
                         reinterpret_cast<uintptr_t>(run_argmax);
  const int vec = bits % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* summ = static_cast<int4*>(summaries);
  if (n_pieces > 1) {
    const long long first = static_cast<long long>(b) * (n_pieces - 1);
    trigger_scan_kernel_summaries<<<static_cast<unsigned>((first + kScanWarps - 1) / kScanWarps),
                                    kScanThreads, 0, s>>>(prob, t1, t2, w, piece, n_pieces, first,
                                                          vec, summ);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  trigger_scan_kernel<<<static_cast<unsigned>((n_warps + kScanWarps - 1) / kScanWarps),
                        kScanThreads, 0, s>>>(prob, t1, t2, w, piece, n_pieces, n_warps, vec, summ,
                                              onset, run_max, run_argmax);
  return static_cast<int>(cudaGetLastError());
}
