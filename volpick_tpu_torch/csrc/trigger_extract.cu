// Two-threshold trigger extraction with pick emission, one CTA per curve.
//
// Replaces: volpick_tpu/ops/pallas/triggers.py::trigger_extract_pallas
// (_extract_kernel). Semantics are obspy's trigger_onset(prob, t1, t2) plus
// an in-trigger argmax, as specified by volpick_tpu/ops/triggers.py: for every
// maximal run of samples with prob > t2 that contains a sample > t1, emit
// (peak = first argmax over the run, peak value, onset = first > t1 index of
// the run, offset = last index of the run). A run that reaches the row end
// ends at W-1. The first K picks of each row are kept, in time order;
// unused slots hold idx/onset/offset = -1 and value 0.
//
// What bounds it on an H100: not bytes (a 24 x 120000 float curve batch is
// 11.5 MB, ~3.4 us at the 3.35 TB/s of the H100 SXM data sheet, and stays in
// the 50 MB L2 across the three passes) but the serial dependence of the
// segmented scan and the small row count: the main path hands it 24 rows for
// 132 SMs.
//
// Design: the Pallas kernel carries the scan state in VMEM from one column
// chunk to the next, which relies on the TPU running the grid in order.
// CUDA blocks run in no order, so here one CTA owns a whole row and the
// carry never leaves the block:
//   1. each thread folds its contiguous segment of the row into a summary
//      (flag, onset, max, argmax) with the segmented-scan monoid;
//   2. a block-wide Hillis-Steele scan of the summaries gives every thread
//      the state carried into its segment;
//   3. each thread re-folds its segment from that carry and counts the run
//      ends it emits; an exclusive block scan of the counts gives each
//      emission its global slot, so picks land in time order;
//   4. threads whose first slot is < K fold once more and write their picks.
// Dense curves (a run every other sample) only raise the per-thread counts;
// the cost stays three passes over the row. Rows run on separate CTAs; a
// chunk-parallel split of each row over several CTAs is left to later work.

#include "trigger_monoid.cuh"

namespace {

constexpr float kOutside = -INFINITY;  // max of a stretch outside any run

// Block-wide inclusive sum; on return sh[t] holds thread t's inclusive sum.
__device__ int scan_counts(int v, int* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    int left = 0;
    if (tid >= d) left = sh[tid - d];
    __syncthreads();
    if (tid >= d) {
      v += left;
      sh[tid] = v;
    }
    __syncthreads();
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
trigger_extract_kernel(const float* __restrict__ prob, const float* __restrict__ t1s,
                       const float* __restrict__ t2s, int w, int k,
                       int* __restrict__ peak_idx, float* __restrict__ peak_val,
                       uint8_t* __restrict__ valid, int* __restrict__ onset,
                       int* __restrict__ offset) {
  __shared__ State sh_state[kThreads];
  __shared__ int sh_count[kThreads];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = prob + static_cast<size_t>(row) * w;
  const float t1 = t1s[row];
  const float t2 = t2s[row];
  const int seg = (w + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * seg, w);
  const int hi = min(lo + seg, w);

  // 1 + 2: segment summaries, then the state carried into each segment
  const auto skip = [](int, const State&) {};
  const State summary = fold(x, lo, hi, w, t1, t2, kOutside, identity(kOutside), skip,
                             [](int, const State&) { return true; });
  scan_states(summary, sh_state, kOutside);
  const State carry = tid > 0 ? sh_state[tid - 1] : identity(kOutside);

  // 3: emissions per segment -> first slot of each segment
  int count = 0;
  fold(x, lo, hi, w, t1, t2, kOutside, carry, skip, [&](int, const State&) {
    ++count;
    return true;
  });
  const int incl = scan_counts(count, sh_count);
  const int total = sh_count[blockDim.x - 1];
  int slot = incl - count;

  // 4: write the picks that fit
  const size_t out0 = static_cast<size_t>(row) * k;
  if (count > 0 && slot < k) {
    fold(x, lo, hi, w, t1, t2, kOutside, carry, skip, [&](int i, const State& st) {
      peak_idx[out0 + slot] = st.am;
      peak_val[out0 + slot] = st.m;
      onset[out0 + slot] = st.on;
      offset[out0 + slot] = i;
      valid[out0 + slot] = 1;
      return ++slot < k;
    });
  }
  for (int j = tid; j < k; j += blockDim.x) {
    if (j >= total) {
      peak_idx[out0 + j] = -1;
      peak_val[out0 + j] = 0.0f;
      onset[out0 + j] = -1;
      offset[out0 + j] = -1;
      valid[out0 + j] = 0;
    }
  }
}

}  // namespace

// prob (B, W), t1/t2 (B,) float32, all contiguous on the device; outputs
// (B, K) int32 / float32 / uint8 (bool) / int32 / int32. Returns the launch's
// cudaGetLastError().
extern "C" int trigger_extract_f32(const float* prob, const float* t1, const float* t2,
                                   int b, int w, int k, int* peak_idx, float* peak_val,
                                   uint8_t* valid, int* onset, int* offset, void* stream) {
  trigger_extract_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      prob, t1, t2, w, k, peak_idx, peak_val, valid, onset, offset);
  return static_cast<int>(cudaGetLastError());
}
