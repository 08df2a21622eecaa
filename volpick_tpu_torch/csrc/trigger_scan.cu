// Two-threshold trigger scan: the scanned state at every position of every
// curve, no pick emission. One CTA per curve.
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
// and selects a sample.
//
// Design: the Pallas kernel carries the scan state in VMEM scratch from one
// column chunk to the next, which relies on the TPU running the grid in
// order. CUDA blocks run in no order, so, as in trigger_extract.cu, one CTA
// owns a whole row and the carry never leaves the block:
//   1. each thread folds its contiguous segment of the row into a summary;
//   2. a block-wide scan of the summaries gives every thread the state
//      carried into its segment;
//   3. each thread folds its segment again from that carry and writes the
//      state after every sample.
// Known costs of this first design, left to the kernel's redesign: with 24
// rows it occupies 24 of the 132 SMs, and a thread writes a contiguous
// segment, so the 32 stores of a warp go to 32 different cache lines.

#include "trigger_monoid.cuh"

namespace {

constexpr float kOutside = -3.4e38f;  // max of a stretch outside any run

__global__ void __launch_bounds__(kThreads)
trigger_scan_kernel(const float* __restrict__ prob, const float* __restrict__ t1s,
                    const float* __restrict__ t2s, int w, int* __restrict__ onset,
                    float* __restrict__ run_max, int* __restrict__ run_argmax) {
  __shared__ State sh_state[kThreads];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(row) * w;
  const float* x = prob + row0;
  const float t1 = t1s[row];
  const float t2 = t2s[row];
  const int seg = (w + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * seg, w);
  const int hi = min(lo + seg, w);

  const auto go_on = [](int, const State&) { return true; };
  const State summary = fold(x, lo, hi, w, t1, t2, kOutside, identity(kOutside),
                             [](int, const State&) {}, go_on);
  scan_states(summary, sh_state, kOutside);
  const State carry = tid > 0 ? sh_state[tid - 1] : identity(kOutside);

  fold(x, lo, hi, w, t1, t2, kOutside, carry,
       [&](int i, const State& st) {
         onset[row0 + i] = st.on;
         run_max[row0 + i] = st.m;
         run_argmax[row0 + i] = st.am;
       },
       go_on);
}

}  // namespace

// prob (B, W), t1/t2 (B,) float32, contiguous on the device; outputs (B, W)
// int32 / float32 / int32. Returns the launch's cudaGetLastError().
extern "C" int trigger_scan_f32(const float* prob, const float* t1, const float* t2, int b,
                                int w, int* onset, float* run_max, int* run_argmax,
                                void* stream) {
  trigger_scan_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      prob, t1, t2, w, onset, run_max, run_argmax);
  return static_cast<int>(cudaGetLastError());
}
