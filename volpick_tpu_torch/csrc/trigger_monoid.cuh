// The segmented-scan monoid of the two-threshold trigger automaton and the
// per-row fold / block-scan building blocks shared by trigger_extract.cu
// (scan + pick emission) and trigger_scan.cu (scan state at every position).
//
// State per stretch of samples (volpick_tpu/ops/triggers.py): (flag, onset,
// max, argmax). `none` is the max of a stretch outside any run: -INFINITY in
// trigger_extract.cu, where it never leaves the kernel, and the finite
// -3.4e38 of volpick_tpu/ops/pallas/triggers.py in trigger_scan.cu, whose
// outputs show it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kNone = 2147483647;  // INT32_MAX: no > t1 sample seen in the run

struct State {
  int flag;  // this stretch opens a new > t2 run (segment reset)
  int on;    // first > t1 index in the current run, or kNone
  float m;   // running max of the run (`none` outside runs)
  int am;    // index of the first occurrence of that max
};

__device__ __forceinline__ State identity(float none) {
  State s;
  s.flag = 0;
  s.on = kNone;
  s.m = none;
  s.am = 0;
  return s;
}

// volpick_tpu/ops/triggers.py::_combine; `a` covers the earlier samples.
__device__ __forceinline__ State combine(const State& a, const State& c) {
  const bool use_c = c.m > a.m;  // strict: the first occurrence of the max wins
  State r;
  r.flag = a.flag | c.flag;
  r.on = c.flag ? c.on : min(a.on, c.on);
  r.m = c.flag ? c.m : (use_c ? c.m : a.m);
  r.am = c.flag ? c.am : (use_c ? c.am : a.am);
  return r;
}

// Folds x[lo, hi) into `st` sample by sample. each(i, st) sees the state
// after every sample i; emit(i, st) is called at every run end whose run has
// crossed t1 and stops the fold by returning false.
template <typename Each, typename Emit>
__device__ __forceinline__ State fold(const float* __restrict__ x, int lo, int hi, int w,
                                      float t1, float t2, float none, State st, Each each,
                                      Emit emit) {
  bool prev2 = lo > 0 && x[lo - 1] > t2;
  bool a2 = lo < hi && x[lo] > t2;
  for (int i = lo; i < hi; ++i) {
    const float v = x[i];
    State e;
    e.flag = a2 && !prev2;
    e.on = (a2 && v > t1) ? i : kNone;
    e.m = a2 ? v : none;
    e.am = i;
    st = combine(st, e);
    each(i, st);
    const bool next2 = i + 1 < w && x[i + 1] > t2;
    if (a2 && !next2 && st.on != kNone) {
      if (!emit(i, st)) break;
    }
    prev2 = a2;
    a2 = next2;
  }
  return st;
}

// Block-wide inclusive scan; on return sh[t] holds thread t's inclusive state.
__device__ State scan_states(State s, State* sh, float none) {
  const int tid = threadIdx.x;
  sh[tid] = s;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    State left = identity(none);
    if (tid >= d) left = sh[tid - d];
    __syncthreads();
    if (tid >= d) {
      s = combine(left, s);
      sh[tid] = s;
    }
    __syncthreads();
  }
  return s;
}

}  // namespace
