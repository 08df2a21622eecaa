// The segmented-scan monoid of the two-threshold trigger automaton and the
// building blocks shared by trigger_extract.cu (scan + pick emission) and
// trigger_scan.cu (scan state at every position), both split over warps and
// moving 16 bytes a thread: load_quad / load_prev (aligned quads of a row),
// fold_quad (four neighbouring samples), warp_scan (shuffles on the four
// fields) and warp_prefix (the state carried into a lane of a step, and from
// step to step). `combine` is selects and compares only, so it is
// exactly associative: every tree order gives the bits of a left-to-right
// fold.
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

constexpr int kStep = 128;  // samples a warp covers with one 16-byte load a lane: 32 x 4
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

// The state of sample i alone: value v, `prev2` says whether sample i - 1
// lies above t2 (false at i = 0).
__device__ __forceinline__ State element(float v, bool prev2, int i, float t1, float t2,
                                         float none) {
  const bool a2 = v > t2;
  State e;
  e.flag = a2 && !prev2;
  e.on = (a2 && v > t1) ? i : kNone;
  e.m = a2 ? v : none;
  e.am = i;
  return e;
}

// Inclusive states st[0..3] of the four neighbouring samples i0 .. i0 + 3 of
// a row of width w, folded from the identity; a sample outside [0, w) leaves
// the state as it is. `prev` is sample i0 - 1 (not read when i0 <= 0). The
// identity on the left turns the argmax of a run-free stretch into 0: harmless,
// because the caller combines a carry that starts at the row's sample 0 on
// the left of st[], and a run-free right operand takes the left one's argmax.
__device__ __forceinline__ void fold_quad(const float (&v)[4], float prev, int i0, int w,
                                          float t1, float t2, float none, State (&st)[4]) {
  bool prev2 = i0 > 0 && prev > t2;
  State acc = identity(none);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = i0 + j;
    if (i >= 0 && i < w) {
      acc = combine(acc, element(v[j], prev2, i, t1, t2, none));
      prev2 = v[j] > t2;
    }
    st[j] = acc;
  }
}

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ State shfl_up_state(const State& s, int d) {
  State r;
  r.flag = __shfl_up_sync(kFullMask, s.flag, d);
  r.on = __shfl_up_sync(kFullMask, s.on, d);
  r.m = __shfl_up_sync(kFullMask, s.m, d);
  r.am = __shfl_up_sync(kFullMask, s.am, d);
  return r;
}

// Inclusive scan over the 32 lanes of a warp (all lanes must call it).
__device__ __forceinline__ State warp_scan(State s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const State left = shfl_up_state(s, d);
    if (lane >= d) s = combine(left, s);
  }
  return s;
}

__device__ __forceinline__ State shfl_state(const State& s, int lane) {
  State r;
  r.flag = __shfl_sync(kFullMask, s.flag, lane);
  r.on = __shfl_sync(kFullMask, s.on, lane);
  r.m = __shfl_sync(kFullMask, s.m, lane);
  r.am = __shfl_sync(kFullMask, s.am, lane);
  return r;
}

// One step of a warp whose lanes hold neighbouring stretches in lane order:
// `own` is this lane's stretch, `carry` the state before the warp's 32
// stretches (the same in every lane). Returns the state before this lane's
// stretch and moves `carry` past the step. All lanes must call it.
__device__ __forceinline__ State warp_prefix(const State& own, State& carry, float none) {
  const State inc = warp_scan(own);
  State before = shfl_up_state(inc, 1);
  if ((threadIdx.x & 31) == 0) before = identity(none);
  before = combine(carry, before);
  carry = combine(carry, shfl_state(inc, 31));
  return before;
}

// Four neighbouring samples from i0 on, zeros outside [0, w); one 16-byte
// load where `vec` and the quad lies inside the row.
__device__ __forceinline__ void load_quad(const float* __restrict__ x, int i0, int w, bool vec,
                                          float (&v)[4]) {
  if (vec && i0 >= 0 && i0 + 4 <= w) {
    const float4 f = *reinterpret_cast<const float4*>(x + i0);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (i0 + j >= 0 && i0 + j < w) ? x[i0 + j] : 0.0f;
  }
}

// Sample i0 - 1, where the row has one.
__device__ __forceinline__ float load_prev(const float* __restrict__ x, int i0, int w) {
  return (i0 > 0 && i0 <= w) ? x[i0 - 1] : 0.0f;
}

}  // namespace
