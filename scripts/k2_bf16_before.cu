// The earlier design of K2's bf16 recurrence, kept only as a yardstick: the
// float32 body of volpick_tpu_torch/csrc/lstm_multi.cu instantiated on bf16
// (xp from a bf16 matrix product outside the kernel, staged by an 8-byte
// cp.async ring, W_hh and the bias widened to float32, the bias added in
// float32). The fused bf16 body in csrc/lstm_multi.cu replaced it; nothing in
// the package builds or calls this file. chip_smoke.py (phase 3) builds it
// into a library of its own and times it, with the projection the port's
// float32 route uses (ops/cuda/lstm.py::project_shared on bf16), beside the
// present kernel in the same process.
//
// Entry: lstm_recurrence_bf16_before, with the arguments of lstm_multi_f32
// on bf16 operands.

#include "../volpick_tpu_torch/csrc/lstm_multi.cu"

extern "C" int lstm_recurrence_bf16_before(const __nv_bfloat16* xp, const __nv_bfloat16* whh,
                                           const __nv_bfloat16* bias, __nv_bfloat16* out, int g,
                                           int b, int t, int h, long long sxg, long long sxb,
                                           long long sxt, long long sog, long long sob,
                                           unsigned reverse_mask, void* stream) {
  return launch(xp, whh, bias, out, g, b, t, h, sxg, sxb, sxt, sog, sob, reverse_mask, stream);
}
