// The earlier design of K5's bf16 entries, kept only as a yardstick: the
// float32 body of volpick_tpu_torch/csrc/addattn.cu instantiated on bf16 (x,
// q, k or the weights widened to float32 on plain loads, everything in
// float32, two special-function operations a tanh). The bf16 body in
// csrc/addattn.cu replaced it; nothing in the package builds or calls this
// file. chip_smoke.py (phase 3) builds it into a library of its own and times
// its profiler row beside the present kernel's in the same process.
//
// Entries: addattn_x_bf16_before and addattn_bf16_before, with the arguments
// of addattn_x_bf16 and addattn_bf16; g is the float32 body's windows a CTA
// (ops/cuda/addattn.py::windows_per_cta).

#include "../volpick_tpu_torch/csrc/addattn.cu"

extern "C" int addattn_x_bf16_before(const __nv_bfloat16* x, const __nv_bfloat16* wt,
                                     const __nv_bfloat16* bh, const __nv_bfloat16* wx,
                                     const __nv_bfloat16* wa, __nv_bfloat16* out, int b, int c,
                                     int t, int u, int g, float eps, void* stream) {
  return launch<true>(x, wt, wx, bh, wa, out, b, c, t, u, g, eps, stream);
}

extern "C" int addattn_bf16_before(const __nv_bfloat16* x, const __nv_bfloat16* q,
                                   const __nv_bfloat16* k, const __nv_bfloat16* wa,
                                   __nv_bfloat16* out, int b, int c, int t, int u, int g,
                                   float eps, void* stream) {
  return launch<false>(x, q, k, static_cast<const __nv_bfloat16*>(nullptr), wa, out, b, c, t, u,
                       g, eps, stream);
}
