// Two-threshold trigger extraction with pick emission. A row is split into
// pieces, one warp a piece; the picks' slots come from counts that each piece
// takes alone.
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
// What bounds it on an H100: by the count of bytes, almost nothing (a 24 x
// 120000 float curve batch is 11.5 MB, 3.4 us at the 3.35 TB/s of the H100
// SXM data sheet, and the outputs are a few KB). What it costs is the scan
// itself, a dozen dependent compares and selects a sample, the latency of the
// loads that feed it, and the picks' order, which ties every piece of a row
// to all the pieces on its left. So the design spreads a row over the whole
// card, keeps a lane's loads four quads deep and reads the curves once.
//
// Design: the Pallas kernel carries the scan state and the pick count in VMEM
// from one column chunk to the next, which relies on the TPU running the grid
// in order. CUDA blocks run in no order. Here a row is cut into pieces (the
// caller's split, ops/cuda/triggers.py::scan_plan: 86 pieces of 1408 samples a
// row at 24 x 120000, one piece a row at 3000 x 6000), one warp a piece, no
// shared memory and no barrier, and what a piece needs from its left goes
// through device memory as one 16-byte summary a piece:
//   1. trigger_extract_kernel_summaries (rows of more than one piece): a warp
//      folds its piece from the identity into the state at its last sample and
//      counts the run ends that will emit. A run end emits when its run has
//      crossed t1. Inside the piece that is known for every run end but one:
//      the run that was already open where the piece begins and does not
//      cross t1 in the piece emits if and only if it crossed t1 earlier. So a
//      piece reports `sure` (emissions whatever came before) and one `pending`
//      bit, packed beside the state's flag.
//   2. trigger_extract_kernel: a warp scans the summaries on its left (32 a
//      step, by warp scan). That gives its carry, and it gives every left
//      piece its own carry, which resolves that piece's pending bit; the sum
//      of sure + resolved is the slot of the warp's first pick. A warp whose
//      first slot is >= K is done (dense curves: only the first pieces of a
//      row do any work). Otherwise it walks its piece from the carry and
//      writes its picks at first slot + rank. The warp of a row's last piece
//      knows the row's total and fills the unused slots.
// Where all CTAs of the launch fit on the card at once, the two kernels can be
// one cooperative launch with a grid-wide barrier between them
// (trigger_extract_kernel_cooperative), and then a lane keeps its fold across
// the barrier and the curves are read once.
// A warp walks its piece in stretches: a lane folds a contiguous 1/32 of the
// piece sample by sample (16-byte loads, four quads in flight), one warp scan
// joins the 32 stretches and gives each lane the state before its stretch and,
// by an exclusive sum of the lanes' counts, its first slot; only a lane that
// has picks to write folds its stretch a second time, from that state. (The
// walk of trigger_scan.cu, 128 samples a step with neighbouring lanes on
// neighbouring 16 bytes and a warp scan a step, was slower at both shapes: on
// an H100 80GB HBM3 at 700 W its launch took 0.0146 ms against 0.0110 at 24 x
// 120000 and 0.080 against 0.064 at 3000 x 6000.)
// A row whose start is not 16-byte aligned (W not a multiple of 4) is walked
// on a grid shifted left by (row * W) mod 4 samples, so that its quads are
// aligned all the same; when `prob` itself is not 16-byte aligned, every load
// is scalar, inside these same kernels.

#include <cooperative_groups.h>

#include "trigger_monoid.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kOutside = -INFINITY;  // max of a stretch outside any run
constexpr int kExtractThreads = 256;
constexpr int kExtractWarps = kExtractThreads / 32;
constexpr int kBatch = 4;  // quads a lane loads before it folds them

struct Rows {  // the curves and how they are split
  const float* prob;
  const float* t1s;
  const float* t2s;
  int w, piece, n_pieces, vec;
};

struct Picks {  // the five (B, K) outputs
  int k;
  int* peak_idx;
  float* peak_val;
  uint8_t* valid;
  int* onset;
  int* offset;
};

struct Piece {  // one warp's share of a row
  const float* x;  // the row
  float t1, t2;
  int row, p, shift;  // sample i of the row sits at grid position i + shift
};

struct Lane {  // a lane's stretch, folded from the identity
  State acc;
  int sure;     // run ends that emit whatever lies on the left of the stretch
  int pending;  // a run end whose run was open where the stretch began and has not crossed t1 in it
};

__device__ __forceinline__ Piece piece_of(const Rows& r, long long wid, int pieces_a_row) {
  Piece pc;
  pc.row = static_cast<int>(wid / pieces_a_row);
  pc.p = static_cast<int>(wid - static_cast<long long>(pc.row) * pieces_a_row);
  const long long row0 = static_cast<long long>(pc.row) * r.w;
  pc.x = r.prob + row0;
  pc.t1 = r.t1s[pc.row];
  pc.t2 = r.t2s[pc.row];
  pc.shift = r.vec ? static_cast<int>(row0 & 3) : 0;
  return pc;
}

__device__ __forceinline__ State unpack(const int4& q) {
  State s;
  s.flag = q.x & 1, s.on = q.y, s.m = __int_as_float(q.z), s.am = q.w;
  return s;
}

// One sample of a stretch: reports the run end at i - 1 where sample i - 1
// of this stretch lies above t2 and sample i does not, then folds sample i.
// A sample outside a run leaves on / max / argmax as they were, so the state
// at hand is still that of the run that just ended.
template <typename AtEnd>
__device__ __forceinline__ void fold_sample(float v, int i, float t1, float t2, bool& prev2,
                                            bool& open, State& acc, AtEnd& at_end) {
  const bool a2 = v > t2;
  if (open && !a2) at_end(i - 1, acc);
  acc = combine(acc, element(v, prev2, i, t1, t2, kOutside));
  prev2 = open = a2;
}

// Folds the row's samples among grid positions [first, end) into `acc` (end -
// first is a multiple of 4, `first` 16-byte aligned where `vec`) and calls
// at_end(i, state at i) for every run end i among them, in time order.
template <typename AtEnd>
__device__ __forceinline__ State fold_stretch(const float* __restrict__ x, int first, int end, int w,
                                              bool vec, float t1, float t2, State acc,
                                              AtEnd at_end) {
  bool prev2 = first > 0 && load_prev(x, first, w) > t2;
  bool open = false;  // the sample before belongs to this stretch and lies above t2
  const int stop = min(end, w);
  for (int base = first; base < stop; base += 4 * kBatch) {
    float v[kBatch][4];
    if (base >= 0 && base + 4 * kBatch <= stop) {  // a whole batch inside the row
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (vec) {
          const float4 f = *reinterpret_cast<const float4*>(x + base + 4 * q);
          v[q][0] = f.x, v[q][1] = f.y, v[q][2] = f.z, v[q][3] = f.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[q][j] = x[base + 4 * q + j];
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fold_sample(v[q][j], base + 4 * q + j, t1, t2, prev2, open, acc, at_end);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (base + 4 * q < stop) load_quad(x, base + 4 * q, w, vec, v[q]);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (base + 4 * q < stop) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = base + 4 * q + j;
            if (i >= 0 && i < w) fold_sample(v[q][j], i, t1, t2, prev2, open, acc, at_end);
          }
        }
      }
    }
  }
  // the stretch's last sample ends its run unless the next sample carries it on
  if (open && !(stop < w && x[stop] > t2)) at_end(stop - 1, acc);
  return acc;
}

// This lane's 1/32 of the piece as grid positions [first, end).
__device__ __forceinline__ void stretch_of(const Rows& r, const Piece& pc, int& first, int& end) {
  const int per = r.piece / 32;  // a multiple of 4
  first = pc.p * r.piece + (threadIdx.x & 31) * per - pc.shift;
  end = first + per;
}

__device__ __forceinline__ Lane fold_lane(const Rows& r, const Piece& pc) {
  int first, end;
  stretch_of(r, pc, first, end);
  Lane me;
  me.sure = 0, me.pending = 0;
  me.acc = fold_stretch(pc.x, first, end, r.w, r.vec, pc.t1, pc.t2, identity(kOutside),
                        [&](int, const State& s) {
                          if (s.on != kNone) {
                            ++me.sure;
                          } else if (!s.flag) {
                            me.pending = 1;
                          }
                        });
  return me;
}

// The piece's summary from its 32 lanes: the state at its last sample, its
// sure count and its pending bit, in 16 bytes (flag | pending << 1 | sure << 2,
// onset, max, argmax). All lanes must call it.
__device__ __forceinline__ void write_summary(const Lane& me, int4* dst) {
  const int lane = threadIdx.x & 31;
  const State inc = warp_scan(me.acc);
  State before = shfl_up_state(inc, 1);  // the piece from its start to this lane's stretch
  if (lane == 0) before = identity(kOutside);
  const bool crossed = before.on != kNone;
  const int sure = __reduce_add_sync(kFullMask, me.sure + (me.pending && crossed));
  const unsigned pending = __ballot_sync(kFullMask, me.pending && !crossed && !before.flag);
  if (lane == 31) {
    *dst = make_int4(inc.flag | (pending ? 2 : 0) | (sure << 2), inc.on, __float_as_int(inc.m),
                     inc.am);
  }
}

// Scans the summaries of the pieces 0 .. p - 1 of a row into the state
// carried into piece p and the slot of its first pick; false as soon as that
// slot reaches k (the same in every lane). All lanes must call it.
__device__ __forceinline__ bool scan_left(const int4* left, int p, int k, State& carry,
                                          int& slot0) {
  const int lane = threadIdx.x & 31;
  carry = identity(kOutside);
  slot0 = 0;
  for (int j0 = 0; j0 < p; j0 += 32) {
    State s = identity(kOutside);
    int sure = 0, pending = 0;
    if (j0 + lane < p) {
      const int4 q = left[j0 + lane];
      s = unpack(q);
      pending = (q.x >> 1) & 1;
      sure = q.x >> 2;
    }
    const State before = warp_prefix(s, carry, kOutside);  // the carry of piece j0 + lane
    slot0 += __reduce_add_sync(kFullMask, sure + (pending && before.on != kNone));
    if (slot0 >= k) return false;
  }
  return true;
}

__device__ __forceinline__ void write_pick(const Picks& out, size_t at, int i, const State& s) {
  out.peak_idx[at] = s.am;
  out.peak_val[at] = s.m;
  out.onset[at] = s.on;
  out.offset[at] = i;
  out.valid[at] = 1;
}

// Slots [total, k) of a row hold no pick.
__device__ __forceinline__ void fill_unused(const Picks& out, size_t out0, int total) {
  for (int j = total + (threadIdx.x & 31); j < out.k; j += 32) {
    out.peak_idx[out0 + j] = -1;
    out.peak_val[out0 + j] = 0.0f;
    out.onset[out0 + j] = -1;
    out.offset[out0 + j] = -1;
    out.valid[out0 + j] = 0;
  }
}

// Writes the picks of a warp's piece: `me` is the piece folded by fold_lane,
// `carry` the state before the piece, slot0 (< k) the slot of its first pick.
__device__ __forceinline__ void emit_stretches(const Rows& r, const Piece& pc, const Picks& out,
                                               const Lane& me, State carry, int slot0) {
  const int lane = threadIdx.x & 31;
  const State before = warp_prefix(me.acc, carry, kOutside);
  const int count = me.sure + (me.pending && before.on != kNone);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int left = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += left;
  }
  int slot = slot0 + incl - count;
  const int total = slot0 + __shfl_sync(kFullMask, incl, 31);
  const size_t out0 = static_cast<size_t>(pc.row) * out.k;
  if (count > 0 && slot < out.k) {
    int first, end;
    stretch_of(r, pc, first, end);
    fold_stretch(pc.x, first, end, r.w, r.vec, pc.t1, pc.t2, before, [&](int i, const State& s) {
      if (s.on != kNone) {
        if (slot < out.k) write_pick(out, out0 + slot, i, s);
        ++slot;
      }
    });
  }
  if (pc.p == r.n_pieces - 1 && total < out.k) fill_unused(out, out0, total);
}

// Launch 1: warp `wid` of B * (n_pieces - 1) folds piece wid % (n_pieces - 1)
// of row wid / (n_pieces - 1) into summaries[wid].
__global__ void __launch_bounds__(kExtractThreads)
trigger_extract_kernel_summaries(Rows r, long long n_warps, int4* __restrict__ summaries) {
  const long long wid =
      static_cast<long long>(blockIdx.x) * kExtractWarps + (threadIdx.x >> 5);
  if (wid >= n_warps) return;
  const Piece pc = piece_of(r, wid, r.n_pieces - 1);
  write_summary(fold_lane(r, pc), summaries + wid);
}

// Launch 2: warp `wid` of B * n_pieces finds its carry and first slot from
// the summaries on its left and writes the picks of piece wid % n_pieces of
// row wid / n_pieces.
__global__ void __launch_bounds__(kExtractThreads)
trigger_extract_kernel(Rows r, long long n_warps, const int4* __restrict__ summaries, Picks out) {
  const long long wid =
      static_cast<long long>(blockIdx.x) * kExtractWarps + (threadIdx.x >> 5);
  if (wid >= n_warps) return;
  const Piece pc = piece_of(r, wid, r.n_pieces);
  State carry;
  int slot0;
  if (!scan_left(summaries + static_cast<long long>(pc.row) * (r.n_pieces - 1), pc.p, out.k, carry,
                 slot0)) {
    return;
  }
  emit_stretches(r, pc, out, fold_lane(r, pc), carry, slot0);
}

// Both in one cooperative launch (every CTA resident): a lane keeps its fold
// across the grid-wide barrier, so the curves are read once. Here every piece
// of a row has a summary: summaries is (B, n_pieces), written and read in this
// one kernel, so it must not be read through the read-only cache.
__global__ void __launch_bounds__(kExtractThreads)
trigger_extract_kernel_cooperative(Rows r, long long n_warps, int4* summaries, Picks out) {
  const long long wid =
      static_cast<long long>(blockIdx.x) * kExtractWarps + (threadIdx.x >> 5);
  const bool active = wid < n_warps;
  Piece pc;
  Lane me;
  if (active) {
    pc = piece_of(r, wid, r.n_pieces);
    me = fold_lane(r, pc);
    write_summary(me, summaries + wid);
  }
  cg::this_grid().sync();
  if (!active) return;
  State carry;
  int slot0;
  if (!scan_left(summaries + static_cast<long long>(pc.row) * r.n_pieces, pc.p, out.k, carry,
                 slot0)) {
    return;
  }
  emit_stretches(r, pc, out, me, carry, slot0);
}

}  // namespace

// prob (B, W), t1/t2 (B,) float32, all contiguous on the device; outputs
// (B, K) int32 / float32 / uint8 (bool) / int32 / int32. `piece` (a multiple
// of 128) and `n_pieces` (with n_pieces * piece >= W, and >= W + 3 where W is
// not a multiple of 4: room for the shifted grid) are the caller's split of a
// row; `summaries` is scratch of B * n_pieces * 16 bytes, 16-byte aligned.
// `cooperative` != 0 asks for one cooperative launch and gets it where every
// CTA of it is resident at once; otherwise, and always for one piece a row,
// the launches are one or two plain ones. Returns cudaErrorInvalidValue (1)
// for a split that does not cover the row, else the last launch's error.
extern "C" int trigger_extract_f32(const float* prob, const float* t1, const float* t2, int b,
                                   int w, int k, int piece, int n_pieces, int cooperative,
                                   void* summaries, int* peak_idx, float* peak_val,
                                   uint8_t* valid, int* onset, int* offset, void* stream) {
  const long long n_warps = static_cast<long long>(b) * n_pieces;
  if (piece < kStep || piece % kStep != 0 || n_pieces < 1 || k < 1 ||
      static_cast<long long>(piece) * n_pieces < static_cast<long long>(w) + (w % 4 ? 3 : 0) ||
      n_warps / kExtractWarps >= 2147483647LL ||
      reinterpret_cast<uintptr_t>(summaries) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows r;
  r.prob = prob, r.t1s = t1, r.t2s = t2;
  r.w = w, r.piece = piece, r.n_pieces = n_pieces;
  r.vec = reinterpret_cast<uintptr_t>(prob) % 16 == 0;
  Picks out;
  out.k = k, out.peak_idx = peak_idx, out.peak_val = peak_val, out.valid = valid;
  out.onset = onset, out.offset = offset;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* summ = static_cast<int4*>(summaries);
  const unsigned ctas = static_cast<unsigned>((n_warps + kExtractWarps - 1) / kExtractWarps);

  if (cooperative && n_pieces > 1) {
    // CTAs of the cooperative kernel a card holds at once, asked of the first
    // device that comes here (the cards of one host are alike)
    static int resident = -1;
    if (resident < 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, trigger_extract_kernel_cooperative, kExtractThreads, 0);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      resident = sms * per_sm;
    }
    if (ctas <= static_cast<unsigned>(resident)) {
      long long n = n_warps;
      void* args[] = {&r, &n, &summ, &out};
      return static_cast<int>(cudaLaunchCooperativeKernel(
          reinterpret_cast<void*>(trigger_extract_kernel_cooperative), dim3(ctas),
          dim3(kExtractThreads), args, 0, s));
    }
  }
  if (n_pieces > 1) {
    const long long first = static_cast<long long>(b) * (n_pieces - 1);
    trigger_extract_kernel_summaries<<<
        static_cast<unsigned>((first + kExtractWarps - 1) / kExtractWarps), kExtractThreads, 0, s>>>(
        r, first, summ);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  trigger_extract_kernel<<<ctas, kExtractThreads, 0, s>>>(r, n_warps, summ, out);
  return static_cast<int>(cudaGetLastError());
}
