// Hysteresis rounds on a batch of packed planes, and the unpack to edge maps.
//
// Replaces the back half of the TPU megakernel (cudacam_tpu/ops/pallas/
// megakernel.py: _phase1_finalize, _unpack_out; per frame of a batch in
// _kernel_batched), its phase-2 continuation (_cont_kernel / _cont_call),
// and the convergence and unpack of the fused hysteresis kernel and of the
// threshold-sweep kernel (hysteresis_fused.py: _kernel, _sweep_kernel; the
// sweep runs both phases once per pair). On a sharded frame they are also
// the export megakernel's in-kernel phase 1 (megakernel.py:607 via :569) and
// the local saturate of the collective round loop (hysteresis_fused.py:844
// saturate_packed -> _sat_kernel :742: both phases, the round count starting
// at 0 on each call), over a batch of extended tiles, and unpack_core
// replaces the core unpack (megakernel.py:714 unpack_core_call ->
// _unpack_core_kernel :653). Both phases execute the round schedule of
// cudacam_tpu/ops/bitpack.py::_make_ops exactly: the same dilate_steps with
// bitpack's default carry cadence (every 8th step exact across words) and
// an exact last step, the same 8 scan directions in the same order, the
// same round counting. So an output cut off by the max_iters cap is the JAX
// package's, bit for bit.
//
// Design: one cooperative persistent kernel per phase (route (a)), launched
// with cudaLaunchCooperativeKernel on a grid sized from the occupancy
// calculator, with grid.sync() between the steps that read other blocks'
// words. A 1080p plane is 34 x 1920 words (261 KB): it fits L2 but not one
// SM's shared memory, and Hopper blocks carry nothing between them, so the
// state lives in device memory (L2) between barriers. A batch of B frames
// is one launch per phase: every frame keeps its own planes, round count
// and stop test, and the work of a round is enumerated over (frame, tile)
// or (frame, word) of the frames still active.
//
// * A round's dilate_steps dilations run in shared memory per tile (TR word
//   rows x TC columns core) with a halo as deep as the steps: dilate_steps
//   columns and ceil(dilate_steps / 32) word rows. The core of a tile after
//   the steps is exact; the halo is scratch. One grid barrier per round.
// * The 8 directional scans propagate across the whole frame, so each
//   doubling step (out = g | (pp & shifted(g))) is one pass over the planes
//   followed by a grid barrier, on ping-pong buffers (Jacobi: every step
//   reads only the previous step's words).
// * Per-frame state. Each block holds a copy of every frame's (round count,
//   still growing) in shared memory and updates it after each round's
//   barrier from the frame's "changed" slot, so all blocks agree on which
//   frames are active without another barrier. A frame that stopped is
//   frozen: no more dilations, no more counted rounds. The round loop runs
//   while any frame is active.
// * Phase 1 ping-pongs each frame between its FINAL plane and one scratch
//   plane by the frame's own round parity, and copies back the frames that
//   ended on the scratch plane.
// * The "changed" flags rotate over three slots of B words: a slot is
//   cleared one round before it is written and two barriers after its last
//   read, so no reset races a write or a read.
// * Phase 1 writes flags[b][0] = (round count, still growing); phase 2
//   reads them on the device, works only on frames still growing, and
//   returns at once when none is, so the host never reads a flag back.
//   Phase 2 writes flags[b][1] for every frame.
// * An optional device gate: when *gate is 0 both phases return at once,
//   writing nothing. The sharded round loop launches its bounded chain of
//   rounds with the global pending flag as the gate, so the host never reads
//   it back.
//
// * The occupancy query runs once per (phase, device, dilate_steps, B), on
//   the first launch; later launches reuse the grid.
//
// Bound: grid barriers and L2 latency, not bytes or operations: a round moves
// a few hundred KB per frame through L2 and does ~10 integer ops per word
// per step.
//
// split_kernel replaces the column-split continuation (hysteresis_fused.py:876
// converge_packed_split, driven by megakernel.py:921 _cont_split: a host-traced
// loop of one saturate_packed launch per column slice with XLA pad / slice /
// concatenate between). Here the whole seam loop is ONE cooperative launch,
// gated on the frame's growing flag as phase 2 is: the slices are the batch
// dimension of a scratch copy (n_split, hw, k + ws + k) that the round code
// above works on unchanged (per-slice round counts and stop tests). A seam
// round extracts every slice with its k halo columns from the frame's plane
// (zero outside the frame), runs the saturate schedule on each (one
// unconditional dilation round, dilation rounds below scan_after, then
// dilations + scans, while the slice changes and below the inner cap), writes
// the owned ws columns back, and adds the most rounds any slice took to the
// budget counter; the loop ends on the device when a seam round changes no
// owned word or the budget is spent. So a call is one launch whatever the
// cap, and the host reads nothing back. Bound: as the round kernels, grid
// barriers; the extract and merge passes move the planes through L2 once a
// seam round.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TR = 4;    // tile core: packed word rows
constexpr int TC = 128;  // tile core: columns
constexpr int CARRY_EVERY = 8;  // bitpack._CARRY_EVERY: every 8th dilation step is exact
constexpr int MAX_DILATE_STEPS = 256;  // the tile halo (steps columns) fits shared memory

struct Params {
  uint32_t* f;        // (B, hw, w) FINAL planes, updated in place
  const uint32_t* p;  // (B, hw, w) CANDIDATE planes
  uint32_t* buf[4];   // scratch: B planes each
  int* chg;           // [3][B] per-round change flags
  int* flags;         // (B, 2, 2): phase-1 (it, growing), final (it, growing)
  const int* gate;    // null, or: return at once when *gate == 0
  int nb;             // frames in the batch
  int hw, w, h;       // plane rows, plane columns (= image columns), image rows
  long long plane;    // words per plane: hw * w
  int dilate_steps, cap;
  int halo_r, halo_c;  // tile halo: word rows, columns
};

// Per-frame state, one copy per block in shared memory after the tile.
struct FrameState {
  int* it;    // [B] round count
  int* grow;  // [B] still growing (the last round changed the frame)
  int* list;  // [B] frames active this round
  int* n;     // [1] their number
};

__device__ __forceinline__ uint32_t ld(const uint32_t* x, int k, int c, int hw, int w) {
  return (k >= 0 && k < hw && c >= 0 && c < w) ? __ldcg(x + k * w + c) : 0u;
}

// bitpack._shift_px(x, s) at word (k, c): the packed stream shifted by s
// image rows, zero fill.
__device__ __forceinline__ uint32_t shift_px(const uint32_t* x, int k, int c, int s,
                                             int hw, int w) {
  if (c < 0 || c >= w) return 0u;
  if (s > 0) {
    int q = s >> 5, r = s & 31;
    uint32_t b = ld(x, k - q, c, hw, w);
    return r ? (b << r) | (ld(x, k - q - 1, c, hw, w) >> (32 - r)) : b;
  }
  s = -s;
  int q = s >> 5, r = s & 31;
  uint32_t b = ld(x, k + q, c, hw, w);
  return r ? (b >> r) | (ld(x, k + q + 1, c, hw, w) << (32 - r)) : b;
}

// The value s cells upstream of (k, c) along scan direction dir, in the
// order of bitpack._make_ops: left->right, right->left, top->bottom,
// bottom->top, down-right, up-left, down-left, up-right.
__device__ __forceinline__ uint32_t upstream(const uint32_t* x, int k, int c, int dir, int s,
                                             int hw, int w) {
  switch (dir) {
    case 0: return ld(x, k, c - s, hw, w);
    case 1: return ld(x, k, c + s, hw, w);
    case 2: return shift_px(x, k, c, s, hw, w);
    case 3: return shift_px(x, k, c, -s, hw, w);
    case 4: return shift_px(x, k, c - s, s, hw, w);
    case 5: return shift_px(x, k, c + s, -s, hw, w);
    case 6: return shift_px(x, k, c + s, s, hw, w);
    default: return shift_px(x, k, c - s, -s, hw, w);
  }
}

__device__ __forceinline__ uint32_t row_or(const uint32_t* A, int rr, int cc, int RW) {
  const uint32_t* row = A + rr * RW;
  return row[cc] | (cc > 0 ? row[cc - 1] : 0u) | (cc < RW - 1 ? row[cc + 1] : 0u);
}

__host__ __device__ inline int tile_words(int dilate_steps) {
  return 3 * (TR + 2 * ((dilate_steps + 31) / 32)) * (TC + 2 * dilate_steps);
}

// One round of dilate_steps dilations on every active frame, tile by tile in
// shared memory. Phase 1 reads frame b's plane of its round parity and
// writes the other, and marks chg[slot][b] when a tile changed a word;
// phase 2 reads f and writes buf[0].
template <bool PHASE2>
__device__ void dilate_round(const Params& a, const FrameState& st, int slot, uint32_t* sm) {
  const int RH = TR + 2 * a.halo_r, RW = TC + 2 * a.halo_c, RN = RH * RW;
  const int tiles_c = (a.w + TC - 1) / TC;
  const int n_tiles = ((a.hw + TR - 1) / TR) * tiles_c;
  const int n_act = *st.n;
  for (int t = blockIdx.x; t < n_act * n_tiles; t += gridDim.x) {
    const int b = st.list[t / n_tiles], tt = t - (t / n_tiles) * n_tiles;
    uint32_t* fb = a.f + b * a.plane;
    uint32_t* bb = a.buf[0] + b * a.plane;
    const bool odd = !PHASE2 && (st.it[b] & 1);
    const uint32_t* src = odd ? bb : fb;
    uint32_t* dst = odd ? fb : bb;
    const uint32_t* pb = a.p + b * a.plane;
    const int k0 = (tt / tiles_c) * TR - a.halo_r;
    const int c0 = (tt % tiles_c) * TC - a.halo_c;
    uint32_t* A = sm;
    uint32_t* B = sm + RN;
    uint32_t* P = sm + 2 * RN;
    for (int i = threadIdx.x; i < RN; i += NT) {
      int rr = i / RW, cc = i - rr * RW;
      A[i] = ld(src, k0 + rr, c0 + cc, a.hw, a.w);
      P[i] = ld(pb, k0 + rr, c0 + cc, a.hw, a.w);
    }
    __syncthreads();
    for (int step = 1; step <= a.dilate_steps; ++step) {
      const bool exact = (step % CARRY_EVERY == 0) || step == a.dilate_steps;
      for (int i = threadIdx.x; i < RN; i += NT) {
        int rr = i / RW, cc = i - rr * RW;
        uint32_t v = row_or(A, rr, cc, RW);
        uint32_t h = v | (v << 1) | (v >> 1);
        if (exact) {  // cross-word carry: bit 31 of the word above, bit 0 below
          if (rr > 0) h |= row_or(A, rr - 1, cc, RW) >> 31;
          if (rr < RH - 1) h |= row_or(A, rr + 1, cc, RW) << 31;
        }
        B[i] = A[i] | (P[i] & h);
      }
      __syncthreads();
      uint32_t* T = A;
      A = B;
      B = T;
    }
    bool changed = false;
    for (int i = threadIdx.x; i < TR * TC; i += NT) {
      int rr = i / TC + a.halo_r, cc = i % TC + a.halo_c;
      int k = k0 + rr, c = c0 + cc;
      if (k < a.hw && c < a.w) {
        uint32_t v = A[rr * RW + cc];
        if (!PHASE2) changed |= v != __ldcg(src + k * a.w + c);
        dst[k * a.w + c] = v;
      }
    }
    // The barrier also frees the shared memory for the next tile.
    if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(&a.chg[slot * a.nb + b], 1);
  }
}

// A round's result, the planes ``gs`` of every active frame, into f; marks
// chg[slot][b] when frame b changed.
__device__ void commit_round(const Params& a, const FrameState& st, int slot,
                             const uint32_t* gs) {
  const int n = (int)a.plane;
  const int n_act = *st.n;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int gsize = gridDim.x * NT;
  for (int i = 0; i < n_act; ++i) {
    const int b = st.list[i];
    const uint32_t* gb = gs + b * a.plane;
    uint32_t* fb = a.f + b * a.plane;
    bool changed = false;
    for (int e = gtid; e < n; e += gsize) {
      const uint32_t v = __ldcg(gb + e);
      changed |= v != __ldcg(fb + e);
      fb[e] = v;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(&a.chg[slot * a.nb + b], 1);
  }
}

// The 8 directional scans on the dilated planes in buf[0] of every active
// frame, then the result into f; marks chg[slot][b] when frame b changed.
__device__ void scan_round(const Params& a, const FrameState& st, int slot,
                           cg::grid_group& grid) {
  const int n = (int)a.plane;
  const int n_act = *st.n;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int gsize = gridDim.x * NT;
  const uint32_t* gs = a.buf[0];
  for (int dir = 0; dir < 8; ++dir) {
    const int extent = dir < 2 ? a.w : (dir < 4 ? a.h : min(a.h, a.w));
    const uint32_t* ps = a.p;
    for (int s = 1; s < extent; s *= 2) {
      const bool last = 2 * s >= extent;
      uint32_t* gd = gs == a.buf[0] ? a.buf[1] : a.buf[0];
      uint32_t* pd = ps == a.buf[2] ? a.buf[3] : a.buf[2];
      for (int i = 0; i < n_act; ++i) {
        const long long off = st.list[i] * a.plane;
        const uint32_t* gsb = gs + off;
        const uint32_t* psb = ps + off;
        for (int e = gtid; e < n; e += gsize) {
          const int k = e / a.w, c = e - k * a.w;
          const uint32_t gv = __ldcg(gsb + e), pv = __ldcg(psb + e);
          gd[off + e] = gv | (pv & upstream(gsb, k, c, dir, s, a.hw, a.w));
          if (!last) pd[off + e] = pv & upstream(psb, k, c, dir, s, a.hw, a.w);
        }
      }
      grid.sync();
      gs = gd;
      ps = pd;
    }
  }
  commit_round(a, st, slot, gs);
}

// Lists the frames that run round r (thread 0 only; the caller syncs the
// block). Every block computes the same list from the same state.
template <bool PHASE2>
__device__ void list_active(const Params& a, const FrameState& st, int r) {
  int n = 0;
  for (int b = 0; b < a.nb; ++b) {
    // Phase 1 runs its first round unconditionally; phase 2 starts at the
    // phase-1 exit state.
    const bool on = (!PHASE2 && r == 0) || (st.grow[b] && st.it[b] < a.cap);
    if (on) st.list[n++] = b;
  }
  *st.n = n;
}

template <bool PHASE2>
__global__ void __launch_bounds__(NT) hyst_kernel(Params a) {
  if (a.gate && __ldcg(a.gate) == 0) return;  // every block: the pending flag is down
  extern __shared__ uint32_t sm[];
  int* state = reinterpret_cast<int*>(sm + tile_words(a.dilate_steps));
  const FrameState st{state, state + a.nb, state + 2 * a.nb, state + 3 * a.nb};
  cg::grid_group grid = cg::this_grid();
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if (threadIdx.x == 0) {
    for (int b = 0; b < a.nb; ++b) {
      st.it[b] = PHASE2 ? a.flags[4 * b] : 0;
      st.grow[b] = PHASE2 ? a.flags[4 * b + 1] : 1;
    }
    list_active<PHASE2>(a, st, 0);
  }
  __syncthreads();
  if (PHASE2 && *st.n == 0) {  // every frame converged in phase 1
    for (int b = blockIdx.x * NT + threadIdx.x; b < a.nb; b += gridDim.x * NT) {
      a.flags[4 * b + 2] = st.it[b];
      a.flags[4 * b + 3] = st.grow[b];
    }
    return;
  }
  if (lead)
    for (int i = 0; i < 3 * a.nb; ++i) a.chg[i] = 0;
  grid.sync();

  for (int r = 0; *st.n > 0; ++r) {
    const int slot = r % 3;
    if (lead)
      for (int b = 0; b < a.nb; ++b) a.chg[((r + 1) % 3) * a.nb + b] = 0;
    if (PHASE2) {
      dilate_round<true>(a, st, slot, sm);
      grid.sync();
      scan_round(a, st, slot, grid);
    } else {
      dilate_round<false>(a, st, slot, sm);
    }
    grid.sync();
    if (threadIdx.x == 0) {
      for (int i = 0; i < *st.n; ++i) {
        const int b = st.list[i];
        st.grow[b] = *(volatile int*)&a.chg[slot * a.nb + b];
        ++st.it[b];
      }
      list_active<PHASE2>(a, st, r + 1);
    }
    __syncthreads();
  }
  if (!PHASE2) {  // frames that ended on the scratch plane: copy it back
    for (int b = 0; b < a.nb; ++b) {
      if (!(st.it[b] & 1)) continue;
      uint32_t* fb = a.f + b * a.plane;
      const uint32_t* bb = a.buf[0] + b * a.plane;
      for (int e = blockIdx.x * NT + threadIdx.x; e < a.plane; e += gridDim.x * NT)
        fb[e] = __ldcg(bb + e);
    }
  }
  if (lead) {
    for (int b = 0; b < a.nb; ++b) {
      a.flags[4 * b + (PHASE2 ? 2 : 0)] = st.it[b];
      a.flags[4 * b + (PHASE2 ? 3 : 1)] = st.grow[b];
    }
  }
}

// The column-split continuation of one frame (see the head of this file).
struct SplitParams {
  uint32_t* ff;        // (hw, fw) the frame's FINAL plane, updated in place
  const uint32_t* fp;  // (hw, fw) the frame's CANDIDATE plane
  uint32_t* sp;        // (n_split, hw, k + ws + k) the slices' CANDIDATE planes (scratch)
  int* fflags;         // (2, 2): row 0 read (round count, growing), row 1 written
  int* mchg;           // [3] "a seam round changed an owned word", rotating
  int fw, ws, k;       // frame columns, owned columns a slice, seam halo columns
  int cap1;            // inner rounds below it are dilations only
  int budget;          // the total round budget (max_iters)
  int chunked;         // a seam round spends its slowest slice's rounds (else 1)
};

// Slice i of a frame plane with its halo, zero outside the frame.
__device__ void split_extract(const Params& a, const SplitParams& s, const uint32_t* src,
                              uint32_t* dst) {
  const long long total = a.nb * a.plane;
  for (long long e = blockIdx.x * NT + threadIdx.x; e < total; e += (long long)gridDim.x * NT) {
    const int i = (int)(e / a.plane), rem = (int)(e - i * a.plane);
    const int kr = rem / a.w, c = rem - kr * a.w;
    const int gc = i * s.ws - s.k + c;
    dst[e] = (gc >= 0 && gc < s.fw) ? __ldcg(src + (long long)kr * s.fw + gc) : 0u;
  }
}

__global__ void __launch_bounds__(NT) split_kernel(Params a, SplitParams s) {
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  int it = s.fflags[0];
  if (s.fflags[1] == 0) {  // every block: the frame converged in phase 1
    if (lead) {
      s.fflags[2] = it;
      s.fflags[3] = 0;
    }
    return;
  }
  extern __shared__ uint32_t sm[];
  int* state = reinterpret_cast<int*>(sm + tile_words(a.dilate_steps));
  const FrameState st{state, state + a.nb, state + 2 * a.nb, state + 3 * a.nb};
  cg::grid_group grid = cg::this_grid();
  split_extract(a, s, s.fp, s.sp);
  if (lead) {
    for (int i = 0; i < 3 * a.nb; ++i) a.chg[i] = 0;
    for (int i = 0; i < 3; ++i) s.mchg[i] = 0;
  }
  int changed = 1;
  int r = 0;  // rounds over all seam rounds: the rotation of the chg slots
  for (int seam = 0; changed && it < s.budget; ++seam) {
    split_extract(a, s, s.ff, a.f);
    if (lead) s.mchg[(seam + 1) % 3] = 0;
    __syncthreads();  // the previous seam round's reads of the state are done
    if (threadIdx.x == 0) {
      for (int i = 0; i < a.nb; ++i) {
        st.it[i] = 0;
        st.grow[i] = 1;
      }
      list_active<false>(a, st, 0);  // round 0 runs on every slice
    }
    __syncthreads();
    grid.sync();
    for (int ri = 0; *st.n > 0; ++ri, ++r) {
      const int slot = r % 3;
      if (lead)
        for (int i = 0; i < a.nb; ++i) a.chg[((r + 1) % 3) * a.nb + i] = 0;
      dilate_round<true>(a, st, slot, sm);
      grid.sync();
      // Every active slice is at round ri: the kind of round is uniform.
      if (ri == 0 || ri < s.cap1) commit_round(a, st, slot, a.buf[0]);
      else scan_round(a, st, slot, grid);
      grid.sync();
      if (threadIdx.x == 0) {
        for (int i = 0; i < *st.n; ++i) {
          const int b = st.list[i];
          st.grow[b] = *(volatile int*)&a.chg[slot * a.nb + b];
          ++st.it[b];
        }
        list_active<true>(a, st, ri + 1);
      }
      __syncthreads();
    }
    int spent = 0;
    for (int i = 0; i < a.nb; ++i) spent = max(spent, st.it[i]);
    // Merge: the owned columns of every slice back into the frame's plane.
    const int mslot = seam % 3;
    const long long owned = (long long)a.hw * s.ws, total = a.nb * owned;
    bool ch = false;
    for (long long e = blockIdx.x * NT + threadIdx.x; e < total; e += (long long)gridDim.x * NT) {
      const int i = (int)(e / owned), rem = (int)(e - i * owned);
      const int kr = rem / s.ws, c = rem - kr * s.ws;
      const uint32_t v = __ldcg(a.f + i * a.plane + (long long)kr * a.w + s.k + c);
      uint32_t* dst = s.ff + (long long)kr * s.fw + i * s.ws + c;
      ch |= v != __ldcg(dst);
      *dst = v;
    }
    if (__syncthreads_or(ch) && threadIdx.x == 0) atomicOr(&s.mchg[mslot], 1);
    grid.sync();
    changed = *(volatile int*)&s.mchg[mslot];
    it += s.chunked ? spent : 1;
  }
  if (lead) {
    s.fflags[2] = it;
    s.fflags[3] = changed;
  }
}

// Frame blockIdx.y of the batch: every byte of its edge map written once, to
// out[index[b]] when an index is given (the sweep's original pair order: the
// TPU sweep kernel's prefetch-indexed output block), else to out[b]. An index
// outside [0, B) writes nothing.
__global__ void unpack_kernel(const uint32_t* __restrict__ f, uint8_t* __restrict__ out,
                              const int* __restrict__ index, int nb, int h, int w) {
  const int n = h * w;
  const int to = index ? index[blockIdx.y] : (int)blockIdx.y;
  if (to < 0 || to >= nb) return;
  const uint32_t* fb = f + (size_t)blockIdx.y * ((h + 31) / 32) * w;
  uint8_t* ob = out + (size_t)to * n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int r = i / w, c = i - r * w;
    ob[i] = ((fb[(r >> 5) * w + c] >> (r & 31)) & 1u) ? 255 : 0;
  }
}

// The owned cores of a batch of extended tiles' FINAL planes, (T, hwe, ew)
// words, into their places in the edge maps: tile t = (b, i, j) over an
// nty x ntx grid per frame; its core is the h_loc x w_loc pixels from row
// e_top, lane e_left of its plane, and lands at out[b][i h_loc + r][j w_loc
// + c] of the (B, oh, ow) maps. Each byte of a core is written once, so a
// sharded frame needs no gather after it; aligning the core is a bit and
// lane offset in the word index. Bound: the output bytes (33 MB for an 8K
// frame, ~10 us at HBM rate); one byte per thread, simple first.
__global__ void unpack_core_kernel(const uint32_t* __restrict__ f, uint8_t* __restrict__ out,
                                   int hwe, int ew, int e_top, int e_left, int h_loc, int w_loc,
                                   int nty, int ntx, int oh, int ow) {
  const int t = blockIdx.y;
  const int b = t / (nty * ntx), i = (t / ntx) % nty, j = t % ntx;
  const uint32_t* ft = f + (size_t)t * hwe * ew + e_left;
  uint8_t* ob = out + ((size_t)b * oh + (size_t)i * h_loc) * ow + (size_t)j * w_loc;
  const int n = h_loc * w_loc;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n; k += gridDim.x * blockDim.x) {
    const int r = k / w_loc, c = k - r * w_loc;
    const int er = e_top + r;
    ob[(size_t)r * ow + c] = ((ft[(size_t)(er >> 5) * ew + c] >> (er & 31)) & 1u) ? 255 : 0;
  }
}

int scratch_planes(int phase) { return phase == 2 ? 4 : 1; }

// Dynamic shared memory: the tile's A, B and P planes with the halo, then
// the per-frame state (FrameState: 3 ints per frame and a count).
size_t smem_bytes(int dilate_steps, int nb) {
  return ((size_t)tile_words(dilate_steps) + 3 * (size_t)nb + 1) * sizeof(uint32_t);
}

// The most blocks of the cooperative kernel ``kern`` that can be co-resident
// on `device` (the cooperative grid's limit), computed on the first launch
// for each (kernel, dilate_steps, batch) and cached.
cudaError_t max_grid(const void* kern, int device, int dilate_steps, int nb, int* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kern, device, dilate_steps, nb);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  const size_t bytes = smem_bytes(dilate_steps, nb);
  int optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;  // batch too large for one launch
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = cache[key] = per_sm * sms;
  return cudaSuccess;
}

// The cooperative grid of a launch over ``scale`` planes of a: it covers
// their tiles or their words, whichever is more, up to the limit.
cudaError_t grid_blocks(const void* kern, const Params& a, long long scale, int device,
                        unsigned* out) {
  if (a.dilate_steps < 1 || a.dilate_steps > MAX_DILATE_STEPS || a.nb < 1)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = max_grid(kern, device, a.dilate_steps, a.nb, &limit);
  if (err != cudaSuccess) return err;
  const long long n_tiles = scale * ((a.hw + TR - 1) / TR) * ((a.w + TC - 1) / TC);
  const long long n_blocks_words = (scale * a.plane + NT - 1) / NT;
  long long grid = n_tiles > n_blocks_words ? n_tiles : n_blocks_words;
  *out = (unsigned)(grid > limit ? limit : grid);
  return cudaSuccess;
}

template <bool PHASE2>
cudaError_t launch_rounds(Params a, int device, cudaStream_t stream) {
  // Phase 1 starts with every frame active: its grid covers the batch's
  // tiles. Phase 2 works on the escalated frames, rarely more than one, and
  // a grid barrier costs more the more blocks take part, so its grid covers
  // one frame (x8 1080p batch with one escalating frame: 1.53 -> 1.24
  // ms/frame on an H100; with none escalating, unchanged).
  const void* kern = (const void*)hyst_kernel<PHASE2>;
  unsigned grid = 0;
  cudaError_t err = grid_blocks(kern, a, PHASE2 ? 1 : a.nb, device, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), args,
                                    smem_bytes(a.dilate_steps, a.nb), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Params make_params(void* f, const void* p, void* scratch, void* flags, const void* gate, int nb,
                   int h, int w, int dilate_steps, int cap, int phase) {
  Params a;
  a.nb = nb;
  a.hw = (h + 31) / 32;
  a.w = w;
  a.h = h;
  a.plane = (long long)a.hw * w;
  a.f = static_cast<uint32_t*>(f);
  a.p = static_cast<const uint32_t*>(p);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  const int planes = scratch_planes(phase);
  for (int i = 0; i < 4; ++i) a.buf[i] = s + (i < planes ? i : 0) * nb * a.plane;
  a.chg = reinterpret_cast<int*>(s + planes * nb * a.plane);
  a.flags = static_cast<int*>(flags);
  a.gate = static_cast<const int*>(gate);
  a.dilate_steps = dilate_steps;
  a.cap = cap;
  a.halo_r = (dilate_steps + 31) / 32;
  a.halo_c = dilate_steps;
  return a;
}

}  // namespace

// int32 words of scratch the phase needs for B frames: its scratch planes +
// 3 change flags per frame.
extern "C" long long cc_hyst_scratch_words(int nb, int h, int w, int phase) {
  return (long long)nb * (scratch_planes(phase) * (long long)((h + 31) / 32) * w + 3);
}

extern "C" int cc_hyst_phase1(void* f, const void* p, void* scratch, void* flags,
                              const void* gate, int nb, int h, int w, int dilate_steps,
                              int scan_after, int max_iters, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int cap = scan_after < max_iters ? scan_after : max_iters;
  Params a = make_params(f, p, scratch, flags, gate, nb, h, w, dilate_steps, cap, 1);
  return launch_rounds<false>(a, device, static_cast<cudaStream_t>(stream));
}

extern "C" int cc_hyst_phase2(void* f, const void* p, void* scratch, void* flags,
                              const void* gate, int nb, int h, int w, int dilate_steps,
                              int max_iters, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  Params a = make_params(f, p, scratch, flags, gate, nb, h, w, dilate_steps, max_iters, 2);
  return launch_rounds<true>(a, device, static_cast<cudaStream_t>(stream));
}

extern "C" int cc_unpack(const void* f, void* out, const void* index, int nb, int h, int w,
                         int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nb < 1 || nb > 65535) return cudaErrorInvalidValue;  // grid.y
  const long long blocks = ((long long)h * w + 255) / 256;
  const dim3 grid((unsigned)(blocks < (1 << 30) ? blocks : (1 << 30)), nb);
  unpack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<uint8_t*>(out),
      static_cast<const int*>(index), nb, h, w);
  return cudaGetLastError();
}

extern "C" int cc_unpack_core(const void* f, void* out, int tiles, int hwe, int ew, int e_top,
                              int e_left, int h_loc, int w_loc, int nty, int ntx, int oh, int ow,
                              int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (tiles < 1 || tiles > 65535) return cudaErrorInvalidValue;  // grid.y
  const long long blocks = ((long long)h_loc * w_loc + 255) / 256;
  const dim3 grid((unsigned)(blocks < (1 << 30) ? blocks : (1 << 30)), tiles);
  unpack_core_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<uint8_t*>(out), hwe, ew, e_top, e_left, h_loc,
      w_loc, nty, ntx, oh, ow);
  return cudaGetLastError();
}

// int32 words of scratch the column-split continuation needs: the slices'
// FINAL and CANDIDATE planes and four scratch planes each, 3 change flags a
// slice and 3 for the seam rounds.
extern "C" long long cc_split_scratch_words(int n_split, int h, int slice_w) {
  return (long long)n_split * (6 * (long long)((h + 31) / 32) * slice_w + 3) + 3;
}

// The column-split continuation of one (ceil(h/32), w) frame: flags row 0
// (round count, growing) is read on the device, row 1 written. ``chunk`` < 1
// is the unchunked mode: slices run to max_iters and a seam round counts 1.
extern "C" int cc_split_converge(void* f, const void* p, void* scratch, void* flags, int h, int w,
                                 int n_split, int dilate_steps, int scan_after, int max_iters,
                                 int chunk, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (n_split < 1 || w % n_split || max_iters < 1) return cudaErrorInvalidValue;
  const int ws = w / n_split, k = ws < 64 ? ws : 64;
  const int inner = chunk >= 1 ? chunk : max_iters;
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  const long long planes = (long long)n_split * ((h + 31) / 32) * (ws + 2 * k);
  // The slice batch: its FINAL planes first, then the four scratch planes
  // and the change flags where make_params puts them, then the CANDIDATEs.
  Params a = make_params(sc, sc + 5 * planes + 3 * n_split, sc + planes, nullptr, nullptr, n_split,
                         h, ws + 2 * k, dilate_steps, inner, 2);
  SplitParams s;
  s.ff = static_cast<uint32_t*>(f);
  s.fp = static_cast<const uint32_t*>(p);
  s.sp = sc + 5 * planes + 3 * n_split;
  s.mchg = reinterpret_cast<int*>(s.sp + planes);
  s.fflags = static_cast<int*>(flags);
  s.fw = w;
  s.ws = ws;
  s.k = k;
  s.cap1 = scan_after < inner ? scan_after : inner;
  s.budget = max_iters;
  s.chunked = chunk >= 1;
  const void* kern = (const void*)split_kernel;
  unsigned grid = 0;
  cudaError_t err = grid_blocks(kern, a, n_split, device, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&a, &s};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), args,
                                    smem_bytes(dilate_steps, n_split), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
