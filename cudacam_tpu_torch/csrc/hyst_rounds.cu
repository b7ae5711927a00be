// Hysteresis rounds on a batch of packed planes.
//
// Replaces the back half of the TPU megakernel (cudacam_tpu/ops/pallas/
// megakernel.py: _phase1_finalize; per frame of a batch in _kernel_batched),
// its phase-2 continuation (_cont_kernel / _cont_call), and the convergence
// of the fused hysteresis kernel and of the threshold-sweep kernel
// (hysteresis_fused.py: _kernel, _sweep_kernel; the sweep runs both phases
// once per pair). On a sharded frame they are also the export megakernel's
// in-kernel phase 1 (megakernel.py:607 via :569) and the local saturate of
// the collective round loop (hysteresis_fused.py:844 saturate_packed ->
// _sat_kernel :742: both phases, the round count starting at 0 on each
// call), over a batch of extended tiles, inside sharded_loop_kernel or as two
// launches per round. The unpacks to edge maps (the megakernel's _unpack_out
// and the core unpack) are unpack.cu's. Every round executes the round
// schedule of cudacam_tpu/ops/bitpack.py::_make_ops exactly: the same
// dilate_steps with bitpack's default carry cadence (every 8th step exact
// across words) and an exact last step, the same 8 scan directions in the
// same order, the same round counting and stop test. So an output cut off by
// the max_iters cap is the JAX package's, bit for bit.
//
// Design: one cooperative persistent kernel per phase, launched with
// cudaLaunchCooperativeKernel, 512 threads a block. One implementation of a
// round, round_loop, which every kernel here runs but phase 1's register
// route (below). Each frame's (hw, w)
// planes are cut into full-height column bands of bw columns, chosen at
// launch so that the bands of the frames a launch starts on are about as
// many as the SMs (a multiple of 32 where the launch scans, of 16 for phase
// 1 alone): phase 1 takes 16 at 1080p (120 bands), 128 for an x8 1080p
// batch; phase 2 lays out one frame, 32 at 1080p and 4K, 64 at 8K. A band
// spans every word row, so every vertical neighbourhood stays inside it. A
// block owns its band for the whole loop and keeps it in shared memory: two
// FINAL planes (Jacobi steps; the second one holds a scan's propagate
// words) and the CANDIDATE plane, core and `halo` columns each side, hw x
// (bw + 2 halo + 1) words each, loaded once and written back when the loop
// ends (about 166 KB a block at 8K). Only edge columns and summaries cross
// bands, through L2. Where a launch's bands outnumber its co-resident blocks
// (more frames still growing in phase 2 than its one-frame layout, or a
// batch past the card's shared memory), a block takes several bands and
// each stage loads and stores a band's words around its work; the stages
// and barriers are the same.
//
// Height segments. Past the word rows a block's shared memory holds as one
// band with one halo column (476 where a launch scans, 785 for phase 1
// alone, in the H100's 227 KB), each band is cut into the fewest stacked
// height segments that fit, each of MIN_SEG word rows or more: a block then
// owns a tile (a band of a segment). A tile dilates with ceil(halo / 32)
// word rows of vertical halo above and below, published and refreshed with
// its halo columns as one edge ring. Directions 2 and 3 scan a tile with
// carry-in zero and publish each column's (carry out, every word
// propagates); after a barrier each tile folds the segments upstream into
// its carry-in and runs the carries again. A diagonal's tile scans with
// carry-in zero at its segment edge too and publishes its exit row's
// (L, Q); after a barrier it carries them down the lines that enter by
// that edge (fix_diagonal: a line crosses a band in bw <= 32 MIN_SEG rows,
// so one segment edge at most), which makes its L and Q the full band's;
// the fold and apply follow as before, the carry column folded over bw / 32
// rows more each side. Six grid barriers more a phase-2 round; 1080p, 4K
// and 8K planes never take segments. Each cooperative kernel is compiled
// with and without this code (SEG) and a launch takes the one its layout
// needs; without it a tile's row geometry is a compile-time constant, so
// the one-segment kernels keep the registers they had before segments (at
// 128 a thread, a few more live values spilled them: PERF.md §6).
//
// * A round's dilate_steps dilations run in shared memory on band + halo,
//   halo = min(dilate_steps, bw) columns taken from the neighbours' edges as
//   they published them (two slots of edge planes, by the parity of the
//   publication), a __syncthreads a step; then the band publishes its own
//   edges. One grid barrier a round; where the halo that fits is narrower
//   than the steps, the round runs in segments of halo steps with a barrier
//   each, the carry cadence counted over the whole round. CANDIDATE is never
//   reloaded. A round only adds bits, so a band changed iff its core's
//   popcount grew: no second read of the old plane.
// * The scans need no doubling across the frame. A direction's result along
//   a line is the associative scan of (g, p) pairs. Directions 2 and 3
//   (top->bottom, bottom->top) lie in a band column: each word's own scan,
//   then the carries across words as a ballot scan of 32 words at a time; no
//   grid barrier. Directions 0, 1 and the diagonals 4-7 cross bands only at
//   a band's side edge: the band scans itself with zero carry-in (a warp a
//   word row, 32 columns in five shuffle steps; on a diagonal the carries
//   across words as bit vectors over the columns, which reach back at most
//   bw / 32 word rows), giving its local result L and the propagate product
//   Q from its entry edge, and publishes its exit column (L, Q), 2 hw words.
//   After one grid barrier each band folds the summaries upstream of it into
//   its carry-in column (the composition of two bands shifts by bw image
//   rows on a diagonal, whole words) and applies G = L | (Q & carry); the
//   next direction's local scan follows before the next barrier.
// * Grid barriers a phase-2 round: one per dilation segment (one where the
//   halo covers the steps: 1080p, 4K at 32 inner steps, 8K) and one per
//   crossing direction (6): 7 at 1080p, 4K and 8K (90, 100 and 106 passes
//   of the whole plane through L2, each followed by a barrier, before);
//   with height segments 6 more (the vertical directions' and the
//   diagonals' carries across segments): 13. A phase-1 round: one.
//   cc_hyst_layout reports a launch's layout and count.
// * Bound: latency. Phase 1 by the dilation steps in shared memory, each a
//   warp's serial pass over its rows and columns and a __syncthreads, far
//   more than by the round's one grid barrier (~1.2 us of a 1080p x8
//   round's ~32 us); phase 2 besides by the folds' L2 round trips and the
//   barriers. The words moved and the operations are a few percent of it
//   (PERF.md §5, §6).
//
// Phase 1's register route (hyst_kernel<false, false, R>, reg_plan). A
// phase-1 launch whose columns a thread pair holds whole (hw <= HW_MAX word
// rows) and whose bands, with a halo of dilate_steps columns, all fit the
// co-resident grid takes a round loop that keeps each band's words in
// registers instead: a block a band, its lanes the columns of the band and
// its halo, 16 to a warp, each column's R word rows (R = hw rounded up to
// even) of FINAL and CANDIDATE split between lane i (the top R / 2) and
// lane i + 16 of the warp (the bottom R / 2). A dilation step is the Jacobi
// step of dilate_band on the thread's rows: the words left and right by
// __shfl_up/down_sync within the half-warp; the column across a warp's edge
// from the block's shared memory, where the edge lanes publish theirs after
// each step (two buffers by the step's parity, one __syncthreads a step,
// which the step's shuffles run before); at the exact steps, the rows above
// and below from the thread's own registers and, across the halves, by
// __shfl_xor_sync. No other word crosses a thread within a round. The halo
// lanes reload their words from the edge slot once a round, the core's edge
// columns are published there, a core thread changed iff its popcount grew
// (one __syncthreads_or), and one grid barrier ends the round. The round
// schedule, the change flags, the frame state, the counters and the flags
// are round_loop's; the two routes give the same bits. Every other launch
// (taller planes: 4K, 8K whole frames; dilate_steps past the lanes; batches
// past the grid) and every other loop (phase 2, sharded_loop_kernel,
// split_kernel, which need the bands in shared memory) keeps round_loop.
// cc_hyst_layout reports the route a launch takes. Bound: the SMs' 32-bit
// integer lanes (six logic and shift operations a word a step, over about
// 1.25 times the frame's words with the halos), the step's barrier and,
// once a round, the L2 round trips of the halo and the change flags
// (PERF.md §6).
// * Per-frame state. Each block holds a copy of every frame's (round count,
//   still growing) in shared memory and updates it after each round's last
//   barrier from the frame's "changed" slot, so all blocks agree on which
//   frames are active without another barrier. A frame that stopped is
//   frozen: its bands do no more work, its rounds are not counted. The round
//   loop runs while any frame is active.
// * The "changed" flags rotate over three slots of B words: a slot is
//   cleared one round before it is written and two barriers after its last
//   read, so no reset races a write or a read.
// * Phase 1 writes flags[b][0] = (round count, still growing); phase 2
//   reads them on the device, works only on frames still growing, and
//   returns at once when none is, so the host never reads a flag back.
//   Phase 2 writes flags[b][1] for every frame.
// * The main path's launches count their rounds in two 64-bit words
//   (Params::count, a slot of the wrappers' counter block, round_counts()):
//   block 0's thread 0 adds the frames of the loop's layout (phase 1: every
//   frame; phase 2: those it continues) once, and after each round's last
//   barrier the frames that round ran, so the sum is the rounds phase 1
//   took, or phase 2 added. No barrier waits on the atomics, and a launch
//   adds nothing after its last round. The local saturate, split_kernel
//   and sharded_loop_kernel's rounds count nothing (null, or CARRY);
//   sharded_loop_kernel adds (1, collective rounds) at its end.
// * The rounds see the h x w image only: the bits of rows at and past h
//   are cleared as a plane is loaded, so they come out zero (every pack
//   leaves them zero; the plain versions clear them the same way). A band
//   scans a whole column, which equals bitpack's doubling steps (< h).
// * The layout (occupancy per shared-memory size) is chosen once per
//   (kernel, device, frames, batch, plane shape, dilate_steps) on the first
//   launch; later launches reuse it.
//
// split_kernel replaces the column-split continuation (hysteresis_fused.py:876
// converge_packed_split, driven by megakernel.py:921 _cont_split: a host-traced
// loop of one saturate_packed launch per column slice with XLA pad / slice /
// concatenate between). Here the seam loops of a batch of frames are ONE
// cooperative launch, gated on each frame's growing flag as phase 2 is. The
// n_split slices of each frame still growing (k + ws + k columns: the ws it
// owns and k = min(64, ws) of halo each side, zero outside the frame) are
// the frames of round_loop, cut into bands that stay in the blocks' shared
// memory for the whole launch, as sharded_loop_kernel's tiles do:
// * load once: each band loads its F and P words straight from the frame's
//   planes (16 bytes a lane where the address allows it);
// * a seam round runs the saturate schedule on every slice of the frames
//   still in their loop (one unconditional dilation round, dilation rounds
//   below scan_after, then dilations + scans, while the slice changes and
//   below the inner cap; round_loop with SEAM: a frame out of its loop takes
//   no round), then the change test (some owned word changed: a seam round
//   only adds bits to a slice, so the popcount of the owned columns grew)
//   and, from the bands that hold owned columns within k of a seam, those
//   columns into the slice's seam records; one grid barrier; each frame
//   adds the most rounds any of its slices took to its budget count (or 1
//   unchunked) and goes on while the round changed an owned word and the
//   count is below max_iters;
// * the seam refresh on the resident bands: the bands that hold a slice's
//   halo columns overwrite them with the neighbours' records (an overwrite,
//   as the reference's extract is: a slice may have grown bits in its halo
//   that the neighbour does not hold), every band publishes its edges
//   again, one grid barrier; interior bands keep their words;
// * write once: the owned columns of FINAL into the frames' planes at the
//   end. So a call is one launch whatever the cap and the batch, and the
//   host reads nothing back.
// Layout (split_plan, reported by cc_split_layout): one frame's slices, a
// block a band, as phase 2 lays out one frame; where the frames still
// growing hold more bands than that, each block streams its bands through
// shared memory stage by stage, from slice planes extracted into scratch
// once a launch. Bound: as the round kernels; a seam round moves only the
// seam columns and the edges through L2 besides its rounds'.

// sharded_loop_kernel replaces the collective round loop of the sharded path
// on one card (cudacam_tpu/parallel/packed_halo.py:256-306: a lax.while_loop
// whose body is K9 on every tile, the FINAL strip exchange, and a psum of
// "some tile still growing | some new halo bit"), and the two strip
// exchanges before it (:285-286). The whole loop is ONE cooperative launch.
// Its prologue refreshes both planes in global memory, the grid's threads
// split between the tiles: halo.cuh's publish_planes on CANDIDATE's and
// FINAL's words, one grid barrier, apply_planes on both, and the loop's
// first flag ("some FINAL bit new, or some flags[t][0][1]") read after a
// second barrier; then the budget test, so a budget of 0 still refreshes both, as
// the reference does. Each tile's bands then stay resident in shared
// memory: the first round loop (round_loop with CARRY) loads a band's
// CANDIDATE words (never changed again) and its FINAL core once, and the
// kernel writes FINAL back once at its end. A collective round runs phase
// 1 (from round 0) and phase 2 (from the state phase 1 left in each block's
// copy, no barrier between) on every tile, each writing the tiles' flags as
// K9 does, then the same refresh on the resident bands:
// each band publishes what its tile's neighbours read of it, one grid
// barrier, each band ORs what falls in its own halo rows and lanes into its
// words (its change test counting the new bits) and publishes its edges
// again, and the flag "some new bit, or some flags[t][1][1]" is read after
// the barrier that ends the round. The loop runs while the flag is up and
// below the round budget, then writes the rounds taken. So a sharded HYSTER
// call is four launches (the export pack, its phase 1, this loop, the core
// unpack) whatever the cap and however soon the tiles converge, and nothing
// is read back.
// * Layout (choose_layout over every tile, reported by
//   cc_sharded_loop_layout): every tile's bands in both phases, a block a
//   band, the rounds' barriers grid barriers; where the bands outnumber the
//   co-resident blocks, each block streams its bands through shared memory
//   stage by stage, the refresh included.
// * Grid barriers a collective round besides its rounds': two (the
//   refresh's and the flag's); the prologue's: two. Nothing moves through
//   global memory between the two phases, and the refresh moves only what
//   crosses tiles.
// * Bound: as the round kernels (latency: the dilation steps and the
//   barriers); the refresh moves two word rows and 2 x 64 lanes a tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "device_guard.cuh"
#include "halo.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;                // threads per block
constexpr int CARRY_EVERY = 8;         // bitpack._CARRY_EVERY: every 8th dilation step is exact
constexpr int MAX_DILATE_STEPS = 256;  // bitpack's schedule on the GPU: the wrappers' limit
constexpr int BAND_UNIT = 32;          // a scanning launch's band widths: multiples of a word's rows
constexpr int MIN_BAND = 16;           // a launch of dilation rounds only (phase 1): multiples of 16
constexpr int MAX_SCAN_BAND = 256;     // a scanning band's widest: 8 words of column bits
constexpr int MAX_SCAN_WORDS = MAX_SCAN_BAND / 32;
constexpr int N_XDIR = 6;              // scan directions that cross bands: 0, 1, 4, 5, 6, 7
constexpr int FOLD_BATCH = 8;          // upstream bands a fold loads in one pass
constexpr int MIN_SEG = 64;            // the fewest word rows of a height segment
constexpr int N_SEAM = 6;              // words a column of a tile's seam record: see Params::seam
constexpr int SEAM_BATCH = 8;          // words a thread loads at once in split_kernel's seam refresh

struct Params {
  uint32_t* f;        // (B, hw, w) FINAL planes, updated in place
  const uint32_t* p;  // (B, hw, w) CANDIDATE planes
  uint32_t* q;        // (B, hw, w) a tile's propagate words between barriers, when not resident
  uint32_t* edge;     // [2 slots][B] (hw, w) planes: the tiles' published edge rings
  uint32_t* summ;     // per band: [N_XDIR][2][hw] the exit column (L, Q) of each local scan
  uint32_t* seam;     // per (layout frame, height segment): [N_SEAM][w] what crosses its exit
                      // row: directions 2 and 3's (carry out, all propagate), a diagonal's (L, Q)
  int* cnt;           // per tile: the popcount of its core
  int* chg;           // [3][B] per-round change flags
  int* flags;         // (B, 2, 2): phase-1 (it, growing), final (it, growing); null: not written
  unsigned long long* count;  // the main path's (planes, rounds) counters; null: nothing counted
  int nb;             // frames in the batch
  int hw, w;          // plane rows, plane columns (= image columns)
  uint32_t tail;      // the bits of the last plane row that lie above h
  long long plane;    // words per plane: hw * w
  int dilate_steps, cap;
  int scan_from;      // the rounds of a loop from this index on run the scans
  int bw, halo, rs, nbw;  // band width, halo columns, shared row stride, bands per frame
  int ns, hs, vh, vq;     // height segments, a segment's most rows, the dilation's vertical halo
                          // rows, the margin rows of a diagonal's carry column
  int rows, wsw;          // rows of a shared plane (hs + 2 vh), words of the band workspace
};

// A launch's shared geometry for (hw, w) planes cut into ns height segments
// of bw-column bands with `halo` halo columns (see Params).
struct Geom {
  int hs, vh, vq, rows, rs, words;
};

__host__ __device__ inline Geom geometry(int hw, int ns, int bw, int halo) {
  Geom g;
  g.hs = (hw + ns - 1) / ns;
  g.vh = ns > 1 ? (halo + 31) / 32 : 0;
  g.vq = ns > 1 ? (bw + 31) / 32 : 0;
  g.rows = g.hs + 2 * g.vh;
  g.rs = bw + 2 * halo + 1;
  const int vrows = g.hs + 2 * g.vq, bits = g.hs * 5 * ((bw + 31) / 32),
            fold = vrows * 2 * FOLD_BATCH;
  g.words = 3 * g.rows * g.rs + vrows + (bits > fold ? bits : fold);
  return g;
}

// Per-frame state, one copy per block in shared memory after the workspace.
struct FrameState {
  int* it;    // [B] round count
  int* grow;  // [B] still growing (the last round changed the frame)
  int* on;    // [B] active this round
  int* lay;   // [B] the frames of the band layout (active in the loop's first round)
  int* n;     // [1] frames active this round
  int* nl;    // [1] frames in the layout
};

// The shared workspace of one tile: two FINAL planes (Jacobi steps; the
// second one holds the propagate words Q of a scan), the CANDIDATE plane,
// `rows` rows of rs words each (vertical halo, core, vertical halo; a row is
// halo, core, halo, one pad word: rs is odd, so a column's words fall in
// distinct banks); the carry column with its margins; five bit vectors over
// the band's columns a word row (diagonal_scan), or a fold's batch of
// summary words; two ints.
struct Ws {
  uint32_t* x[2];
  uint32_t* pc;
  uint32_t* v;  // row 0 of the tile; rows -vq .. hs + vq - 1 exist
  uint32_t* bits;
  int* red;
};

__device__ __forceinline__ Ws workspace(const Params& a, uint32_t* sm) {
  const int n = a.rows * a.rs;
  return Ws{{sm, sm + n}, sm + 2 * n, sm + 3 * n + a.vq, sm + 3 * n + a.hs + 2 * a.vq,
            reinterpret_cast<int*>(sm + a.wsw)};
}

__device__ __forceinline__ FrameState frame_state(const Params& a, uint32_t* sm) {
  int* s = reinterpret_cast<int*>(sm + a.wsw) + 2;
  return FrameState{s, s + a.nb, s + 2 * a.nb, s + 3 * a.nb, s + 4 * a.nb, s + 4 * a.nb + 1};
}

// Tile g of the layout: a band of a height segment. Its frame, band index
// (gb: over the layout's frames; j: in the frame), segment index (s; sg:
// over the layout's frames), first column and width, first word row and
// rows; and the launch's segments, vertical halo rows and carry-column
// margin (Params' ns, vh, vq). Only a frame's last band is narrower than
// bw; segments differ by a row at most. Compiled without segments (SEG
// false), the row fields are constants: the one-segment kernels keep no
// register and do no arithmetic for them.
struct Band {
  int g, gb, sg, b, j, s, c0, cb, k0, hk, ns, vh, vq;
};

template <bool SEG>
__device__ __forceinline__ Band band_of(const Params& a, const FrameState& st, int g) {
  Band d;
  d.g = g;
  if constexpr (SEG) {
    const int per = a.ns * a.nbw, li = g / per, rem = g - li * per;
    d.s = rem / a.nbw;
    d.j = rem - d.s * a.nbw;
    d.b = st.lay[li];
    d.gb = li * a.nbw + d.j;
    d.sg = li * a.ns + d.s;
    d.k0 = (int)((long long)d.s * a.hw / a.ns);
    d.hk = (int)((long long)(d.s + 1) * a.hw / a.ns) - d.k0;
    d.ns = a.ns;
    d.vh = a.vh;
    d.vq = a.vq;
  } else {
    d.s = 0;
    d.j = g % a.nbw;
    d.b = st.lay[g / a.nbw];
    d.gb = g;
    d.sg = g / a.nbw;
    d.k0 = 0;
    d.hk = a.hw;
    d.ns = 1;
    d.vh = 0;
    d.vq = 0;
  }
  d.c0 = d.j * a.bw;
  d.cb = min(a.bw, a.w - d.c0);
  return d;
}

// The offset of a tile's core word (0, 0) in a shared plane.
__device__ __forceinline__ int core0(const Params& a, Band d) { return d.vh * a.rs + a.halo; }

// Direction DIR of bitpack._make_ops as (dc, dr): downstream is +dc columns
// and +dr image rows a step; the value s cells upstream of (r, c) is at
// (r - dr s, c - dc s). 2 and 3 (top->bottom, bottom->top) stay in a band.
template <int DIR>
struct Dir {
  static constexpr int dc = (DIR == 0 || DIR == 4 || DIR == 7) ? 1 : -1;
  static constexpr int dr = DIR < 2 ? 0 : ((DIR == 4 || DIR == 6) ? 1 : -1);
  static constexpr int slot = DIR < 2 ? DIR : DIR - 2;  // its summary's index
};

constexpr int NW = NT / 32;  // warps per block
constexpr uint32_t FULL = 0xffffffffu;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// The loops over a band's words below run a warp a word row and a lane a
// column: no division, a column's words in distinct banks (rs is odd).

// Shared rows [r0, r1) and columns [lo, hi) of X from frame d.b of the
// (B, hw, w) planes src: shared (i, cc) is plane row k0 - vh + i, frame
// column c0 - halo + cc, zero outside the frame. The bits of rows at and
// past h read as zero, so the rounds see the h x w image only.
__device__ void load_rows(const Params& a, uint32_t* X, const uint32_t* src, Band d, int r0,
                          int r1, int lo, int hi) {
  const uint32_t* s = src + d.b * a.plane;
  const int base = d.c0 - a.halo;
  for (int i = r0 + warp_id(); i < r1; i += NW) {
    const int k = d.k0 - d.vh + i;
    const bool in = k >= 0 && k < a.hw;
    const uint32_t m = k == a.hw - 1 ? a.tail : FULL;
    const uint32_t* row = s + (long long)(in ? k : 0) * a.w;
    for (int cc = lo + lane_id(); cc < hi; cc += 32) {
      const int c = base + cc;
      X[i * a.rs + cc] = (in && c >= 0 && c < a.w) ? __ldcg(row + c) & m : 0u;
    }
  }
}

__device__ __forceinline__ void load_core(const Params& a, uint32_t* X, const uint32_t* src,
                                          Band d) {
  load_rows(a, X, src, d, d.vh, d.vh + d.hk, a.halo, a.halo + d.cb);
}

// The CANDIDATE words of the tile's core, halo columns and vertical halo.
__device__ __forceinline__ void load_candidates(const Params& a, Ws ws, Band d) {
  load_rows(a, ws.pc, a.p, d, 0, d.hk + 2 * d.vh, 0, d.cb + 2 * a.halo);
}

__device__ void store_core(const Params& a, const uint32_t* X, uint32_t* dst, Band d) {
  uint32_t* o = dst + d.b * a.plane + (long long)d.k0 * a.w + d.c0;
  X += core0(a, d);
  for (int k = warp_id(); k < d.hk; k += NW)
    for (int t = lane_id(); t < d.cb; t += 32) o[(long long)k * a.w + t] = X[k * a.rs + t];
}

// The tile's edge ring into edge slot `slot`, at its places in the frame's
// plane there: its first and last `halo` core columns, and with height
// segments its first and last vh core rows whole.
__device__ void publish_edges(const Params& a, const uint32_t* X, Band d, int slot) {
  uint32_t* e = a.edge + ((long long)slot * a.nb + d.b) * a.plane + (long long)d.k0 * a.w + d.c0;
  const int h2 = 2 * a.halo;
  X += core0(a, d);
  for (int k = warp_id(); k < d.hk; k += NW) {
    const uint32_t* row = X + k * a.rs;
    uint32_t* er = e + (long long)k * a.w;
    if (k < d.vh || k >= d.hk - d.vh) {
      for (int t = lane_id(); t < d.cb; t += 32) er[t] = row[t];
    } else {
      for (int m = lane_id(); m < h2; m += 32) {
        const int t = m < a.halo ? m : d.cb - h2 + m;  // core column
        if (t >= 0 && t < d.cb) er[t] = row[t];
      }
    }
  }
}

// The tile's halo from edge slot `slot`: its neighbours' edge rings as they
// published them (the halo columns of its core rows, and the vertical halo
// rows whole), zero outside the frame.
__device__ void refresh_halo(const Params& a, uint32_t* X, Band d, int slot) {
  const uint32_t* e = a.edge + ((long long)slot * a.nb + d.b) * a.plane;
  const int h2 = 2 * a.halo, base = d.c0 - a.halo, W = d.cb + h2;
  for (int i = warp_id(); i < d.hk + 2 * d.vh; i += NW) {
    const int k = d.k0 - d.vh + i;
    const bool in = k >= 0 && k < a.hw, whole = i < d.vh || i >= d.vh + d.hk;
    const uint32_t* er = e + (long long)(in ? k : 0) * a.w;
    for (int m = lane_id(); m < (whole ? W : h2); m += 32) {
      const int cc = whole ? m : (m < a.halo ? m : d.cb + m);  // shared column
      const int c = base + cc;
      X[i * a.rs + cc] = (in && c >= 0 && c < a.w) ? __ldcg(er + c) : 0u;
    }
  }
}

__device__ __forceinline__ uint32_t row_or(const uint32_t* row, int cc, int W) {
  return row[cc] | (cc > 0 ? row[cc - 1] : 0u) | (cc < W - 1 ? row[cc + 1] : 0u);
}

// Steps s0 + 1 .. s0 + n of the round's dilate_steps dilations on the tile
// in X[cur] (core and halo; n <= halo <= 32 vh where there are height
// segments), Jacobi between the two planes. Returns the plane that holds
// the result, whose core is exact: a step moves a bit one pixel at most, so
// what the zeros past the halo get wrong stays outside the core. Step i
// recomputes only the columns the core still depends on after it.
__device__ int dilate_band(const Params& a, Ws ws, int cur, Band d, int s0, int n) {
  const int W = d.cb + 2 * a.halo, RS = a.rs, R = d.hk + 2 * d.vh;
  for (int i = 1; i <= n; ++i) {
    const int step = s0 + i;
    const bool exact = step % CARRY_EVERY == 0 || step == a.dilate_steps;
    const int m = n - i, lo = a.halo - m, hi = a.halo + d.cb + m;
    const uint32_t* __restrict__ A = ws.x[cur];
    const uint32_t* __restrict__ Pc = ws.pc;
    uint32_t* __restrict__ B = ws.x[cur ^ 1];
    for (int k = warp_id(); k < R; k += NW) {
      const uint32_t* row = A + k * RS;
      for (int cc = lo + lane_id(); cc < hi; cc += 32) {
        const uint32_t v = row_or(row, cc, W);
        uint32_t h = v | (v << 1) | (v >> 1);
        if (exact) {  // cross-word carry: bit 31 of the word above, bit 0 below
          if (k > 0) h |= row_or(row - RS, cc, W) >> 31;
          if (k < R - 1) h |= row_or(row + RS, cc, W) << 31;
        }
        B[k * RS + cc] = row[cc] | (Pc[k * RS + cc] & h);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

// The sum of every thread's v over the block (every thread gets it).
__device__ __forceinline__ int block_sum(Ws ws, int v) {
  __syncthreads();
  if (threadIdx.x == 0) *ws.red = 0;
  __syncthreads();
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  if (lane_id() == 0) atomicAdd(ws.red, v);
  __syncthreads();
  return *ws.red;
}

// The popcount of the tile's core in X (every thread gets it).
__device__ int core_popc(const Params& a, Ws ws, const uint32_t* X, Band d) {
  __syncthreads();
  if (threadIdx.x == 0) *ws.red = 0;
  __syncthreads();
  int c = 0;
  X += core0(a, d);
  for (int k = warp_id(); k < d.hk; k += NW)
    for (int t = lane_id(); t < d.cb; t += 32) c += __popc(X[k * a.rs + t]);
  for (int o = 16; o; o >>= 1) c += __shfl_down_sync(FULL, c, o);
  if (lane_id() == 0) atomicAdd(ws.red, c);
  __syncthreads();
  return *ws.red;
}

// The round's change test of a tile: a round only adds bits, so the tile
// changed iff its core's popcount grew. Marks chg[slot][b].
__device__ void test_change(const Params& a, Ws ws, const uint32_t* X, Band d,
                            int slot) {
  const int c = core_popc(a, ws, X, d);
  if (threadIdx.x == 0) {
    volatile int* cnt = a.cnt + d.g;
    if (c != *cnt) {
      *cnt = c;
      atomicOr(&a.chg[slot * a.nb + d.b], 1);
    }
  }
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* V, int i, int lo, int hi) {
  return (i >= lo && i < hi) ? V[i] : 0u;
}

// Word k of the column V (words lo .. hi - 1) shifted by s image rows, down
// for s > 0, zero fill: bitpack._shift_px on one column.
__device__ __forceinline__ uint32_t vshift(const uint32_t* V, int k, int s, int lo, int hi) {
  if (s > 0) {
    const int q = s >> 5, r = s & 31;
    const uint32_t b = word_at(V, k - q, lo, hi);
    return r ? (b << r) | (word_at(V, k - q - 1, lo, hi) >> (32 - r)) : b;
  }
  s = -s;
  const int q = s >> 5, r = s & 31;
  const uint32_t b = word_at(V, k + q, lo, hi);
  return r ? (b >> r) | (word_at(V, k + q + 1, lo, hi) << (32 - r)) : b;
}

// Bits s .. s + 31 of the bit vector v (nv words), zero outside it.
__device__ __forceinline__ uint32_t window(const uint32_t* v, int s, int nv) {
  const int q = s >> 5, r = s & 31;
  const uint32_t lo = (q >= 0 && q < nv) ? v[q] : 0u;
  if (!r) return lo;
  const uint32_t hi = (q + 1 >= 0 && q + 1 < nv) ? v[q + 1] : 0u;
  return (lo >> r) | (hi << (32 - r));
}

// v shifted by s image rows along direction DIR's line (down for dr > 0)
// inside its word: the value s columns upstream, as a word row sees it.
template <int DIR>
__device__ __forceinline__ uint32_t along(uint32_t v, int s) {
  if constexpr (Dir<DIR>::dr > 0) return v << s;
  if constexpr (Dir<DIR>::dr < 0) return v >> s;
  return v;
}

// One warp's inclusive scan over its 32 lanes (consecutive columns from
// the entry edge) of direction DIR inside one word row: the generates g[0..G)
// and the propagate q, in five shuffle steps (Kogge-Stone); a value from s
// lanes upstream moves s rows along the line, inside the word. On return
// q is the product of the candidates along the line from lane 0.
template <int DIR, int G>
__device__ __forceinline__ void warp_scan(uint32_t (&g)[G], uint32_t& q) {
  const int lane = lane_id();
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t qu = __shfl_up_sync(FULL, q, s);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const uint32_t gu = __shfl_up_sync(FULL, g[j], s);
      if (lane >= s) g[j] |= q & along<DIR>(gu, s);
    }
    if (lane >= s) q &= along<DIR>(qu, s);
  }
}

// A diagonal local scan in three passes, t counting columns from the entry
// edge (tests/test_torch_round_bands.py models it):
// 1. each word row on its own, a warp a word row and its lanes columns,
//    32 at a time (warp_scan): L (the lines that stay in the word, carry-in
//    zero), E (the propagate product from the band's entry edge, staying in
//    the word) into X and Qp, and D (from an entry at the word's entry bit
//    at a column >= 1); the exit bit (31 going down, 0 going up) of each as
//    a bit vector over t (ballots);
// 2. the carries into the entry bit as bit vectors over t, for G and for
//    Q: c_k = (l | (d & (c_prev << 31))) << 1 of the word row before; a
//    carry moves 32 columns a word row, so c_k depends on the nv word rows
//    before it only, and each word row computes its own;
// 3. each word row again (D by warp_scan): G = L | (D & c spread over the
//    word's bits), Q = E | (D & the Q carries spread).
template <int DIR>
__device__ void diagonal_scan(const Params& a, Ws ws, uint32_t* __restrict__ X,
                              uint32_t* __restrict__ Qp, Band d) {
  constexpr int dc = Dir<DIR>::dc, dr = Dir<DIR>::dr;
  constexpr uint32_t ENTRY = dr > 0 ? 1u : 0x80000000u;
  constexpr int EXIT = dr > 0 ? 31 : 0;
  // The tile's core rows as the whole column: what enters through its top
  // (bottom) edge joins in fix_diagonal.
  const int RS = a.rs, hw = d.hk, H = core0(a, d), cb = d.cb, nv = (cb + 31) >> 5, lane = lane_id();
  const uint32_t* __restrict__ P = ws.pc;
  uint32_t* __restrict__ lv = ws.bits;
  uint32_t* __restrict__ dv = lv + hw * nv;
  uint32_t* __restrict__ ev = dv + hw * nv;
  uint32_t* __restrict__ cgv = ev + hw * nv;
  uint32_t* __restrict__ cqv = cgv + hw * nv;
  for (int k = warp_id(); k < hw; k += NW) {
    uint32_t last[3] = {0u, 0u, 0u};  // L, D, E at the previous chunk's last column
    for (int c = 0; c < nv; ++c) {
      const int t = c * 32 + lane;
      const bool in = t < cb;
      const int i = k * RS + H + (dc > 0 ? t : cb - 1 - t);
      const uint32_t p = in ? P[i] : 0u;
      uint32_t g[3] = {in ? X[i] : 0u, t >= 1 ? p & ENTRY : 0u, t == 0 ? p : 0u};
      if (lane == 0)
        for (int j = 0; j < 3; ++j) g[j] |= p & along<DIR>(last[j], 1);
      uint32_t q = p;
      warp_scan<DIR, 3>(g, q);
      if (in) {
        X[i] = g[0];
        Qp[i] = g[2];
      }
      const uint32_t lb = __ballot_sync(FULL, in && ((g[0] >> EXIT) & 1u));
      const uint32_t db = __ballot_sync(FULL, in && ((g[1] >> EXIT) & 1u));
      const uint32_t eb = __ballot_sync(FULL, in && ((g[2] >> EXIT) & 1u));
      if (lane == 0) {
        lv[k * nv + c] = lb;
        dv[k * nv + c] = db;
        ev[k * nv + c] = eb;
      }
      for (int j = 0; j < 3; ++j) last[j] = __shfl_sync(FULL, g[j], 31);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < hw; k += NT) {
    // A carry moves 32 columns a word row, so what entered nv word rows
    // back has left the band: start there with carry zero.
    const int before = dr > 0 ? k : hw - 1 - k, back = before < nv ? before : nv;
    uint32_t cg[MAX_SCAN_WORDS], cq[MAX_SCAN_WORDS];
#pragma unroll
    for (int i = 0; i < MAX_SCAN_WORDS; ++i) cg[i] = cq[i] = 0u;
    for (int j = back; j >= 1; --j) {
      const int kp = k - dr * j;  // the word row the carry leaves
      // u = l | (d & (c << 31)) word by word; the next carry is u << 1.
      uint32_t ug_prev = 0u, uq_prev = 0u, cg_prev = 0u, cq_prev = 0u;
#pragma unroll
      for (int i = 0; i < MAX_SCAN_WORDS; ++i) {
        if (i < nv) {
          const int o = kp * nv + i;
          const uint32_t dd = dv[o];
          const uint32_t ug = lv[o] | (dd & ((cg[i] << 31) | (cg_prev >> 1)));
          const uint32_t uq = ev[o] | (dd & ((cq[i] << 31) | (cq_prev >> 1)));
          cg_prev = cg[i];
          cq_prev = cq[i];
          cg[i] = (ug << 1) | (ug_prev >> 31);
          cq[i] = (uq << 1) | (uq_prev >> 31);
          ug_prev = ug;
          uq_prev = uq;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_SCAN_WORDS; ++i) {
      if (i < nv) {
        cgv[k * nv + i] = cg[i];
        cqv[k * nv + i] = cq[i];
      }
    }
  }
  __syncthreads();
  for (int k = warp_id(); k < hw; k += NW) {
    uint32_t last = 0u;  // D at the previous chunk's last column
    for (int c = 0; c < nv; ++c) {
      const int t = c * 32 + lane;
      const bool in = t < cb;
      const int i = k * RS + H + (dc > 0 ? t : cb - 1 - t);
      const uint32_t p = in ? P[i] : 0u;
      uint32_t g[1] = {t >= 1 ? p & ENTRY : 0u};
      if (lane == 0) g[0] |= p & along<DIR>(last, 1);
      uint32_t q = p;
      warp_scan<DIR, 1>(g, q);
      if (in && g[0]) {
        // Bit b of a word entered at column t - b (down) or t - 31 + b (up).
        uint32_t wg = window(cgv + k * nv, t - 31, nv), wq = window(cqv + k * nv, t - 31, nv);
        if (dr > 0) {
          wg = __brev(wg);
          wq = __brev(wq);
        }
        X[i] |= g[0] & wg;
        Qp[i] |= g[0] & wq;
      }
      last = __shfl_sync(FULL, g[0], 31);
    }
  }
  __syncthreads();
}

// The exit column's (L, Q) of a tile's scan of crossing direction DIR into
// its band's summary, at the tile's rows.
template <int DIR>
__device__ void write_summary(const Params& a, const uint32_t* X, const uint32_t* Qp, Band d) {
  uint32_t* s = a.summ + ((long long)d.gb * N_XDIR + Dir<DIR>::slot) * 2 * a.hw + d.k0;
  const int ce = core0(a, d) + (Dir<DIR>::dc > 0 ? d.cb - 1 : 0);
  for (int k = threadIdx.x; k < d.hk; k += NT) {
    s[k] = X[k * a.rs + ce];
    s[a.hw + k] = Qp[k * a.rs + ce];
  }
}

// The local scan of crossing direction DIR on the tile's core, carry-in
// zero at its entry edge (and, on a diagonal, at the edge between height
// segments it enters by): the result L in X, in place, and the propagate
// product Q from the entry edge in Qp; then the exit column's (L, Q) into
// the band's summary, and on a diagonal with height segments the exit row's
// (L, Q) bits into the segment's seam record. Along a row (0, 1) a warp
// scans a word row, 32 columns at a time (warp_scan); a diagonal is
// diagonal_scan.
template <int DIR>
__device__ void local_scan(const Params& a, Ws ws, uint32_t* X, uint32_t* Qp, Band d) {
  constexpr int dc = Dir<DIR>::dc, dr = Dir<DIR>::dr;
  const int RS = a.rs, hw = d.hk, H = core0(a, d), cb = d.cb, lane = lane_id();
  if constexpr (dr != 0) {
    diagonal_scan<DIR>(a, ws, X, Qp, d);
    if (d.ns > 1) {
      uint32_t* sr = a.seam + (long long)d.sg * N_SEAM * a.w + 4 * a.w + d.c0;
      const int i0 = H + (dr > 0 ? hw - 1 : 0) * RS, bit = dr > 0 ? 31 : 0;
      for (int c = threadIdx.x; c < cb; c += NT) {
        sr[c] = (X[i0 + c] >> bit) & 1u;
        sr[a.w + c] = (Qp[i0 + c] >> bit) & 1u;
      }
    }
  } else {
    const int nch = (cb + 31) >> 5;
    for (int k = warp_id(); k < hw; k += NW) {
      uint32_t gin = 0u, qin = ~0u;  // L and Q at the previous chunk's last column
      for (int c = 0; c < nch; ++c) {
        const int t = c * 32 + lane;
        const bool in = t < cb;
        const int i = k * RS + H + (dc > 0 ? t : cb - 1 - t);
        const uint32_t p = in ? ws.pc[i] : 0u;
        uint32_t g[1] = {in ? X[i] : 0u};
        if (lane == 0) g[0] |= p & gin;
        uint32_t q = p;
        warp_scan<DIR, 1>(g, q);
        q &= qin;
        if (in) {
          X[i] = g[0];
          Qp[i] = q;
        }
        gin = __shfl_sync(FULL, g[0], 31);
        qin = __shfl_sync(FULL, q, 31);
      }
    }
    __syncthreads();
  }
  write_summary<DIR>(a, X, Qp, d);
}

// With height segments, diagonal DIR's lines that enter the tile through
// its edge with the segment upstream (above going down, below going up):
// after a grid barrier, the tile takes that segment's exit row (L, Q) as
// its local scan published it (a line crosses a band in bw <= 32 hk rows,
// so an exit row's lines all entered by the band's entry column and its
// bits are the band's) and carries them down each line as far as the
// candidates reach, a thread a line: L |= the carried L, Q = the carried Q
// (a line from that edge had none). Then the band's scan is the same as
// over a full-height band, and the tile writes its summary again.
template <int DIR>
__device__ __noinline__ void fix_diagonal(const Params& a, Ws ws, uint32_t* X, uint32_t* Qp, Band d) {
  constexpr int dc = Dir<DIR>::dc, dr = Dir<DIR>::dr;
  const int su = d.s - dr;  // the segment upstream
  if (su < 0 || su >= a.ns) return;
  const uint32_t* src = a.seam + (long long)(d.sg - dr) * N_SEAM * a.w + 4 * a.w + d.c0;
  const int RS = a.rs, H = core0(a, d), cb = d.cb, nrow = 32 * d.hk;
  for (int t0 = threadIdx.x + 1; t0 < cb; t0 += NT) {  // t0: columns from the entry edge
    const int cp = dc > 0 ? t0 - 1 : cb - t0;             // the column of t0 - 1
    uint32_t cl = __ldcg(src + cp), cq = __ldcg(src + a.w + cp);
    for (int i = 0; (cl | cq) && t0 + i < cb && i < nrow; ++i) {
      const int r = dr > 0 ? i : nrow - 1 - i, c = dc > 0 ? t0 + i : cb - 1 - t0 - i;
      const int idx = H + (r >> 5) * RS + c;
      const uint32_t bit = 1u << (r & 31);
      if (!(ws.pc[idx] & bit)) break;
      if (cl) atomicOr(&X[idx], bit);  // lines one row apart share a word
      if (cq) atomicOr(&Qp[idx], bit);
    }
  }
  __syncthreads();
  write_summary<DIR>(a, X, Qp, d);
}

// Direction dir's carry into the tile from the summaries of the bands
// upstream of it, then G = L | (Q & carry) on every core word. The carry
// column V is the result just outside the entry edge; a band composes onto
// it as V' = L | (Q & V shifted by dr * bw rows), whole words since bw is a
// multiple of 32, so word k of V folds the chain of words k - dr (m - 1)
// bw / 32 of the m-th band upstream, nearest first, and stops where the
// product of the Qs is zero or the chain leaves the frame (mostly within a
// band or two). A frame's last band, the only narrower one, is never
// crossed on the way. The summaries hold every plane row, so a tile folds
// V at its rows and, on a diagonal with height segments, at vq rows more
// each side, where the lines that entered by the segment upstream began.
template <int DIR>
__device__ void fold_apply(const Params& a, Ws ws, uint32_t* X, const uint32_t* Qp,
                           Band d) {
  constexpr int dc = Dir<DIR>::dc, dr = Dir<DIR>::dr;
  const int hw = a.hw, RS = a.rs, H = core0(a, d), cb = d.cb, lane = lane_id();
  const int up = dc > 0 ? d.j : a.nbw - 1 - d.j;  // bands upstream
  if (up == 0) return;  // the frame's border: carry 0
  const int wq = a.bw / BAND_UNIT, mg = dr != 0 ? d.vq : 0, nr = d.hk + 2 * mg;
  const int kb = d.k0 - mg;  // the plane row of V's first row
  auto summary = [&](int m) {  // the m-th band upstream's summary of direction DIR
    return a.summ + ((long long)(d.gb - dc * m) * N_XDIR + Dir<DIR>::slot) * 2 * hw;
  };
  uint32_t* V = ws.v - mg;
  // The nearest FOLD_BATCH bands' words, every load of the block at once.
  uint32_t* fl = ws.bits;
  uint32_t* fq = fl + nr * FOLD_BATCH;
  for (int e = threadIdx.x; e < nr * FOLD_BATCH; e += NT) {
    const int k = e / FOLD_BATCH, m = e % FOLD_BATCH + 1, kk = kb + k - dr * (m - 1) * wq;
    uint32_t l = 0u, q = 0u;
    if (m <= up && kk >= 0 && kk < hw) {
      l = __ldcg(summary(m) + kk);
      q = __ldcg(summary(m) + hw + kk);
    }
    fl[e] = l;
    fq[e] = q;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nr; k += NT) {
    uint32_t acc_l = 0u, acc_q = ~0u;
    for (int m = 0; m < FOLD_BATCH; ++m) {
      acc_l |= acc_q & fl[k * FOLD_BATCH + m];
      acc_q &= fq[k * FOLD_BATCH + m];
    }
    V[k] = acc_l;
    fl[k * FOLD_BATCH] = acc_q;  // nonzero: the chain goes on
  }
  __syncthreads();
  // The chains that go on past FOLD_BATCH bands: a warp a word, its lanes
  // loading 32 bands at once and composing them in five shuffle steps.
  for (int k = warp_id(); up > FOLD_BATCH && k < nr; k += NW) {
    uint32_t acc_l = V[k], acc_q = fl[k * FOLD_BATCH];
    for (int m0 = FOLD_BATCH; m0 < up && acc_q; m0 += 32) {
      const int m = m0 + lane + 1, kk = kb + k - dr * (m - 1) * wq;
      uint32_t l = 0u, q = 0u;
      if (m <= up && kk >= 0 && kk < hw) {
        l = __ldcg(summary(m) + kk);
        q = __ldcg(summary(m) + hw + kk);
      }
      for (int off = 1; off < 32; off <<= 1) {  // lane 0: bands m0 + 1 .. m0 + 32
        const uint32_t l2 = __shfl_down_sync(FULL, l, off), q2 = __shfl_down_sync(FULL, q, off);
        l |= q & l2;
        q &= q2;
      }
      acc_l |= acc_q & __shfl_sync(FULL, l, 0);
      acc_q &= __shfl_sync(FULL, q, 0);
    }
    __syncwarp();
    if (lane == 0) V[k] = acc_l;
  }
  __syncthreads();
  for (int k = warp_id(); k < d.hk; k += NW)
    for (int t = lane; t < cb; t += 32) {  // t: columns from the entry edge
      const int i = k * RS + H + (dc > 0 ? t : cb - 1 - t);
      const uint32_t c = dr == 0 ? ws.v[k] : vshift(ws.v, k, dr * (t + 1), -mg, d.hk + mg);
      X[i] |= Qp[i] & c;
    }
  __syncthreads();
}

// One warp's carries along core column t of the tile, down (up) from the
// carry cin into its first word: each word's G = L | (Q & its carry in),
// with L and Q the word's own scan from its entry bit (X, T). Bit j of a
// ballot over 32 consecutive words is word j's exit bit (of L, and of Q),
// so a warp scans 32 words' carries in five steps on one word. Returns the
// carry out of the column's last word; *full (where given): every word
// propagates.
__device__ uint32_t column_carry(const Params& a, uint32_t* X, const uint32_t* T, Band d, int t,
                                 bool down, uint32_t cin, bool* full) {
  const int hw = d.hk, RS = a.rs, H = core0(a, d), lane = lane_id(), exit_bit = down ? 31 : 0;
  bool all = true;
  for (int n0 = 0; n0 < hw; n0 += 32) {
    const int n = n0 + lane, cnt = min(32, hw - n0);
    const bool in = n < hw;
    const int i = (down ? n : hw - 1 - n) * RS + H + t;
    const uint32_t l = in ? X[i] : 0u, q = in ? T[i] : 0u;
    uint32_t g = __ballot_sync(FULL, (l >> exit_bit) & 1u);
    uint32_t p = __ballot_sync(FULL, (q >> exit_bit) & 1u);
    all = all && p == (cnt == 32 ? FULL : (1u << cnt) - 1u);
    g |= p & cin;  // bit j: the carry out of word n0 + j
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      g |= p & (g << s);
      p &= p << s;
    }
    const uint32_t into = lane ? (g >> (lane - 1)) & 1u : cin;
    if (in) X[i] = l | (q & (0u - into));
    cin = (g >> (cnt - 1)) & 1u;
  }
  if (full) *full = all;
  return cin;
}

// Direction 2 (top->bottom, down) or 3 (bottom->top) on the tile's core,
// carry-in zero at its entry row. Each word first on its own, in parallel:
// its scan with carry-in zero (five doubling steps) into X and the
// propagate product from its entry bit into T; then the carries across
// words (column_carry). With one segment the tile spans every word row and
// this is the direction's result: no grid barrier. With height segments
// the tile also writes each column's (carry out, every word propagates) to
// its segment's seam record, and vertical_apply finishes after a barrier.
__device__ void vertical_scan(const Params& a, Ws ws, uint32_t* X, uint32_t* T, Band d,
                              bool down) {
  const int hw = d.hk, RS = a.rs, H = core0(a, d), cb = d.cb, lane = lane_id();
  for (int k = warp_id(); k < hw; k += NW)
    for (int t = lane; t < cb; t += 32) {
      const int i = k * RS + H + t;
      uint32_t g = X[i], pp = ws.pc[i], q = pp;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        if (down) {
          g |= pp & (g << s);
          q &= (q << s) | ((1u << s) - 1u);
          pp &= pp << s;
        } else {
          g |= pp & (g >> s);
          q &= (q >> s) | ~(~0u >> s);
          pp &= pp >> s;
        }
      }
      X[i] = g;
      T[i] = q;
    }
  __syncthreads();
  uint32_t* sr = a.seam + (long long)d.sg * N_SEAM * a.w + (down ? 0 : 2) * a.w + d.c0;
  for (int t = warp_id(); t < cb; t += NW) {
    bool full;
    const uint32_t out = column_carry(a, X, T, d, t, down, 0u, &full);
    if (d.ns > 1 && lane == 0) {
      sr[t] = out;
      sr[a.w + t] = full;
    }
  }
  __syncthreads();
}

// Directions 2 and 3 in turn on a tile that spans every word row (one
// segment): each whole, with no grid barrier.
__device__ void vertical_scans(const Params& a, Ws ws, uint32_t* X, uint32_t* T, Band d) {
  for (int down = 1; down >= 0; --down) vertical_scan(a, ws, X, T, d, down);
}

// With height segments, direction 2 or 3's carry into each core column from
// the seam records of the segments upstream (nearest first, while every
// word of the ones between propagates), then the carries down (up) the
// column again from it: as G = L | (Q & carry) word by word, a second pass
// from the tile's local result gives the scan's bits.
__device__ __noinline__ void vertical_apply(const Params& a, uint32_t* X, const uint32_t* T,
                                           Band d, bool down) {
  const int dr = down ? 1 : -1, lane = lane_id();
  const uint32_t* base = a.seam + (long long)(d.sg - d.s) * N_SEAM * a.w + (down ? 0 : 2) * a.w + d.c0;
  for (int t = warp_id(); t < d.cb; t += NW) {
    uint32_t cin = 0u;
    if (lane == 0) {
      uint32_t acc_q = 1u;
      for (int s = d.s - dr; s >= 0 && s < a.ns && acc_q; s -= dr) {
        const uint32_t* r = base + (long long)s * N_SEAM * a.w + t;
        cin |= acc_q & __ldcg(r);
        acc_q &= __ldcg(r + a.w);
      }
    }
    cin = __shfl_sync(FULL, cin, 0);
    if (cin) column_carry(a, X, T, d, t, down, cin, nullptr);
  }
  __syncthreads();
}

// The scan functions for a direction known only at run time: the local
// scan, and what finishes a direction after a grid barrier (a crossing
// direction's fold and apply, a vertical one's carry across segments, or a
// diagonal's fix-up across segments). The two that run only with height
// segments stay out of line.
template <bool SEG>
__device__ void local_scan_dir(const Params& a, Ws ws, uint32_t* X, uint32_t* Qp, Band d,
                               int dir) {
  if constexpr (SEG) {
    if (dir == 2 || dir == 3) {
      vertical_scan(a, ws, X, Qp, d, dir == 2);
      return;
    }
  }
  switch (dir) {
    case 0: local_scan<0>(a, ws, X, Qp, d); break;
    case 1: local_scan<1>(a, ws, X, Qp, d); break;
    case 4: local_scan<4>(a, ws, X, Qp, d); break;
    case 5: local_scan<5>(a, ws, X, Qp, d); break;
    case 6: local_scan<6>(a, ws, X, Qp, d); break;
    default: local_scan<7>(a, ws, X, Qp, d); break;
  }
}

template <bool SEG>
__device__ void finish_dir(const Params& a, Ws ws, uint32_t* X, uint32_t* Qp, Band d, int dir,
                           bool fix) {
  if constexpr (SEG) {
    if (dir == 2 || dir == 3) {
      vertical_apply(a, X, Qp, d, dir == 2);
      return;
    }
    if (fix) {
      switch (dir) {
        case 4: fix_diagonal<4>(a, ws, X, Qp, d); break;
        case 5: fix_diagonal<5>(a, ws, X, Qp, d); break;
        case 6: fix_diagonal<6>(a, ws, X, Qp, d); break;
        default: fix_diagonal<7>(a, ws, X, Qp, d); break;
      }
      return;
    }
  }
  switch (dir) {
    case 0: fold_apply<0>(a, ws, X, Qp, d); break;
    case 1: fold_apply<1>(a, ws, X, Qp, d); break;
    case 4: fold_apply<4>(a, ws, X, Qp, d); break;
    case 5: fold_apply<5>(a, ws, X, Qp, d); break;
    case 6: fold_apply<6>(a, ws, X, Qp, d); break;
    default: fold_apply<7>(a, ws, X, Qp, d); break;
  }
}

// The scan stages of a phase-2 round, one grid barrier after each: stage s
// finishes direction *dir (*fix: a diagonal's fix-up across segments, which
// its fold and apply follow in the next stage), then runs the local scans
// that follow. With one segment, 6 stages: 0, 1 (then 2 and 3 in full), 4,
// 5, 6, 7. With height segments, 12: 0, 1, 2, 3, then fix-up and apply of
// each of 4, 5, 6, 7. SEG: the launch's layout has height segments.
template <bool SEG>
__device__ __forceinline__ void scan_stage(int s, int* dir, bool* fix) {
  if constexpr (!SEG) {
    *dir = s < 2 ? s : s + 2;
    *fix = false;
  } else {
    *dir = s < 4 ? s : 4 + (s - 4) / 2;
    *fix = s >= 4 && (s - 4) % 2 == 0;
  }
}

// Marks the frames that run round r (thread 0 only; the caller syncs the
// block). Every block computes the same state. MASK (split_kernel's seam
// rounds): the first round too runs only the frames whose grow the caller
// set.
template <bool PHASE2, bool MASK = false>
__device__ void list_active(const Params& a, const FrameState& st, int r) {
  int n = 0;
  for (int b = 0; b < a.nb; ++b) {
    // Phase 1 runs its first round unconditionally; phase 2 starts at the
    // phase-1 exit state.
    const bool on = (!PHASE2 && !MASK && r == 0) || (st.grow[b] && st.it[b] < a.cap);
    st.on[b] = on;
    n += on;
  }
  *st.n = n;
}

// What sharded_loop_kernel's round loops (CARRY) carry from one to the
// next, the same in every block: the FINAL plane of the workspace, the edge
// publications so far (the latest is in slot (ex - 1) & 1) and the rounds
// so far (the change flags rotate over three slots by them).
struct Carry {
  int cur, ex, q;
};

// One round loop on every frame of a: dilation rounds, and from round
// a.scan_from on rounds of dilations and the 8 scans (hyst_kernel's body;
// each seam round of split_kernel runs one loop on its slices, each
// collective round of sharded_loop_kernel a phase-1 and a phase-2 loop).
// Every block of a cooperative grid calls it with the same arguments and
// takes the same branches: the per-frame state is a copy per block. PHASE2
// starts from flags[b][0] (read through L2) and writes flags[b][1]; phase 1
// starts every frame at round 0 and writes flags[b][0]. The planes are read
// at the start and written back at the end; a caller syncs the grid before
// it reads them. SEG: compiled for layouts with height segments (a launch
// takes the kernel its layout needs), so the code that carries across
// segments is not in the one-segment kernels.
// CARRY (sharded_loop_kernel): the bands of every frame stay in the blocks'
// shared memory from one loop to the next, loaded by the first phase-1 loop
// of the launch and stored by the kernel at its end; phase 2 starts from
// the state phase 1 left in the block's copy. SEAM (with CARRY,
// split_kernel): the kernel loads the bands and sets each frame's round
// count and grow before every loop; a frame whose grow is 0 takes no round.
// Without CARRY the code is the round kernels' alone: a local that outlives
// the loop (a hoisted Params field, an argument more to list_active) moves
// their registers and spills.
template <bool PHASE2, bool SEG, bool CARRY = false, bool SEAM = false>
__device__ void round_loop(const Params& a, uint32_t* sm, cg::grid_group& grid,
                           Carry* c = nullptr) {
  const FrameState st = frame_state(a, sm);
  const Ws ws = workspace(a, sm);
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if constexpr (CARRY) {
    if (threadIdx.x == 0) {
      for (int b = 0; !PHASE2 && !SEAM && b < a.nb; ++b) {
        st.it[b] = 0;
        st.grow[b] = 1;
      }
      list_active<PHASE2, SEAM>(a, st, 0);
    }
  } else if (threadIdx.x == 0) {
    for (int b = 0; b < a.nb; ++b) {
      st.it[b] = PHASE2 ? __ldcg(a.flags + 4 * b) : 0;
      st.grow[b] = PHASE2 ? __ldcg(a.flags + 4 * b + 1) : 1;
    }
    list_active<PHASE2>(a, st, 0);
    int nl = 0;
    for (int b = 0; b < a.nb; ++b)
      if (st.on[b]) st.lay[nl++] = b;
    *st.nl = nl;
    if (lead && a.count && nl) atomicAdd(a.count, (unsigned long long)nl);
  }
  __syncthreads();
  if (PHASE2 && *st.n == 0) {  // every frame converged in phase 1
    for (int b = blockIdx.x * NT + threadIdx.x; b < a.nb; b += gridDim.x * NT) {
      a.flags[4 * b + 2] = st.it[b];
      a.flags[4 * b + 3] = st.grow[b];
    }
    return;
  }
  // The layout: tiles (bw-column bands of ns height segments) of the
  // frames active in the first round, tile g on block g mod grid. A block
  // that owns one tile keeps it in its shared memory for the whole loop;
  // with more tiles than blocks, each stage loads a tile's words and stores
  // them back (FINAL in f, Q in q).
  const int bands = *st.nl * a.nbw * (SEG ? a.ns : 1);
  const bool resident = bands <= (int)gridDim.x;
  int cur = 0;  // the FINAL plane of the workspace
  int ex = 1;   // edge publications so far: the latest is in slot (ex - 1) & 1
  int q = 0;    // the rounds before this loop
  if constexpr (CARRY) {
    cur = c->cur;
    ex = c->ex;
    q = c->q;
  }
  if (!CARRY || (!SEAM && q == 0)) {
    for (int g = blockIdx.x; g < bands; g += gridDim.x) {
      const Band d = band_of<SEG>(a, st, g);
      if (resident) {  // zero first: the columns outside the frame stay 0
        for (int i = threadIdx.x; i < 3 * a.rows * a.rs; i += NT) sm[i] = 0u;
        __syncthreads();
        load_candidates(a, ws, d);
      }
      load_core(a, ws.x[0], a.f, d);
      __syncthreads();
      publish_edges(a, ws.x[0], d, 0);
      const int n = core_popc(a, ws, ws.x[0], d);
      if (threadIdx.x == 0) a.cnt[g] = n;
    }
    if (lead)
      for (int i = 0; i < 3 * a.nb; ++i) a.chg[i] = 0;
    grid.sync();
  }

  const int nseg = (a.dilate_steps + a.halo - 1) / a.halo;
  for (int r = 0; *st.n > 0; ++r) {
    const int slot = (q + r) % 3;
    if (lead)
      for (int b = 0; b < a.nb; ++b) a.chg[((q + r + 1) % 3) * a.nb + b] = 0;
    const bool scan = r >= a.scan_from;
    // The dilations, in segments of at most `halo` steps: the halo from
    // the edges last published, the steps, and the edges published again,
    // or after the last segment of a scan round the local scan of
    // direction 0. One grid barrier a segment.
    for (int seg = 0; seg < nseg; ++seg) {
      const int s0 = seg * a.halo, n = min(a.halo, a.dilate_steps - s0);
      const bool to_scan = scan && seg == nseg - 1;
      for (int g = blockIdx.x; g < bands; g += gridDim.x) {
        const Band d = band_of<SEG>(a, st, g);
        if (!st.on[d.b]) continue;
        if (!resident) {
          cur = 0;
          load_candidates(a, ws, d);
          load_core(a, ws.x[0], a.f, d);
        }
        refresh_halo(a, ws.x[cur], d, (ex - 1) & 1);
        __syncthreads();
        cur = dilate_band(a, ws, cur, d, s0, n);
        if (to_scan) {
          local_scan<0>(a, ws, ws.x[cur], ws.x[cur ^ 1], d);
        } else {
          if (seg == nseg - 1) test_change(a, ws, ws.x[cur], d, slot);
          publish_edges(a, ws.x[cur], d, ex & 1);
        }
        if (!resident) {
          __syncthreads();
          store_core(a, ws.x[cur], a.f, d);
          if (to_scan) store_core(a, ws.x[cur ^ 1], a.q, d);
          __syncthreads();
        }
      }
      if (!to_scan) ++ex;
      grid.sync();
    }
    // The scans (scan_stage): stage s finishes a direction, then runs the
    // local scans up to the next one that needs a barrier, publishing their
    // summaries; the last stage tests the change and publishes the edges.
    constexpr int nst = SEG ? 12 : 6;
    for (int s = 0; scan && s < nst; ++s) {
      int pd;
      bool fix;
      scan_stage<SEG>(s, &pd, &fix);
      const bool ends = s == nst - 1;
      for (int g = blockIdx.x; g < bands; g += gridDim.x) {
        const Band d = band_of<SEG>(a, st, g);
        if (!st.on[d.b]) continue;
        if (!resident) {
          cur = 0;
          load_core(a, ws.pc, a.p, d);
          load_core(a, ws.x[0], a.f, d);
          load_core(a, ws.x[1], a.q, d);
          __syncthreads();
        }
        finish_dir<SEG>(a, ws, ws.x[cur], ws.x[cur ^ 1], d, pd, fix);
        if (!SEG && pd == 1) vertical_scans(a, ws, ws.x[cur], ws.x[cur ^ 1], d);  // whole
        const int nd = !SEG && pd == 1 ? 4 : pd + 1;
        if (ends) {
          test_change(a, ws, ws.x[cur], d, slot);
          publish_edges(a, ws.x[cur], d, ex & 1);
        } else if (!fix) {
          local_scan_dir<SEG>(a, ws, ws.x[cur], ws.x[cur ^ 1], d, nd);
        }
        if (!resident) {
          __syncthreads();
          store_core(a, ws.x[cur], a.f, d);
          if (!ends) store_core(a, ws.x[cur ^ 1], a.q, d);
          __syncthreads();
        }
      }
      if (s == nst - 1) ++ex;
      grid.sync();
    }
    if (threadIdx.x == 0) {
      for (int b = 0; b < a.nb; ++b) {
        if (!st.on[b]) continue;
        st.grow[b] = *(volatile int*)&a.chg[slot * a.nb + b];
        ++st.it[b];
      }
      if (!CARRY && lead && a.count) atomicAdd(a.count + 1, (unsigned long long)*st.n);
      list_active<PHASE2, SEAM>(a, st, r + 1);
    }
    __syncthreads();
    if constexpr (CARRY) ++c->q;
  }
  if constexpr (CARRY) {
    c->cur = cur;
    c->ex = ex;
  } else if (resident && (int)blockIdx.x < bands) {
    store_core(a, ws.x[cur], a.f, band_of<SEG>(a, st, blockIdx.x));
  }
  if (lead && a.flags) {
    for (int b = 0; b < a.nb; ++b) {
      a.flags[4 * b + (PHASE2 ? 2 : 0)] = st.it[b];
      a.flags[4 * b + (PHASE2 ? 3 : 1)] = st.grow[b];
    }
  }
}

template <bool PHASE2, bool SEG>
__global__ void __launch_bounds__(NT, 1) hyst_kernel(Params a) {
  extern __shared__ uint32_t sm[];
  cg::grid_group grid = cg::this_grid();
  round_loop<PHASE2, SEG>(a, sm, grid);
}

// --- Phase 1 on the register route (see the head of this file) ---------------

constexpr int HW_MAX = 36;   // word rows of a column the register route holds at most (1152 rows)
constexpr int REG_NT = 576;  // a register band's threads at most: two a lane, bw + 2 halo lanes
                             // (ptxas then allots up to 96 registers a thread: no instance spills)

// Words of a register block's shared memory before its warps' edge columns:
// the per-frame state (frame_state with a.wsw = 0), rounded to 16 bytes.
__host__ __device__ inline int reg_state_words(int nb) { return (2 + 4 * nb + 2 + 3) & ~3; }

// Words of a published column's half in shared memory: H rounded up to
// even, so that each half starts 8-byte aligned.
__host__ __device__ constexpr int reg_half_words(int h) { return (h + 1) & ~1; }

// Each of a thread's H rows ORed with the rows of the columns left and
// right within its half-warp (a lane past its half's end gets its own
// word, which changes nothing): dilate_band's row_or but for the column
// across the warp's edge, which reg_step adds.
template <int H>
__device__ __forceinline__ void reg_row_ors(const uint32_t (&f)[H], uint32_t (&v)[H]) {
#pragma unroll
  for (int k = 0; k < H; ++k)
    v[k] = f[k] | __shfl_up_sync(FULL, f[k], 1, 16) | __shfl_down_sync(FULL, f[k], 1, 16);
}

// The rest of a dilation step on a thread's H rows, Jacobi: v holds every
// row's reg_row_ors of the step before's words; at an edge lane it ORs in
// the column across the warp's edge at its rows, as the neighbour warp
// published it the step before (e, 8-byte aligned), every other lane's edge
// words being 0. EXACT (every CARRY_EVERY-th step and the round's last):
// across words too, bit 31 of the row above and bit 0 of the row below,
// from the thread's own rows and, across the halves of the column, the
// other half-warp's by shuffle.
template <int H, bool EXACT>
__device__ __forceinline__ void reg_step(uint32_t (&f)[H], const uint32_t (&p)[H],
                                         uint32_t (&v)[H], const uint32_t* __restrict__ e,
                                         bool edge, bool top) {
  uint2 x = make_uint2(0u, 0u);  // the edge words of rows k, k + 1 (k even)
#pragma unroll
  for (int k = 0; k < H; ++k) {
    if (k % 2 == 0 && edge)
      x = k + 1 < H ? *reinterpret_cast<const uint2*>(e + k) : make_uint2(e[k], 0u);
    v[k] |= k % 2 ? x.y : x.x;
    if (!EXACT) f[k] |= p[k] & (v[k] | (v[k] << 1) | (v[k] >> 1));
  }
  if (EXACT) {  // rows H - 1 and H of the column meet across the halves
    const uint32_t first = __shfl_xor_sync(FULL, v[0], 16), last = __shfl_xor_sync(FULL, v[H - 1], 16);
    uint32_t vp = top ? 0u : last;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const uint32_t vn = k + 1 < H ? v[k + 1] : (top ? first : 0u);
      f[k] |= p[k] & (v[k] | __funnelshift_l(vp, v[k], 1) | __funnelshift_r(v[k], vn, 1));
      vp = v[k];
    }
  }
}

// An edge lane's H rows into its warp's published column (8-byte aligned).
template <int H>
__device__ __forceinline__ void publish_rows(uint32_t* dst, const uint32_t (&f)[H]) {
#pragma unroll
  for (int k = 0; k < H; k += 2) {
    if (k + 1 < H)
      *reinterpret_cast<uint2*>(dst + k) = make_uint2(f[k], f[k + 1]);
    else
      dst[k] = f[k];
  }
}

// Phase 1's round loop with each band's words in registers: block g is band
// g % nbw of frame g / nbw (every frame of the batch, a block a band, all
// resident), over bw + 2 halo lanes, the band's columns and `halo` more
// each side (zero outside the frame and past the band's halo). A warp takes
// 16 lanes (columns) side by side, its lanes 0-15 the top H = R / 2 word
// rows of those columns and lanes 16-31 the bottom H (R = hw rounded up to
// even; a row past hw stays 0), so a thread holds H FINAL and H CANDIDATE
// words in registers and an SM's four schedulers get near equal shares of
// its rows. The round schedule, the change flags, the frame state, the
// counters and the flags are round_loop's for phase 1 with one segment of
// dilate_steps = halo steps; a frame's round:
// * dilate_steps steps in registers: each step's shuffles (reg_row_ors)
//   run before the barrier that publishes the edge columns they do not
//   need, the rest (reg_step) after it; the two edge lanes of each
//   half-warp publish their rows into the block's shared memory by the
//   step's parity, and one __syncthreads follows each step but the last;
// * the change test: a round only adds bits, so a core thread changed iff
//   its popcount grew; one __syncthreads_or over the block;
// * the core lanes within `halo` of the band's edges publish their rows
//   into edge slot (round & 1);
// then one grid barrier, after which the halo lanes reload their rows from
// the edge slot the round filled (in round 0 they hold the frame's own,
// loaded with the core) while the block reads the round's change flags,
// one frame a thread, into its copy of the frame state.
template <bool PHASE2, bool SEG, int R>
__global__ void __launch_bounds__(REG_NT, 1) hyst_kernel(Params a) {
  static_assert(!PHASE2 && !SEG && R % 2 == 0 && R <= HW_MAX,
                "the register route runs phase 1 on one-segment layouts");
  constexpr int H = R / 2, HP = reg_half_words(H);  // word rows a thread; its half's words
  extern __shared__ uint32_t sm[];
  cg::grid_group grid = cg::this_grid();
  const FrameState st = frame_state(a, sm);                 // a.wsw == 0
  uint32_t* xb = sm + reg_state_words(a.nb);                // [2][warps][2 sides][2 HP]
  const int lane = lane_id(), warp = warp_id(), nw = blockDim.x >> 5, per_buf = 4 * nw * HP;
  const bool top = lane < 16;
  const int i = lane & 15, k0 = top ? 0 : H, ks = top ? 0 : HP;  // column in the warp, rows
  const int b = blockIdx.x / a.nbw, c0 = (blockIdx.x - b * a.nbw) * a.bw;
  const int cb = min(a.bw, a.w - c0), cc = 16 * warp + i, c = c0 - a.halo + cc;
  const bool in = c >= 0 && c < a.w && cc < cb + 2 * a.halo;
  const bool core = cc >= a.halo && cc < a.halo + cb;
  const bool pub = core && (cc < 2 * a.halo || cc >= cb);  // within halo of the band's edges
  const bool side = i == 0 || i == 15;                      // publishes the warp's edge column
  const bool edge = (i == 0 && warp > 0) || (i == 15 && warp < nw - 1);
  const uint32_t* nbr = xb + (i == 0 ? 2 * warp - 1 : 2 * warp + 2) * 2 * HP + ks;  // when edge
  uint32_t* mine = xb + (2 * warp + (i == 15)) * 2 * HP + ks;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const long long col = b * a.plane + c;
  // Row k of the thread is the plane's row k0 + k: below hw but for the
  // bottom half's last where hw is odd.
  auto row_in = [&](int k) { return k < H - 1 || k0 + k < a.hw; };
  uint32_t f[H], p[H], v[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const bool row = in && row_in(k);
    const uint32_t m = k0 + k == a.hw - 1 ? a.tail : FULL;
    p[k] = row ? __ldcg(a.p + col + (long long)(k0 + k) * a.w) & m : 0u;
    f[k] = row ? __ldcg(a.f + col + (long long)(k0 + k) * a.w) & m : 0u;
  }
  int pc = 0;  // the thread's core words' popcount at the last change test
#pragma unroll
  for (int k = 0; k < H; ++k) pc += core ? __popc(f[k]) : 0;
  if (threadIdx.x == 0) {
    for (int j = 0; j < a.nb; ++j) {
      st.it[j] = 0;
      st.grow[j] = 1;
    }
    list_active<false>(a, st, 0);
  }
  if (lead) {
    if (a.count) atomicAdd(a.count, (unsigned long long)a.nb);
    for (int j = 0; j < 3 * a.nb; ++j) a.chg[j] = 0;
  }
  grid.sync();
  for (int r = 0; *st.n > 0; ++r) {
    const int slot = r % 3;
    const bool on = st.on[b];
    if (lead)
      for (int j = 0; j < a.nb; ++j) a.chg[((r + 1) % 3) * a.nb + j] = 0;
    if (on) {
      if (side) publish_rows(mine, f);
      reg_row_ors(f, v);
      __syncthreads();
      for (int s = 1; s <= a.dilate_steps; ++s) {
        const uint32_t* e = nbr + ((s - 1) & 1) * per_buf;
        if (s % CARRY_EVERY == 0 || s == a.dilate_steps)
          reg_step<H, true>(f, p, v, e, edge, top);
        else
          reg_step<H, false>(f, p, v, e, edge, top);
        if (s < a.dilate_steps) {
          if (side) publish_rows(mine + (s & 1) * per_buf, f);
          reg_row_ors(f, v);
          __syncthreads();
        }
      }
      int n = 0;
#pragma unroll
      for (int k = 0; k < H; ++k) n += core ? __popc(f[k]) : 0;
      const bool grew = n != pc;
      pc = n;
      if (__syncthreads_or(grew) && threadIdx.x == 0) atomicOr(&a.chg[slot * a.nb + b], 1);
      if (pub) {
        uint32_t* e = a.edge + ((long long)(r & 1) * a.nb + b) * a.plane + c;
#pragma unroll
        for (int k = 0; k < H; ++k)
          if (row_in(k)) e[(long long)(k0 + k) * a.w] = f[k];
      }
    }
    grid.sync();
    // The next round's halo (a frame that stopped discards it: its halo is
    // never stored), in flight with the change flags' reads.
    if (on && in && !core) {
      const uint32_t* e = a.edge + ((long long)(r & 1) * a.nb + b) * a.plane + c;
#pragma unroll
      for (int k = 0; k < H; ++k)
        if (row_in(k)) f[k] = __ldcg(e + (long long)(k0 + k) * a.w);
    }
    for (int j = threadIdx.x; j < a.nb; j += blockDim.x) {
      if (!st.on[j]) continue;
      st.grow[j] = *(volatile int*)&a.chg[slot * a.nb + j];
      ++st.it[j];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (lead && a.count) atomicAdd(a.count + 1, (unsigned long long)*st.n);
      list_active<false>(a, st, r + 1);
    }
    __syncthreads();
  }
  if (core) {
#pragma unroll
    for (int k = 0; k < H; ++k)
      if (row_in(k)) a.f[col + (long long)(k0 + k) * a.w] = f[k];
  }
  if (lead && a.flags) {
    for (int j = 0; j < a.nb; ++j) {
      a.flags[4 * j] = st.it[j];
      a.flags[4 * j + 1] = st.grow[j];
    }
  }
}

// The collective round loop of a one-card sharded batch of extended tiles
// (see the head of this file): four slots of scratch flags (three of a
// round's flag, rotating, then the prologue's); the round count it writes at
// the end; the round budget.
struct LoopParams {
  int* pend;
  int* rounds;
  unsigned long long* count;  // (calls, collective rounds) added to; null: nothing counted
  int max_rounds;
};

// The loop's prologue: the two refreshes that follow the export
// (packed_halo.py:285-286, before the while_loop), CANDIDATE's and FINAL's,
// in one pass over both planes in global memory (halo.cuh's publish_planes /
// apply_planes, the grid's threads split between the tiles): both planes
// published (xf, xp: a scratch each), one grid barrier, both applied; the
// flag "some FINAL bit new, or some flags[t][0][1]" goes into *flag (zero
// before the barrier), read after a second barrier. The round loop's first
// loads (with __ldcg) come after it. On a (b, 1, 1) mesh the flag is the
// tiles' growth alone, read by every thread.
__device__ bool loop_prologue(const Params& a, const halo::Strips& xf, const halo::Strips& xp,
                              int* flag, cg::grid_group& grid) {
  if (xf.ny == 1 && xf.nx == 1) {  // no tile has a neighbour: no refresh, no barrier
    bool up = false;
    for (int b = 0; b < a.nb; ++b) up = up || __ldcg(a.flags + 4 * b + 1);
    return up;
  }
  const int i = blockIdx.x * NT + threadIdx.x, n = gridDim.x * NT;
  uint32_t* P = const_cast<uint32_t*>(a.p);
  halo::publish_planes(xf, a.f, a.nb, i, n);
  halo::publish_planes(xp, P, a.nb, i, n);
  grid.sync();
  const int fresh = halo::apply_planes(xf, a.f, a.nb, i, n);
  halo::apply_planes(xp, P, a.nb, i, n);
  bool up = __syncthreads_or(fresh);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int b = 0; b < a.nb; ++b) up = up || __ldcg(a.flags + 4 * b + 1);
  if (up && threadIdx.x == 0) atomicOr(flag, 1);
  grid.sync();
  return *(volatile int*)flag;
}

// a: phase 2's parameters; a1: phase 1's (its cap min(scan_after,
// max_iters), no scans), a kernel parameter of its own so that neither is
// copied to local memory.
template <bool SEG>
__global__ void __launch_bounds__(NT, 1) sharded_loop_kernel(Params a, Params a1,
                                                            halo::Strips x, halo::Strips xp,
                                                            LoopParams l) {
  extern __shared__ uint32_t sm[];
  cg::grid_group grid = cg::this_grid();
  const FrameState st = frame_state(a, sm);
  const Ws ws = workspace(a, sm);
  // Every tile's bands in both phases: the layout does not follow the
  // active tiles, so a block keeps its band for the whole launch.
  if (threadIdx.x == 0) {
    for (int b = 0; b < a.nb; ++b) st.lay[b] = b;
    *st.nl = a.nb;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int i = 0; i < 4; ++i) l.pend[i] = 0;
  __syncthreads();
  // The reference's cond (packed_halo.py:294): the budget is tested before
  // a round, after the refreshes. Every thread reads the flag, after a grid
  // barrier.
  bool pending = loop_prologue(a, x, xp, &l.pend[3], grid) && l.max_rounds > 0;
  int it = 0;
  if (pending) {
    const int bands = a.nb * a.nbw * (SEG ? a.ns : 1);
    const bool resident = bands <= (int)gridDim.x;
    Carry c{0, 1, 0};
    while (it < l.max_rounds && pending) {
      // K9 on every tile, its round count from 0: phase 1, then phase 2 on
      // the tiles still growing, from the state phase 1 left. Where the cap
      // is phase 1, phase 2 finds no tile below the cap and writes each
      // tile's phase-1 flags as final, as the host loop does.
      round_loop<false, SEG, true>(a1, sm, grid, &c);
      round_loop<true, SEG, true>(a, sm, grid, &c);
      // The refresh on the resident bands: publish, one grid barrier, OR
      // in; every band publishes its edges again (a tile that stopped
      // early left older edges in the latest slot), and the flag is "some
      // new bit, or some tile still growing (flags[t][1][1])".
      const int ps = it % 3;
      if (blockIdx.x == 0 && threadIdx.x == 0) l.pend[(it + 1) % 3] = 0;
      for (int g = blockIdx.x; g < bands; g += gridDim.x) {
        const Band d = band_of<SEG>(a, st, g);
        uint32_t* X = ws.x[resident ? c.cur : 0];
        if (!resident) {
          load_core(a, X, a.f, d);
          __syncthreads();
        }
        halo::publish_band(x, d.b, X + core0(a, d), a.rs, d.k0, d.hk, d.c0, d.cb, threadIdx.x,
                           blockDim.x);
        if (!resident) __syncthreads();
      }
      grid.sync();
      bool up = false;
      if (blockIdx.x == 0 && threadIdx.x == 0)
        for (int b = 0; b < a.nb; ++b) up = up || __ldcg(a.flags + 4 * b + 3);
      for (int g = blockIdx.x; g < bands; g += gridDim.x) {
        const Band d = band_of<SEG>(a, st, g);
        uint32_t* X = ws.x[resident ? c.cur : 0];
        if (!resident) {
          load_core(a, X, a.f, d);
          __syncthreads();
        }
        const int fresh = block_sum(ws, halo::apply_band(x, d.b, X + core0(a, d), a.rs, d.k0, d.hk,
                                                         d.c0, d.cb, threadIdx.x, blockDim.x));
        if (fresh && threadIdx.x == 0) {
          a.cnt[g] += fresh;  // a round's change test counts from here
          up = true;
        }
        publish_edges(a, X, d, (c.ex - 1) & 1);
        if (!resident) {
          __syncthreads();
          store_core(a, X, a.f, d);
          __syncthreads();
        }
      }
      if (up) atomicOr(&l.pend[ps], 1);
      grid.sync();
      pending = *(volatile int*)&l.pend[ps];
      ++it;
    }
    if (resident && (int)blockIdx.x < bands)
      store_core(a, ws.x[c.cur], a.f, band_of<SEG>(a, st, blockIdx.x));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *l.rounds = it;
    if (l.count) {
      atomicAdd(l.count, 1ull);
      atomicAdd(l.count + 1, (unsigned long long)it);
    }
  }
}

// The column-split continuation of a batch of frames (see the head of this
// file). The slices are the frames of the launch's Params: slice i of frame
// f is a.f's frame f n + i, slice column c is frame column i ws - k + c.
struct SplitParams {
  uint32_t* ff;        // (nf, hw, fw) the frames' FINAL planes, updated in place
  const uint32_t* fp;  // (nf, hw, fw) the frames' CANDIDATE planes
  int* fflags;         // (nf, 2, 2): row 0 read (round count, growing), row 1 written
  uint32_t* sp;        // the streaming layout's slice CANDIDATE planes (a.p; scratch)
  uint32_t* pub;       // per slice [2][hw][k]: its first and its last k owned columns
  int* ocnt;           // per tile: the popcount of the owned columns it holds
  int* mchg;           // [3][nf] "a seam round changed an owned word of frame f", rotating
  int nf, n;           // frames, slices a frame
  int fw, ws, k;       // frame columns, owned columns a slice, seam halo columns
  int budget;          // the total round budget (max_iters)
  int chunked;         // a seam round spends its slowest slice's rounds (else 1)
};

// The frames' seam-loop state, one copy per block after the slices'
// FrameState (the layout sizes a block's shared memory for nb + nf frames).
struct SeamState {
  int* it;   // [nf] round count (the budget spent)
  int* ch;   // [nf] the last seam round changed an owned word (at first: growing)
  int* on;   // [nf] the frame takes another seam round
  int* any;  // [1] some frame does
};

__device__ __forceinline__ SeamState seam_state(const Params& a, const SplitParams& s,
                                                uint32_t* sm) {
  int* t = reinterpret_cast<int*>(sm + a.wsw) + 2 + 4 * a.nb + 2;
  return SeamState{t, t + s.nf, t + 2 * s.nf, t + 3 * s.nf};
}

// Words [0, n) of a plane row from src into dst, 16 bytes a lane where the
// address allows it (a slice starts at frame column i ws - k, a multiple of
// 4 words only where ws and k are; a row's first word sits on a 16-byte
// boundary only where its row index times fw is a multiple of 4), 4 bytes
// at the head and the tail; each word ANDed with m. One warp.
__device__ void load_row16(uint32_t* dst, const uint32_t* src, int n, uint32_t m) {
  const int lane = lane_id();
  const int head = min(n, (int)(((16u - ((uint32_t)(uintptr_t)src & 15u)) & 15u) >> 2));
  const int nv = (n - head) >> 2;
  if (lane < head) dst[lane] = __ldcg(src + lane) & m;
  const uint4* v = reinterpret_cast<const uint4*>(src + head);
  for (int j = lane; j < nv; j += 32) {
    const uint4 x = __ldcg(v + j);
    uint32_t* o = dst + head + 4 * j;
    o[0] = x.x & m;
    o[1] = x.y & m;
    o[2] = x.z & m;
    o[3] = x.w & m;
  }
  for (int t = head + 4 * nv + lane; t < n; t += 32) dst[t] = __ldcg(src + t) & m;
}

// The resident start-up's load into a zeroed workspace: shared rows [r0,
// r1) and columns [lo, hi) of X straight from the frame plane that slice
// d.b cuts from src. Shared (i, cc) is plane row k0 - vh + i and slice
// column c0 - halo + cc; what lies outside the frame stays zero, and the
// bits of rows at and past h read as zero.
__device__ void load_slice(const Params& a, const SplitParams& s, uint32_t* X, const uint32_t* src,
                           Band d, int r0, int r1, int lo, int hi) {
  const int f = d.b / s.n, base = (d.b - f * s.n) * s.ws - s.k + d.c0 - a.halo;
  const int g0 = max(base + lo, 0), g1 = min(base + hi, s.fw);
  if (g0 >= g1) return;
  const uint32_t* plane = src + (long long)f * a.hw * s.fw;
  for (int i = r0 + warp_id(); i < r1; i += NW) {
    const int kr = d.k0 - d.vh + i;
    if (kr < 0 || kr >= a.hw) continue;
    load_row16(X + i * a.rs + g0 - base, plane + (long long)kr * s.fw + g0, g1 - g0,
               kr == a.hw - 1 ? a.tail : FULL);
  }
}

// The streaming layout's start-up: the layout's slices of the frames' F and
// P planes into the scratch slice planes a.f and s.sp, zero outside the
// frame. Its rounds then stream the bands from there.
__device__ void extract_slices(const Params& a, const SplitParams& s, const FrameState& st) {
  const long long total = (long long)*st.nl * a.plane;
  for (long long e = blockIdx.x * NT + threadIdx.x; e < total; e += (long long)gridDim.x * NT) {
    const int li = (int)(e / a.plane), rem = (int)(e - li * a.plane);
    const int sl = st.lay[li], f = sl / s.n, kr = rem / a.w, c = rem - kr * a.w;
    const int gc = (sl - f * s.n) * s.ws - s.k + c;
    const long long src = ((long long)f * a.hw + kr) * s.fw + gc, dst = sl * a.plane + rem;
    const bool in = gc >= 0 && gc < s.fw;
    a.f[dst] = in ? __ldcg(s.ff + src) : 0u;
    s.sp[dst] = in ? __ldcg(s.fp + src) : 0u;
  }
}

// The tile's core columns [*t0, *t1) that are slice columns [lo, lo + n).
__device__ __forceinline__ void cols_of(Band d, int lo, int n, int* t0, int* t1) {
  *t0 = max(lo - d.c0, 0);
  *t1 = min(lo + n - d.c0, d.cb);
}

// The popcount of the owned columns the tile holds (every thread gets it).
// A seam round only adds bits to a slice, so its owned words changed iff
// this grew; the halo columns do not count.
__device__ int owned_popc(const Params& a, const SplitParams& s, Ws ws, const uint32_t* X,
                          Band d) {
  int t0, t1, c = 0;
  cols_of(d, s.k, s.ws, &t0, &t1);
  X += core0(a, d);
  for (int kk = warp_id(); kk < d.hk; kk += NW)
    for (int t = t0 + lane_id(); t < t1; t += 32) c += __popc(X[kk * a.rs + t]);
  return block_sum(ws, c);
}

// The owned columns the tile holds within k of its slice's seams, at its
// rows of the slice's records: record 0 its first k owned columns (the left
// neighbour's right halo), record 1 its last k (the right neighbour's left
// halo). A frame's first slice has no record 0 and its last no record 1.
__device__ void publish_seams(const Params& a, const SplitParams& s, const uint32_t* X, Band d) {
  const int i = d.b % s.n;
  X += core0(a, d);
  for (int r = 0; r < 2; ++r) {
    if (r == 0 ? i == 0 : i == s.n - 1) continue;
    const int lo = r == 0 ? s.k : s.ws;  // slice columns [lo, lo + k)
    int t0, t1;
    cols_of(d, lo, s.k, &t0, &t1);
    uint32_t* o = s.pub + ((long long)(2 * d.b + r) * a.hw + d.k0) * s.k + d.c0 - lo;
    for (int kk = warp_id(); kk < d.hk; kk += NW)
      for (int t = t0 + lane_id(); t < t1; t += 32) o[(long long)kk * s.k + t] = X[kk * a.rs + t];
  }
}

// The tile's words in its slice's halo columns overwritten with the
// neighbours' owned words as they published them: the left halo is the left
// neighbour's record 1, the right halo the right neighbour's record 0. An
// overwrite, as the reference's extract is, not an OR: a slice may have
// grown bits in its halo that the neighbour does not hold. The halo outside
// the frame stays zero (no candidate lies there, so no bit grows). Returns
// whether the tile holds any halo column it overwrote (uniform in the block).
__device__ bool apply_seams(const Params& a, const SplitParams& s, uint32_t* X, Band d) {
  const int i = d.b % s.n;
  bool any = false;
  X += core0(a, d);
  for (int r = 0; r < 2; ++r) {
    if (r == 0 ? i == 0 : i == s.n - 1) continue;
    const int lo = r == 0 ? 0 : s.k + s.ws;  // slice columns [lo, lo + k)
    int t0, t1;
    cols_of(d, lo, s.k, &t0, &t1);
    if (t0 >= t1) continue;
    any = true;
    const int nbr = r == 0 ? d.b - 1 : d.b + 1;  // the neighbouring slice
    const uint32_t* src = s.pub + ((long long)(2 * nbr + 1 - r) * a.hw + d.k0) * s.k + d.c0 - lo;
    // A thread's words are loaded before any is stored, so that its L2
    // round trips are in flight together: the other blocks wait for this
    // at the next grid barrier.
    const int cw = t1 - t0, n = d.hk * cw;
    for (int e0 = threadIdx.x; e0 < n; e0 += SEAM_BATCH * NT) {
      uint32_t v[SEAM_BATCH];
#pragma unroll
      for (int j = 0; j < SEAM_BATCH; ++j) {
        const int e = e0 + j * NT, kk = e / cw;
        v[j] = e < n ? __ldcg(src + (long long)kk * s.k + t0 + e - kk * cw) : 0u;
      }
#pragma unroll
      for (int j = 0; j < SEAM_BATCH; ++j) {
        const int e = e0 + j * NT, kk = e / cw;
        if (e < n) X[kk * a.rs + t0 + e - kk * cw] = v[j];
      }
    }
  }
  return any;
}

// The owned columns the tile holds into its frame's plane.
__device__ void store_owned(const Params& a, const SplitParams& s, const uint32_t* X, Band d) {
  const int f = d.b / s.n;
  int t0, t1;
  cols_of(d, s.k, s.ws, &t0, &t1);
  uint32_t* o = s.ff + ((long long)f * a.hw + d.k0) * s.fw + (d.b - f * s.n) * s.ws - s.k + d.c0;
  X += core0(a, d);
  for (int kk = warp_id(); kk < d.hk; kk += NW)
    for (int t = t0 + lane_id(); t < t1; t += 32) o[(long long)kk * s.fw + t] = X[kk * a.rs + t];
}

template <bool SEG>
__global__ void __launch_bounds__(NT, 1) split_kernel(Params a, SplitParams s) {
  extern __shared__ uint32_t sm[];
  cg::grid_group grid = cg::this_grid();
  const FrameState st = frame_state(a, sm);
  const Ws ws = workspace(a, sm);
  const SeamState ss = seam_state(a, s, sm);
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  // The layout: the slices of the frames that take a seam round, for the
  // whole launch (a frame still growing at phase 1 and below the budget).
  if (threadIdx.x == 0) {
    int nl = 0;
    for (int f = 0; f < s.nf; ++f) {
      ss.it[f] = __ldcg(s.fflags + 4 * f);
      ss.ch[f] = __ldcg(s.fflags + 4 * f + 1) != 0;
      ss.on[f] = ss.ch[f] && ss.it[f] < s.budget;
      for (int i = 0; ss.on[f] && i < s.n; ++i) st.lay[nl++] = f * s.n + i;
    }
    *st.nl = nl;
  }
  __syncthreads();
  const int bands = *st.nl * a.nbw * (SEG ? a.ns : 1);
  const bool resident = bands <= (int)gridDim.x;
  if (bands > 0) {
    // Load once: a resident tile from the frames' planes straight into its
    // block's shared memory; a streamed one from the slice planes extracted
    // into scratch. Then its edges and its counts.
    if (!resident) {
      extract_slices(a, s, st);
      grid.sync();
    }
    for (int g = blockIdx.x; g < bands; g += gridDim.x) {
      const Band d = band_of<SEG>(a, st, g);
      uint32_t* X = ws.x[0];
      if (resident) {  // zero first: the columns outside the frame stay 0
        for (int i = threadIdx.x; i < 3 * a.rows * a.rs; i += NT) sm[i] = 0u;
        __syncthreads();
        load_slice(a, s, ws.pc, s.fp, d, 0, d.hk + 2 * d.vh, 0, d.cb + 2 * a.halo);
        load_slice(a, s, X, s.ff, d, d.vh, d.vh + d.hk, a.halo, a.halo + d.cb);
      } else {
        load_core(a, X, a.f, d);
      }
      __syncthreads();
      publish_edges(a, X, d, 0);
      const int n = core_popc(a, ws, X, d), o = owned_popc(a, s, ws, X, d);
      if (threadIdx.x == 0) {
        a.cnt[g] = n;
        s.ocnt[g] = o;
      }
    }
    if (lead) {
      for (int i = 0; i < 3 * a.nb; ++i) a.chg[i] = 0;
      for (int i = 0; i < 3 * s.nf; ++i) s.mchg[i] = 0;
    }
    grid.sync();
    Carry c{0, 1, 0};
    for (int seam = 0;; ++seam) {
      // Every slice of a frame that takes this seam round from round 0: one
      // unconditional round, dilation rounds below a.scan_from, then
      // dilations + scans, while it changes and below the inner cap.
      if (threadIdx.x == 0)
        for (int b = 0; b < a.nb; ++b) {
          st.it[b] = 0;
          st.grow[b] = ss.on[b / s.n];
        }
      round_loop<false, SEG, true, true>(a, sm, grid, &c);
      // The change test on the owned columns, and the seam columns out.
      const int mslot = seam % 3;
      if (lead)
        for (int f = 0; f < s.nf; ++f) s.mchg[((seam + 1) % 3) * s.nf + f] = 0;
      for (int g = blockIdx.x; g < bands; g += gridDim.x) {
        const Band d = band_of<SEG>(a, st, g);
        if (!ss.on[d.b / s.n]) continue;
        uint32_t* X = ws.x[resident ? c.cur : 0];
        if (!resident) {
          load_core(a, X, a.f, d);
          __syncthreads();
        }
        const int o = owned_popc(a, s, ws, X, d);
        if (threadIdx.x == 0 && o != s.ocnt[g]) {
          s.ocnt[g] = o;
          atomicOr(&s.mchg[mslot * s.nf + d.b / s.n], 1);
        }
        publish_seams(a, s, X, d);
        if (!resident) __syncthreads();
      }
      grid.sync();
      for (int f = threadIdx.x; f < s.nf; f += NT)  // the L2 reads side by side
        if (ss.on[f]) ss.ch[f] = *(volatile int*)&s.mchg[mslot * s.nf + f];
      __syncthreads();
      if (threadIdx.x == 0) {
        int any = 0;
        for (int f = 0; f < s.nf; ++f) {
          if (!ss.on[f]) continue;
          int spent = 0;
          for (int i = 0; i < s.n; ++i) spent = max(spent, st.it[f * s.n + i]);
          ss.it[f] += s.chunked ? spent : 1;
          ss.on[f] = ss.ch[f] && ss.it[f] < s.budget;
          any |= ss.on[f];
        }
        *ss.any = any;
      }
      __syncthreads();
      if (!*ss.any) break;
      // The seam refresh on the tiles of the frames that go on: the halo
      // columns overwritten (their count taken again), and every tile's
      // edges published again in the latest slot (a slice that stopped
      // early left older edges there).
      for (int g = blockIdx.x; g < bands; g += gridDim.x) {
        const Band d = band_of<SEG>(a, st, g);
        if (!ss.on[d.b / s.n]) continue;
        uint32_t* X = ws.x[resident ? c.cur : 0];
        if (!resident) {
          load_core(a, X, a.f, d);
          __syncthreads();
        }
        if (apply_seams(a, s, X, d)) {
          const int n = core_popc(a, ws, X, d);
          if (threadIdx.x == 0) a.cnt[g] = n;
        }
        __syncthreads();
        publish_edges(a, X, d, (c.ex - 1) & 1);
        if (!resident) {
          __syncthreads();
          store_core(a, X, a.f, d);
          __syncthreads();
        }
      }
      grid.sync();
    }
    // Write once: every tile's owned columns into its frame's plane.
    for (int g = blockIdx.x; g < bands; g += gridDim.x) {
      const Band d = band_of<SEG>(a, st, g);
      const uint32_t* X = ws.x[resident ? c.cur : 0];
      if (!resident) {
        __syncthreads();
        load_core(a, ws.x[0], a.f, d);
        __syncthreads();
      }
      store_owned(a, s, X, d);
    }
  }
  if (lead)
    for (int f = 0; f < s.nf; ++f) {
      s.fflags[4 * f + 2] = ss.it[f];
      s.fflags[4 * f + 3] = ss.ch[f];
    }
}

// Dynamic shared memory of a block: the tile workspace (geometry), two
// ints, then the per-frame state (4 ints a frame and 2).
size_t smem_bytes(int hw, int ns, int bw, int halo, int nb) {
  return ((size_t)geometry(hw, ns, bw, halo).words + 2 + 4 * (size_t)nb + 2) * sizeof(uint32_t);
}

// The most blocks of the cooperative kernel ``kern`` with ``smem`` bytes of
// shared memory and ``threads`` threads each that can be co-resident on
// `device` (the cooperative grid's limit), cached.
cudaError_t co_resident(const void* kern, int device, size_t smem, int* out, int threads = NT) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t, int>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kern, device, smem, threads);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  int optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *out = cache[key] = per_sm * sms;
  return cudaSuccess;
}

// A launch's band layout: the band width, the halo, the height segments,
// the shared memory of a block and the co-resident blocks at that size.
struct Layout {
  int bw, halo, ns;
  size_t smem;
  int limit;
};

// A cooperative kernel compiled without and with height segments: a launch
// takes the one its layout needs.
struct Kern {
  const void* one;
  const void* seg;
  const void* pick(int ns) const { return ns > 1 ? seg : one; }
};

// The band layout of a launch whose first round works on ``frames`` frames
// of a batch of nb (hw, w) planes: the narrowest multiple of ``unit`` columns
// whose tiles, over those frames, are no more than the SMs and fit the
// co-resident grid. A band spans every word row where a block's shared
// memory holds it with one halo column, else it is cut into the fewest
// height segments that fit (each of MIN_SEG word rows at least); then its
// halo is min(dilate_steps, bw) columns where that fits (else the largest
// that does: the round's dilations then run in segments of steps). Failing
// that, the narrowest whose tiles all fit the grid (each block keeps its
// tile resident), else the narrowest that fits at all (blocks take several
// tiles and stream them). A scanning band is at most MAX_SCAN_BAND wide.
// Cached.
cudaError_t choose_layout(const Kern& kern, int device, int frames, int nb, int hw, int w,
                          int dilate_steps, int unit, Layout* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int, int, int, int>, Layout> cache;
  const auto key = std::make_tuple(kern.one, device, frames, nb, hw, w, dilate_steps, unit);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = cache.find(key);
    if (hit != cache.end()) {
      *out = hit->second;
      return cudaSuccess;
    }
  }
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  Layout first{0, 0, 0, 0, 0}, resident{0, 0, 0, 0, 0}, pick{0, 0, 0, 0, 0};
  const int wmax = (w + unit - 1) / unit * unit;
  const int wtop = unit == BAND_UNIT && wmax > MAX_SCAN_BAND ? MAX_SCAN_BAND : wmax;
  for (int bw = unit; bw <= wtop && !pick.bw; bw += unit) {
    int ns = 1;
    while (smem_bytes(hw, ns, bw, 1, nb) > (size_t)optin && hw / (ns + 1) >= MIN_SEG) ++ns;
    if (smem_bytes(hw, ns, bw, 1, nb) > (size_t)optin) break;  // a wider band fits no better
    int halo = dilate_steps < bw ? dilate_steps : bw;
    while (smem_bytes(hw, ns, bw, halo, nb) > (size_t)optin) --halo;
    Layout l{bw, halo, ns, smem_bytes(hw, ns, bw, halo, nb), 0};
    err = co_resident(kern.pick(ns), device, l.smem, &l.limit);
    if (err != cudaSuccess) return err;
    if (l.limit < 1) break;
    const long long bands = (long long)frames * ((w + bw - 1) / bw) * ns;
    if (!first.bw) first = l;
    if (bands <= l.limit && !resident.bw) resident = l;
    if (bands <= l.limit && bands <= sms) pick = l;
  }
  if (!pick.bw) pick = resident.bw ? resident : first;
  if (!pick.bw) return cudaErrorInvalidValue;  // a MIN_SEG-row tile does not fit
  std::lock_guard<std::mutex> lock(mu);
  *out = cache[key] = pick;
  return cudaSuccess;
}

// The most height segments of (hw, w) planes (choose_layout keeps every
// segment MIN_SEG word rows or more).
long long max_segments(long long hw) { return hw / MIN_SEG > 1 ? hw / MIN_SEG : 1; }

// int32 words of the rounds' scratch for nb (h, w) planes: the Q planes, the
// two edge slots' planes, the bands' summaries (at most ceil(w/16) bands a
// frame), the segments' seam records, the tiles' popcounts, then 3 change
// flags a frame, last.
long long rounds_scratch_words(int nb, int h, int w) {
  const long long hw = (h + 31) / 32, plane = hw * w, bands = (w + MIN_BAND - 1) / MIN_BAND;
  const long long ns = max_segments(hw);
  return (long long)nb * (3 * plane + bands * (2LL * N_XDIR * hw + ns) + ns * N_SEAM * w + 3);
}

Params make_params(void* f, const void* p, void* scratch, void* flags, int nb, int h, int w,
                   int dilate_steps, int cap, int scan_from) {
  Params a;
  a.nb = nb;
  a.hw = (h + 31) / 32;
  a.w = w;
  a.tail = h % 32 ? (1u << (h % 32)) - 1u : 0xffffffffu;
  a.plane = (long long)a.hw * w;
  a.f = static_cast<uint32_t*>(f);
  a.p = static_cast<const uint32_t*>(p);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  const long long bands = (long long)nb * ((w + MIN_BAND - 1) / MIN_BAND), ns = max_segments(a.hw);
  a.q = s;
  a.edge = s + nb * a.plane;
  a.summ = s + 3 * nb * a.plane;
  a.seam = a.summ + bands * 2 * N_XDIR * a.hw;
  a.cnt = reinterpret_cast<int*>(a.seam + nb * ns * N_SEAM * w);
  a.chg = a.cnt + bands * ns;
  a.flags = static_cast<int*>(flags);
  a.count = nullptr;
  a.dilate_steps = dilate_steps;
  a.cap = cap;
  a.scan_from = scan_from;
  a.bw = a.halo = a.rs = a.nbw = a.ns = a.hs = a.vh = a.vq = a.rows = a.wsw = 0;
  return a;
}

void set_layout(Params& a, const Layout& l) {
  const Geom g = geometry(a.hw, l.ns, l.bw, l.halo);
  a.bw = l.bw;
  a.halo = l.halo;
  a.ns = l.ns;
  a.rs = g.rs;
  a.nbw = (a.w + l.bw - 1) / l.bw;
  a.hs = g.hs;
  a.vh = g.vh;
  a.vq = g.vq;
  a.rows = g.rows;
  a.wsw = g.words;
}

// The layout of a launch of ``kern`` over a whose first round works on
// ``frames`` frames, and its grid: a block a band, up to the limit.
cudaError_t plan(const Kern& kern, Params& a, int frames, int unit, int device, Layout* l,
                 unsigned* grid) {
  if (a.dilate_steps < 1 || a.dilate_steps > MAX_DILATE_STEPS || a.nb < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = choose_layout(kern, device, frames, a.nb, a.hw, a.w, a.dilate_steps, unit, l);
  if (err != cudaSuccess) return err;
  set_layout(a, *l);
  const long long bands = (long long)frames * a.nbw * a.ns;
  *grid = (unsigned)(bands < l->limit ? bands : l->limit);
  return cudaSuccess;
}

// A round kernel's type: hyst_kernel names both the shared-memory kernels
// <PHASE2, SEG> and the register route's <false, false, R>.
using RoundKernel = void (*)(Params);

// The register route's instance for hw word rows: R = hw rounded up to even.
template <int... Ks>
const void* reg_kernel(int hw, std::integer_sequence<int, Ks...>) {
  static const void* const table[] = {(const void*)(RoundKernel)hyst_kernel<false, false, 2 * (Ks + 1)>...};
  return table[(hw + 1) / 2 - 1];
}

// The register route's launch for phase 1 over nb (hw, w) planes.
struct RegPlan {
  const void* kern;  // the instance for hw; null: the launch takes the shared route
  int bw, halo, threads, bands;
  size_t smem;
};

// Phase 1's route, decided by what the launch observes: the register route
// where a column's word rows fit a thread pair (hw <= HW_MAX) and the
// bands, with a halo of dilate_steps columns each side (one segment of
// steps a round), all fit the co-resident grid of one block a band, two
// threads a lane and bw + 2 halo lanes a multiple of 16, up to REG_NT
// threads. Of those layouts, the one whose busiest scheduler steps through
// the fewest warps (the bands an SM holds times a band's warps over the
// SM's four schedulers), then the fewest warps an SM, then the narrowest
// band. Else (taller planes, halos past the lanes, batches past the grid)
// kern is null and the launch takes hyst_kernel<false, SEG>. Cached.
cudaError_t reg_plan(int device, int nb, int hw, int w, int dilate_steps, RegPlan* out) {
  if (dilate_steps < 1 || dilate_steps > MAX_DILATE_STEPS || nb < 1) return cudaErrorInvalidValue;
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int>, RegPlan> cache;
  const auto key = std::make_tuple(device, nb, hw, w, dilate_steps);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = cache.find(key);
    if (hit != cache.end()) {
      *out = hit->second;
      return cudaSuccess;
    }
  }
  RegPlan pick{nullptr, 0, 0, 0, 0, 0};
  if (hw <= HW_MAX) {
    int sms = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const void* kern = reg_kernel(hw, std::make_integer_sequence<int, HW_MAX / 2>{});
    const int hp = reg_half_words((hw + 1) / 2);
    std::pair<long long, long long> best{LLONG_MAX, LLONG_MAX};
    for (int t = 32; t <= REG_NT; t += 32) {  // t threads: t / 2 lanes
      const int bw = t / 2 - 2 * dilate_steps, warps = t / 32;
      if (bw < 1) continue;
      const size_t smem = (size_t)(reg_state_words(nb) + 8 * warps * hp) * sizeof(uint32_t);
      int limit = 0;
      err = co_resident(kern, device, smem, &limit, t);
      if (err != cudaSuccess) return err;
      const long long bands = (long long)nb * ((w + bw - 1) / bw);
      if (bands > limit) continue;
      const long long per_sm = (bands + sms - 1) / sms;
      const std::pair<long long, long long> cost{per_sm * ((warps + 3) / 4), per_sm * warps};
      if (cost < best) {
        best = cost;
        pick = RegPlan{kern, bw, dilate_steps, t, (int)bands, smem};
      }
    }
  }
  std::lock_guard<std::mutex> lock(mu);
  *out = cache[key] = pick;
  return cudaSuccess;
}

void set_reg_layout(Params& a, const RegPlan& r) {
  a.bw = r.bw;
  a.halo = r.halo;
  a.ns = 1;
  a.nbw = (a.w + r.bw - 1) / r.bw;
  a.wsw = 0;  // the frame state at the start of shared memory
}

template <bool PHASE2>
cudaError_t launch_rounds(Params a, int device, cudaStream_t stream) {
  if constexpr (!PHASE2) {
    RegPlan r;
    cudaError_t err = reg_plan(device, a.nb, a.hw, a.w, a.dilate_steps, &r);
    if (err != cudaSuccess) return err;
    if (r.kern) {
      set_reg_layout(a, r);
      void* args[] = {&a};
      err = cudaLaunchCooperativeKernel(r.kern, dim3(r.bands), dim3(r.threads), args, r.smem, stream);
      if (err != cudaSuccess) return err;
      return cudaGetLastError();
    }
  }
  // Phase 1 starts with every frame active: its layout covers the batch.
  // Phase 2 works on the escalated frames, rarely more than one, and a grid
  // barrier costs more the more blocks take part, so its layout covers one
  // frame; more frames still growing share the blocks, each block then
  // streaming its bands.
  const Kern kern{(const void*)(RoundKernel)hyst_kernel<PHASE2, false>,
                  (const void*)(RoundKernel)hyst_kernel<PHASE2, true>};
  Layout l;
  unsigned grid = 0;
  cudaError_t err = plan(kern, a, PHASE2 ? 1 : a.nb, PHASE2 ? BAND_UNIT : MIN_BAND, device, &l, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern.pick(l.ns), dim3(grid), dim3(NT), args, l.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The collective round loop's kernels and its layout for the (tiles, hw, w)
// planes of a, set into a: choose_layout's bands over every tile, a block a
// band up to the co-resident grid.
const Kern LOOP{(const void*)sharded_loop_kernel<false>, (const void*)sharded_loop_kernel<true>};

cudaError_t loop_plan(Params& a, int device, Layout* lay, unsigned* grid) {
  return plan(LOOP, a, a.nb, BAND_UNIT, device, lay, grid);
}

// The column-split continuation's launch over nf (h, w) frames cut into
// n_split slices: its Params over the nf n_split slices of ws + 2k columns
// (no pointers set), its layout and grid, and the scratch it needs.
// choose_layout's bands over one frame's slices, a block a band up to the
// co-resident grid, as phase 2 lays out one frame: a launch whose frames
// still growing hold more bands than that streams them. Each block's shared
// memory holds the slices' state and, as nf frames more, the frames'
// seam-loop state. The scratch: the rounds' over the slices, the seam
// rounds' change flags (3 a frame), a count a tile, the slices' seam
// records, and where the launch can stream, the slices' F and P planes.
struct SplitPlan {
  Params a;
  Layout l;
  unsigned grid;
  int ws, k;
  long long words;  // int32 words of scratch
  bool planes;      // the scratch holds slice planes: more frames than one can grow
};

const Kern SPLIT{(const void*)split_kernel<false>, (const void*)split_kernel<true>};

cudaError_t split_plan(int nf, int h, int w, int n_split, int dilate_steps, int device,
                       SplitPlan* o) {
  if (nf < 1 || h < 1 || n_split < 1 || w % n_split || dilate_steps < 1 ||
      dilate_steps > MAX_DILATE_STEPS)
    return cudaErrorInvalidValue;
  o->ws = w / n_split;
  o->k = o->ws < 64 ? o->ws : 64;
  const int nb = nf * n_split, sw = o->ws + 2 * o->k;
  o->a = make_params(nullptr, nullptr, nullptr, nullptr, nb, h, sw, dilate_steps, 0, 0);
  cudaError_t err = choose_layout(SPLIT, device, n_split, nb + nf, o->a.hw, sw, dilate_steps,
                                  BAND_UNIT, &o->l);
  if (err != cudaSuccess) return err;
  set_layout(o->a, o->l);
  const long long one = (long long)n_split * o->a.nbw * o->a.ns;
  o->grid = (unsigned)(one < o->l.limit ? one : o->l.limit);
  o->planes = nf > (long long)o->grid / one;
  const long long tiles = (long long)nb * ((sw + MIN_BAND - 1) / MIN_BAND) * max_segments(o->a.hw);
  o->words = rounds_scratch_words(nb, h, sw) + 3LL * nf + tiles + 2LL * nb * o->a.hw * o->k +
             (o->planes ? 2 * nb * o->a.plane : 0);
  return cudaSuccess;
}

}  // namespace

// int32 words of scratch either phase needs for B frames (``phase`` is kept
// for the callers; both phases take the same).
extern "C" long long cc_hyst_scratch_words(int nb, int h, int w, int phase) {
  (void)phase;
  return rounds_scratch_words(nb, h, w);
}

// count: two unsigned 64-bit words the launch adds (planes, rounds) to
// (phase 2: the planes it continued and the rounds it added), or null.
extern "C" int cc_hyst_phase1(void* f, const void* p, void* scratch, void* flags, void* count,
                              int nb, int h, int w, int dilate_steps, int scan_after, int max_iters,
                              int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int cap = scan_after < max_iters ? scan_after : max_iters;
  Params a = make_params(f, p, scratch, flags, nb, h, w, dilate_steps, cap, INT_MAX);
  a.count = static_cast<unsigned long long*>(count);
  return launch_rounds<false>(a, device, static_cast<cudaStream_t>(stream));
}

extern "C" int cc_hyst_phase2(void* f, const void* p, void* scratch, void* flags, void* count,
                              int nb, int h, int w, int dilate_steps, int max_iters, int device,
                              void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  Params a = make_params(f, p, scratch, flags, nb, h, w, dilate_steps, max_iters, 0);
  a.count = static_cast<unsigned long long*>(count);
  return launch_rounds<true>(a, device, static_cast<cudaStream_t>(stream));
}

// The band layout a round kernel's launch takes for nb (h, w) frames
// (phase 1 or 2): out = (band width, halo columns, blocks, bands of one
// frame, grid barriers a round: ceil(dilate_steps / halo) segments of steps,
// plus in phase 2 the scan stages (6, or 12 with height segments), height
// segments); *route = 1 where the launch takes phase 1's register route
// (reg_plan; its blocks are its bands), else 0.
extern "C" int cc_hyst_layout(int nb, int h, int w, int dilate_steps, int phase, int device,
                              int* out, int* route) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  Params a = make_params(nullptr, nullptr, nullptr, nullptr, nb, h, w, dilate_steps, 0, 0);
  RegPlan r{nullptr, 0, 0, 0, 0, 0};
  cudaError_t err = phase == 2 ? cudaSuccess : reg_plan(device, nb, a.hw, w, dilate_steps, &r);
  if (err != cudaSuccess) return err;
  unsigned grid = 0;
  if (r.kern) {
    set_reg_layout(a, r);
    grid = (unsigned)r.bands;
  } else {
    const Kern kern =
        phase == 2 ? Kern{(const void*)(RoundKernel)hyst_kernel<true, false>,
                          (const void*)(RoundKernel)hyst_kernel<true, true>}
                   : Kern{(const void*)(RoundKernel)hyst_kernel<false, false>,
                          (const void*)(RoundKernel)hyst_kernel<false, true>};
    Layout l;
    err = plan(kern, a, phase == 2 ? 1 : nb, phase == 2 ? BAND_UNIT : MIN_BAND, device, &l, &grid);
    if (err != cudaSuccess) return err;
  }
  *route = r.kern != nullptr;
  out[0] = a.bw;
  out[1] = a.halo;
  out[2] = (int)grid;
  out[3] = a.nbw;
  out[4] = (dilate_steps + a.halo - 1) / a.halo + (phase == 2 ? (a.ns > 1 ? 12 : 6) : 0);
  out[5] = a.ns;
  return cudaSuccess;
}

// int32 words of scratch the column-split continuation of nf (h, w) frames
// needs (split_plan), or minus a CUDA error.
extern "C" long long cc_split_scratch_words(int nf, int h, int w, int n_split, int dilate_steps,
                                            int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -(long long)guard.err;
  SplitPlan o;
  const cudaError_t err = split_plan(nf, h, w, n_split, dilate_steps, device, &o);
  return err != cudaSuccess ? -(long long)err : o.words;
}

// The column-split continuation of nf (ceil(h/32), w) frames, one launch:
// each frame's flags row 0 (round count, growing) is read on the device,
// row 1 written. ``chunk`` < 1 is the unchunked mode: slices run to
// max_iters and a seam round counts 1.
extern "C" int cc_split_converge(void* f, const void* p, void* scratch, void* flags, int nf, int h,
                                 int w, int n_split, int dilate_steps, int scan_after,
                                 int max_iters, int chunk, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (max_iters < 1) return cudaErrorInvalidValue;
  SplitPlan o;
  cudaError_t err = split_plan(nf, h, w, n_split, dilate_steps, device, &o);
  if (err != cudaSuccess) return err;
  const int nb = nf * n_split, inner = chunk >= 1 ? chunk : max_iters;
  const int cap1 = scan_after < inner ? scan_after : inner;
  Params a = make_params(nullptr, nullptr, scratch, nullptr, nb, h, o.a.w, dilate_steps, inner,
                         cap1 > 1 ? cap1 : 1);
  set_layout(a, o.l);
  SplitParams s;
  s.ff = static_cast<uint32_t*>(f);
  s.fp = static_cast<const uint32_t*>(p);
  s.fflags = static_cast<int*>(flags);
  s.mchg = a.chg + 3 * nb;
  s.ocnt = s.mchg + 3 * nf;
  s.pub = reinterpret_cast<uint32_t*>(
      s.ocnt + (long long)nb * ((a.w + MIN_BAND - 1) / MIN_BAND) * max_segments(a.hw));
  uint32_t* planes = s.pub + 2LL * nb * a.hw * o.k;
  a.f = o.planes ? planes : nullptr;
  s.sp = o.planes ? planes + nb * a.plane : nullptr;
  a.p = s.sp;
  s.nf = nf;
  s.n = n_split;
  s.fw = w;
  s.ws = o.ws;
  s.k = o.k;
  s.budget = max_iters;
  s.chunked = chunk >= 1;
  void* args[] = {&a, &s};
  err = cudaLaunchCooperativeKernel(SPLIT.pick(o.l.ns), dim3(o.grid), dim3(NT), args, o.l.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The layout of the column-split continuation of nf (h, w) frames by
// n_split slices: out = (band width, halo columns, bands a slice, blocks,
// height segments, frames whose slices stay resident when they grow at
// once (0: every launch streams), whether the scratch holds slice planes,
// grid barriers a seam round besides its rounds', grid barriers a dilation
// round and a scan round, dynamic shared memory bytes a block).
extern "C" int cc_split_layout(int nf, int h, int w, int n_split, int dilate_steps, int device,
                               int* out) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  SplitPlan o;
  const cudaError_t err = split_plan(nf, h, w, n_split, dilate_steps, device, &o);
  if (err != cudaSuccess) return err;
  const int one = n_split * o.a.nbw * o.a.ns, p1 = (dilate_steps + o.a.halo - 1) / o.a.halo;
  out[0] = o.a.bw;
  out[1] = o.a.halo;
  out[2] = o.a.nbw * o.a.ns;
  out[3] = (int)o.grid;
  out[4] = o.a.ns;
  out[5] = (int)o.grid / one;
  out[6] = o.planes;
  out[7] = 2;  // after the change test and the seam records; after the refresh
  out[8] = p1;
  out[9] = p1 + (o.a.ns > 1 ? 12 : 6);
  out[10] = (int)o.l.smem;
  return cudaSuccess;
}

// int32 words of scratch the sharded loop needs for T extended tiles of
// h x w: the rounds' scratch (its change flags last), then the refresh's
// published strips and lanes (FINAL's, then CANDIDATE's for the prologue)
// and four flag slots.
extern "C" long long cc_sharded_loop_scratch_words(int tiles, int h, int w) {
  return rounds_scratch_words(tiles, h, w) + 2 * halo::strips_words(tiles, (h + 31) / 32, w) + 4;
}

// The collective round loop of a one-card (nb, ny, nx) mesh, one launch:
// f, p are the (T, ceil(h/32), w) extended-tile planes at the export's
// phase-1 exit (T = nb ny nx, h x w the extended tile; both refreshed in
// place before the first round), flags the (T, 2, 2) round flags, rounds the
// one int it writes, count two unsigned 64-bit words it adds (1, rounds) to
// (or null). geo: 5 ints (e_top, h_loc, e_left, w_loc, ext_h), as
// cc_halo_exchange's.
extern "C" int cc_sharded_loop(void* f, void* p, void* scratch, void* flags, void* rounds,
                               void* count, int nb, int ny, int nx, int h, int w, const int* geo,
                               int dilate_steps, int scan_after, int max_iters, int max_rounds,
                               int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nb < 1 || ny < 1 || nx < 1 || max_rounds < 0) return cudaErrorInvalidValue;
  const int tiles = nb * ny * nx;
  Params a = make_params(f, p, scratch, flags, tiles, h, w, dilate_steps, max_iters, 0);
  halo::Strips x;
  x.rows = reinterpret_cast<uint32_t*>(a.chg + 3 * tiles);
  x.lanes = x.rows + 4LL * tiles * w;
  x.ny = ny;
  x.nx = nx;
  x.hw = a.hw;
  x.w = w;
  x.e_top = geo[0];
  x.h_loc = geo[1];
  x.e_left = geo[2];
  x.w_loc = geo[3];
  x.ext_h = geo[4];
  halo::Strips xp = x;
  xp.rows = x.rows + halo::strips_words(tiles, a.hw, w);
  xp.lanes = xp.rows + 4LL * tiles * w;
  LoopParams l;
  l.pend = reinterpret_cast<int*>(xp.rows + halo::strips_words(tiles, a.hw, w));
  l.rounds = static_cast<int*>(rounds);
  l.count = static_cast<unsigned long long*>(count);
  l.max_rounds = max_rounds;
  Layout lay;
  unsigned grid = 0;
  cudaError_t err = loop_plan(a, device, &lay, &grid);
  if (err != cudaSuccess) return err;
  Params a1 = a;  // phase 1: min(scan_after, max_iters) rounds, no scans
  a1.cap = scan_after < max_iters ? scan_after : max_iters;
  a1.scan_from = INT_MAX;
  void* args[] = {&a, &a1, &x, &xp, &l};
  err = cudaLaunchCooperativeKernel(LOOP.pick(lay.ns), dim3(grid), dim3(NT), args, lay.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The layout of the collective round loop of a one-card (nb, ny, nx) mesh of
// h x w extended tiles: out = (band width, halo columns, bands a tile,
// blocks, cluster size (1: the loop has no cluster form), grid barriers a
// phase-1 round and a phase-2 round, height segments, grid barriers a
// collective round besides its rounds', dynamic shared memory bytes a
// block, grid barriers of the prologue).
extern "C" int cc_sharded_loop_layout(int nb, int ny, int nx, int h, int w, int dilate_steps,
                                      int device, int* out) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nb < 1 || ny < 1 || nx < 1) return cudaErrorInvalidValue;
  Params a = make_params(nullptr, nullptr, nullptr, nullptr, nb * ny * nx, h, w, dilate_steps, 0,
                         0);
  Layout lay;
  unsigned grid = 0;
  cudaError_t err = loop_plan(a, device, &lay, &grid);
  if (err != cudaSuccess) return err;
  const int p1 = (dilate_steps + a.halo - 1) / a.halo;
  out[0] = a.bw;
  out[1] = a.halo;
  out[2] = a.nbw * a.ns;
  out[3] = (int)grid;
  out[4] = 1;
  out[5] = p1;
  out[6] = p1 + (a.ns > 1 ? 12 : 6);
  out[7] = a.ns;
  out[8] = 2;  // the refresh's and the flag's
  out[9] = (int)lay.smem;
  out[10] = 2;  // the prologue's refresh and its flag
  return cudaSuccess;
}
