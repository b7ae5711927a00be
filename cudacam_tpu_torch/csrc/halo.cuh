// The halo refresh of a one-card sharded frame batch, as a device function:
// the body of halo.cu's exchange_kernel and one step of hyst_rounds.cu's
// sharded_loop (the whole collective round loop in one launch).
//
// Replaces the strip exchange of the sharded round loop, which the JAX
// package computes as XLA ops around jax.lax.ppermute (cudacam_tpu/parallel/
// packed_halo.py: exchange_packed :195, _extract32 :124, _or_place32 :150,
// and the psum'd flag of packed_hysteresis_loop :256). On one card every
// tile of the (b, y, x) mesh lives on the device as the leading axis of one
// (T, hw, w) tensor, so a neighbour hop is an index shift over that axis.
//
// The order is the reference's, in three steps over all tiles with a grid
// barrier between them:
//   1. rows: every tile's two 32-row strips, its bottom core rows (for the
//      tile below) and its top core rows (for the tile above), spanning all
//      lanes, into scratch, from the planes as they stand;
//   2. each strip ORed into the neighbour's halo rows, bits past the
//      extended tile dropped; atomicOr, because a small tile's two halo
//      slots can share a word;
//   3. columns: min(64, e_left) lanes of core columns over ALL word rows
//      (so they carry the corners just placed) into the left and right
//      neighbours' halo lanes. Core lanes are read and halo lanes written,
//      each by one thread, so this step needs no snapshot.
// A bit is new when the OR set it. The flag written to `pending` is "some
// tile still growing (any of the n_grow ints at grow[i * grow_stride], e.g.
// the round kernels' flags[t][1][1]) or some new halo bit", the loop's exit
// test (packed_halo.py:288-306).
//
// The caller launches cooperatively; every block calls exchange_body. It
// ends with a grid barrier, after which thread 0 of block 0 writes
// *pending; a caller that reads it in other blocks syncs the grid first.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

namespace halo {

namespace cg = cooperative_groups;

struct Xchg {
  uint32_t* x;        // (T, hw, w) planes, T = nb * ny * nx tiles in (b, y, x) order
  uint32_t* strips;   // scratch: (T, 2, w) row strips
  int* newbit;        // scratch: one word
  const int* grow;    // null, or n_grow "still growing" ints, grow_stride apart
  int n_grow, grow_stride;
  int* pending;       // null, or: where the round's flag goes
  int nb, ny, nx, hw, w;
  int e_top, h_loc, e_left, w_loc, ext_h;
};

// int32 words of scratch for T tiles of w lanes: the row strips and newbit.
__host__ __device__ inline long long scratch_words(long long tiles, int w) {
  return 2 * tiles * w + 1;
}

// The threads one refresh can keep busy: every lane of every tile (the row
// steps), or every halo lane of every word row (the column step).
__host__ __device__ inline long long work_items(const Xchg& a) {
  const long long T = (long long)a.nb * a.ny * a.nx;
  const long long k = a.e_left < 64 ? a.e_left : 64;
  const long long rows = T * a.w, cols = 2 * T * a.hw * k;
  return rows > cols ? rows : cols;
}

// _extract32: lane c of the 32-row strip of plane x starting at row b
// (b > -32; rows before the plane read as zero).
__device__ __forceinline__ uint32_t extract32(const uint32_t* x, int b, int c, int hw, int w) {
  if (b < 0) return __ldcg(x + c) << (-b);
  const int q = b >> 5, r = b & 31;
  uint32_t row = __ldcg(x + (size_t)q * w + c);
  if (r) {
    const uint32_t nxt = q + 1 < hw ? __ldcg(x + (size_t)(q + 1) * w + c) : 0u;
    row = (row >> r) | (nxt << (32 - r));
  }
  return row;
}

// The bits of word wi that lie in rows [b, min(cap, b + 32)).
__device__ __forceinline__ uint32_t word_mask(int b, int cap, int wi) {
  const int lo = max(b, wi * 32) - wi * 32;
  const int hi = min(min(cap, b + 32), (wi + 1) * 32) - wi * 32;
  if (hi <= lo) return 0u;
  return hi - lo >= 32 ? 0xffffffffu : ((1u << (hi - lo)) - 1u) << lo;
}

// _or_place32 of lane c: OR a 32-row strip into rows [b, b + 32) of plane x,
// dropping bits at rows >= cap. Returns whether a bit was new.
__device__ __forceinline__ bool or_place32(uint32_t* x, uint32_t strip, int b, int cap, int c,
                                           int hw, int w) {
  if (b < 0) {
    strip >>= -b;
    b = 0;
  }
  if (b >= cap) return false;
  const int q = b >> 5, r = b & 31;
  bool fresh = false;
  const uint32_t lo = (r ? strip << r : strip) & word_mask(b, cap, q);
  if (lo) fresh |= (lo & ~atomicOr(x + (size_t)q * w + c, lo)) != 0u;
  if (r && q + 1 < hw) {
    const uint32_t hi = (strip >> (32 - r)) & word_mask(b, cap, q + 1);
    if (hi) fresh |= (hi & ~atomicOr(x + (size_t)(q + 1) * w + c, hi)) != 0u;
  }
  return fresh;
}

// One halo refresh of every tile's planes, in place, and the pending flag.
__device__ inline void exchange_body(const Xchg& a, cg::grid_group& grid) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  const int T = a.nb * a.ny * a.nx;
  const size_t plane = (size_t)a.hw * a.w;
  if (gtid == 0) *a.newbit = 0;
  if (a.ny > 1) {
    for (long long e = gtid; e < (long long)T * a.w; e += gsize) {
      const int t = (int)(e / a.w), c = (int)(e % a.w);
      const uint32_t* xt = a.x + t * plane;
      a.strips[(size_t)(2 * t) * a.w + c] = extract32(xt, a.e_top + a.h_loc - 32, c, a.hw, a.w);
      a.strips[(size_t)(2 * t + 1) * a.w + c] = extract32(xt, a.e_top, c, a.hw, a.w);
    }
  }
  grid.sync();  // the strips are out and newbit is clear
  bool fresh = false;
  if (a.ny > 1) {
    for (long long e = gtid; e < (long long)T * a.w; e += gsize) {
      const int t = (int)(e / a.w), c = (int)(e % a.w);
      const int i = (t / a.nx) % a.ny;
      uint32_t* xt = a.x + t * plane;
      if (i > 0)  // the upper neighbour's bottom rows -> my top halo slot
        fresh |= or_place32(xt, __ldcg(a.strips + (size_t)(2 * (t - a.nx)) * a.w + c),
                            a.e_top - 32, a.ext_h, c, a.hw, a.w);
      if (i < a.ny - 1)  // the lower neighbour's top rows -> my bottom halo slot
        fresh |= or_place32(xt, __ldcg(a.strips + (size_t)(2 * (t + a.nx) + 1) * a.w + c),
                            a.e_top + a.h_loc, a.ext_h, c, a.hw, a.w);
    }
    grid.sync();  // the column step carries the rows just placed
  }
  if (a.nx > 1) {
    const int k = min(64, a.e_left), c_r = a.e_left + a.w_loc;
    const long long n = 2LL * T * a.hw * k;
    for (long long e = gtid; e < n; e += gsize) {
      const int l = (int)(e % k);
      const long long rest = e / k;
      const int row = (int)(rest % a.hw);
      const int t = (int)((rest / a.hw) % T);
      const bool left = rest / ((long long)a.hw * T) == 0;
      const int j = t % a.nx;
      if (left ? j == 0 : j == a.nx - 1) continue;
      // left: the left neighbour's last core lanes -> my left halo lanes;
      // right: the right neighbour's first core lanes -> my right halo lanes.
      const uint32_t* src = a.x + (left ? t - 1 : t + 1) * plane + (size_t)row * a.w +
                            (left ? c_r - k : a.e_left) + l;
      uint32_t* dst = a.x + t * plane + (size_t)row * a.w + (left ? a.e_left - k : c_r) + l;
      const uint32_t v = __ldcg(src);
      const uint32_t old = __ldcg(dst);
      if (v & ~old) {
        fresh = true;
        *dst = old | v;
      }
    }
  }
  if (__syncthreads_or(fresh) && threadIdx.x == 0) atomicOr(a.newbit, 1);
  grid.sync();
  if (gtid == 0 && a.pending) {
    int p = __ldcg(a.newbit);
    if (a.grow)
      for (int i = 0; i < a.n_grow; ++i) p |= __ldcg(a.grow + (size_t)i * a.grow_stride);
    *a.pending = p != 0;
  }
}

}  // namespace halo
