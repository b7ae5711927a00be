// The halo refresh of a one-card sharded frame batch, as device functions:
// exchange_body, the body of halo.cu's exchange_kernel, on the planes in
// global memory; and its resident form (publish_band, apply_band), one step
// of hyst_rounds.cu's sharded_loop (the whole collective round loop in one
// launch), on the bands each block keeps in shared memory.
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
//
// The resident form computes the same words with one grid barrier. Before
// it, each band (columns [c0, c0 + cb), word rows [k0, k0 + hk) of tile t,
// its words in shared memory) publishes what its tile's neighbours read of
// it, as the planes stand: the two word rows each row strip starts in, and
// its part of the tile's first and last k core lanes over every word row.
// After it, each band computes every word of its own that the refresh
// writes, one thread a word: the strips of the tiles above and below placed
// in its halo rows, and in its halo lanes the neighbour's edge lanes ORed
// with what the neighbour's own row step places in them (the corners, which
// the reference carries by running the column step after the row step).
// Each word is ORed in by one thread, so two small halo slots that share a
// word need no atomics; a bit is new where the OR set it.

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

// The resident form's scratch: each tile's plane words at the two word rows
// each of its row strips starts in, and its first and last k (<= 64) core
// lanes over every word row, as published before the barrier.
struct Strips {
  uint32_t* rows;   // (T, 4, w): strip s (0: down, 1: up), its word rows q_s and q_s + 1
  uint32_t* lanes;  // (T, 2, hw, 64): the first (0) and last (1) k core lanes
  int ny, nx, hw, w;
  int e_top, h_loc, e_left, w_loc, ext_h;
};

// int32 words of the resident form's scratch for T tiles of hw x w words.
__host__ __device__ inline long long strips_words(long long tiles, int hw, int w) {
  return tiles * (4LL * w + 128LL * hw);
}

// The first row of strip s of a tile (0: its bottom core rows, for the tile
// below; 1: its top core rows, for the tile above), and the word row it
// starts in.
__device__ __forceinline__ int strip_row(const Strips& a, int s) {
  return s ? a.e_top : a.e_top + a.h_loc - 32;
}
__device__ __forceinline__ int strip_word(const Strips& a, int s) {
  const int b = strip_row(a, s);
  return b < 0 ? 0 : b >> 5;
}

// _extract32 of lane c of strip s of tile u, from its published words.
__device__ __forceinline__ uint32_t strip_at(const Strips& a, int u, int s, int c) {
  const uint32_t* r = a.rows + (size_t)(4 * u + 2 * s) * a.w + c;
  const int b = strip_row(a, s);
  if (b < 0) return __ldcg(r) << (-b);
  const int q = b >> 5, sh = b & 31;
  uint32_t v = __ldcg(r);
  if (sh) v = (v >> sh) | ((q + 1 < a.hw ? __ldcg(r + a.w) : 0u) << (32 - sh));
  return v;
}

// What _or_place32 of `strip` at row b (bits at rows >= cap dropped) puts
// in word row k.
__device__ __forceinline__ uint32_t placed(uint32_t strip, int b, int cap, int k, int hw) {
  if (b < 0) {
    strip >>= -b;
    b = 0;
  }
  if (b >= cap) return 0u;
  const int q = b >> 5, r = b & 31;
  if (k == q) return (r ? strip << r : strip) & word_mask(b, cap, q);
  if (r && k == q + 1 && q + 1 < hw) return (strip >> (32 - r)) & word_mask(b, cap, q + 1);
  return 0u;
}

// The row step's bits in word (k, c) of tile t: the strip of the tile above
// in its top halo slot, of the tile below in its bottom one.
__device__ __forceinline__ uint32_t row_part(const Strips& a, int t, int k, int c) {
  const int i = (t / a.nx) % a.ny;
  uint32_t v = 0u;
  if (i > 0) v |= placed(strip_at(a, t - a.nx, 0, c), a.e_top - 32, a.ext_h, k, a.hw);
  if (i < a.ny - 1) v |= placed(strip_at(a, t + a.nx, 1, c), a.e_top + a.h_loc, a.ext_h, k, a.hw);
  return v;
}

// The column step's bits in word (k, c) of tile t, c a halo lane: the
// neighbour's edge lane as its row step leaves it.
__device__ __forceinline__ uint32_t lane_part(const Strips& a, int t, int k, int c) {
  const int j = t % a.nx, kl = min(64, a.e_left), c_r = a.e_left + a.w_loc;
  if (j > 0 && c >= a.e_left - kl && c < a.e_left) {
    const int l = c - (a.e_left - kl);
    return __ldcg(a.lanes + ((size_t)(2 * (t - 1) + 1) * a.hw + k) * 64 + l) |
           row_part(a, t - 1, k, c_r - kl + l);
  }
  if (j < a.nx - 1 && c >= c_r && c < c_r + kl) {
    const int l = c - c_r;
    return __ldcg(a.lanes + ((size_t)(2 * (t + 1)) * a.hw + k) * 64 + l) |
           row_part(a, t + 1, k, a.e_left + l);
  }
  return 0u;
}

// Publishes a band's part of what its tile's neighbours read (see the head
// of this file): X is the band's word (k0, c0), rows rs words apart. Every
// thread of the block calls it.
__device__ inline void publish_band(const Strips& a, int t, const uint32_t* X, int rs, int k0,
                                    int hk, int c0, int cb) {
  const int i = (t / a.nx) % a.ny, j = t % a.nx;
  for (int s = 0; s < 2 && a.ny > 1; ++s) {
    if (s == 0 ? i == a.ny - 1 : i == 0) continue;  // no tile reads it
    for (int jj = 0; jj < 2; ++jj) {
      const int k = strip_word(a, s) + jj;
      if (k < k0 || k >= k0 + hk || k >= a.hw) continue;
      uint32_t* o = a.rows + (size_t)(4 * t + 2 * s + jj) * a.w + c0;
      for (int c = threadIdx.x; c < cb; c += blockDim.x) o[c] = X[(k - k0) * rs + c];
    }
  }
  if (a.nx == 1) return;
  const int kl = min(64, a.e_left), c_r = a.e_left + a.w_loc;
  for (int side = 0; side < 2; ++side) {
    if (side == 0 ? j == 0 : j == a.nx - 1) continue;
    const int lo = side ? c_r - kl : a.e_left;
    const int s0 = max(lo, c0), s1 = min(lo + kl, c0 + cb), n = s1 - s0;
    if (n <= 0) continue;
    uint32_t* o = a.lanes + ((size_t)(2 * t + side) * a.hw + k0) * 64 + (s0 - lo);
    for (int e = threadIdx.x; e < hk * n; e += blockDim.x) {
      const int k = e / n, l = e - k * n;
      o[(size_t)k * 64 + l] = X[k * rs + s0 - c0 + l];
    }
  }
}

// ORs into a band's words what the refresh writes there (after the barrier
// that follows every band's publish_band). Returns the new bits this thread
// set. Every thread of the block calls it; the caller syncs the block.
__device__ inline int apply_band(const Strips& a, int t, uint32_t* X, int rs, int k0, int hk,
                                 int c0, int cb) {
  const int i = (t / a.nx) % a.ny, j = t % a.nx;
  // The word rows the row step writes, those of this band: at most 4, each
  // once (-1: none), held in registers.
  int rows[4] = {-1, -1, -1, -1};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const bool from = a.ny > 1 && (s == 0 ? i > 0 : i < a.ny - 1);  // a tile above / below
    const int b = max(s == 0 ? a.e_top - 32 : a.e_top + a.h_loc, 0);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int k = (b >> 5) + jj;
      const bool in = from && b < a.ext_h && (jj == 0 || (b & 31)) && k >= k0 && k < k0 + hk &&
                      k < a.hw;
      rows[2 * s + jj] = in ? k : -1;
    }
  }
#pragma unroll
  for (int m = 1; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < m; ++q)
      if (rows[m] == rows[q]) rows[m] = -1;
  // The halo lanes of this band: left [e_left - kl, e_left) and right
  // [c_r, c_r + kl), where there is a neighbour.
  const int kl = min(64, a.e_left), c_r = a.e_left + a.w_loc;
  const int l0 = j > 0 ? max(c0, a.e_left - kl) : 0, l1 = j > 0 ? min(c0 + cb, a.e_left) : 0;
  const int r0 = j < a.nx - 1 ? max(c0, c_r) : 0, r1 = j < a.nx - 1 ? min(c0 + cb, c_r + kl) : 0;
  const int nl = max(l1 - l0, 0), nrt = max(r1 - r0, 0), nlanes = a.nx > 1 ? nl + nrt : 0;
  int fresh = 0;
  // Every word of the rows the row step writes, its halo lanes' bits with it.
  for (int e = threadIdx.x; e < 4 * cb; e += blockDim.x) {
    const int m = e / cb, c = c0 + e - m * cb;
    const int k = m == 0 ? rows[0] : m == 1 ? rows[1] : m == 2 ? rows[2] : rows[3];
    if (k < 0) continue;
    const uint32_t v = row_part(a, t, k, c) | (nlanes ? lane_part(a, t, k, c) : 0u);
    uint32_t* w = X + (k - k0) * rs + (c - c0);
    const uint32_t nb = v & ~*w;
    *w |= nb;
    fresh += __popc(nb);
  }
  // The halo lanes' words in the other rows.
  for (int e = threadIdx.x; e < nlanes * hk; e += blockDim.x) {
    const int kk = e / nlanes, l = e - kk * nlanes, k = k0 + kk;
    if (k == rows[0] || k == rows[1] || k == rows[2] || k == rows[3]) continue;
    const int c = l < nl ? l0 + l : r0 + (l - nl);
    const uint32_t v = lane_part(a, t, k, c);
    uint32_t* w = X + kk * rs + (c - c0);
    const uint32_t nb = v & ~*w;
    *w |= nb;
    fresh += __popc(nb);
  }
  return fresh;
}

}  // namespace halo
