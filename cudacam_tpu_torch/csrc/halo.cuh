// The halo refresh of a one-card sharded frame batch, as device functions
// (publish_band, apply_band) that work on one band of a tile: a block of
// columns [c0, c0 + cb) and word rows [k0, k0 + hk) of tile t, its words at
// X, rows rs words apart, shared by nt threads. Three callers:
// hyst_rounds.cu's sharded_loop runs them on the bands each block keeps in
// shared memory (a block a band), once a collective round, and in its
// prologue on the planes in global memory (both planes before the first
// round; publish_planes / apply_planes: each tile one band, the grid's
// threads split between the tiles); halo.cu's exchange_kernel (the
// standalone refresh) the same way.
//
// Replaces the strip exchange of the sharded round loop, which the JAX
// package computes as XLA ops around jax.lax.ppermute (cudacam_tpu/parallel/
// packed_halo.py: exchange_packed :195, _extract32 :124, _or_place32 :150,
// and the psum'd flag of packed_hysteresis_loop :256). On one card every
// tile of the (b, y, x) mesh lives on the device as the leading axis of one
// (T, hw, w) tensor, so a neighbour hop is an index shift over that axis.
//
// The reference runs three steps in turn: the row strips out, each ORed
// into the neighbour's halo rows (bits past the extended tile dropped), then
// the core lanes over ALL word rows (so they carry the corners just placed)
// into the left and right neighbours' halo lanes. Here the same words come
// from one grid barrier. Before it, each band publishes what its tile's
// neighbours read of it, as the planes stand: the word rows each row strip
// spans (one, or two where it starts mid-word), and its part of the tile's
// first and last k (<= 64) core lanes over every word row. After it, each
// band computes every word of its own that the refresh writes, one thread a
// word: the strips of the tiles above and below placed in its halo rows,
// and in its halo lanes the neighbour's edge lanes ORed with what the
// neighbour's own row step places in them (the corners, by algebra:
// row_part | lane_part, not by ordering the steps). Each word is ORed in by
// one thread, so two small halo slots that share a word need no atomics; a
// bit is new where the OR set it. A thread reads only the plane words it
// publishes or writes (what crosses bands goes through the published
// scratch, read with __ldcg after the barrier), so the form is the same on
// shared and on global memory. On global memory a tile is one band over
// many blocks: the halo lanes' words, whose values take the longest chains
// of loads, would otherwise all fall on the few blocks that hold a tile's
// edge columns. A band's rows and lanes are one range of items, so its
// threads share them evenly.

#pragma once

#include <stdint.h>

namespace halo {

// The bits of word wi that lie in rows [b, min(cap, b + 32)).
__device__ __forceinline__ uint32_t word_mask(int b, int cap, int wi) {
  const int lo = max(b, wi * 32) - wi * 32;
  const int hi = min(min(cap, b + 32), (wi + 1) * 32) - wi * 32;
  if (hi <= lo) return 0u;
  return hi - lo >= 32 ? 0xffffffffu : ((1u << (hi - lo)) - 1u) << lo;
}

// The published scratch: each tile's plane words at the word rows each of
// its row strips spans, and its first and last k (<= 64) core lanes over
// every word row, as published before the barrier.
struct Strips {
  uint32_t* rows;   // (T, 4, w): strip s (0: down, 1: up), its word rows q_s and q_s + 1
  uint32_t* lanes;  // (T, 2, hw, 64): the first (0) and last (1) k core lanes
  int ny, nx, hw, w;
  int e_top, h_loc, e_left, w_loc, ext_h;
};

// int32 words of the published scratch for T tiles of hw x w words.
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

// The slot of the m-th set bit (m from 0) of the 4-bit mask live.
__device__ __forceinline__ int nth_slot(int live, int m) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!((live >> q) & 1)) continue;
    if (m == 0) return q;
    --m;
  }
  return 3;
}

// Publishes a band's part of what its tile's neighbours read (see the head
// of this file): X is the band's word (k0, c0), rows rs words apart. Each of
// the band's nt threads calls it, as thread tid. The words of the strip rows
// and the edge lanes are one range of items, so the threads share them
// evenly.
__device__ inline void publish_band(const Strips& a, int t, const uint32_t* X, int rs, int k0,
                                    int hk, int c0, int cb, int tid, int nt) {
  const int i = (t / a.nx) % a.ny, j = t % a.nx;
  // The strip word rows some tile reads (slot 2 s + jj: strip s's jj-th word
  // row, the second only where the strip starts mid-word), those of this band.
  int live = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int s = q >> 1, b = strip_row(a, s), k = strip_word(a, s) + (q & 1);
    const bool read =
        a.ny > 1 && (s == 0 ? i < a.ny - 1 : i > 0) && (!(q & 1) || (b > 0 && (b & 31)));
    if (read && k >= k0 && k < k0 + hk && k < a.hw) live |= 1 << q;
  }
  // Its part of the first (side 0) and last (side 1) k core lanes, where a
  // neighbour reads them: columns [m0, m0 + n0) and [m1, m1 + n1).
  const int kl = min(64, a.e_left), c_r = a.e_left + a.w_loc, lo1 = c_r - kl;
  const int m0 = max(a.e_left, c0), m1 = max(lo1, c0);
  const int n0 = a.nx > 1 && j > 0 ? max(min(a.e_left + kl, c0 + cb) - m0, 0) : 0;
  const int n1 = a.nx > 1 && j < a.nx - 1 ? max(min(c_r, c0 + cb) - m1, 0) : 0;
  const int nrow = __popc(live) * cb, nlane = n0 + n1;
  for (int e = tid; e < nrow + hk * nlane; e += nt) {
    if (e < nrow) {
      const int m = e / cb, c = e - m * cb, q = nth_slot(live, m);
      const int k = strip_word(a, q >> 1) + (q & 1);
      a.rows[(size_t)(4 * t + q) * a.w + c0 + c] = X[(k - k0) * rs + c];
    } else {
      const int f = e - nrow, kk = f / nlane, l = f - kk * nlane, side = l >= n0;
      const int c = side ? m1 + l - n0 : m0 + l, lo = side ? lo1 : a.e_left;
      a.lanes[((size_t)(2 * t + side) * a.hw + k0 + kk) * 64 + c - lo] = X[kk * rs + c - c0];
    }
  }
}

// ORs into a band's words what the refresh writes there (after the barrier
// that follows every band's publish_band). Returns the new bits this thread
// set. Each of the band's nt threads calls it, as thread tid; the words of
// the rows and the lanes are one range of items, as in publish_band.
__device__ inline int apply_band(const Strips& a, int t, uint32_t* X, int rs, int k0, int hk,
                                 int c0, int cb, int tid, int nt) {
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
  int live = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int q = 0; q < m; ++q)
      if (rows[m] == rows[q]) rows[m] = -1;
    if (rows[m] >= 0) live |= 1 << m;
  }
  // The halo lanes of this band: left [e_left - kl, e_left) and right
  // [c_r, c_r + kl), where there is a neighbour.
  const int kl = min(64, a.e_left), c_r = a.e_left + a.w_loc;
  const int l0 = j > 0 ? max(c0, a.e_left - kl) : 0, l1 = j > 0 ? min(c0 + cb, a.e_left) : 0;
  const int r0 = j < a.nx - 1 ? max(c0, c_r) : 0, r1 = j < a.nx - 1 ? min(c0 + cb, c_r + kl) : 0;
  const int nl = max(l1 - l0, 0), nrt = max(r1 - r0, 0), nlanes = a.nx > 1 ? nl + nrt : 0;
  const int nrow = __popc(live) * cb;
  int fresh = 0;
  // Every word of the rows the row step writes, its halo lanes' bits with
  // it; then the halo lanes' words in the other rows.
  for (int e = tid; e < nrow + nlanes * hk; e += nt) {
    int k, c;
    if (e < nrow) {
      const int m = e / cb, q = nth_slot(live, m);
      c = c0 + e - m * cb;
      k = q == 0 ? rows[0] : q == 1 ? rows[1] : q == 2 ? rows[2] : rows[3];
    } else {
      const int f = e - nrow, kk = f / nlanes, l = f - kk * nlanes;
      k = k0 + kk;
      if (k == rows[0] || k == rows[1] || k == rows[2] || k == rows[3]) continue;
      c = l < nl ? l0 + l : r0 + (l - nl);
    }
    const uint32_t v =
        (e < nrow ? row_part(a, t, k, c) : 0u) | (nlanes ? lane_part(a, t, k, c) : 0u);
    uint32_t* w = X + (k - k0) * rs + (c - c0);
    const uint32_t nb = v & ~*w;
    *w |= nb;
    fresh += __popc(nb);
  }
  return fresh;
}

// The refresh on the (tiles, hw, w) planes x in global memory, thread i of n
// of a grid: each tile one band, n / tiles threads to a tile (every thread
// takes tiles in turn where n < tiles). publish_planes, a grid barrier, then
// apply_planes, which returns the new bits this thread set.
__device__ inline void publish_planes(const Strips& a, const uint32_t* x, int tiles, int i, int n) {
  const int per = n >= tiles ? n / tiles : 1;
  for (int t = i / per; t < tiles; t += n / per)
    publish_band(a, t, x + (size_t)t * a.hw * a.w, a.w, 0, a.hw, 0, a.w, i % per, per);
}

__device__ inline int apply_planes(const Strips& a, uint32_t* x, int tiles, int i, int n) {
  const int per = n >= tiles ? n / tiles : 1;
  int fresh = 0;
  for (int t = i / per; t < tiles; t += n / per)
    fresh += apply_band(a, t, x + (size_t)t * a.hw * a.w, a.w, 0, a.hw, 0, a.w, i % per, per);
  return fresh;
}

// The words one refresh of T tiles writes at most: the word rows of the
// row step (4 a tile) and the halo lanes of every word row.
__host__ __device__ inline long long refresh_items(long long tiles, int hw, int w, int e_left) {
  return tiles * (4LL * w + 2LL * (e_left < 64 ? e_left : 64) * hw);
}

}  // namespace halo
