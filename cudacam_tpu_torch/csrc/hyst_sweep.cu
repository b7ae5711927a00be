// The legacy row-sweep hysteresis: a threshold map converged slab by slab.
//
// Replaces the TPU sweep kernel (cudacam_tpu/ops/pallas/hysteresis.py:157
// pallas_call in _make_sweep -> _sweep_kernel :75; entry hysteresis_pallas
// :194). There a sequential grid walks full-width row slabs: slab b is the
// window of rows [b bh - 8, b bh + bh + 8) of the map (zero outside it),
// saturated locally by 8-neighbour promotion steps (at most max_local_iters)
// and written back, halo rows included; the slabs of a sweep run in order on
// the updated map, sweeps alternate down and up, and a device loop ends at
// the first sweep that changes no slab or after 2 max_iters sweeps. This
// kernel gives the same bytes for the same block height, cut off or not.
//
// Bound: the chain's latency, not bytes or operations. The slab order is a
// true dependence, so one block walks it: steps x (one step + its block
// barrier) + windows x (the move from one window to the next). At 1080p with
// bh 16 that is 1834 steps and 204 windows against a map of 2 MB.
//
// Design: three launches on the stream, the chain's alone on the card.
//  1. sweeps_kernel_pack, a block a word row: packs the u8 map into bit
//     planes of *groups* (bh rows of a column in ceil(bh / 32) words) in two
//     layouts whose origins differ by the window's 2 HALO extra rows (see
//     Geo): the down layout's group b is the rows a down sweep's window
//     leaves at slab b, the up layout's group b + extra those an up sweep's
//     leaves. A down sweep stores the down layout and takes its windows' new
//     rows from the up layout, an up sweep the other way round: every store
//     and every load of the chain is a whole group of words, never a byte,
//     never a read-modify-write, and no load can meet a store of the same
//     sweep.
//  2. sweeps_kernel_chain, ONE block, walks the chain. The window is carried
//     from slab to slab: a shift by bh bits of each column's words, the
//     leaving group stored, the entering group (prefetched into registers
//     while the window steps, as nothing of the sweep writes it) ORed in.
//     The turn from a down sweep to an up sweep moves nothing: its first
//     window is the last one. In the register form each thread holds J
//     adjacent columns' words (template J, and WR words a column): a step is
//     the vertical dilation in registers, the neighbour columns by warp
//     shuffles and the warps' edge columns through a double-buffered
//     exchange in shared memory, and ONE __syncthreads_or, which is also the
//     stop test. layout_of picks the instance (CC_SWEEP_FORMS). Windows of
//     more than 5 words a column, or maps wider than the register form's
//     blocks, take the shared-memory form: the window in shared memory
//     (FINAL ping-pong and CANDIDATE, as wide as the old one-block kernel
//     took) with the same moves.
//  3. sweeps_kernel_unpack, a block a map row: writes the output map from
//     the last sweep's layout: 255 where FINAL, else 0 (remove_candidates)
//     or the input byte.
// One cooperative launch with grid barriers around the chain took from 0.4%
// less to 2.8% more device time in one call (PERF.md §6, K12), and kept
// every SM waiting while the chain ran.
// The steps are Jacobi steps counted exactly (a slab changed when its first
// step grew), so the max_local_iters cut-off is the TPU kernel's too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int HALO = 8;  // rows of the neighbour slabs in a window, each side
constexpr uint8_t FINAL_EDGE = 255, CANDIDATE_EDGE = 128;
constexpr int MAX_WARPS = 32;
constexpr int COPY_THREADS = 256;  // a block of the pack and the unpack

// The register-form instances (J columns a thread, WR window words a
// column) in the order layout_of tries them: for each WR the fewest columns
// that give a thread 8 window words (measured best at 1080p, 4K and 8K,
// PERF.md §6), then a wider one for maps the first cannot cover.
#define CC_SWEEP_FORMS(X) X(8, 1) X(4, 2) X(8, 2) X(4, 3) X(2, 4) X(4, 4) X(2, 5)

// The most threads of a register-form block: the registers of the window,
// its dilation and the prefetched rows, five words for each of J x WR, fit
// the SM's 65536 at that size (one-word windows of up to 8 columns in 64 a
// thread).
constexpr int reg_max_threads(int cols, int wr) {
  return cols * wr <= 4 || (wr == 1 && cols <= 8) ? 1024 : 512;
}

template <int J, int WR>
constexpr int max_threads() {
  return J == 0 ? 1024 : reg_max_threads(J, WR);
}

// The map lives in bit planes of groups: a group is bh rows of a column in
// gw words (bit i of word k is the group's row 32 k + i). Rows are counted
// from HALO rows above the map (map row r is padded row r + 8). The down
// layout's group u is padded rows [u bh, u bh + bh); the up layout's group u
// is padded rows [up_origin + u bh, ...) with up_origin = 16 - extra bh, the
// rows an up sweep's window leaves at slab u - extra. Each of the four
// planes holds groups * gw word rows of pitch words.
struct Geo {
  const uint8_t* in;
  uint8_t* out;
  uint32_t *fu, *cu, *fd, *cd;  // FINAL / CANDIDATE planes, up and down layouts
  int* info;
  int h, w, bh, rows, wr, gw, extra, slabs, groups, pitch, up_origin;
  int max_sweeps, max_local_iters, remove;
};

__device__ __forceinline__ uint32_t low_bits(int n) { return n >= 32 ? ~0u : (1u << n) - 1u; }

// -- the pack and the unpack: a grid ----------------------------------------

__device__ void pack_phase(const Geo& g) {
  const int lines = g.groups * g.gw;  // word rows of a layout
  for (int line = blockIdx.x; line < 2 * lines; line += gridDim.x) {
    const bool up = line < lines;
    const int l = up ? line : line - lines, u = l / g.gw, word = l - u * g.gw;
    const int r0 = (up ? g.up_origin : 0) + u * g.bh + 32 * word - HALO;  // map row of bit 0
    const int b0 = r0 < 0 ? -r0 : 0;
    int b1 = g.bh - 32 * word < 32 ? g.bh - 32 * word : 32;
    if (g.h - r0 < b1) b1 = g.h - r0;
    const size_t at = (size_t)l * g.pitch;
    for (int c = threadIdx.x; c < g.pitch; c += blockDim.x) {
      uint32_t fin = 0, cand = 0;
      if (c < g.w) {
        for (int b = b0; b < b1; ++b) {
          const uint8_t v = __ldg(g.in + (size_t)(r0 + b) * g.w + c);
          fin |= (uint32_t)(v == FINAL_EDGE) << b;
          cand |= (uint32_t)(v == CANDIDATE_EDGE) << b;
        }
      }
      if (up) {
        g.fu[at + c] = fin;
        g.cu[at + c] = cand;
      } else {
        g.cd[at + c] = cand;
      }
    }
  }
}

__device__ void unpack_phase(const Geo& g) {
  const bool down = (__ldcg(g.info) & 1) == 1;  // the last sweep ran down
  const uint32_t* plane = down ? g.fd : g.fu;
  const int origin = down ? 0 : g.up_origin;
  for (int r = blockIdx.x; r < g.h; r += gridDim.x) {
    const int q = r + HALO - origin, u = q / g.bh, b = q - u * g.bh;
    const uint32_t* words = plane + ((size_t)u * g.gw + (b >> 5)) * g.pitch;
    const size_t at = (size_t)r * g.w;
    for (int c = threadIdx.x; c < g.w; c += blockDim.x) {
      const bool fin = (__ldcg(words + c) >> (b & 31)) & 1u;
      g.out[at + c] = fin ? FINAL_EDGE : (g.remove ? 0 : g.in[at + c]);
    }
  }
}

// -- the chain, the register form ---------------------------------------------

// out[k][j] = bits [base + 32 k, base + 32 k + 32) of column j's bit string
// a[0..WR)[j], zero outside it (base may be negative); out may be a. The
// word offset base / 32 is the same for every thread, so the shift is one
// uniform branch with constant indices and the arrays stay in registers (a
// select on a run-time index compiles to an array in local memory). In
// place, word k reads words >= k (d >= 0, k ascending) or <= k (d < 0, k
// descending), none written before it.
template <int WR, int J>
__device__ __forceinline__ void shift_bits(const uint32_t (&a)[WR][J], int base,
                                           uint32_t (&out)[WR][J]) {
  const int qb = base >> 5, s = base & 31;
#pragma unroll
  for (int d = -WR; d < WR; ++d) {  // the word offsets that reach a word of a
    if (qb == d) {
#pragma unroll
      for (int i = 0; i < WR; ++i) {
        const int k = d >= 0 ? i : WR - 1 - i;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const uint32_t lo = k + d >= 0 && k + d < WR ? a[k + d][j] : 0u;
          const uint32_t hi = k + d + 1 >= 0 && k + d + 1 < WR ? a[k + d + 1][j] : 0u;
          out[k][j] = __funnelshift_r(lo, hi, s);
        }
      }
    }
  }
  if (qb < -WR || qb >= WR) {
#pragma unroll
    for (int k = 0; k < WR; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j) out[k][j] = 0;
  }
}

// J consecutive words at p (16-byte aligned when J is a multiple of 4).
template <int J>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t* v) {
  if constexpr (J % 4 == 0) {
#pragma unroll
    for (int j = 0; j < J; j += 4) {
      const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p + j));
      v[j] = x.x, v[j + 1] = x.y, v[j + 2] = x.z, v[j + 3] = x.w;
    }
  } else if constexpr (J == 2) {
    const uint2 x = __ldcg(reinterpret_cast<const uint2*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int J>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t* v) {
  if constexpr (J % 4 == 0) {
#pragma unroll
    for (int j = 0; j < J; j += 4)
      *reinterpret_cast<uint4*>(p + j) = make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (J == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Group u of a plane for the thread's columns: words [0, gw), zero above.
template <int J, int WR>
__device__ __forceinline__ void load_group(const Geo& g, const uint32_t* plane, int u, int c0,
                                           uint32_t (&out)[WR][J]) {
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    if (k < g.gw) {
      load_words<J>(plane + ((size_t)u * g.gw + k) * g.pitch + c0, out[k]);
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) out[k][j] = 0;
    }
  }
}

// Stores window bits [off, off + bh) of the thread's columns as group u.
template <int J, int WR>
__device__ __forceinline__ void store_group(const Geo& g, uint32_t* plane, int u, int c0,
                                            const uint32_t (&win)[WR][J], int off) {
  uint32_t v[WR][J];
  shift_bits(win, off, v);
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    if (k < g.gw) {
#pragma unroll
      for (int j = 0; j < J; ++j) v[k][j] &= low_bits(g.bh - 32 * k);
      store_words<J>(plane + ((size_t)u * g.gw + k) * g.pitch + c0, v[k]);
    }
  }
}

// The vertical 3-dilation of word k of a column (carries across words).
template <int WR>
__device__ __forceinline__ uint32_t vert(const uint32_t* col, int stride, int k) {
  const uint32_t f = col[k * stride];
  uint32_t v = f | (f << 1) | (f >> 1);
  if (k > 0) v |= col[(k - 1) * stride] >> 31;
  if (k < WR - 1) v |= col[(k + 1) * stride] << 31;
  return v;
}

__device__ __forceinline__ int edge_at(int par, int warp, int side, int k, int wr) {
  return ((par * MAX_WARPS + warp) * 2 + side) * wr + k;
}

// The vertical dilation of warp `warp`'s edge column `side` (0 first, 1
// last) from the exchange buffer `par`, zero past the block's edges.
template <int WR>
__device__ __forceinline__ void edge_vert(const uint32_t* edge, int par, int warp, int side,
                                          int nw, uint32_t (&out)[WR]) {
  uint32_t e[WR];
#pragma unroll
  for (int k = 0; k < WR; ++k)
    e[k] = warp >= 0 && warp < nw ? edge[edge_at(par, warp, side, k, WR)] : 0u;
#pragma unroll
  for (int k = 0; k < WR; ++k) out[k] = vert<WR>(e, 1, k);
}

template <int J, int WR>
__device__ __forceinline__ void put_edges(uint32_t* edge, int par, int lane, int warp,
                                          const uint32_t (&F)[WR][J]) {
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < WR; ++k) edge[edge_at(par, warp, 0, k, WR)] = F[k][0];
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < WR; ++k) edge[edge_at(par, warp, 1, k, WR)] = F[k][J - 1];
  }
}

// One Jacobi promotion step f | (cand & dilate8(f)) on the window; the
// neighbours' words of step t come from exchange buffer par, this step's
// edges go to par ^ 1. Returns whether any thread's words grew.
template <int J, int WR>
__device__ __forceinline__ bool reg_step(uint32_t (&F)[WR][J], const uint32_t (&C)[WR][J],
                                         uint32_t* edge, int par, int lane, int warp, int nw) {
  uint32_t V[WR][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    uint32_t col[WR];
#pragma unroll
    for (int k = 0; k < WR; ++k) col[k] = F[k][j];
#pragma unroll
    for (int k = 0; k < WR; ++k) V[k][j] = vert<WR>(col, 1, k);
  }
  uint32_t L[WR], R[WR];
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    L[k] = __shfl_up_sync(0xffffffffu, V[k][J - 1], 1);
    R[k] = __shfl_down_sync(0xffffffffu, V[k][0], 1);
  }
  if (lane == 0) edge_vert<WR>(edge, par, warp - 1, 1, nw, L);
  if (lane == 31) edge_vert<WR>(edge, par, warp + 1, 0, nw, R);
  bool grew = false;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int k = 0; k < WR; ++k) {
      const uint32_t nb = V[k][j] | (j > 0 ? V[k][j - 1] : L[k]) | (j < J - 1 ? V[k][j + 1] : R[k]);
      const uint32_t nf = F[k][j] | (C[k][j] & nb);
      grew |= nf != F[k][j];
      F[k][j] = nf;
    }
  }
  put_edges<J, WR>(edge, par ^ 1, lane, warp, F);
  return __syncthreads_or(grew);
}

template <int J, int WR>
__device__ void chain_regs(const Geo& g) {
  __shared__ uint32_t edge[2 * MAX_WARPS * 2 * WR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int c0 = tid * J, n = g.slabs, bh = g.bh, E = g.extra;
  uint32_t F[WR][J], C[WR][J];
#pragma unroll
  for (int k = 0; k < WR; ++k)
#pragma unroll
    for (int j = 0; j < J; ++j) F[k][j] = C[k][j] = 0;
  for (int u = 0; u <= E; ++u) {  // the first window: up groups 0..E at their rows
    uint32_t gf[WR][J], gc[WR][J];
    load_group<J, WR>(g, g.fu, u, c0, gf);
    load_group<J, WR>(g, g.cu, u, c0, gc);
    shift_bits(gf, -(g.up_origin + u * bh), gf);
    shift_bits(gc, -(g.up_origin + u * bh), gc);
#pragma unroll
    for (int k = 0; k < WR; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j) F[k][j] |= gf[k][j], C[k][j] |= gc[k][j];
  }
  int par = 0;
  put_edges<J, WR>(edge, par, lane, warp, F);
  __syncthreads();
  int sweeps = 0, changed = 0;
  long long steps = 0;
  do {
    const bool down = (sweeps & 1) == 0;
    changed = 0;
    for (int i = 0; i < n; ++i) {
      const int b = down ? i : n - 1 - i;
      const bool move = i < n - 1;
      uint32_t pf[WR][J] = {}, pc[WR][J] = {};  // the group the next move brings in
      if (move) {
        load_group<J, WR>(g, down ? g.fu : g.fd, down ? b + 1 + E : b - 1, c0, pf);
        load_group<J, WR>(g, down ? g.cu : g.cd, down ? b + 1 + E : b - 1, c0, pc);
      }
      int it = 0;
      bool first = false;
      while (it < g.max_local_iters) {
        const bool grew = reg_step<J, WR>(F, C, edge, par, lane, warp, nw);
        par ^= 1;
        if (++it == 1) first = grew;
        if (!grew) break;
      }
      steps += it;
      changed |= first;
      if (!move) continue;  // the turn: the next sweep starts on this window
      if (down) {  // leave down group b; rows enter at window bit 2 HALO
        store_group<J, WR>(g, g.fd, b, c0, F, 0);
        shift_bits(F, bh, F);
        shift_bits(C, bh, C);
        shift_bits(pf, -2 * HALO, pf);
        shift_bits(pc, -2 * HALO, pc);
      } else {  // leave up group b + E; rows enter at window bit 0
        store_group<J, WR>(g, g.fu, b + E, c0, F, 2 * HALO);
        shift_bits(F, -bh, F);
        shift_bits(C, -bh, C);
#pragma unroll
        for (int k = 0; k < WR; ++k)
#pragma unroll
          for (int j = 0; j < J; ++j) {
            F[k][j] &= low_bits(g.rows - 32 * k);
            C[k][j] &= low_bits(g.rows - 32 * k);
          }
      }
#pragma unroll
      for (int k = 0; k < WR; ++k)
#pragma unroll
        for (int j = 0; j < J; ++j) F[k][j] |= pf[k][j], C[k][j] |= pc[k][j];
      put_edges<J, WR>(edge, par, lane, warp, F);
      __syncthreads();
    }
    ++sweeps;
  } while (changed && sweeps < g.max_sweeps);
  const bool ended_down = (sweeps & 1) == 1;
  for (int u = 0; u <= E; ++u) {  // flush the last window into the last sweep's layout
    if (ended_down) {
      store_group<J, WR>(g, g.fd, n - 1 + u, c0, F, u * bh);
    } else {
      store_group<J, WR>(g, g.fu, u, c0, F, g.up_origin + u * bh);
    }
  }
  if (tid == 0) {
    g.info[0] = sweeps;
    g.info[1] = changed;
    g.info[2] = (int)(steps < 0x7fffffff ? steps : 0x7fffffff);
  }
}

// -- the chain, the shared-memory form -----------------------------------------

// Bits [off, off + 32) of column c's bit string of n words, word k at
// a[k * stride] (shared memory or a plane's group), zero outside it.
__device__ __forceinline__ uint32_t col_get32(const uint32_t* a, int n, int stride, int off,
                                              bool global) {
  const int q = off >> 5;
  uint32_t lo = 0, hi = 0;
  if (q >= 0 && q < n) lo = global ? __ldcg(a + (size_t)q * stride) : a[(size_t)q * stride];
  if (q + 1 >= 0 && q + 1 < n)
    hi = global ? __ldcg(a + (size_t)(q + 1) * stride) : a[(size_t)(q + 1) * stride];
  return __funnelshift_r(lo, hi, off & 31);
}

__device__ __forceinline__ uint32_t row_or(const uint32_t* A, int kr, int c, int w) {
  const uint32_t* row = A + kr * w;
  return row[c] | (c > 0 ? row[c - 1] : 0u) | (c < w - 1 ? row[c + 1] : 0u);
}

// Stores window bits [off, off + bh) of column c (words at win[k * w]) as
// group u of a plane.
__device__ __forceinline__ void smem_store_group(const Geo& g, uint32_t* plane, int u, int c,
                                                 const uint32_t* win, int off) {
  for (int k = 0; k < g.gw; ++k)
    plane[((size_t)u * g.gw + k) * g.pitch + c] =
        col_get32(win + c, g.wr, g.w, off + 32 * k, false) & low_bits(g.bh - 32 * k);
}

__device__ void chain_smem(const Geo& g) {
  extern __shared__ uint32_t sm[];
  const int w = g.w, wr = g.wr, nwords = wr * w, n = g.slabs, bh = g.bh, E = g.extra;
  const int NT = blockDim.x;
  uint32_t* src = sm;
  uint32_t* dst = sm + nwords;
  uint32_t* P = sm + 2 * nwords;
  const size_t gstride = (size_t)g.gw * g.pitch;  // words of a group
  for (int c = threadIdx.x; c < w; c += NT) {     // the first window
    for (int k = 0; k < wr; ++k) {
      uint32_t f = 0, cand = 0;
      for (int u = 0; u <= E; ++u) {
        const int off = 32 * k - (g.up_origin + u * bh);
        f |= col_get32(g.fu + u * gstride + c, g.gw, g.pitch, off, true);
        cand |= col_get32(g.cu + u * gstride + c, g.gw, g.pitch, off, true);
      }
      src[k * w + c] = f;
      P[k * w + c] = cand;
    }
  }
  __syncthreads();
  int sweeps = 0, changed = 0;
  long long steps = 0;
  do {
    const bool down = (sweeps & 1) == 0;
    changed = 0;
    for (int i = 0; i < n; ++i) {
      const int b = down ? i : n - 1 - i;
      int it = 0;
      bool first = false;
      while (it < g.max_local_iters) {
        bool ch = false;
        for (int x = threadIdx.x; x < nwords; x += NT) {
          const int kr = x / w, c = x - kr * w;
          const uint32_t v = row_or(src, kr, c, w);
          uint32_t nb = v | (v << 1) | (v >> 1);
          if (kr > 0) nb |= row_or(src, kr - 1, c, w) >> 31;
          if (kr < wr - 1) nb |= row_or(src, kr + 1, c, w) << 31;
          const uint32_t old = src[x], nv = old | (P[x] & nb);
          ch |= nv != old;
          dst[x] = nv;
        }
        const bool grew = __syncthreads_or(ch);
        uint32_t* t = src;
        src = dst;
        dst = t;
        if (++it == 1) first = grew;
        if (!grew) break;
      }
      steps += it;
      changed |= first;
      if (i == n - 1) continue;  // the turn: the next sweep starts on this window
      for (int c = threadIdx.x; c < w; c += NT) {
        if (down) {  // leave down group b; rows enter at window bit 2 HALO
          smem_store_group(g, g.fd, b, c, src, 0);
          const uint32_t* ef = g.fu + (b + 1 + E) * gstride + c;
          const uint32_t* ec = g.cu + (b + 1 + E) * gstride + c;
          for (int k = 0; k < wr; ++k) {  // ascending: reads words >= k
            const int off = 32 * k - 2 * HALO;
            const uint32_t f = col_get32(src + c, wr, w, bh + 32 * k, false) |
                               col_get32(ef, g.gw, g.pitch, off, true);
            const uint32_t p = col_get32(P + c, wr, w, bh + 32 * k, false) |
                               col_get32(ec, g.gw, g.pitch, off, true);
            src[k * w + c] = f;
            P[k * w + c] = p;
          }
        } else {  // leave up group b + E; rows enter at window bit 0
          smem_store_group(g, g.fu, b + E, c, src, 2 * HALO);
          const uint32_t* ef = g.fd + (b - 1) * gstride + c;
          const uint32_t* ec = g.cd + (b - 1) * gstride + c;
          for (int k = wr - 1; k >= 0; --k) {  // descending: reads words <= k
            const uint32_t keep = low_bits(g.rows - 32 * k);
            const uint32_t f = (col_get32(src + c, wr, w, 32 * k - bh, false) & keep) |
                               col_get32(ef, g.gw, g.pitch, 32 * k, true);
            const uint32_t p = (col_get32(P + c, wr, w, 32 * k - bh, false) & keep) |
                               col_get32(ec, g.gw, g.pitch, 32 * k, true);
            src[k * w + c] = f;
            P[k * w + c] = p;
          }
        }
      }
      __syncthreads();
    }
    ++sweeps;
  } while (changed && sweeps < g.max_sweeps);
  const bool ended_down = (sweeps & 1) == 1;
  for (int c = threadIdx.x; c < w; c += NT) {
    for (int u = 0; u <= E; ++u) {
      if (ended_down) {
        smem_store_group(g, g.fd, n - 1 + u, c, src, u * bh);
      } else {
        smem_store_group(g, g.fu, u, c, src, g.up_origin + u * bh);
      }
    }
  }
  if (threadIdx.x == 0) {
    g.info[0] = sweeps;
    g.info[1] = changed;
    g.info[2] = (int)(steps < 0x7fffffff ? steps : 0x7fffffff);
  }
}

__global__ void __launch_bounds__(COPY_THREADS) sweeps_kernel_pack(Geo g) { pack_phase(g); }

// J columns a thread in registers with WR words a column; J = 0: the
// shared-memory form.
template <int J, int WR>
__global__ void __launch_bounds__(max_threads<J, WR>()) sweeps_kernel_chain(Geo g) {
  if constexpr (J == 0) {
    chain_smem(g);
  } else {
    chain_regs<J, WR>(g);
  }
}

__global__ void __launch_bounds__(COPY_THREADS) sweeps_kernel_unpack(Geo g) { unpack_phase(g); }

using Kernel = void (*)(Geo);

Kernel pick(int cols, int wr) {
#define CC_PICK(J, WR) \
  if (cols == J && wr == WR) return sweeps_kernel_chain<J, WR>;
  CC_SWEEP_FORMS(CC_PICK)
#undef CC_PICK
  return cols == 0 ? sweeps_kernel_chain<0, 0> : nullptr;
}

struct Layout {
  int cols, threads, pitch;  // cols 0: the shared-memory form
  long long plane_words, smem;
};

// The chain's form for an (h, w) map at block height bh: the first
// register instance of the window's words whose block covers w, else the
// shared-memory form (1024 threads, the window's FINAL ping-pong and
// CANDIDATE words in shared memory).
Layout layout_of(int h, int w, int bh) {
  const int wr = (bh + 2 * HALO + 31) / 32, gw = (bh + 31) / 32;
  const long long groups = (h + bh - 1) / bh + (2 * HALO + bh - 1) / bh;
  constexpr int forms[][2] = {
#define CC_ENTRY(J, WR) {J, WR},
      CC_SWEEP_FORMS(CC_ENTRY)
#undef CC_ENTRY
  };
  Layout l{0, 1024, w, 0, 3LL * wr * w * (long long)sizeof(uint32_t)};
  for (const auto& f : forms) {
    const int threads = ((w + f[0] - 1) / f[0] + 31) / 32 * 32;
    if (f[1] == wr && threads <= reg_max_threads(f[0], wr)) {
      l = Layout{f[0], threads, f[0] * threads, 0, 0};
      break;
    }
  }
  l.plane_words = groups * gw * l.pitch;
  return l;
}

}  // namespace

// The layout cc_hyst_sweeps takes for an (h, w) map at block height bh:
// out = (columns a thread (0: the shared-memory form), threads of the
// chain's block, pitch, words of one of the four planes, bytes of shared
// memory).
extern "C" int cc_hyst_sweeps_layout(int h, int w, int bh, long long* out) {
  if (h < 1 || w < 1 || bh < 1) return cudaErrorInvalidValue;
  const Layout l = layout_of(h, w, bh);
  out[0] = l.cols, out[1] = l.threads, out[2] = l.pitch, out[3] = l.plane_words, out[4] = l.smem;
  return cudaSuccess;
}

// Converges the (h, w) uint8 threshold map `thresh` into `out`: FINAL_EDGE
// where a CANDIDATE was promoted or a FINAL stood, else 0 (remove) or the
// input byte. `planes`: four planes of cc_hyst_sweeps_layout's words each
// (FINAL up, CANDIDATE up, FINAL down, CANDIDATE down; no contents needed).
// info: [sweeps run, the last sweep changed a slab, steps taken].
extern "C" int cc_hyst_sweeps(const void* thresh, void* out, void* planes, void* info, int h,
                              int w, int bh, int max_iters, int max_local_iters, int remove,
                              int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (h < 1 || w < 1 || bh < 1 || max_iters < 0 || max_local_iters < 0) return cudaErrorInvalidValue;
  const Layout l = layout_of(h, w, bh);
  Geo g;
  g.h = h, g.w = w, g.bh = bh, g.rows = bh + 2 * HALO, g.wr = (g.rows + 31) / 32;
  g.gw = (bh + 31) / 32, g.extra = (2 * HALO + bh - 1) / bh, g.slabs = (h + bh - 1) / bh;
  g.groups = g.slabs + g.extra, g.pitch = l.pitch, g.up_origin = 2 * HALO - g.extra * bh;
  g.max_sweeps = max_iters > 0 ? 2 * max_iters : 1;
  g.max_local_iters = max_local_iters, g.remove = remove;
  uint32_t* base = static_cast<uint32_t*>(planes);
  g.in = static_cast<const uint8_t*>(thresh);
  g.out = static_cast<uint8_t*>(out);
  g.fu = base, g.cu = base + l.plane_words, g.fd = base + 2 * l.plane_words;
  g.cd = base + 3 * l.plane_words;
  g.info = static_cast<int*>(info);
  const Kernel chain = pick(l.cols, g.wr);
  if (l.smem > 0) {  // the shared-memory form: past the 48 KB default
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    if (l.smem > optin) return cudaErrorInvalidValue;  // the window does not fit one SM
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(chain),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (err != cudaSuccess) return err;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sweeps_kernel_pack<<<2 * g.groups * g.gw, COPY_THREADS, 0, s>>>(g);
  void* args[] = {&g};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(chain), dim3(1), dim3(l.threads),
                                     args, (size_t)l.smem, s);
  if (err != cudaSuccess) return err;
  sweeps_kernel_unpack<<<h, COPY_THREADS, 0, s>>>(g);
  return cudaGetLastError();
}
