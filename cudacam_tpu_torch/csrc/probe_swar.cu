// swar_stencil: the 16-bit stencil probe, two 16-bit lanes per 32-bit
// register, with an int32 mode of the same kernel.
//
// Replaces the TPU i16 probe tools/i16_swar_probe.py (_run :35, pallas_call
// :37, bodies p1-p4 :56-83), which asks whether the feed-forward chain's
// stencils can run on 16-bit lanes. Four bodies on an (H, W) plane, each
// result an int16 widened to int32 (jnp semantics: int16 arithmetic wraps,
// the rolls are cyclic):
//
//   P1  int16 x:  x * 3 + (x + x) * 2
//   P2  int16 x:  x + roll(x, 1, rows) + roll(x, H - 1, rows)
//   P3  int16 x:  2x + 3 roll(x, 1, cols) + roll(x, W - 1, cols)
//   P4  uint8 x:  v = x + roll(x, 1, rows) + roll(x, H - 1, rows) in int16,
//                 then 2v + roll(v, 1, cols) + roll(v, W - 1, cols)
//
// The Hopper construct under test is SIMD within a register: a word holds
// the two columns (j, j + 1) of a row as its low and high half, added with
// __vadd2 (each lane wraps mod 2^16, as int16 does, so the result is exact
// for any input); a constant multiply is a chain of __vadd2, which cannot
// carry out of a lane; a column roll is a byte permute of two neighbouring
// words. The int32 mode computes the same columns with one int32 per value
// and wraps to int16 at the end. Both write int32.
//
// Two routes of one launch, chosen from the plane's width and addresses
// (swar_plan):
// - vector: W % 8 == 0, the input 16-byte aligned (8-byte for the u8 plane)
//   and the output 16-byte aligned. A block is 8 warps, a warp one row of
//   256 columns (2-D grid: column chunks on x, rows on y with a row loop
//   past 65535 blocks), a thread 8 neighbouring columns of one row: one
//   16-byte int16 load a row (8-byte for u8), so 4 words of lane pairs or 8
//   int32 values. The row rolls (P2, P4) are the same loads from rows i - 1
//   and i + 1 (the block's other warps read them too: L1 hits), the row
//   index wrapped once a thread and row. The column rolls (P3, P4) take
//   the column before and after a thread's chunk from the neighbouring
//   lanes (__shfl_up_sync / __shfl_down_sync); only a warp's first lane,
//   its last lane and the lane of the plane's last chunk load the one value
//   beyond their chunk, cyclically at the plane's edges. The 8 results go
//   out as two 16-byte int32 stores, through the warp's 1 KB of shared
//   memory so that each store instruction of the warp writes 512
//   contiguous bytes: stored straight from the registers, a thread's two
//   stores each fill half of 32-byte sectors, and that form took 5.6-5.7 us
//   against 3.75 at 1080p for P1 on an H100 (PERF.md §6).
// - general: every other plane (odd W, a base off its boundary). A thread
//   takes the column pair (j, j + 1) of a row (2-D grid: pairs on x, rows
//   on y with a row loop); a pair is one 32-bit load (16-bit for u8) where
//   W is even and the base aligned to a pair, else lane by lane; cyclic
//   indices wrap at the edges only. No 64-bit division on either route.
//
// Bound: bytes (an int16 or u8 read and an int32 write per pixel: 10 MB at
// 1080p for P4); a handful of integer operations per pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_guard.cuh"

namespace {

constexpr int NT = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int VEC_COLS = 8;               // columns a thread, vector route
constexpr int VEC_ROWS = NT / 32;         // rows a block, vector route (a warp each)
constexpr int WARP_COLS = 32 * VEC_COLS;  // columns a warp, vector route
constexpr int MAX_GRID_Y = 65535;

struct SwarPlan {
  int vector;   // 1: the vector route; 0: the general route
  int gx, gy;   // the grid
  int columns;  // columns a thread
};

// The route and grid for an (H, W) plane of body `body` whose input starts
// `x_offset` bytes past a 16-byte boundary and whose output is 16-byte
// aligned when out_aligned.
SwarPlan swar_plan(int H, int W, int body, int x_offset, bool out_aligned) {
  SwarPlan p{};
  const int align = body == 4 ? 8 : 16;
  p.vector = W % VEC_COLS == 0 && x_offset % align == 0 && out_aligned;
  if (p.vector) {
    p.gx = (W + WARP_COLS - 1) / WARP_COLS;
    p.gy = (H + VEC_ROWS - 1) / VEC_ROWS;
    p.columns = VEC_COLS;
  } else {
    p.gx = ((W + 1) / 2 + NT - 1) / NT;
    p.gy = H;
    p.columns = 2;
  }
  if (p.gy > MAX_GRID_Y) p.gy = MAX_GRID_Y;
  return p;
}

// ---- the general route: a column pair a thread ----

// v mod n in [0, n): the cyclic roll's index (a division only at the edges).
__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0) return v + n * ((n - 1 - v) / n);
  return v < n ? v : v % n;
}

// The 16 bits of x[i, j] (j in [0, W)).
template <typename T>
__device__ __forceinline__ uint32_t bits16(const T* x, int i, int j, int W) {
  return (uint32_t)(uint16_t)x[(size_t)i * W + j];
}

// Lanes (x[i, j mod W], x[i, (j + 1) mod W]) for an even j, as one word:
// one load where `pairs` (W even and the base aligned to a pair: the pair
// lies inside the row and on its boundary), else lane by lane.
template <typename T>
__device__ __forceinline__ uint32_t pair(const T* x, int i, int j, int W, bool pairs) {
  j = wrap(j, W);
  if (pairs) {
    const T* at = x + (size_t)i * W + j;
    if (sizeof(T) == 2) return *reinterpret_cast<const uint32_t*>(at);
    const uint32_t v = *reinterpret_cast<const uint16_t*>(at);
    return (v & 0xffu) | ((v & 0xff00u) << 8);
  }
  return bits16(x, i, j, W) | (bits16(x, i, wrap(j + 1, W), W) << 16);
}

// (lanes of a).hi, (lanes of b).lo: the pair one column to the left of b.
__device__ __forceinline__ uint32_t left_of(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5432);
}

template <int BODY, typename T>
__device__ __forceinline__ uint32_t body_swar(const T* x, int i, int j, int H, int W, bool pairs) {
  const int up = i == 0 ? H - 1 : i - 1, dn = i == H - 1 ? 0 : i + 1;
  if constexpr (BODY == 1) {
    const uint32_t v = pair(x, i, j, W, pairs), t = __vadd2(v, v);
    return __vadd2(__vadd2(t, v), __vadd2(t, t));
  } else if constexpr (BODY == 2) {
    return __vadd2(__vadd2(pair(x, i, j, W, pairs), pair(x, up, j, W, pairs)),
                   pair(x, dn, j, W, pairs));
  } else if constexpr (BODY == 3) {
    const uint32_t p = pair(x, i, j - 2, W, pairs), c = pair(x, i, j, W, pairs),
                   n = pair(x, i, j + 2, W, pairs);
    const uint32_t l = left_of(p, c), r = left_of(c, n);
    return __vadd2(__vadd2(__vadd2(c, c), __vadd2(__vadd2(l, l), l)), r);
  } else {
    // P4: the 3-row sums of the pairs left, here and right, then the columns.
    uint32_t v[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int jj = j + 2 * (d - 1);
      v[d] = __vadd2(__vadd2(pair(x, i, jj, W, pairs), pair(x, up, jj, W, pairs)),
                     pair(x, dn, jj, W, pairs));
    }
    return __vadd2(__vadd2(__vadd2(v[1], v[1]), left_of(v[0], v[1])), left_of(v[1], v[2]));
  }
}

template <typename T>
__device__ __forceinline__ int val(const T* x, int i, int j, int W) {
  return (int)x[(size_t)i * W + wrap(j, W)];
}

template <int BODY, typename T>
__device__ __forceinline__ int body_i32(const T* x, int i, int j, int H, int W) {
  const int up = i == 0 ? H - 1 : i - 1, dn = i == H - 1 ? 0 : i + 1;
  if constexpr (BODY == 1) {
    const int v = val(x, i, j, W), t = v + v;
    return (t + v) + (t + t);
  } else if constexpr (BODY == 2) {
    return val(x, i, j, W) + val(x, up, j, W) + val(x, dn, j, W);
  } else if constexpr (BODY == 3) {
    const int c = val(x, i, j, W), l = val(x, i, j - 1, W);
    return (c + c) + ((l + l) + l) + val(x, i, j + 1, W);
  } else {
    int v[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      v[d] = val(x, i, j + d - 1, W) + val(x, up, j + d - 1, W) + val(x, dn, j + d - 1, W);
    return (v[1] + v[1]) + v[0] + v[2];
  }
}

// Thread (blockIdx.x NT + threadIdx.x) takes columns (2p, 2p + 1) of rows
// blockIdx.y, blockIdx.y + gridDim.y, ...
template <int BODY, bool SWAR, typename T>
__global__ void __launch_bounds__(NT) swar_pair_kernel(const T* __restrict__ x,
                                                       int* __restrict__ out, int H, int W,
                                                       bool pairs) {
  const int j = 2 * (int)(blockIdx.x * NT + threadIdx.x);
  if (j >= W) return;
  for (int i = blockIdx.y; i < H; i += gridDim.y) {
    int r0, r1;
    if (SWAR) {
      const uint32_t y = body_swar<BODY>(x, i, j, H, W, pairs);
      r0 = (int16_t)(y & 0xffffu);
      r1 = (int16_t)(y >> 16);
    } else {
      r0 = (int16_t)body_i32<BODY>(x, i, j, H, W);
      r1 = j + 1 < W ? (int16_t)body_i32<BODY>(x, i, j + 1, H, W) : 0;
    }
    int* o = out + (size_t)i * W + j;
    o[0] = r0;
    if (j + 1 < W) o[1] = r1;
  }
}

// ---- the vector route: 8 columns a thread ----

// Columns c0..c0+7 of row `row` as 4 words of 16-bit lanes (column c0 + 2q
// low, c0 + 2q + 1 high in word q): one 16-byte load for int16, one 8-byte
// load for u8, its bytes spread to 16-bit lanes.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ x, size_t at, uint32_t (&w)[4]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + at));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(x + at));
    w[0] = __byte_perm(v.x, 0, 0x4140), w[1] = __byte_perm(v.x, 0, 0x4342);
    w[2] = __byte_perm(v.y, 0, 0x4140), w[3] = __byte_perm(v.y, 0, 0x4342);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t load1(const T* __restrict__ x, size_t at) {
  return (uint32_t)(uint16_t)__ldg(x + at);
}

__device__ __forceinline__ int lane_val(uint32_t word, int half) {
  return (int)(int16_t)(half ? word >> 16 : word & 0xffffu);
}

// Thread (lane, warp) of block (bx, by) computes columns c0 = 8 (32 bx +
// lane) .. c0 + 7 of rows 8 by + warp, + 8 gridDim.y, ... (a row is the same
// for a whole warp, so the shuffles run on full warps; lanes past W compute
// on zeros, and no column past W is stored).
template <int BODY, bool SWAR, typename T>
__global__ void __launch_bounds__(NT) swar_vec_kernel(const T* __restrict__ x,
                                                      int* __restrict__ out, int H, int W) {
  __shared__ int4 stage[VEC_ROWS][WARP_COLS / 4];  // a warp's 256 results
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = (blockIdx.x * 32 + lane) * VEC_COLS;
  const bool live = c0 < W;
  // Only these lanes load the value beyond their chunk: the warp's first
  // lane the one before, its last lane and the plane's last chunk the one
  // after (cyclic).
  const bool load_left = lane == 0, load_right = lane == 31 || c0 + VEC_COLS == W;
  const int lc = c0 == 0 ? W - 1 : c0 - 1, rc = c0 + VEC_COLS == W ? 0 : c0 + VEC_COLS;
  constexpr bool ROWS = BODY == 2 || BODY == 4, COLS = BODY == 3 || BODY == 4;
  for (int i = blockIdx.y * VEC_ROWS + warp; i < H; i += gridDim.y * VEC_ROWS) {
    const int up = i == 0 ? H - 1 : i - 1, dn = i == H - 1 ? 0 : i + 1;
    const size_t rows[3] = {(size_t)i * W, (size_t)up * W, (size_t)dn * W};
    // The chunk of rows i, i - 1, i + 1 (the last two for the row rolls)
    // and the 16 bits of the columns before and after it, where this lane
    // loads them (0 elsewhere, and on lanes past W).
    uint32_t c[3][4] = {}, el[3] = {}, er[3] = {};
    if (live) {
#pragma unroll
      for (int r = 0; r < (ROWS ? 3 : 1); ++r) {
        load8(x, rows[r] + c0, c[r]);
        if constexpr (COLS) {
          if (load_left) el[r] = load1(x, rows[r] + lc);
          if (load_right) er[r] = load1(x, rows[r] + rc);
        }
      }
    }
    int res[VEC_COLS];
    if constexpr (SWAR) {
      uint32_t s[4], y[4];  // s: the words rolled over (P2, P4: the 3-row sums)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[q] = ROWS ? __vadd2(__vadd2(c[0][q], c[1][q]), c[2][q]) : c[0][q];
      if constexpr (COLS) {
        const uint32_t from_left = __shfl_up_sync(FULL, s[3] >> 16, 1);
        const uint32_t from_right = __shfl_down_sync(FULL, s[0] & 0xffffu, 1);
        // hi of p: the column before c0; lo of n: the column after c0 + 7.
        const uint32_t p = load_left ? (el[0] + el[1] + el[2]) << 16 : from_left << 16;
        const uint32_t n = load_right ? (er[0] + er[1] + er[2]) & 0xffffu : from_right;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t l = left_of(q == 0 ? p : s[q - 1], s[q]);
          const uint32_t r = left_of(s[q], q == 3 ? n : s[q + 1]);
          y[q] = BODY == 3 ? __vadd2(__vadd2(__vadd2(s[q], s[q]), __vadd2(__vadd2(l, l), l)), r)
                           : __vadd2(__vadd2(__vadd2(s[q], s[q]), l), r);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t t = __vadd2(s[q], s[q]);
          y[q] = BODY == 1 ? __vadd2(__vadd2(t, s[q]), __vadd2(t, t)) : s[q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        res[2 * q] = lane_val(y[q], 0), res[2 * q + 1] = lane_val(y[q], 1);
    } else {
      // int32 mode: a column's value in an int, the sums unwrapped, the
      // result wrapped to int16 at the end.
      int v[VEC_COLS];
#pragma unroll
      for (int k = 0; k < VEC_COLS; ++k)
        v[k] = lane_val(c[0][k / 2], k & 1) + lane_val(c[1][k / 2], k & 1) +
               lane_val(c[2][k / 2], k & 1);
      if constexpr (COLS) {
        const int from_left = __shfl_up_sync(FULL, v[VEC_COLS - 1], 1);
        const int from_right = __shfl_down_sync(FULL, v[0], 1);
        const int l0 = load_left ? lane_val(el[0], 0) + lane_val(el[1], 0) + lane_val(el[2], 0)
                                 : from_left;
        const int r7 = load_right ? lane_val(er[0], 0) + lane_val(er[1], 0) + lane_val(er[2], 0)
                                  : from_right;
#pragma unroll
        for (int k = 0; k < VEC_COLS; ++k) {
          const int l = k == 0 ? l0 : v[k - 1], r = k == VEC_COLS - 1 ? r7 : v[k + 1];
          res[k] = BODY == 3 ? (v[k] + v[k]) + ((l + l) + l) + r : (v[k] + v[k]) + l + r;
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC_COLS; ++k) {
          const int t = v[k] + v[k];
          res[k] = BODY == 1 ? (t + v[k]) + (t + t) : v[k];
        }
      }
#pragma unroll
      for (int k = 0; k < VEC_COLS; ++k) res[k] = (int16_t)res[k];
    }
    // Through the warp's stage: lane l stores the warp's columns 4 l .. 4 l
    // + 3 and 128 + 4 l .. + 3 (a quad lies inside W or past it as a whole:
    // W % 8 == 0).
    int4* st = stage[warp];
    st[2 * lane] = make_int4(res[0], res[1], res[2], res[3]);
    st[2 * lane + 1] = make_int4(res[4], res[5], res[6], res[7]);
    __syncwarp();
    const int base = blockIdx.x * WARP_COLS;
    int4* o = reinterpret_cast<int4*>(out + rows[0] + base);
    if (base + 4 * lane < W) o[lane] = st[lane];
    if (base + WARP_COLS / 2 + 4 * lane < W) o[32 + lane] = st[32 + lane];
    __syncwarp();
  }
}

template <int BODY>
cudaError_t launch(const void* x, int* out, int H, int W, bool swar, cudaStream_t s) {
  using T = std::conditional_t<BODY == 4, uint8_t, int16_t>;
  const int x_offset = (int)(reinterpret_cast<uintptr_t>(x) & 15);
  const SwarPlan p =
      swar_plan(H, W, BODY, x_offset, (reinterpret_cast<uintptr_t>(out) & 15) == 0);
  auto xp = static_cast<const T*>(x);
  const dim3 grid(p.gx, p.gy);
  if (p.vector) {
    if (swar)
      swar_vec_kernel<BODY, true, T><<<grid, NT, 0, s>>>(xp, out, H, W);
    else
      swar_vec_kernel<BODY, false, T><<<grid, NT, 0, s>>>(xp, out, H, W);
  } else {
    const bool pairs = W % 2 == 0 && x_offset % (2 * (int)sizeof(T)) == 0;
    if (swar)
      swar_pair_kernel<BODY, true, T><<<grid, NT, 0, s>>>(xp, out, H, W, pairs);
    else
      swar_pair_kernel<BODY, false, T><<<grid, NT, 0, s>>>(xp, out, H, W, pairs);
  }
  return cudaGetLastError();
}

}  // namespace

// body 1-3: an (H, W) int16 plane; body 4: an (H, W) uint8 plane. out: (H, W)
// int32. swar 0 is the int32 mode.
extern "C" int cc_swar_stencil(const void* x, void* out, int H, int W, int body, int swar,
                               int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (H < 1 || W < 1) return cudaErrorInvalidValue;
  auto o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool sw = swar != 0;
  switch (body) {
    case 1: return launch<1>(x, o, H, W, sw, s);
    case 2: return launch<2>(x, o, H, W, sw, s);
    case 3: return launch<3>(x, o, H, W, sw, s);
    case 4: return launch<4>(x, o, H, W, sw, s);
    default: return cudaErrorInvalidValue;
  }
}

// The route swar_stencil takes for an (H, W) plane of body `body` whose
// input starts x_offset bytes past a 16-byte boundary (the output is the
// wrapper's own, 16-byte aligned): out[0] 1 vector / 0 general, out[1]
// threads a block, out[2] blocks, out[3] columns a thread.
extern "C" int cc_swar_layout(int H, int W, int body, int x_offset, int* out) {
  if (H < 1 || W < 1 || body < 1 || body > 4 || x_offset < 0) return cudaErrorInvalidValue;
  const SwarPlan p = swar_plan(H, W, body, x_offset % 16, true);
  out[0] = p.vector;
  out[1] = NT;
  out[2] = p.gx * p.gy;
  out[3] = p.columns;
  return cudaSuccess;
}
