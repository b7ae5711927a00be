// The unpacks: packed FINAL planes -> uint8 edge maps (255 where the bit is
// set, else 0), every output byte written once.
//
// unpack replaces the TPU megakernel's unpack (cudacam_tpu/ops/pallas/
// megakernel.py: _unpack_out :130; per frame of a batch in _kernel_batched)
// and the output blocks of the fused hysteresis and sweep kernels
// (hysteresis_fused.py: _kernel, _sweep_kernel; with an index, the sweep's
// prefetch-indexed output block). unpack_core replaces the core unpack
// (megakernel.py:714 pallas_call in unpack_core_call :689 ->
// _unpack_core_kernel :653): the owned cores of a batch of extended tiles,
// each into its place in the sharded frame's edge map.
//
// Design: both kernels run one routine, unpack_runs, on one word row of a
// plane at a time. A block takes 32 / UNPACK_NRH of the word row's 32 image
// rows, UNPACK_SEG columns of them (block x = (word row, row part,
// segment)): it stages the segment's words (and the 16 after it) in shared
// memory with coalesced loads, padded a word every 32 so that a lane's run
// of 32 words reads without bank conflicts. Lane l of each warp owns the 32
// columns from 32 l, each warp UNPACK_ROWS image rows: per row the thread
// gathers the row's bit of its 48 words into one 64-bit mask (own 32, the
// next 16) and writes the 16-byte aligned runs of output bytes that start in
// its columns, each as one vector store (bits expanded to 0 / 255 four at a
// time). The 16-byte boundary is the output row's address, not its column:
// the row's first bytes before its first 16-byte boundary (the head) go byte
// by byte from the thread of column 0, and so do the bytes of a last run that
// passes the row's end (the tail). No division per byte.
//
// A caller gives the routine the word row's first word and its columns, and
// maps each of the 32 bits to its output row or to none. unpack: bit j of
// word row k is row 32 k + j of the frame's map (none at or past h), rows of
// w bytes. unpack_core: the core of tile t is its h_loc x w_loc pixels from
// row e_top and lane e_left of its plane; its blocks walk the word rows from
// e_top / 32 to (e_top + h_loc - 1) / 32 (each block stages one word row, so
// where e_top % 32 != 0 the core's first and last word rows are partly
// outside it), starting at lane e_left; bit j of word row k is core row
// 32 k + j - e_top (none outside [0, h_loc)), at column j_t w_loc of a row of
// pitch ow in the frame's map: so a head and a tail can fall at every
// column split.
//
// Bound: the output bytes and the words they come from, read once (an 8K
// frame: 33 MB written, ~10 us at HBM rate); the stores are 16-byte vectors,
// the loads coalesced 4-byte words, ~4.5 instructions an output byte.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int UNPACK_SEG = 1024;   // columns a block
constexpr int UNPACK_ROWS = 2;     // image rows a warp
constexpr int UNPACK_NT = 256;     // threads a block
constexpr int UNPACK_NRH = 32 / (UNPACK_NT / 32 * UNPACK_ROWS);  // blocks a word row's rows take
constexpr int UNPACK_STAGED = UNPACK_SEG + 16;

__device__ __forceinline__ uint32_t expand_nibble(uint32_t n) {  // 4 bits -> 4 bytes 0 / 255
  return ((n * 0x00204081u) & 0x01010101u) * 0xffu;
}

// Part rpart of the 32 image rows of one word row, columns [c0, c0 +
// UNPACK_SEG) of its n: fr points at the word row's first word (column 0),
// and row_at(j) at the first byte of the n-byte output row that bit j goes
// to, or is null where bit j goes nowhere.
template <class RowAt>
__device__ __forceinline__ void unpack_runs(const uint32_t* __restrict__ fr, int n, int c0,
                                            int rpart, RowAt row_at) {
  __shared__ uint32_t st[UNPACK_STAGED + UNPACK_STAGED / 32 + 1];
  for (int q = threadIdx.x; q < UNPACK_STAGED; q += UNPACK_NT)
    st[q + (q >> 5)] = c0 + q < n ? __ldg(fr + c0 + q) : 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = c0 + 32 * lane;  // the thread's first column
  if (cg >= n) return;
  uint32_t wd[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) {
    const int q = 32 * lane + i;
    wd[i] = st[q + (q >> 5)];
  }
#pragma unroll
  for (int jj = 0; jj < UNPACK_ROWS; ++jj) {
    const int j = (rpart * (UNPACK_NT / 32) + warp) * UNPACK_ROWS + jj;
    uint8_t* row = row_at(j);
    if (!row) continue;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) lo |= ((wd[i] >> j) & 1u) << i;
#pragma unroll
    for (int i = 0; i < 16; ++i) hi |= ((wd[32 + i] >> j) & 1u) << i;
    const int d = (16 - (int)(reinterpret_cast<uintptr_t>(row) & 15)) & 15;  // first aligned column
    if (cg == 0)
      for (int c = 0; c < d && c < n; ++c) row[c] = ((lo >> c) & 1u) ? 255 : 0;
#pragma unroll
    for (int o = d; o < d + 32; o += 16) {
      const int c = cg + o;
      if (c >= n) break;
      const uint32_t bits = __funnelshift_r(lo, hi, o) & 0xffffu;
      if (c + 16 <= n) {
        *reinterpret_cast<uint4*>(row + c) =
            make_uint4(expand_nibble(bits & 15u), expand_nibble((bits >> 4) & 15u),
                       expand_nibble((bits >> 8) & 15u), expand_nibble(bits >> 12));
      } else {
        for (int i = 0; c + i < n; ++i) row[c + i] = ((bits >> i) & 1u) ? 255 : 0;
      }
    }
  }
}

// Frame blockIdx.y of the batch, to out[index[b]] when an index is given,
// else to out[b]. An index outside [0, B) writes nothing.
__global__ void __launch_bounds__(UNPACK_NT) unpack_kernel(
    const uint32_t* __restrict__ f, uint8_t* __restrict__ out, const int* __restrict__ index,
    int nb, int h, int w, int nseg) {
  const int to = index ? index[blockIdx.y] : (int)blockIdx.y;
  if (to < 0 || to >= nb) return;
  const int kr = blockIdx.x / nseg, c0 = (blockIdx.x - kr * nseg) * UNPACK_SEG;
  const int k = kr / UNPACK_NRH, rpart = kr - k * UNPACK_NRH;
  const int hw = (h + 31) / 32;
  uint8_t* ob = out + (size_t)to * h * w;
  unpack_runs(f + ((size_t)blockIdx.y * hw + k) * w, w, c0, rpart, [=](int j) -> uint8_t* {
    const int r = 32 * k + j;
    return r < h ? ob + (size_t)r * w : nullptr;
  });
}

// Tile blockIdx.y = (b, i, j) over an nty x ntx grid per frame: its core
// lands at out[b][i h_loc + r][j w_loc + c] of the (B, oh, ow) maps.
__global__ void __launch_bounds__(UNPACK_NT) unpack_core_kernel(
    const uint32_t* __restrict__ f, uint8_t* __restrict__ out, int hwe, int ew, int e_top,
    int e_left, int h_loc, int w_loc, int nty, int ntx, int oh, int ow, int nseg) {
  const int t = blockIdx.y;
  const int b = t / (nty * ntx), ti = (t / ntx) % nty, tj = t % ntx;
  const int kr = blockIdx.x / nseg, c0 = (blockIdx.x - kr * nseg) * UNPACK_SEG;
  const int k = (e_top >> 5) + kr / UNPACK_NRH, rpart = kr % UNPACK_NRH;
  uint8_t* ob = out + ((size_t)b * oh + (size_t)ti * h_loc) * ow + (size_t)tj * w_loc;
  unpack_runs(f + ((size_t)t * hwe + k) * ew + e_left, w_loc, c0, rpart,
              [=](int j) -> uint8_t* {
                const int r = 32 * k + j - e_top;
                return r >= 0 && r < h_loc ? ob + (size_t)r * ow : nullptr;
              });
}

}  // namespace

extern "C" int cc_unpack(const void* f, void* out, const void* index, int nb, int h, int w,
                         int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nb < 1 || nb > 65535) return cudaErrorInvalidValue;  // grid.y
  const int nseg = (w + UNPACK_SEG - 1) / UNPACK_SEG;
  const long long blocks = (long long)((h + 31) / 32) * UNPACK_NRH * nseg;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  unpack_kernel<<<dim3((unsigned)blocks, nb), UNPACK_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<uint8_t*>(out),
      static_cast<const int*>(index), nb, h, w, nseg);
  return cudaGetLastError();
}

extern "C" int cc_unpack_core(const void* f, void* out, int tiles, int hwe, int ew, int e_top,
                              int e_left, int h_loc, int w_loc, int nty, int ntx, int oh, int ow,
                              int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (tiles < 1 || tiles > 65535 || h_loc < 1 || w_loc < 1 || e_top < 0 || e_left < 0)
    return cudaErrorInvalidValue;  // grid.y, an empty or misplaced core
  const int nseg = (w_loc + UNPACK_SEG - 1) / UNPACK_SEG;
  const int nwr = ((e_top + h_loc - 1) >> 5) - (e_top >> 5) + 1;  // word rows the core spans
  const long long blocks = (long long)nwr * UNPACK_NRH * nseg;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  unpack_core_kernel<<<dim3((unsigned)blocks, tiles), UNPACK_NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<uint8_t*>(out), hwe, ew, e_top, e_left, h_loc,
      w_loc, nty, ntx, oh, ow, nseg);
  return cudaGetLastError();
}
