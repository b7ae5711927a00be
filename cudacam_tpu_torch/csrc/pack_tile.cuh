// The packing tile of pack.cu (pack_thresh): per-pixel classes -> packed
// FINAL / CANDIDATE words. (The threshold sweep's pack, sweep.cu, walks
// columns instead.)
//
// One block of 256 threads per 32-row x PACK_TW-column tile (blockIdx.y =
// word row, blockIdx.x = column tile). The tile's classes are staged in
// shared memory from coalesced row-major loads, then each warp packs columns
// with a ballot: lane j holds row j, so the ballot IS the packed word (bit j
// of word [k, c] = pixel [32k + j, c]). Pixels past H or W are class 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int PACK_TW = 128;  // tile columns
constexpr int PACK_NT = 256;  // threads per block

// classify(at) gives the class of the pixel at row-major offset `at`: 0 none,
// 1 candidate, 2 final. Writes words [blockIdx.y, c] of f and p.
template <class Classify>
__device__ __forceinline__ void pack_tile(Classify classify, uint32_t* __restrict__ f,
                                          uint32_t* __restrict__ p, int H, int W) {
  __shared__ int cls[32][PACK_TW + 1];  // +1: lane j reads row j without bank conflicts
  const int k = blockIdx.y, r0 = k * 32, c0 = blockIdx.x * PACK_TW;
  for (int i = threadIdx.x; i < 32 * PACK_TW; i += blockDim.x) {
    const int r = i / PACK_TW, c = i - r * PACK_TW;
    const int y = r0 + r, x = c0 + c;
    cls[r][c] = (y < H && x < W) ? classify((size_t)y * W + x) : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < PACK_TW; c += blockDim.x >> 5) {
    const int v = cls[lane][c];
    const uint32_t fw = __ballot_sync(0xffffffffu, v == 2);
    const uint32_t pw = __ballot_sync(0xffffffffu, v == 1);
    const int x = c0 + c;
    if (lane == 0 && x < W) {
      const size_t at = (size_t)k * W + x;
      f[at] = fw;
      p[at] = pw;
    }
  }
}

// Strict double threshold of a keep * g value against bounds clamped at 0.
__device__ __forceinline__ int kg_class(int kg, int lo, int hi) {
  return kg > hi ? 2 : (kg > lo ? 1 : 0);
}

inline dim3 pack_grid(int H, int W) { return dim3((W + PACK_TW - 1) / PACK_TW, (H + 31) / 32); }
