// pack_thresh: a threshold map -> packed FINAL / CANDIDATE hysteresis planes.
//
// Replaces the pack of the TPU fused hysteresis kernel (cudacam_tpu/ops/
// pallas/hysteresis_fused.py:365/:373 pallas_call: _fused_call :310 ->
// _kernel :168, its i == 0 pack loop); the kernel's two convergence phases
// and its unpack are hyst_rounds.cu's kernels, run after this one. Two
// input modes, as on the TPU:
//
//   u8    (H, W) threshold map: FINAL = (v == 255), CANDIDATE = (v == 128);
//   nmsq  (H, W) int32 keep * g plane and device bounds [lo, hi], clamped at
//         0: FINAL = (kg > hi), CANDIDATE = (kg > lo) and not FINAL.
//
// Design: one block of 256 threads per 32-row x PW-column tile. The tile's
// classes are staged in shared memory from coalesced row-major loads, then
// each warp packs columns with a ballot: lane j holds row j, so the ballot
// IS the packed word (bit j of word [k, c] = pixel [32k + j, c]).
//
// Bound: one read of the map (2 MB u8 or 8 MB int32 at 1080p) and a 0.5 MB
// write of the planes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int PW = 128;  // tile columns

template <bool NMSQ>
__global__ void __launch_bounds__(256) pack_thresh_kernel(
    const void* __restrict__ src, const int* __restrict__ bounds, uint32_t* __restrict__ f,
    uint32_t* __restrict__ p, int H, int W) {
  __shared__ int cls[32][PW + 1];  // +1: lane j reads row j without bank conflicts
  const int k = blockIdx.y, r0 = k * 32, c0 = blockIdx.x * PW;
  int lo = 0, hi = 0;
  if (NMSQ) {
    lo = max(bounds[0], 0);
    hi = max(bounds[1], 0);
  }
  for (int i = threadIdx.x; i < 32 * PW; i += blockDim.x) {
    const int r = i / PW, c = i - (i / PW) * PW;
    const int y = r0 + r, x = c0 + c;
    int v = 0;  // 0 none, 1 candidate, 2 final
    if (y < H && x < W) {
      const size_t at = (size_t)y * W + x;
      if (NMSQ) {
        const int kg = static_cast<const int*>(src)[at];
        v = kg > hi ? 2 : (kg > lo ? 1 : 0);
      } else {
        const int u = static_cast<const uint8_t*>(src)[at];
        v = u == 255 ? 2 : (u == 128 ? 1 : 0);
      }
    }
    cls[r][c] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < PW; c += blockDim.x >> 5) {
    const int v = cls[lane][c];
    const uint32_t fw = __ballot_sync(0xffffffffu, v == 2);
    const uint32_t pw = __ballot_sync(0xffffffffu, v == 1);
    const int x = c0 + c;
    if (lane == 0 && x < W) {
      f[(size_t)k * W + x] = fw;
      p[(size_t)k * W + x] = pw;
    }
  }
}

}  // namespace

extern "C" int cc_pack_thresh(const void* src, const void* bounds, void* f, void* p, int H,
                              int W, int nmsq, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nmsq && !bounds) return cudaErrorInvalidValue;
  dim3 grid((W + PW - 1) / PW, (H + 31) / 32);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int*>(bounds);
  auto fp = static_cast<uint32_t*>(f);
  auto pp = static_cast<uint32_t*>(p);
  if (nmsq)
    pack_thresh_kernel<true><<<grid, 256, 0, s>>>(src, b, fp, pp, H, W);
  else
    pack_thresh_kernel<false><<<grid, 256, 0, s>>>(src, b, fp, pp, H, W);
  return cudaGetLastError();
}
