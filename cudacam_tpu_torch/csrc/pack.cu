// pack_thresh: a threshold map -> packed FINAL / CANDIDATE hysteresis planes.
//
// Replaces the pack of the TPU fused hysteresis kernel (cudacam_tpu/ops/
// pallas/hysteresis_fused.py:365/:373 pallas_call: _fused_call :310 ->
// _kernel :168, its i == 0 pack loop); the kernel's two convergence phases
// are hyst_rounds.cu's kernels and its unpack is unpack.cu's, run after this
// one. Two
// input modes, as on the TPU:
//
//   u8    (H, W) threshold map: FINAL = (v == 255), CANDIDATE = (v == 128);
//   nmsq  (H, W) int32 keep * g plane and device bounds [lo, hi], clamped at
//         0: FINAL = (kg > hi), CANDIDATE = (kg > lo) and not FINAL.
//
// Design: pack_tile.cuh's staged tile and warp ballot, one block per 32-row
// x 128-column tile.
//
// Bound: one read of the map (2 MB u8 or 8 MB int32 at 1080p) and a 0.5 MB
// write of the planes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "pack_tile.cuh"

namespace {

template <bool NMSQ>
__global__ void __launch_bounds__(PACK_NT) pack_thresh_kernel(
    const void* __restrict__ src, const int* __restrict__ bounds, uint32_t* __restrict__ f,
    uint32_t* __restrict__ p, int H, int W) {
  if (NMSQ) {
    const int* kg = static_cast<const int*>(src);
    const int lo = max(bounds[0], 0), hi = max(bounds[1], 0);
    pack_tile([=](size_t at) { return kg_class(kg[at], lo, hi); }, f, p, H, W);
  } else {
    const uint8_t* map = static_cast<const uint8_t*>(src);
    pack_tile([=](size_t at) {
      const int u = map[at];
      return u == 255 ? 2 : (u == 128 ? 1 : 0);
    }, f, p, H, W);
  }
}

}  // namespace

extern "C" int cc_pack_thresh(const void* src, const void* bounds, void* f, void* p, int H,
                              int W, int nmsq, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nmsq && !bounds) return cudaErrorInvalidValue;
  const dim3 grid = pack_grid(H, W);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int*>(bounds);
  auto fp = static_cast<uint32_t*>(f);
  auto pp = static_cast<uint32_t*>(p);
  if (nmsq)
    pack_thresh_kernel<true><<<grid, PACK_NT, 0, s>>>(src, b, fp, pp, H, W);
  else
    pack_thresh_kernel<false><<<grid, PACK_NT, 0, s>>>(src, b, fp, pp, H, W);
  return cudaGetLastError();
}
