// sweep_pack: one (low, high) pair of a threshold sweep -> its packed FINAL /
// CANDIDATE planes, warm-started from the previous pair's converged plane.
//
// Replaces the per-pair pack of the TPU sweep kernel (cudacam_tpu/ops/pallas/
// hysteresis_fused.py:729 pallas_call in sweep_fused :644 -> _sweep_kernel
// :478, its classify + pack loop and its monotone seed). On the TPU one launch
// runs all K pairs as K sequential grid steps over a VMEM-resident keep * g
// plane. Hopper blocks carry nothing from one launch to the next, so the
// sweep is, per sorted slot i, this kernel and then hyst_rounds.cu's phase-1
// and phase-2 kernels on slot i's planes, in stream order; one batched unpack
// writes every map to its original index at the end (ops/cuda/
// hysteresis_fused.py::sweep_fused).
//
// Slot i classifies the int32 keep * g plane against bounds[2i], bounds[2i+1]
// (clamped at 0): FINAL = kg > hi, CANDIDATE = lo < kg <= hi. With the
// monotone seed, when slot i-1's pair dominates slot i's (lo_{i-1} >= lo_i and
// hi_{i-1} >= hi_i, read here on the device, so the host decides nothing),
// slot i's FINAL words are ORed with slot i-1's plane, which the round kernels
// before this launch left converged or cut off by the cap.
//
// Design: pack_tile.cuh's staged tile and warp ballot, one block per 32-row x
// 128-column tile; the seed test is the same in every thread of the launch.
//
// Bound: one read of the kg plane (8 MB at 1080p, 33 MB at 4K, 133 MB at 8K;
// the sweep's K reads stay in the 50 MB L2 up to 4K) and a write of two
// planes, plus the seed plane's read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "pack_tile.cuh"

namespace {

__global__ void __launch_bounds__(PACK_NT) sweep_pack_kernel(
    const int* __restrict__ kg, const int* __restrict__ bounds, uint32_t* __restrict__ f,
    uint32_t* __restrict__ p, int slot, int H, int W, bool monotone) {
  const size_t plane = (size_t)((H + 31) / 32) * W;
  const int lo = max(bounds[2 * slot], 0), hi = max(bounds[2 * slot + 1], 0);
  const bool seed = monotone && slot > 0 && max(bounds[2 * slot - 2], 0) >= lo &&
                    max(bounds[2 * slot - 1], 0) >= hi;
  pack_tile([=](size_t at) { return kg_class(kg[at], lo, hi); }, f + slot * plane,
            p + slot * plane, seed ? f + (slot - 1) * plane : nullptr, H, W);
}

}  // namespace

extern "C" int cc_sweep_pack(const void* kg, const void* bounds, void* f, void* p, int slot,
                             int H, int W, int monotone, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (slot < 0) return cudaErrorInvalidValue;
  sweep_pack_kernel<<<pack_grid(H, W), PACK_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(kg), static_cast<const int*>(bounds), static_cast<uint32_t*>(f),
      static_cast<uint32_t*>(p), slot, H, W, monotone != 0);
  return cudaGetLastError();
}
