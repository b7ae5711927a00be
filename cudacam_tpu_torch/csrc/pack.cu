// pack_thresh: a threshold map -> packed FINAL / CANDIDATE hysteresis planes.
//
// Replaces the pack of the TPU fused hysteresis kernel (cudacam_tpu/ops/
// pallas/hysteresis_fused.py:365/:373 pallas_call: _fused_call :310 ->
// _kernel :168, its i == 0 pack loop); the kernel's two convergence phases
// are hyst_rounds.cu's kernels and its unpack is unpack.cu's, run after this
// one. Two input modes, as on the TPU:
//
//   u8    (H, W) threshold map: FINAL = (v == 255), CANDIDATE = (v == 128);
//   nmsq  (H, W) int32 keep * g plane and device bounds [lo, hi], clamped at
//         0: FINAL = (kg > hi), CANDIDATE = (kg > lo) and not FINAL.
//
// Pixels past H are class 0. Design: the column walk of pack_walk.cuh, the
// one sweep_pack_all runs (the nmsq mode is its work at K = 1). Thread
// (k, c) loads the 32 values of column c in word row k, each load 32
// neighbouring values a warp, and builds both words in registers; the u8
// mode maps 255 to 2, 128 to 1 and any other value to 0 and packs against
// [lo, hi] = [0, 1]. One coalesced store a word of each plane.
//
// A batch of N u8 maps (hysteresis_fused_batched, which replaces the stacked
// sections of hysteresis_fused.py:983) is one launch: frame b is grid.z = b,
// reading map b and writing planes b, each frame's rows past H class 0 as
// for one map. One map takes the instance without the frame offsets (BATCH
// false), whose code is the one-map kernel's: with the offsets' 64-bit
// products ahead of its loads, an H100 80GB HBM3 at 700 W ran the one-map
// call at 1080p in 4.1 us against 3.3 without them.
//
// Bound: one read of the map (2 MB u8 or 8.3 MB int32 at 1080p) and a
// 0.5 MB write of the planes: 0.77 us (u8) and 2.6 us (nmsq) at HBM rate,
// N times that for N maps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "pack_walk.cuh"

namespace {

constexpr int PACK_NT = 256;  // threads a block: 256 columns of one word row

template <bool NMSQ, bool BATCH>
__global__ void __launch_bounds__(PACK_NT) pack_thresh_kernel(
    const void* __restrict__ src, const int* __restrict__ bounds, uint32_t* __restrict__ f,
    uint32_t* __restrict__ p, int H, int W) {
  const int kr = blockIdx.y, c = blockIdx.x * PACK_NT + threadIdx.x;
  const bool live = c < W;
  const size_t frame = BATCH ? blockIdx.z : 0;
  f += frame * ((H + 31) / 32) * W;
  p += frame * ((H + 31) / 32) * W;
  int v[32];
  int lo = 0, hi = 1;  // the u8 mode's classes: 2 FINAL, 1 CANDIDATE
  if (NMSQ) {
    const int* kg = static_cast<const int*>(src) + frame * H * W + c;
    load_column([=](int y) { return max(__ldg(kg + (size_t)y * W), 0); }, kr, H, live, v);
    lo = max(bounds[0], 0);
    hi = max(bounds[1], 0);
  } else {
    const uint8_t* map = static_cast<const uint8_t*>(src) + frame * H * W + c;
    load_column([=](int y) {
      const int u = __ldg(map + (size_t)y * W);
      return u == 255 ? 2 : (u == 128 ? 1 : 0);
    }, kr, H, live, v);
  }
  if (!live) return;
  uint32_t fw, pw;
  pack_words(v, lo, hi, &fw, &pw);
  const size_t at = (size_t)kr * W + c;
  f[at] = fw;
  p[at] = pw;
}

}  // namespace

extern "C" int cc_pack_thresh(const void* src, const void* bounds, void* f, void* p, int N,
                              int H, int W, int nmsq, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nmsq && (!bounds || N != 1)) return cudaErrorInvalidValue;  // a batch is u8 maps
  const int hw = (H + 31) / 32;
  if (N < 1 || N > 65535 || H < 1 || W < 1 || hw > 65535)  // grid.z, grid.y
    return cudaErrorInvalidValue;
  const dim3 grid((W + PACK_NT - 1) / PACK_NT, hw, N);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const int*>(bounds);
  auto fp = static_cast<uint32_t*>(f);
  auto pp = static_cast<uint32_t*>(p);
  if (nmsq)
    pack_thresh_kernel<true, false><<<grid, PACK_NT, 0, s>>>(src, b, fp, pp, H, W);
  else if (N == 1)
    pack_thresh_kernel<false, false><<<grid, PACK_NT, 0, s>>>(src, b, fp, pp, H, W);
  else
    pack_thresh_kernel<false, true><<<grid, PACK_NT, 0, s>>>(src, b, fp, pp, H, W);
  return cudaGetLastError();
}
