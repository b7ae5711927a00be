// ff_pack: a batch of raw frames -> packed FINAL / CANDIDATE hysteresis planes.
//
// Replaces the front half of the TPU megakernel (cudacam_tpu/ops/pallas/
// megakernel.py: _kernel / _ingest_chain_pack, and _kernel_batched for a
// batch): the stage chain of stage_chain.cuh -> strict double threshold
// against scalar bounds -> vertical bit pack (bit j of word [k, c] = pixel
// [32k + j, c]).
//
// Design. One block per tile of 32 image rows (one packed word-row) x TW
// columns of one frame; grid.z runs over the frames, so a batch of B frames
// is one launch. The chain stages the tile in shared memory (stage_tile), so
// it reads the frame once and never writes an intermediate plane to device
// memory. The class of each pixel is packed with a warp ballot: lane j of a
// warp holds row j of one column, so the ballot IS the packed word.
// Thresholds come from a device int32[2] (lo, hi), so a threshold change
// rebuilds nothing.
//
// Bound: one read of the 6.2 MB 1080p frame and a 0.5 MB write of the
// planes per frame; the stencil work is a few hundred integer ops per pixel.
// The kernel is simple first: shared-memory staging with no async copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "stage_chain.cuh"

namespace {

template <int KS, bool GRAY>
__global__ void __launch_bounds__(256) ff_pack_kernel(
    const uint8_t* __restrict__ frames, const int* __restrict__ thr,
    uint32_t* __restrict__ fplanes, uint32_t* __restrict__ pplanes, int H, int W,
    int grad_coeff, bool l2, bool ref_parity) {
  __shared__ Tile t;
  const size_t b = blockIdx.z;
  const uint8_t* frame = frames + b * H * W * (GRAY ? 1 : 3);
  uint32_t* fplane = fplanes + b * ((H + 31) / 32) * W;
  uint32_t* pplane = pplanes + b * ((H + 31) / 32) * W;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  stage_tile<KS, GRAY>(frame, H, W, r0, c0, l2, kMag, t);

  // NMS + threshold class per pixel; lane = row within the word.
  int lo_c, hi_c;
  class_bounds(thr[0], thr[1], grad_coeff, l2, ref_parity, &lo_c, &hi_c);
  const int lane = threadIdx.x;
  const int y = r0 + lane;
  for (int cc = threadIdx.y; cc < TW; cc += blockDim.y) {
    const int x = c0 + cc;
    int cls = 0;  // 0 none, 1 candidate, 2 final
    if (y < H && x < W) {
      const Pixel px = pixel_at(t, lane, cc);
      if (px.keep) cls = px.g > hi_c ? 2 : (px.g > lo_c ? 1 : 0);
    }
    uint32_t fw = __ballot_sync(0xffffffffu, cls == 2);
    uint32_t pw = __ballot_sync(0xffffffffu, cls == 1);
    if (lane == 0 && x < W) {
      fplane[(size_t)blockIdx.y * W + x] = fw;
      pplane[(size_t)blockIdx.y * W + x] = pw;
    }
  }
}

template <int KS>
cudaError_t launch(const void* frames, const void* thr, void* f, void* p, int B, int H,
                   int W, int channels, int grad_coeff, bool l2, bool ref_parity,
                   cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  auto fr = static_cast<const uint8_t*>(frames);
  auto t = static_cast<const int*>(thr);
  auto fp = static_cast<uint32_t*>(f);
  auto pp = static_cast<uint32_t*>(p);
  if (channels == 1)
    ff_pack_kernel<KS, true><<<grid, block, 0, stream>>>(fr, t, fp, pp, H, W, grad_coeff, l2, ref_parity);
  else
    ff_pack_kernel<KS, false><<<grid, block, 0, stream>>>(fr, t, fp, pp, H, W, grad_coeff, l2, ref_parity);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cc_ff_pack(const void* frames, const void* thr, void* f, void* p, int B,
                          int H, int W, int channels, int kernel_size, int grad_coeff,
                          int l2, int ref_parity, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (B < 1 || B > 65535) return cudaErrorInvalidValue;  // grid.z
  auto s = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return launch<3>(frames, thr, f, p, B, H, W, channels, grad_coeff, l2, ref_parity, s);
    case 5: return launch<5>(frames, thr, f, p, B, H, W, channels, grad_coeff, l2, ref_parity, s);
    case 7: return launch<7>(frames, thr, f, p, B, H, W, channels, grad_coeff, l2, ref_parity, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
