// ff_stages: one frame -> any set of its feed-forward stage buffers, in one pass.
//
// Replaces the TPU feed-forward kernel (cudacam_tpu/ops/pallas/
// feedforward.py:810 pallas_call: _feed_forward_multi :718 -> _kernel_body
// :338; entries feed_forward_to_stage :604, feed_forward_all_stages :651 and
// feed_forward_nmsq :693). The chain is stage_chain.cuh's, the one ff_pack
// runs. Each requested output is an (H, W) buffer:
//
//   MONO      u8   fixed-point mono (a copy of a gray frame)
//   GAUSSIAN  u8   masked blur
//   GRADIENT  u8   display magnitude min(255, (isqrt(g) * coeff) >> 3) (L2)
//                  or min(255, (coeff * L1) >> 3), coeff = grad_coeff in
//                  'reference' parity and 8 in 'opencv' parity
//   NMS       u8   the display magnitude where NMS keeps the pixel, else 0
//   THRESH    u8   the 0 / 128 / 255 class map in the configured parity
//   NMSQ      i32  keep * g, the threshold-free comparable magnitude (the
//                  threshold sweep's input; alone, as on the TPU)
//
// A null output pointer is not written; the chain stops at the deepest
// stage an output needs. Design: one block of 256 threads per TH x TW tile;
// the tile is staged in shared memory as in ff_pack, then every thread
// writes whole pixels row-major, so a warp writes 32 neighbouring bytes of
// each output.
//
// Bound: one read of the frame and one write per requested output (2 MB a
// u8 buffer at 1080p); the chain is a few hundred integer ops per pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "stage_chain.cuh"

namespace {

struct Outs {
  uint8_t* mono;
  uint8_t* blur;
  uint8_t* grad;
  uint8_t* nms;
  uint8_t* thresh;
  int* nmsq;
};

template <int KS, bool GRAY>
__global__ void __launch_bounds__(256) ff_stages_kernel(
    const uint8_t* __restrict__ frame, const int* __restrict__ thr, Outs o, int H, int W,
    int grad_coeff, bool l2, bool ref_parity, int depth) {
  __shared__ Tile t;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  stage_tile<KS, GRAY>(frame, H, W, r0, c0, l2, depth, t);

  int lo_c = 0, hi_c = 0;
  if (o.thresh) class_bounds(thr[0], thr[1], grad_coeff, l2, ref_parity, &lo_c, &hi_c);
  const int coeff = ref_parity ? grad_coeff : 8;
  for (int k = threadIdx.x; k < TH * TW; k += blockDim.x) {
    const int i = k / TW, j = k - (k / TW) * TW;
    const int y = r0 + i, x = c0 + j;
    if (y >= H || x >= W) continue;
    const size_t at = (size_t)y * W + x;
    if (o.mono) o.mono[at] = mono_at<KS>(t, i, j);
    if (o.blur) o.blur[at] = blur_at(t, i, j);
    if (depth < kMag) continue;
    const Pixel px = pixel_at(t, i, j);
    const int mag = (o.grad || o.nms) ? display_magnitude(px.sx, px.sy, coeff, l2) : 0;
    if (o.grad) o.grad[at] = mag;
    if (o.nms) o.nms[at] = px.keep ? mag : 0;
    if (o.thresh) o.thresh[at] = !px.keep ? 0 : (px.g > hi_c ? 255 : (px.g > lo_c ? 128 : 0));
    if (o.nmsq) o.nmsq[at] = px.keep ? px.g : 0;
  }
}

template <int KS>
cudaError_t launch(const uint8_t* frame, const int* thr, Outs o, int H, int W, int channels,
                   int grad_coeff, bool l2, bool ref_parity, int depth, cudaStream_t stream) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  if (channels == 1)
    ff_stages_kernel<KS, true><<<grid, 256, 0, stream>>>(frame, thr, o, H, W, grad_coeff, l2, ref_parity, depth);
  else
    ff_stages_kernel<KS, false><<<grid, 256, 0, stream>>>(frame, thr, o, H, W, grad_coeff, l2, ref_parity, depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cc_ff_stages(const void* frame, const void* thr, void* mono, void* blur,
                            void* grad, void* nms, void* thresh, void* nmsq, int H, int W,
                            int channels, int kernel_size, int grad_coeff, int l2,
                            int ref_parity, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  Outs o{static_cast<uint8_t*>(mono),   static_cast<uint8_t*>(blur),
         static_cast<uint8_t*>(grad),   static_cast<uint8_t*>(nms),
         static_cast<uint8_t*>(thresh), static_cast<int*>(nmsq)};
  if (thresh && !thr) return cudaErrorInvalidValue;
  const int depth = (grad || nms || thresh || nmsq) ? kMag : (blur ? kBlur : kMono);
  auto fr = static_cast<const uint8_t*>(frame);
  auto t = static_cast<const int*>(thr);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return launch<3>(fr, t, o, H, W, channels, grad_coeff, l2, ref_parity, depth, s);
    case 5: return launch<5>(fr, t, o, H, W, channels, grad_coeff, l2, ref_parity, depth, s);
    case 7: return launch<7>(fr, t, o, H, W, channels, grad_coeff, l2, ref_parity, depth, s);
    default: return cudaErrorInvalidValue;
  }
}
