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
// stage an output needs. With an origin, the frame is a tile of a larger
// image (a halo-extended tile of a sharded frame): its pixel (0, 0) lies at
// global (oy, ox) of an IH x IW image, zero padding is pinned to that image
// (the TPU kernel's origin / image_size, sharded.py:255-321), and every
// output is 0 outside it. Design: one block of 256 threads per TH x TW tile;
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
    const uint8_t* __restrict__ frame, const int* __restrict__ thr, Outs o, Source s,
    int grad_coeff, bool l2, bool ref_parity, int depth) {
  __shared__ Tile t;
  const int H = s.SH, W = s.SW;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  stage_tile<KS, GRAY>(frame, s, s.sy + r0, s.sx + c0, l2, depth, t);

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
    if (!in_image(s, s.sy + y, s.sx + x)) {
      if (o.grad) o.grad[at] = 0;
      if (o.nms) o.nms[at] = 0;
      if (o.thresh) o.thresh[at] = 0;
      if (o.nmsq) o.nmsq[at] = 0;
      continue;
    }
    const Pixel px = pixel_at(t, i, j);
    const int mag = (o.grad || o.nms) ? display_magnitude(px.sx, px.sy, coeff, l2) : 0;
    if (o.grad) o.grad[at] = mag;
    if (o.nms) o.nms[at] = px.keep ? mag : 0;
    if (o.thresh) o.thresh[at] = !px.keep ? 0 : (px.g > hi_c ? 255 : (px.g > lo_c ? 128 : 0));
    if (o.nmsq) o.nmsq[at] = px.keep ? px.g : 0;
  }
}

template <int KS>
cudaError_t launch(const uint8_t* frame, const int* thr, Outs o, const Source& s, int channels,
                   int grad_coeff, bool l2, bool ref_parity, int depth, cudaStream_t stream) {
  dim3 grid((s.SW + TW - 1) / TW, (s.SH + TH - 1) / TH);
  if (channels == 1)
    ff_stages_kernel<KS, true><<<grid, 256, 0, stream>>>(frame, thr, o, s, grad_coeff, l2, ref_parity, depth);
  else
    ff_stages_kernel<KS, false><<<grid, 256, 0, stream>>>(frame, thr, o, s, grad_coeff, l2, ref_parity, depth);
  return cudaGetLastError();
}

}  // namespace

// The frame is H x W; (oy, ox) its global origin in an IH x IW image (0, 0,
// H, W for a whole frame).
extern "C" int cc_ff_stages(const void* frame, const void* thr, void* mono, void* blur,
                            void* grad, void* nms, void* thresh, void* nmsq, int H, int W,
                            int oy, int ox, int IH, int IW,
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
  auto st = static_cast<cudaStream_t>(stream);
  const Source s{H, W, oy, ox, IH, IW};
  switch (kernel_size) {
    case 3: return launch<3>(fr, t, o, s, channels, grad_coeff, l2, ref_parity, depth, st);
    case 5: return launch<5>(fr, t, o, s, channels, grad_coeff, l2, ref_parity, depth, st);
    case 7: return launch<7>(fr, t, o, s, channels, grad_coeff, l2, ref_parity, depth, st);
    default: return cudaErrorInvalidValue;
  }
}
