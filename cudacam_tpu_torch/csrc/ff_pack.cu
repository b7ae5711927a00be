// ff_pack: raw frame -> packed FINAL / CANDIDATE hysteresis planes.
//
// Replaces the front half of the TPU megakernel (cudacam_tpu/ops/pallas/
// megakernel.py: _kernel / _ingest_chain_pack, with feedforward.py's
// planar_ingest_mono, _valid_mask_i32, _gaussian_rolled and _stage_chain):
// fixed-point mono -> integer Gaussian (exact floor division by the tap sum)
// -> Sobel -> NMS (Q15 sectors, ties kept) -> strict double threshold against
// scalar bounds -> vertical bit pack (bit j of word [k, c] = pixel [32k+j, c]).
//
// Design. One block per tile of 32 image rows (one packed word-row) x TW
// columns. The tile and a halo of kernel_size/2 + 2 pixels are staged in
// shared memory stage by stage (mono, blur, magnitude), so the chain reads
// the frame once and never writes an intermediate plane to device memory.
// The frame is read in its interleaved HWC layout: the TPU path's planar
// transpose would be a real copy here. The class of each pixel is packed
// with a warp ballot: lane j of a warp holds row j of one column, so the
// ballot IS the packed word. Thresholds come from a device int32[2] (lo, hi),
// so a threshold change rebuilds nothing.
//
// Bound: one read of the 6.2 MB 1080p frame and a 0.5 MB write of the
// planes; the stencil work is a few hundred integer ops per pixel. The
// kernel is simple first: shared-memory staging with no async copies.
//
// Borders follow the JAX kernel: mono is zero outside the image, the blur
// is masked to the image, Sobel sums are unmasked but the magnitude used as
// the NMS neighbourhood is masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int TH = 32;  // tile rows: one packed word-row
constexpr int TW = 64;  // tile columns
constexpr int MAXR = 5;  // largest mono halo: kernel_size 7 -> 3 + 2
constexpr int TG22 = 13573;  // round(tan(22.5 deg) * 2^15)
constexpr int TG67 = 79109;  // round(tan(67.5 deg) * 2^15)

// Integer Gaussian taps, row-major, for kernel sizes 3, 5 and 7
// (cudacam_tpu/config.py: GAUSSIAN_TAPS; sums 16, 159, 4096).
__constant__ int kTaps3[9] = {1, 2, 1, 2, 4, 2, 1, 2, 1};
__constant__ int kTaps5[25] = {2, 4,  5,  4, 2, 4, 9, 12, 9, 4, 5, 12, 15,
                               12, 5, 4, 9, 12, 9, 4, 2, 4, 5,  4, 2};
__constant__ int kTaps7[49] = {
    1,  6,   15,  20,  15,  6,   1,  6,  36,  90,  120, 90,  36,  6,  15, 90, 225,
    300, 225, 90, 15, 20, 120, 300, 400, 300, 120, 20, 15, 90, 225, 300, 225, 90,
    15, 6,  36,  90,  120, 90,  36,  6,  1,   6,   15,  20,  15,  6,   1};

template <int KS>
__device__ __forceinline__ int tap(int i) {
  return KS == 3 ? kTaps3[i] : (KS == 5 ? kTaps5[i] : kTaps7[i]);
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Smallest comparable magnitude whose display value exceeds t ('reference'
// parity; cudacam_tpu/ops/xla_ops.py: threshold_magnitude_bound).
__device__ __forceinline__ int magnitude_bound(int t, int grad_coeff, bool l2) {
  if (t >= 255) return 1 << 30;
  int s = floor_div((t + 1) * 8 + grad_coeff - 1, grad_coeff);
  return l2 ? s * s : s;
}

template <int KS, bool GRAY>
__global__ void __launch_bounds__(256) ff_pack_kernel(
    const uint8_t* __restrict__ frame, const int* __restrict__ thr,
    uint32_t* __restrict__ fplane, uint32_t* __restrict__ pplane, int H, int W,
    int grad_coeff, bool l2, bool ref_parity) {
  constexpr int R = KS / 2 + 2;  // mono halo: gaussian + sobel + nms
  constexpr int MW = TW + 2 * R;
  constexpr int MH = TH + 2 * R;
  constexpr int KSUM = KS == 3 ? 16 : (KS == 5 ? 159 : 4096);
  __shared__ int mono[TH + 2 * MAXR][TW + 2 * MAXR];
  __shared__ int blur[TH + 4][TW + 4];
  __shared__ int gmag[TH + 2][TW + 2];

  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // 1. mono over the tile + R halo (zero outside the image).
  for (int i = tid; i < MH * MW; i += nthr) {
    int mr = i / MW, mc = i - mr * MW;
    int y = r0 - R + mr, x = c0 - R + mc;
    int v = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      if (GRAY) {
        v = frame[(size_t)y * W + x];
      } else {
        const uint8_t* px = frame + ((size_t)y * W + x) * 3;
        v = (px[0] * 7 + px[1] * 38 + px[2] * 19) >> 6;
      }
    }
    mono[mr][mc] = v;
  }
  __syncthreads();

  // 2. blur over the tile + 2 halo, masked to the image.
  for (int i = tid; i < (TH + 4) * (TW + 4); i += nthr) {
    int br = i / (TW + 4), bc = i - br * (TW + 4);
    int y = r0 - 2 + br, x = c0 - 2 + bc;
    int v = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      int acc = 0;
#pragma unroll
      for (int dy = 0; dy < KS; ++dy)
#pragma unroll
        for (int dx = 0; dx < KS; ++dx)
          acc += tap<KS>(dy * KS + dx) * mono[br + R - 2 - KS / 2 + dy][bc + R - 2 - KS / 2 + dx];
      v = acc / KSUM;  // acc >= 0: truncation is the floor
    }
    blur[br][bc] = v;
  }
  __syncthreads();

  // 3. comparable magnitude over the tile + 1 halo, masked to the image.
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nthr) {
    int gr = i / (TW + 2), gc = i - gr * (TW + 2);
    int y = r0 - 1 + gr, x = c0 - 1 + gc;
    int v = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      int b = gr + 1, c = gc + 1;  // blur coords of (y, x)
      int sx = -blur[b - 1][c - 1] + blur[b - 1][c + 1] - 2 * blur[b][c - 1] +
               2 * blur[b][c + 1] - blur[b + 1][c - 1] + blur[b + 1][c + 1];
      int sy = blur[b - 1][c - 1] + 2 * blur[b - 1][c] + blur[b - 1][c + 1] -
               blur[b + 1][c - 1] - 2 * blur[b + 1][c] - blur[b + 1][c + 1];
      v = l2 ? sx * sx + sy * sy : abs(sx) + abs(sy);
    }
    gmag[gr][gc] = v;
  }
  __syncthreads();

  // 4. NMS + threshold class per pixel; lane = row within the word.
  int lo = thr[0], hi = thr[1];
  int lo_c, hi_c;  // class: g > hi_c -> FINAL, g > lo_c -> CANDIDATE
  if (ref_parity) {
    lo_c = magnitude_bound(lo, grad_coeff, l2) - 1;
    hi_c = magnitude_bound(hi, grad_coeff, l2) - 1;
  } else {
    lo = min(max(lo, 0), 2048);
    hi = min(max(hi, 0), 2048);
    lo_c = l2 ? lo * lo : lo;
    hi_c = l2 ? hi * hi : hi;
  }
  const int lane = threadIdx.x;
  const int y = r0 + lane;
  for (int cc = threadIdx.y; cc < TW; cc += blockDim.y) {
    const int x = c0 + cc;
    int cls = 0;  // 0 none, 1 candidate, 2 final
    if (y < H && x < W) {
      int b = lane + 2, c = cc + 2;
      int sx = -blur[b - 1][c - 1] + blur[b - 1][c + 1] - 2 * blur[b][c - 1] +
               2 * blur[b][c + 1] - blur[b + 1][c - 1] + blur[b + 1][c + 1];
      int sy = blur[b - 1][c - 1] + 2 * blur[b - 1][c] + blur[b - 1][c + 1] -
               blur[b + 1][c - 1] - 2 * blur[b + 1][c] - blur[b + 1][c + 1];
      int gr = lane + 1, gc = cc + 1;
      int g = gmag[gr][gc];
      int v = abs(sx) << 15;
      int wm = abs(sy);
      int fu = sx >= 0 ? sy : -sy;
      bool bin0 = v < wm * TG22;
      bool bin2 = v >= wm * TG67;
      int q, r;
      if (bin0) {
        q = gmag[gr + 1][gc];
        r = gmag[gr - 1][gc];
      } else if (bin2) {
        q = gmag[gr][gc + 1];
        r = gmag[gr][gc - 1];
      } else if (fu > 0) {
        q = gmag[gr + 1][gc - 1];
        r = gmag[gr - 1][gc + 1];
      } else {
        q = gmag[gr - 1][gc - 1];
        r = gmag[gr + 1][gc + 1];
      }
      if (q <= g && r <= g) cls = g > hi_c ? 2 : (g > lo_c ? 1 : 0);
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
cudaError_t launch(const void* frame, const void* thr, void* f, void* p, int H,
                   int W, int channels, int grad_coeff, bool l2,
                   bool ref_parity, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  auto fr = static_cast<const uint8_t*>(frame);
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

extern "C" int cc_ff_pack(const void* frame, const void* thr, void* f, void* p,
                          int H, int W, int channels, int kernel_size,
                          int grad_coeff, int l2, int ref_parity, int device,
                          void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return launch<3>(frame, thr, f, p, H, W, channels, grad_coeff, l2, ref_parity, s);
    case 5: return launch<5>(frame, thr, f, p, H, W, channels, grad_coeff, l2, ref_parity, s);
    case 7: return launch<7>(frame, thr, f, p, H, W, channels, grad_coeff, l2, ref_parity, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
