// The feed-forward stencil chain on one tile, shared by ff_pack (frame ->
// packed planes) and ff_stages (frame -> display buffers), so the stage math
// exists once.
//
// Replaces the chain of the TPU kernels (cudacam_tpu/ops/pallas/
// feedforward.py: _stage_chain :435, _valid_mask_i32 :318, _gaussian_rolled
// :130, planar_ingest_mono :160): fixed-point mono -> integer Gaussian
// (exact floor division by the tap sum) -> Sobel -> comparable magnitude ->
// NMS (Q15 sectors, ties kept) -> strict double threshold against scalar
// bounds.
//
// A tile is TH image rows x TW columns. stage_tile() stages it and its halo
// in shared memory stage by stage (mono, blur, magnitude), reading the frame
// once in its interleaved HWC layout. Borders follow the JAX kernel: mono is
// zero outside the image, the blur is masked to the image, Sobel sums are
// unmasked but the magnitude used as the NMS neighbourhood is masked.
//
// Zero padding is pinned to a GLOBAL image (the megakernel's origin /
// image_size, megakernel.py:211-220, and its valid mask, feedforward.py
// _valid_mask_i32 :318): a launch reads a source frame whose pixel (0, 0)
// lies at global (sy, sx), and tiles are placed in global coordinates. A
// whole frame is the source at (0, 0) of an image of its own size; a tile of
// a sharded frame reads the whole frame, or its halo-extended copy, at the
// tile's origin.

#pragma once

#include <stdint.h>

namespace {

constexpr int TH = 32;   // tile rows: one packed word-row
constexpr int TW = 64;   // tile columns
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

// Class bounds of a kept pixel: g > hi_c -> FINAL, g > lo_c -> CANDIDATE.
__device__ __forceinline__ void class_bounds(int lo, int hi, int grad_coeff, bool l2,
                                             bool ref_parity, int* lo_c, int* hi_c) {
  if (ref_parity) {
    *lo_c = magnitude_bound(lo, grad_coeff, l2) - 1;
    *hi_c = magnitude_bound(hi, grad_coeff, l2) - 1;
  } else {  // raw Sobel magnitudes, clamped to the 2048 domain cap
    lo = min(max(lo, 0), 2048);
    hi = min(max(hi, 0), 2048);
    *lo_c = l2 ? lo * lo : lo;
    *hi_c = l2 ? hi * hi : hi;
  }
}

// The uint8 display magnitude min(255, (isqrt(sx^2 + sy^2) * coeff) >> 3)
// (L2) or min(255, (coeff * (|sx| + |sy|)) >> 3) (L1). The float sqrt is
// exact on these magnitudes (< 2^24) up to its rounding, which the two
// integer fix-ups of xla_ops.exact_isqrt_i32 remove.
__device__ __forceinline__ int display_magnitude(int sx, int sy, int coeff, bool l2) {
  int val;
  if (l2) {
    const int m = sx * sx + sy * sy;
    int s = (int)sqrtf((float)m);
    if (s * s > m) --s;
    if ((s + 1) * (s + 1) <= m) ++s;
    val = (s * coeff) >> 3;
  } else {
    val = (coeff * (abs(sx) + abs(sy))) >> 3;
  }
  return min(val, 255);
}

// How far stage_tile() runs the chain.
enum Depth { kMono = 1, kBlur = 2, kMag = 3 };

// Where a launch reads its pixels: source frames of SH x SW pixels whose
// pixel (0, 0) lies at global (sy, sx) of an IH x IW image. A pixel outside
// the image or outside the source reads 0.
struct Source {
  int SH, SW;
  int sy, sx;
  int IH, IW;
};

__device__ __forceinline__ bool in_image(const Source& s, int y, int x) {
  return y >= 0 && y < s.IH && x >= 0 && x < s.IW;
}

struct Tile {
  int mono[TH + 2 * MAXR][TW + 2 * MAXR];  // tile + R halo, R = KS/2 + 2
  int blur[TH + 4][TW + 4];                // tile + 2 halo
  int gmag[TH + 2][TW + 2];                // tile + 1 halo
};

// Stage the tile at global (r0, c0) of one (SH, SW[, 3]) source frame into
// t, up to `depth`. Every thread of the block calls it; it ends on a barrier.
template <int KS, bool GRAY>
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ frame, const Source& s,
                                           int r0, int c0, bool l2, int depth, Tile& t) {
  constexpr int R = KS / 2 + 2;  // mono halo: gaussian + sobel + nms
  constexpr int MW = TW + 2 * R;
  constexpr int MH = TH + 2 * R;
  constexpr int KSUM = KS == 3 ? 16 : (KS == 5 ? 159 : 4096);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // 1. mono over the tile + R halo (zero outside the image).
  for (int i = tid; i < MH * MW; i += nthr) {
    int mr = i / MW, mc = i - mr * MW;
    const int y = r0 - R + mr, x = c0 - R + mc;
    const int ly = y - s.sy, lx = x - s.sx;
    int v = 0;
    if (in_image(s, y, x) && ly >= 0 && ly < s.SH && lx >= 0 && lx < s.SW) {
      if (GRAY) {
        v = frame[(size_t)ly * s.SW + lx];
      } else {
        const uint8_t* px = frame + ((size_t)ly * s.SW + lx) * 3;
        v = (px[0] * 7 + px[1] * 38 + px[2] * 19) >> 6;
      }
    }
    t.mono[mr][mc] = v;
  }
  __syncthreads();
  if (depth < kBlur) return;

  // 2. blur over the tile + 2 halo, masked to the image.
  for (int i = tid; i < (TH + 4) * (TW + 4); i += nthr) {
    int br = i / (TW + 4), bc = i - br * (TW + 4);
    int y = r0 - 2 + br, x = c0 - 2 + bc;
    int v = 0;
    if (in_image(s, y, x)) {
      int acc = 0;
#pragma unroll
      for (int dy = 0; dy < KS; ++dy)
#pragma unroll
        for (int dx = 0; dx < KS; ++dx)
          acc += tap<KS>(dy * KS + dx) * t.mono[br + R - 2 - KS / 2 + dy][bc + R - 2 - KS / 2 + dx];
      v = acc / KSUM;  // acc >= 0: truncation is the floor
    }
    t.blur[br][bc] = v;
  }
  __syncthreads();
  if (depth < kMag) return;

  // 3. comparable magnitude over the tile + 1 halo, masked to the image.
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nthr) {
    int gr = i / (TW + 2), gc = i - gr * (TW + 2);
    int y = r0 - 1 + gr, x = c0 - 1 + gc;
    int v = 0;
    if (in_image(s, y, x)) {
      int b = gr + 1, c = gc + 1;  // blur coords of (y, x)
      int sx = -t.blur[b - 1][c - 1] + t.blur[b - 1][c + 1] - 2 * t.blur[b][c - 1] +
               2 * t.blur[b][c + 1] - t.blur[b + 1][c - 1] + t.blur[b + 1][c + 1];
      int sy = t.blur[b - 1][c - 1] + 2 * t.blur[b - 1][c] + t.blur[b - 1][c + 1] -
               t.blur[b + 1][c - 1] - 2 * t.blur[b + 1][c] - t.blur[b + 1][c + 1];
      v = l2 ? sx * sx + sy * sy : abs(sx) + abs(sy);
    }
    t.gmag[gr][gc] = v;
  }
  __syncthreads();
}

// The mono value of tile pixel (i, j), 0 <= i < TH, 0 <= j < TW.
template <int KS>
__device__ __forceinline__ int mono_at(const Tile& t, int i, int j) {
  return t.mono[i + KS / 2 + 2][j + KS / 2 + 2];
}

__device__ __forceinline__ int blur_at(const Tile& t, int i, int j) {
  return t.blur[i + 2][j + 2];
}

// Sobel sums of tile pixel (i, j): needs the chain to kBlur only.
struct Sobel {
  int sx, sy;
};

__device__ __forceinline__ Sobel sobel_at(const Tile& t, int i, int j) {
  const int b = i + 2, c = j + 2;
  return {-t.blur[b - 1][c - 1] + t.blur[b - 1][c + 1] - 2 * t.blur[b][c - 1] +
              2 * t.blur[b][c + 1] - t.blur[b + 1][c - 1] + t.blur[b + 1][c + 1],
          t.blur[b - 1][c - 1] + 2 * t.blur[b - 1][c] + t.blur[b - 1][c + 1] -
              t.blur[b + 1][c - 1] - 2 * t.blur[b + 1][c] - t.blur[b + 1][c + 1]};
}

// Sobel sums, comparable magnitude and NMS decision of tile pixel (i, j).
struct Pixel {
  int sx, sy, g;
  bool keep;
};

__device__ __forceinline__ Pixel pixel_at(const Tile& t, int i, int j) {
  Pixel px;
  const Sobel sb = sobel_at(t, i, j);
  px.sx = sb.sx;
  px.sy = sb.sy;
  const int gr = i + 1, gc = j + 1;
  px.g = t.gmag[gr][gc];
  const int v = abs(px.sx) << 15;
  const int wm = abs(px.sy);
  const int fu = px.sx >= 0 ? px.sy : -px.sy;
  int q, r;
  if (v < wm * TG22) {
    q = t.gmag[gr + 1][gc];
    r = t.gmag[gr - 1][gc];
  } else if (v >= wm * TG67) {
    q = t.gmag[gr][gc + 1];
    r = t.gmag[gr][gc - 1];
  } else if (fu > 0) {
    q = t.gmag[gr + 1][gc - 1];
    r = t.gmag[gr - 1][gc + 1];
  } else {
    q = t.gmag[gr - 1][gc - 1];
    r = t.gmag[gr + 1][gc + 1];
  }
  px.keep = q <= px.g && r <= px.g;
  return px;
}

}  // namespace
