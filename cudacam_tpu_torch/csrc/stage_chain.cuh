// The per-pixel math of the feed-forward stencil chain, shared by ff_pack
// (frame -> packed planes) and ff_stages (frame -> display buffers), so the
// stage math exists once: the Gaussian's row and column forms (Gauss), the
// class bounds, the display magnitude and the NMS decision (nms_keep). Both
// kernels walk columns of the pieces of ff_walk.cuh with them.
//
// Replaces the chain of the TPU kernels (cudacam_tpu/ops/pallas/
// feedforward.py: _stage_chain :435, _valid_mask_i32 :318, _gaussian_rolled
// :130, planar_ingest_mono :160): fixed-point mono -> integer Gaussian
// (exact floor division by the tap sum) -> Sobel -> comparable magnitude ->
// NMS (Q15 sectors, ties kept) -> strict double threshold against scalar
// bounds. Borders follow the JAX kernel: mono is zero outside the image, the
// blur is masked to the image, Sobel sums are unmasked but the magnitude
// used as the NMS neighbourhood is masked.
//
// Zero padding is pinned to a GLOBAL image (the megakernel's origin /
// image_size, megakernel.py:211-220, and its valid mask, feedforward.py
// _valid_mask_i32 :318): a launch reads a source frame whose pixel (0, 0)
// lies at global (sy, sx) (Source below). A whole frame is the source at
// (0, 0) of an image of its own size; a tile of a sharded frame reads the
// whole frame, or its halo-extended copy, at the tile's origin.

#pragma once

#include <stdint.h>

namespace {

constexpr int TG22 = 13573;  // round(tan(22.5 deg) * 2^15)
constexpr int TG67 = 79109;  // round(tan(67.5 deg) * 2^15)

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
// (L2) or min(255, (coeff * (|sx| + |sy|)) >> 3) (L1). The root comes from
// the approximate reciprocal square root (one MUFU instruction, no branch):
// on these magnitudes (m < 2^22) m * rsqrt(m) lies within 1 of the root, and
// the two integer fix-ups of xla_ops.exact_isqrt_i32 make it exact.
__device__ __forceinline__ int display_magnitude(int sx, int sy, int coeff, bool l2) {
  int val;
  if (l2) {
    const int m = sx * sx + sy * sy;
    const float mf = (float)m;
    int s = m ? (int)(mf * rsqrtf(mf)) : 0;
    if (s * s > m) --s;
    if ((s + 1) * (s + 1) <= m) ++s;
    val = (s * coeff) >> 3;
  } else {
    val = (coeff * (abs(sx) + abs(sy))) >> 3;
  }
  return min(val, 255);
}

// How far ff_stages runs the chain: mono only; to the Sobel sums; to the NMS.
enum Depth { kMono = 1, kBlur = 2, kMag = 3 };

// Where a launch reads its pixels: source frames of SH x SW pixels whose
// pixel (0, 0) lies at global (sy, sx) of an IH x IW image. A pixel outside
// the image or outside the source reads 0.
struct Source {
  int SH, SW;
  int sy, sx;
  int IH, IW;
};

// The NMS decision of a pixel with Sobel sums (sx, sy) and comparable
// magnitude gc, from the magnitudes of its eight neighbours (n: the row
// above, s: the row below, w / e: the columns left / right): Q15 sectors,
// ties kept. ff_stages and ff_pack both decide here.
__device__ __forceinline__ bool nms_keep(int sx, int sy, int gnw, int gn, int gne, int gw,
                                         int gc, int ge, int gsw, int gs, int gse) {
  const int v = abs(sx) << 15;
  const int wm = abs(sy);
  const int fu = sx >= 0 ? sy : -sy;
  int q, r;
  if (v < wm * TG22) {
    q = gs;
    r = gn;
  } else if (v >= wm * TG67) {
    q = ge;
    r = gw;
  } else if (fu > 0) {
    q = gsw;
    r = gne;
  } else {
    q = gnw;
    r = gse;
  }
  return q <= gc && r <= gc;
}

// The Gaussian of a sliding window, exactly the 2-D taps (cudacam_tpu_torch/
// config.py: GAUSSIAN_TAPS; sums 16, 159, 4096) before the one floor
// division (tests/test_torch_ff_pack_tiles.py holds each form to the taps). Sizes 3 and 7 are outer products of [1, 2, 1] and
// [1, 6, 15, 20, 15, 6, 1]: a row sum (kHN = 1 value a row), then the same
// taps down the column. Size 5 is not separable, but its rows are three
// symmetric row filters, r0 = [2, 4, 5, 4, 2], r1 = [4, 9, 12, 9, 4] and
// r2 = [5, 12, 15, 12, 5], in the order r0 r1 r2 r1 r0: each mono row gives
// the three (kHN = 3), from two pair sums and its centre, and a blur row is
// r0(y-2) + r1(y-1) + r2(y) + r1(y+1) + r0(y+2).
template <int KS>
struct Gauss {
  static constexpr int kHN = KS == 5 ? 3 : 1;
  static constexpr int kSum = KS == 3 ? 16 : (KS == 5 ? 159 : 4096);

  // The row sums of the mono row m at columns c - KS/2 .. c + KS/2 (m[0] is
  // the leftmost tap).
  __device__ __forceinline__ static void row(const uint8_t* m, int* h) {
    if (KS == 3) {
      h[0] = m[0] + 2 * m[1] + m[2];
    } else if (KS == 5) {
      const int ae = m[0] + m[4], bd = m[1] + m[3], c = m[2];
      h[0] = 2 * ae + 4 * bd + 5 * c;
      h[1] = 4 * ae + 9 * bd + 12 * c;
      h[2] = 5 * ae + 12 * bd + 15 * c;
    } else {
      h[0] = (m[0] + m[6]) + 6 * (m[1] + m[5]) + 15 * (m[2] + m[4]) + 20 * m[3];
    }
  }

  // The blur of the centre row from the row sums of the KS rows of its
  // window, oldest first: floor(sum / kSum) (the sum is >= 0).
  __device__ __forceinline__ static int column(int (*w)[kHN]) {
    int acc;
    if (KS == 3) {
      acc = w[0][0] + 2 * w[1][0] + w[2][0];
    } else if (KS == 5) {
      acc = (w[0][0] + w[4][0]) + (w[1][1] + w[3][1]) + w[2][2];
    } else {
      acc = (w[0][0] + w[6][0]) + 6 * (w[1][0] + w[5][0]) + 15 * (w[2][0] + w[4][0]) +
            20 * w[3][0];
    }
    return (int)((unsigned)acc / (unsigned)kSum);
  }
};

}  // namespace
