// ff_stages: frames -> any set of their feed-forward stage buffers, in one pass.
//
// Replaces the TPU feed-forward kernel (cudacam_tpu/ops/pallas/
// feedforward.py:810 pallas_call: _feed_forward_multi :718 -> _kernel_body
// :338; entries feed_forward_to_stage :604, feed_forward_all_stages :651 and
// feed_forward_nmsq :693). The chain is stage_chain.cuh's, the one ff_pack
// runs. Each requested output is a (B, H, W) buffer:
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
// A null output pointer is not written; the walk stops at the deepest stage
// an output needs: MONO alone copies the mono plane; MONO, GAUSSIAN and
// GRADIENT stop at the Sobel sums (no magnitude, no NMS); NMS, THRESH and
// NMSQ add the magnitude and the NMS. Classes are keep-gated: a pixel NMS
// drops is 0 in THRESH whatever the low threshold. With an origin, the frame
// is a tile of a larger image (a halo-extended tile of a sharded frame): its
// pixel (0, 0) lies at global (oy, ox) of an IH x IW image, zero padding is
// pinned to that image (the TPU kernel's origin / image_size,
// sharded.py:255-321), and every output is 0 outside it.
//
// Design for Hopper: the pieces, window loads and column walk of ff_walk.cuh,
// the ones ff_pack runs (64 x 56 pieces of each frame of the batch on a
// persistent grid; a TMA box or 16-byte cp.async chunks a window; one thread
// a column of a word row, sliding windows in registers, lane shuffles for the
// horizontal neighbours). The launch is ff_pack's geometry with one tile a
// frame, no extension and no ring. Its sink stores each value at the step
// that makes it: MONO (from the mono plane) and GAUSSIAN with the blur row,
// GRADIENT with the Sobel sums, NMS and THRESH with the NMS decision (the
// display magnitude carried from the Sobel step before), each a byte a lane
// (28 neighbouring columns a warp) under a predicate, inside a uniform branch
// on its output's pointer, so no divergent branch splits the unrolled walk.
// NMSQ (alone) is staged in shared memory, an int32 a lane, and copied out
// after the walk in 16-byte aligned blocks (copy_rows). On an H100 staging
// made NMSQ faster and the u8 outputs slower (a piece row of 56 bytes leaves
// up to 30 bytes of head and tail to byte stores), so only NMSQ is staged.
// The display magnitude's root comes from an approximate reciprocal square
// root with exact integer fix-ups (stage_chain.cuh), with no branch.
//
// Bound: one read of the frame and one write per requested output (6.2 MB
// + 2 MB a u8 buffer at 1080p, 4.95 us for all five at HBM rate); the chain
// is ~96 integer operations a pixel (3 us at 1080p).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "ff_walk.cuh"

namespace {

struct Outs {
  uint8_t* mono;
  uint8_t* blur;
  uint8_t* grad;
  uint8_t* nms;
  uint8_t* thresh;
  int* nmsq;
};

// A store of v to *p where pred holds: one predicated instruction, so that
// neither the value nor the address sinks into a branch around it.
__device__ __forceinline__ void store_if(uint8_t* p, int v, bool pred) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.u8 [%0], %1;\n}\n"
               ::"l"(p), "r"(v), "r"((int)pred));
}

// NMSQ's staging tile: the piece's PH x PW int32 values, a row of 4 PW bytes
// (a 16-byte multiple).
constexpr int NMSQ_RS = 4 * PW;
constexpr int NMSQ_TILE = PH * NMSQ_RS;

// One piece's staged NMSQ values to the plane: rows r < nr, n values a row,
// value (r, 0) at index e0 + r pitch of `out`. Each row goes out as the
// 16-byte aligned blocks of its address range: a full block is one vector
// store, the row's first and last blocks value by value where they hold
// values of the neighbouring pieces. Thread t takes blocks t, t + NTHR, ...
__device__ __forceinline__ void copy_rows(const uint8_t* tile, int* out, size_t e0, int pitch,
                                          int nr, int n) {
  constexpr int NBLK = NMSQ_RS / 16 + 1;  // blocks a row can touch
  for (int t = threadIdx.x; t < nr * NBLK; t += NTHR) {
    const int r = t / NBLK, k = t - r * NBLK;
    int* g = out + e0 + (size_t)r * pitch;  // the row's first value
    // The block's first value in the row (the row starts 4-byte aligned).
    const int s0 = 4 * k - (int)((reinterpret_cast<uintptr_t>(g) & 15) >> 2);
    if (s0 >= n || s0 + 4 <= 0) continue;
    const int* src = reinterpret_cast<const int*>(tile + r * NMSQ_RS);
    if (s0 >= 0 && s0 + 4 <= n) {
      *reinterpret_cast<int4*>(g + s0) = make_int4(src[s0], src[s0 + 1], src[s0 + 2], src[s0 + 3]);
    } else {
      for (int i = max(s0, 0); i < min(s0 + 4, n); ++i) g[i] = src[i];
    }
  }
}

// The sink of the stage buffers: this thread's column of one word row.
// Each requested u8 output is a uniform branch (on the launch's pointers)
// around its value and one predicated store (the row is stored: inside the
// frame, a column this lane emits); no divergent branch, so the unrolled
// walk stays long blocks of straight-line code. DISP: the display magnitude
// is made (GRADIENT or NMS requested). NMSQ (alone) is staged in the
// piece's tile instead, one st.shared a value at a constant offset, and
// copied out in 16-byte blocks after the walk (copy_rows).
template <int KS, int C, int DEPTH, bool DISP, bool NMSQ>
struct StageSink {
  static constexpr bool kNms = DEPTH == kMag, kEager = true;
  const Outs& o;
  size_t at;              // the column's pixel in row 0 of the word row
  int pitch;              // output row pitch (W)
  uint32_t rows;          // bit b: row b is stored
  const uint8_t* mono_c;  // the mono plane at the column, row 0
  int coeff, lo_c, hi_c;
  bool l2;
  uint32_t t0;            // NMSQ: shared address of the column's value in the tile's row 0
  bool emit;              // NMSQ: the lane emits its column (lanes 2..29)
  int disp = 0;           // display magnitude of the last Sobel row

  __device__ __forceinline__ bool stored(int b) const { return (rows >> b) & 1u; }
  __device__ __forceinline__ size_t row(int b) const { return at + (size_t)b * pitch; }
  __device__ __forceinline__ void copy_mono() {
#pragma unroll
    for (int b = 0; b < 32; ++b)
      store_if(o.mono + row(b), mono_c[b * Win<KS, C>::MWP], stored(b));
  }
  __device__ __forceinline__ void blur(int b, int v) {
    if (NMSQ || b < 0 || b >= 32) return;  // NMSQ alone; a halo row (b is a constant)
    if (o.mono) store_if(o.mono + row(b), mono_c[b * Win<KS, C>::MWP], stored(b));
    if (o.blur) store_if(o.blur + row(b), v, stored(b));
  }
  __device__ __forceinline__ void sobel(int b, int sx, int sy, bool in) {
    if (!DISP) return;
    disp = in ? display_magnitude(sx, sy, coeff, l2) : 0;
    if (b >= 0 && b < 32 && o.grad) store_if(o.grad + row(b), disp, stored(b));
  }
  __device__ __forceinline__ void nms(int b, bool keep, int g) {
    if (NMSQ) {  // the lanes that emit a column
      asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.shared.b32 [%0], %1;\n}\n"
                   ::"r"(t0 + b * NMSQ_RS), "r"(keep ? g : 0), "r"((int)emit) : "memory");
      return;
    }
    if (DISP && o.nms) store_if(o.nms + row(b), keep ? disp : 0, stored(b));
    if (o.thresh)
      store_if(o.thresh + row(b), keep ? (g > hi_c ? 255 : (g > lo_c ? 128 : 0)) : 0, stored(b));
  }
};

template <int KS, bool GRAY, bool TMA, int DEPTH, bool DISP, bool NMSQ>
__global__ void __launch_bounds__(NTHR) ff_stages_kernel(
    const uint8_t* __restrict__ frames, const int* __restrict__ thr, Outs o, PackGeo g,
    int grad_coeff, bool l2, bool ref_parity, int nstrip, int ncb, int npieces,
    const __grid_constant__ CUtensorMap tmap) {
  constexpr int C = GRAY ? 1 : 3;
  using W = Win<KS, C>;
  int lo_c = 0, hi_c = 0;
  if (o.thresh) class_bounds(thr[0], thr[1], grad_coeff, l2, ref_parity, &lo_c, &hi_c);
  const int coeff = ref_parity ? grad_coeff : 8;
  piece_loop<KS, GRAY, TMA>(frames, g, nstrip, ncb, npieces, &tmap,
                            [&](const Piece& p, const uint8_t* mono) {
    // NMSQ's tile: past the mono plane and the barrier, 16-byte aligned.
    const uint8_t* tile = mono + W::MR * W::MWP + 16;
    Walk<KS, C> w;
    w.begin(mono, p, g, l2);
    const int y0 = p.r0 + w.ybase, left = g.EH - y0;  // rows of the frame from this word row on
    const uint32_t rows = !w.out_lane || left <= 0 ? 0u : (left >= 32 ? ~0u : (1u << left) - 1);
    const int lane = threadIdx.x & 31;
    StageSink<KS, C, DEPTH, DISP, NMSQ> sink{
        o, ((size_t)p.z * g.EH + y0) * g.EW + w.xe, g.EW, rows, w.mcol + W::R * W::MWP + W::K2,
        coeff, lo_c, hi_c, l2, smem_addr(tile) + w.ybase * NMSQ_RS + 4 * (w.xe - p.c0),
        lane >= 2 && lane < 30};
    if constexpr (DEPTH == kMono)
      sink.copy_mono();
    else
      w.template run<DEPTH == kMag ? 2 : 1>(sink);
    if (NMSQ) {
      __syncthreads();  // the tile is whole
      copy_rows(tile, o.nmsq, ((size_t)p.z * g.EH + p.r0) * g.EW + p.c0, g.EW,
                min(PH, g.EH - p.r0), min(PW, g.EW - p.c0));
    }
  });
}

template <int KS, bool GRAY, bool TMA, int DEPTH, bool DISP, bool NMSQ>
cudaError_t launch_route(const uint8_t* fr, const int* thr, const Outs& o, int SB,
                         const PackGeo& g, int grad_coeff, bool l2, bool ref_parity, int device,
                         cudaStream_t stream, int* code) {
  constexpr int C = GRAY ? 1 : 3;
  static GridCache cache;
  return launch_pieces<KS, C, TMA>(cache, ff_stages_kernel<KS, GRAY, TMA, DEPTH, DISP, NMSQ>,
                                   Win<KS, C>::SMEM + (NMSQ ? NMSQ_TILE : 0), fr, SB, g, device,
                                   stream, code, thr, o, g, grad_coeff, l2, ref_parity);
}

// The kernel instance for the outputs asked for: the depth of the walk,
// whether it makes the display magnitude (MONO / GAUSSIAN / GRADIENT stop at
// the Sobel sums with it; at the NMS depth it is made for GRADIENT or NMS),
// and NMSQ alone.
template <int KS, bool GRAY, bool TMA>
cudaError_t launch_depth(const uint8_t* fr, const int* thr, const Outs& o, int SB,
                         const PackGeo& g, int grad_coeff, bool l2, bool ref_parity, int depth,
                         int device, cudaStream_t stream, int* code) {
  if (depth == kMono)
    return launch_route<KS, GRAY, TMA, kMono, false, false>(fr, thr, o, SB, g, grad_coeff, l2, ref_parity, device, stream, code);
  if (depth == kBlur)
    return launch_route<KS, GRAY, TMA, kBlur, true, false>(fr, thr, o, SB, g, grad_coeff, l2, ref_parity, device, stream, code);
  if (o.nmsq)
    return launch_route<KS, GRAY, TMA, kMag, false, true>(fr, thr, o, SB, g, grad_coeff, l2, ref_parity, device, stream, code);
  if (o.grad || o.nms)
    return launch_route<KS, GRAY, TMA, kMag, true, false>(fr, thr, o, SB, g, grad_coeff, l2, ref_parity, device, stream, code);
  return launch_route<KS, GRAY, TMA, kMag, false, false>(fr, thr, o, SB, g, grad_coeff, l2, ref_parity, device, stream, code);
}

template <int KS>
int launch(const uint8_t* fr, const int* thr, const Outs& o, int SB, const PackGeo& g,
           int channels, int grad_coeff, bool l2, bool ref_parity, int depth, int device,
           cudaStream_t stream) {
  return with_route(fr, g.src.SW, channels, [&](auto gray, auto tma, int* code) {
    return launch_depth<KS, decltype(gray)::value, decltype(tma)::value>(
        fr, thr, o, SB, g, grad_coeff, l2, ref_parity, depth, device, stream, code);
  });
}

}  // namespace

// nb frames of H x W pixels (channels 1 or 3), each with its pixel (0, 0)
// at global (oy, ox) of an IH x IW image (0, 0, H, W for whole frames);
// each non-null output is (nb, H, W).
extern "C" int cc_ff_stages(const void* frames, const void* thr, void* mono, void* blur,
                            void* grad, void* nms, void* thresh, void* nmsq, int nb, int H,
                            int W, int oy, int ox, int IH, int IW, int channels,
                            int kernel_size, int grad_coeff, int l2, int ref_parity, int device,
                            void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const Outs o{static_cast<uint8_t*>(mono),   static_cast<uint8_t*>(blur),
               static_cast<uint8_t*>(grad),   static_cast<uint8_t*>(nms),
               static_cast<uint8_t*>(thresh), static_cast<int*>(nmsq)};
  if (thresh && !thr) return cudaErrorInvalidValue;
  if (nmsq && (mono || blur || grad || nms || thresh)) return cudaErrorInvalidValue;  // NMSQ alone
  if (nb < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (channels != 1 && channels != 3) return cudaErrorInvalidValue;
  const int depth = (nms || thresh || nmsq) ? kMag : ((grad || blur) ? kBlur : kMono);
  // One tile a frame: its core is the frame, at the origin, with no
  // extension and no ring.
  const PackGeo g{Source{H, W, oy, ox, IH, IW}, 1, 1, oy, ox, H, W, 0, 0, H, W, 0, 0};
  auto fr = static_cast<const uint8_t*>(frames);
  auto t = static_cast<const int*>(thr);
  auto st = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return launch<3>(fr, t, o, nb, g, channels, grad_coeff, l2, ref_parity, depth, device, st);
    case 5: return launch<5>(fr, t, o, nb, g, channels, grad_coeff, l2, ref_parity, depth, device, st);
    case 7: return launch<7>(fr, t, o, nb, g, channels, grad_coeff, l2, ref_parity, depth, device, st);
    default: return cudaErrorInvalidValue;
  }
}
