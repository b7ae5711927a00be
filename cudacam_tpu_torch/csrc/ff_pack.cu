// ff_pack: raw frames -> packed FINAL / CANDIDATE hysteresis planes, for whole
// frames or for the halo-extended tiles of a sharded frame.
//
// Replaces the front half of the TPU megakernel (cudacam_tpu/ops/pallas/
// megakernel.py: _kernel / _ingest_chain_pack, and _kernel_batched for a
// batch), and of its export mode for sharded tiles (canny_mega_export :607 ->
// _mega_call :569 with export_only): the stage chain of stage_chain.cuh ->
// strict double threshold against scalar bounds -> vertical bit pack (bit j
// of word [k, c] = pixel [32k + j, c]).
//
// Tiles (export mode). A launch covers a grid of nty x ntx tiles per source
// frame; tile (i, j) owns the h_loc x w_loc core at global (oy + i h_loc,
// ox + j w_loc) and packs its EXTENDED tile, EH x EW pixels starting e_top
// rows above and e_left columns left of the core, so its halo slots start
// with the neighbours' exact state. Zero padding is pinned to the global
// image, and the pollution ring (ring_r rows, ring_c columns at the extended
// tile's edges, on axes that have neighbours) is zeroed, as the TPU kernel's
// ring mask does: there a halo-extended copy ends and its stencils read
// zeros. A whole frame is one tile with no extension and no ring. On one
// card the source is the whole frame batch in device memory, read at each
// tile's origin; no tile is copied first.
//
// Bound: one read of the 6.2 MB 1080p frame and a 0.5 MB write of the
// planes per frame; the stencil chain's ~96 integer operations a pixel bind
// (chip_smoke.py counts them: 3 us at 1080p, 52 us over the eight extended
// tiles of an 8K frame on a (1, 4, 2) mesh).
//
// Design for Hopper: the pieces, window loads and column walk of
// ff_walk.cuh (64 x 56 pieces on a persistent grid; a TMA box or 16-byte
// cp.async chunks a window, the route: cc_ff_pack_route; one thread a
// column of a word row, sliding windows in registers, lane shuffles for the
// horizontal neighbours). Its sink holds a whole packed word of its column
// (32 rows), so the pack is a shift-or per row and one coalesced store a
// word; thresholds come from a device int32[2] (lo, hi), so a threshold
// change rebuilds nothing.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "device_guard.cuh"
#include "ff_walk.cuh"

namespace {

// The sink of the pack: a kept pixel's class bits, one word of 32 rows (the
// walk calls it for kept pixels only: kEager false).
struct PackSink {
  static constexpr bool kNms = true, kEager = false;
  int lo_c, hi_c;
  uint32_t fw = 0, pw = 0;
  __device__ __forceinline__ void blur(int, int) {}
  __device__ __forceinline__ void sobel(int, int, int, bool) {}
  __device__ __forceinline__ void nms(int bit, bool, int g) {  // kept pixels only
    fw |= (uint32_t)(g > hi_c) << bit;
    pw |= (uint32_t)(g <= hi_c && g > lo_c) << bit;
  }
};

template <int KS, bool GRAY, bool TMA>
__global__ void __launch_bounds__(NTHR) ff_pack_kernel(
    const uint8_t* __restrict__ frames, const int* __restrict__ thr,
    uint32_t* __restrict__ fplanes, uint32_t* __restrict__ pplanes, PackGeo g,
    int grad_coeff, bool l2, bool ref_parity, int nstrip, int ncb, int npieces,
    const __grid_constant__ CUtensorMap tmap) {
  constexpr int C = GRAY ? 1 : 3;
  int lo_c, hi_c;
  class_bounds(thr[0], thr[1], grad_coeff, l2, ref_parity, &lo_c, &hi_c);
  const size_t plane = (size_t)((g.EH + 31) / 32) * g.EW;
  piece_loop<KS, GRAY, TMA>(frames, g, nstrip, ncb, npieces, &tmap,
                            [&](const Piece& p, const uint8_t* mono) {
    Walk<KS, C> w;
    w.begin(mono, p, g, l2);
    PackSink sink{lo_c, hi_c};
    w.template run<2>(sink);
    const int k = (p.r0 + w.ybase) >> 5;
    if (w.out_lane && k < (g.EH + 31) / 32) {
      fplanes[p.z * plane + (size_t)k * g.EW + w.xe] = sink.fw;
      pplanes[p.z * plane + (size_t)k * g.EW + w.xe] = sink.pw;
    }
  });
}

template <int KS>
int launch(const void* frames, const void* thr, void* f, void* p, int SB, const PackGeo& g,
           int channels, int grad_coeff, bool l2, bool ref_parity, int device,
           cudaStream_t stream) {
  auto fr = static_cast<const uint8_t*>(frames);
  auto t = static_cast<const int*>(thr);
  auto fp = static_cast<uint32_t*>(f);
  auto pp = static_cast<uint32_t*>(p);
  return with_route(frames, g.src.SW, channels, [&](auto gray, auto tma, int* code) {
    constexpr bool GRAY = decltype(gray)::value, TMA = decltype(tma)::value;
    constexpr int C = GRAY ? 1 : 3;
    static GridCache cache;
    return launch_pieces<KS, C, TMA>(cache, ff_pack_kernel<KS, GRAY, TMA>, Win<KS, C>::SMEM, fr,
                                     SB, g, device, stream, code, t, fp, pp, g, grad_coeff, l2,
                                     ref_parity);
  });
}

}  // namespace

// geo: 18 ints, PackGeo's fields in order (SH, SW, sy, sx, IH, IW, nty, ntx,
// oy, ox, h_loc, w_loc, e_top, e_left, EH, EW, ring_r, ring_c). Writes
// (SB * nty * ntx, ceil(EH / 32), EW) planes.
extern "C" int cc_ff_pack(const void* frames, const void* thr, void* f, void* p, int SB,
                          const int* geo, int channels, int kernel_size, int grad_coeff,
                          int l2, int ref_parity, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const PackGeo g{Source{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5]},
                  geo[6], geo[7], geo[8], geo[9], geo[10], geo[11], geo[12], geo[13],
                  geo[14], geo[15], geo[16], geo[17]};
  if (SB < 1 || g.nty < 1 || g.ntx < 1 || g.EH < 1 || g.EW < 1) return cudaErrorInvalidValue;
  if (channels != 1 && channels != 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return launch<3>(frames, thr, f, p, SB, g, channels, grad_coeff, l2, ref_parity, device, s);
    case 5: return launch<5>(frames, thr, f, p, SB, g, channels, grad_coeff, l2, ref_parity, device, s);
    case 7: return launch<7>(frames, thr, f, p, SB, g, channels, grad_coeff, l2, ref_parity, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// The load route cc_ff_pack takes for frames at `frames`, SW pixels of
// `channels` bytes a row: 1 for the TMA load (16-byte aligned base and row
// pitch), 0 for 16-byte cp.async chunks.
extern "C" int cc_ff_pack_route(const void* frames, int SW, int channels) {
  return tma_route(frames, SW, channels) ? 1 : 0;
}

extern "C" const char* cc_error_string(int code) {
  if (code >= kEncodeError) {
    static thread_local char buf[96];
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
