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
// Design. One block per 32-row (one packed word-row) x TW-column piece of
// one (extended) tile; grid.z runs over the tiles of every source frame, so
// a batch is one launch. The chain stages the piece in shared memory
// (stage_tile), so it reads the frame once and never writes an intermediate
// plane to device memory. The class of each pixel is packed with a warp
// ballot: lane j of a warp holds row j of one column, so the ballot IS the
// packed word. Thresholds come from a device int32[2] (lo, hi), so a
// threshold change rebuilds nothing.
//
// Bound: one read of the 6.2 MB 1080p frame and a 0.5 MB write of the
// planes per frame; the stencil chain's ~96 integer ops per pixel bind
// (chip_smoke.py counts them: 3 us at 1080p, 52 us over the eight extended
// tiles of an 8K frame on a (1, 4, 2) mesh). The kernel is simple first:
// shared-memory staging with no async copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "stage_chain.cuh"

namespace {

struct PackGeo {
  Source src;         // source frames (SB of them) and the global image
  int nty, ntx;       // tiles per source frame
  int oy, ox;         // global coords of tile (0, 0)'s core
  int h_loc, w_loc;   // core size: the tile pitch
  int e_top, e_left;  // extension above / left of the core
  int EH, EW;         // extended tile; its planes are ceil(EH / 32) x EW words
  int ring_r, ring_c; // pollution ring zeroed at the extended tile's edges
};

template <int KS, bool GRAY>
__global__ void __launch_bounds__(256) ff_pack_kernel(
    const uint8_t* __restrict__ frames, const int* __restrict__ thr,
    uint32_t* __restrict__ fplanes, uint32_t* __restrict__ pplanes, PackGeo g,
    int grad_coeff, bool l2, bool ref_parity) {
  __shared__ Tile t;
  const int tile = blockIdx.z;
  const int per_frame = g.nty * g.ntx;
  const size_t b = tile / per_frame;
  const int ti = (tile / g.ntx) % g.nty, tj = tile % g.ntx;
  const uint8_t* frame = frames + b * g.src.SH * g.src.SW * (GRAY ? 1 : 3);
  const size_t plane = (size_t)((g.EH + 31) / 32) * g.EW;
  uint32_t* fplane = fplanes + tile * plane;
  uint32_t* pplane = pplanes + tile * plane;
  const int ey = g.oy + ti * g.h_loc - g.e_top;  // global coords of extended (0, 0)
  const int ex = g.ox + tj * g.w_loc - g.e_left;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  stage_tile<KS, GRAY>(frame, g.src, ey + r0, ex + c0, l2, kMag, t);

  // NMS + threshold class per pixel; lane = row within the word.
  int lo_c, hi_c;
  class_bounds(thr[0], thr[1], grad_coeff, l2, ref_parity, &lo_c, &hi_c);
  const int lane = threadIdx.x;
  const int y = r0 + lane;
  const bool row_ok = y < g.EH && y >= g.ring_r && y < g.EH - g.ring_r;
  for (int cc = threadIdx.y; cc < TW; cc += blockDim.y) {
    const int x = c0 + cc;
    int cls = 0;  // 0 none, 1 candidate, 2 final
    if (row_ok && x < g.EW && x >= g.ring_c && x < g.EW - g.ring_c &&
        in_image(g.src, ey + y, ex + x)) {
      const Pixel px = pixel_at(t, lane, cc);
      if (px.keep) cls = px.g > hi_c ? 2 : (px.g > lo_c ? 1 : 0);
    }
    uint32_t fw = __ballot_sync(0xffffffffu, cls == 2);
    uint32_t pw = __ballot_sync(0xffffffffu, cls == 1);
    if (lane == 0 && x < g.EW) {
      fplane[(size_t)blockIdx.y * g.EW + x] = fw;
      pplane[(size_t)blockIdx.y * g.EW + x] = pw;
    }
  }
}

template <int KS>
cudaError_t launch(const void* frames, const void* thr, void* f, void* p, int SB,
                   const PackGeo& g, int channels, int grad_coeff, bool l2, bool ref_parity,
                   cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((g.EW + TW - 1) / TW, (g.EH + TH - 1) / TH, SB * g.nty * g.ntx);
  auto fr = static_cast<const uint8_t*>(frames);
  auto t = static_cast<const int*>(thr);
  auto fp = static_cast<uint32_t*>(f);
  auto pp = static_cast<uint32_t*>(p);
  if (channels == 1)
    ff_pack_kernel<KS, true><<<grid, block, 0, stream>>>(fr, t, fp, pp, g, grad_coeff, l2, ref_parity);
  else
    ff_pack_kernel<KS, false><<<grid, block, 0, stream>>>(fr, t, fp, pp, g, grad_coeff, l2, ref_parity);
  return cudaGetLastError();
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
  const long long tiles = (long long)SB * g.nty * g.ntx;
  if (tiles < 1 || tiles > 65535 || g.EH < 1 || g.EW < 1) return cudaErrorInvalidValue;  // grid.z
  auto s = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return launch<3>(frames, thr, f, p, SB, g, channels, grad_coeff, l2, ref_parity, s);
    case 5: return launch<5>(frames, thr, f, p, SB, g, channels, grad_coeff, l2, ref_parity, s);
    case 7: return launch<7>(frames, thr, f, p, SB, g, channels, grad_coeff, l2, ref_parity, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
