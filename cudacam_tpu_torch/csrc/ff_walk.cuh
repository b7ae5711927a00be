// The piece machinery of the feed-forward kernels, shared by ff_pack (frames
// -> packed FINAL / CANDIDATE planes) and ff_stages (frames -> stage
// buffers): the geometry of a launch, its pieces and their persistent order,
// the asynchronous window loads (TMA or cp.async), the mono plane, and the
// column walk that runs the stencil chain of stage_chain.cuh down a piece.
//
// Geometry. A launch covers a grid of nty x ntx tiles per source frame; tile
// (i, j) owns the h_loc x w_loc core at global (oy + i h_loc, ox + j w_loc)
// and works on its EXTENDED tile, EH x EW pixels starting e_top rows above
// and e_left columns left of the core. Zero padding is pinned to the global
// image; a pollution ring (ring_r rows, ring_c columns at the extended
// tile's edges) counts no class. A whole frame is one tile with no extension
// and no ring; a tile of a sharded frame for the display stages is one tile
// whose pixel (0, 0) lies at a global origin.
//
// Pieces. Work items are 64-row x 56-column pieces of an extended tile (two
// word rows). A persistent grid of whole waves (blocks a SM x SMs, from the
// occupancy calculator) walks them in order (piece, then frame tile), so no
// partial wave trails the launch. A block stages a piece's source window
// (the piece + its halo) in shared memory with an asynchronous copy: where
// the frame's base and row pitch are 16-byte aligned, one TMA load (a box
// must start 16-byte aligned: another start raises an illegal instruction on
// the H100; its out-of-bounds zero fill is the zero of a pixel outside the
// source), else 16-byte cp.async chunks row by row. The next piece's copy is
// issued as soon as the current window became mono, so it lands while the
// block walks the current piece. Mono is converted once a pixel into a uint8
// plane.
//
// The walk. Each thread walks one column of one word row of the piece (two
// row groups of warps, 32 rows + the halo each) with vertical sliding
// windows, fully unrolled: the Gaussian's row sums (Gauss<KS>), the blur, the
// Sobel sums from the blur of its lane neighbours (shuffles), the magnitude
// and the NMS from three rows of magnitudes at its lane neighbours. Lanes 0,
// 1, 30, 31 only feed their neighbours: a warp emits 28 columns. The walk
// hands each value to a sink at the step that makes it (the blur of row
// b at step b + 2, its Sobel sums at b + 3, its NMS at b + 4); ff_pack's sink
// packs the classes, ff_stages' sink stores the stage buffers. The host side
// (the tensor map, the persistent grid, the launch, the choice of kernel
// instance by channels and load route) is shared too.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "stage_chain.cuh"

namespace {

struct PackGeo {
  Source src;         // source frames (SB of them) and the global image
  int nty, ntx;       // tiles per source frame
  int oy, ox;         // global coords of tile (0, 0)'s core
  int h_loc, w_loc;   // core size: the tile pitch
  int e_top, e_left;  // extension above / left of the core
  int EH, EW;         // extended tile; its planes are ceil(EH / 32) x EW words
  int ring_r, ring_c; // pollution ring at the extended tile's edges
};

constexpr int PH = 64;             // piece rows: two packed word rows
constexpr int NWARP = 2;           // warps side by side (a row group's)
constexpr int LANES_OUT = 28;      // columns a warp emits: lanes 2..29
constexpr int PW = NWARP * LANES_OUT;  // piece columns
constexpr int NRG = PH / 32;       // row groups: each walks one word row
constexpr int NTHR = NRG * NWARP * 32;

// The staged window of a piece for kernel size KS and C channels: MR rows
// (the piece + R halo rows each side), MW pixels a row (the 32 lanes of
// each warp, KS/2 more each side), its bytes in rows of SP (room for a
// 16-byte misalignment, a multiple of 16: TMA box rows and cp.async chunks),
// the mono plane in rows of MWP.
template <int KS, int C>
struct Win {
  static constexpr int K2 = KS / 2;
  static constexpr int R = K2 + 2;
  static constexpr int MR = PH + 2 * R;
  static constexpr int MW = PW + 4 + 2 * K2;
  static constexpr int SP = (C * MW + 15 + 15) / 16 * 16;
  static constexpr int MWP = (MW + 15) / 16 * 16;
  static constexpr int STAGE = MR * SP;
  static constexpr int SMEM = 128 + STAGE + MR * MWP + 16;  // + alignment, the mbarrier
};

// A piece: frame tile z (frame b, tile (ti, tj)), rows r0.. and columns
// c0.. of its extended tile, whose pixel (0, 0) lies at global (ey, ex).
struct Piece {
  int b, z, r0, c0, ey, ex;
};

__device__ __forceinline__ Piece piece_at(int t, const PackGeo& g, int nstrip, int ncb) {
  Piece p;
  const int per_z = nstrip * ncb;
  p.z = t / per_z;
  const int rem = t - p.z * per_z;
  const int strip = rem / ncb;
  p.r0 = strip * PH;
  p.c0 = (rem - strip * ncb) * PW;
  const int per_frame = g.nty * g.ntx;
  p.b = p.z / per_frame;
  const int ti = (p.z / g.ntx) % g.nty, tj = p.z % g.ntx;
  p.ey = g.oy + ti * g.h_loc - g.e_top;
  p.ex = g.ox + tj * g.w_loc - g.e_left;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Source-local coordinates of the window's pixel (0, 0).
template <int KS>
__device__ __forceinline__ void window_origin(const Piece& p, const Source& s, int* ly0, int* lx0) {
  *ly0 = p.ey + p.r0 - Win<KS, 1>::R - s.sy;
  *lx0 = p.ex + p.c0 - 2 - KS / 2 - s.sx;
}

// Issue the asynchronous copy of piece p's window into `stage`.
template <int KS, bool GRAY, bool TMA>
__device__ __forceinline__ void issue_window(const uint8_t* __restrict__ frames, const CUtensorMap* tmap,
                                             const Piece& p, const Source& s, uint8_t* stage,
                                             uint32_t bar) {
  constexpr int C = GRAY ? 1 : 3;
  using W = Win<KS, C>;
  int ly0, lx0;
  window_origin<KS>(p, s, &ly0, &lx0);
  if (TMA) {
    if (threadIdx.x == 0) {
      // The window from the 16-byte boundary at or left of its first byte:
      // a box must start 16-byte aligned (on the H100 another start raises
      // an illegal instruction), and the row pitch is a multiple of 16.
      const int cw = ((C * lx0) & ~15) / 4;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(W::STAGE)
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(stage)),
          "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(cw), "r"(ly0), "r"(p.b)
          : "memory");
    }
  } else {
    // 16-byte chunks from the aligned address at or before each row's first
    // pixel; only chunks that hold bytes of the row are copied (they lie in
    // the row's allocation), the rest of the window is masked at conversion.
    const long long pitch = (long long)C * s.SW;
    const uint8_t* fb = frames + (size_t)p.b * s.SH * pitch;
    constexpr int NCH = W::SP / 16;
    for (int i = threadIdx.x; i < W::MR * NCH; i += NTHR) {
      const int r = i / NCH, q = i - r * NCH;
      const int ly = ly0 + r;
      if (ly < 0 || ly >= s.SH) continue;
      const uintptr_t row = reinterpret_cast<uintptr_t>(fb) + (uintptr_t)(ly * pitch);
      const uintptr_t chunk = ((row + (intptr_t)lx0 * C) & ~(uintptr_t)15) + 16 * (uintptr_t)q;
      if (chunk + 16 <= row || chunk >= row + (uintptr_t)pitch) continue;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(stage + r * W::SP + 16 * q)),
                   "l"(chunk)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

template <bool TMA>
__device__ __forceinline__ void wait_window(uint32_t bar, uint32_t parity) {
  if (TMA)
    mbar_wait(bar, parity);
  else
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The staged window -> the mono plane: zero outside the image and outside
// the source.
template <int KS, bool GRAY, bool TMA>
__device__ __forceinline__ void to_mono(const uint8_t* __restrict__ frames, const Piece& p,
                                        const Source& s, const uint8_t* stage, uint8_t* mono) {
  constexpr int C = GRAY ? 1 : 3;
  using W = Win<KS, C>;
  int ly0, lx0;
  window_origin<KS>(p, s, &ly0, &lx0);
  const int gy0 = ly0 + s.sy, gx0 = lx0 + s.sx;
  const long long pitch = (long long)C * s.SW;
  const uint8_t* fb = frames + (size_t)p.b * s.SH * pitch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < W::MR; r += NTHR / 32) {
    const int gy = gy0 + r, ly = ly0 + r;
    const bool row_in = gy >= 0 && gy < s.IH && ly >= 0 && ly < s.SH;
    int off = (C * lx0) & 15;
    if (!TMA && row_in)
      off = (int)((reinterpret_cast<uintptr_t>(fb) + (uintptr_t)(ly * pitch) + (intptr_t)lx0 * C) & 15);
    const uint8_t* srow = stage + r * W::SP + off;
    for (int j = lane; j < W::MW; j += 32) {
      const int gx = gx0 + j, lx = lx0 + j;
      int v = 0;
      if (row_in && gx >= 0 && gx < s.IW && lx >= 0 && lx < s.SW) {
        if (GRAY) {
          v = srow[j];
        } else {
          const uint8_t* px = srow + 3 * j;
          v = (px[0] * 7 + px[1] * 38 + px[2] * 19) >> 6;
        }
      }
      mono[r * W::MWP + j] = (uint8_t)v;
    }
  }
}

// One thread's column of one word row of a piece (row group rg: piece rows
// 32 rg .. 32 rg + 31), walked down the window's rows. Step i makes blur
// row yb = 32 rg - 2 + i from the Gaussian's window, from step 2 on the
// Sobel sums of row yb - 1 (and, where the sink wants the NMS, its
// magnitude), from step 4 on the NMS of row yb - 2. The stages are peeled
// and the steps unrolled, so the windows shift by renaming registers and
// every row index is a constant.
//
// A sink takes, with b the row's bit in the word row (a constant; values of
// rows outside 0..31 are the halo's, and a sink drops them):
//   blur(b, v)                  the blur of row b (0 outside the image)
//   nms(b, keep, g)             row b's NMS decision and comparable magnitude
//                               (keep is false where its class does not count;
//                               a sink with kEager false hears of kept pixels only)
//   sobel(b, sx, sy, in_image)  row b's Sobel sums (after nms(b - 1, ...))
// and says with kNms whether the walk runs the magnitude and the NMS, and
// with kEager whether the NMS test runs on every row, its result a value
// with no branch around it (the stage sink's choice), or only where the
// row's class counts, the sink called for kept pixels alone (the pack's).
template <int KS, int C>
struct Walk {
  using W = Win<KS, C>;
  using G = Gauss<KS>;
  const uint8_t* mcol;   // the leftmost tap of this column in the mono plane
  uint64_t valid;        // bit i: blur row ybase - 2 + i lies in the image (and the column)
  int ybase;             // this row group's first piece row
  int xe;                // this thread's extended-tile column
  bool out_lane;         // the column is one this lane emits: lanes 2..29, inside EW
  bool col_in;           // the column lies in the image
  bool l2;
  uint32_t row_mask = 0; // rows of the word whose class counts
  int hw[KS][G::kHN];    // the Gaussian's row sums, oldest first
  int d0 = 0, d1 = 0, s0 = 0, s1 = 0;  // Sobel row terms of the two rows before
  int gl0 = 0, gc0 = 0, gr0 = 0, gl1 = 0, gc1 = 0, gr1 = 0;  // magnitudes, rows n-1, n
  int sxp = 0, syp = 0;  // Sobel sums of row n

  // The walk of this thread in piece p, whose window's mono plane is `mono`.
  __device__ __forceinline__ void begin(const uint8_t* mono, const Piece& p, const PackGeo& g,
                                        bool use_l2) {
    const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warp = wid % NWARP, rg = wid / NWARP;
    xe = p.c0 - 2 + warp * LANES_OUT + lane;
    const int gx = p.ex + xe;
    const Source& s = g.src;
    ybase = rg * 32;
    // Rows of this group's window: mono rows from 32 rg (tile row 32 rg - R).
    mcol = mono + (size_t)ybase * W::MWP + warp * LANES_OUT + lane;
    col_in = gx >= 0 && gx < s.IW;
    valid = 0;
    if (col_in) {
      const int gy = p.ey + p.r0 + ybase - 2;  // global row of step 0's blur row
      for (int i = 0; i < 36; ++i)
        if (gy + i >= 0 && gy + i < s.IH) valid |= 1ull << i;
    }
    l2 = use_l2;
    out_lane = lane >= 2 && lane < 30 && xe < g.EW;
    // The rows whose class counts: inside the extended tile, off the ring,
    // in the image; the column likewise.
    if (out_lane && xe >= g.ring_c && xe < g.EW - g.ring_c && col_in) {
      for (int b = 0; b < 32; ++b) {
        const int ye = p.r0 + ybase + b;
        if (ye < g.EH && ye >= g.ring_r && ye < g.EH - g.ring_r && p.ey + ye >= 0 &&
            p.ey + ye < s.IH)
          row_mask |= 1u << b;
      }
    }
  }

  __device__ __forceinline__ void row_sums(int m, int* h) const {
    G::row(mcol + m * W::MWP, h);
  }

  template <int STAGE, class Sink>  // 0: blur; 1: + Sobel (and magnitude); 2: + NMS
  __device__ __forceinline__ void step(int i, Sink& sink) {
#pragma unroll
    for (int r = 0; r + 1 < KS; ++r)
#pragma unroll
      for (int k = 0; k < G::kHN; ++k) hw[r][k] = hw[r + 1][k];
    // The window's mono rows run from mcol's row (tile row ybase - R): the
    // one that completes blur row yb's Gaussian is i + KS - 1.
    row_sums(i + KS - 1, hw[KS - 1]);
    const int blur = ((valid >> i) & 1u) ? G::column(hw) : 0;
    sink.blur(i - 2, blur);
    const int bl = __shfl_up_sync(0xffffffffu, blur, 1);
    const int br = __shfl_down_sync(0xffffffffu, blur, 1);
    const int d2 = br - bl, s2 = bl + 2 * blur + br;
    if (STAGE >= 1) {
      const int sx = d0 + 2 * d1 + d2, sy = s0 - s2;
      const bool in = (valid >> (i - 1)) & 1u;
      if (Sink::kNms) {
        const int gm = in ? (l2 ? sx * sx + sy * sy : abs(sx) + abs(sy)) : 0;
        const int gl = __shfl_up_sync(0xffffffffu, gm, 1);
        const int gr = __shfl_down_sync(0xffffffffu, gm, 1);
        if (STAGE == 2) {
          const int bit = i - 4;  // row yn = ybase + bit
          const bool in_row = (row_mask >> bit) & 1u;
          if constexpr (Sink::kEager)
            sink.nms(bit, in_row & nms_keep(sxp, syp, gl0, gc0, gr0, gl1, gc1, gr1, gl, gm, gr),
                     gc1);
          else if (in_row && nms_keep(sxp, syp, gl0, gc0, gr0, gl1, gc1, gr1, gl, gm, gr))
            sink.nms(bit, true, gc1);
        }
        gl0 = gl1; gc0 = gc1; gr0 = gr1;
        gl1 = gl; gc1 = gm; gr1 = gr;
      }
      sink.sobel(i - 3, sx, sy, in);
      sxp = sx; syp = sy;
    }
    d0 = d1; d1 = d2;
    s0 = s1; s1 = s2;
  }

  // The whole walk up to stage TOP: the Gaussian's window primed, then the
  // steps until row 31's value of that stage is out.
  template <int TOP, class Sink>
  __device__ __forceinline__ void run(Sink& sink) {
#pragma unroll
    for (int r = 0; r + 1 < KS; ++r) row_sums(r, hw[r + 1]);
    step<0>(0, sink);
    step<0>(1, sink);
    step<(TOP < 1 ? TOP : 1)>(2, sink);
    step<(TOP < 1 ? TOP : 1)>(3, sink);
#pragma unroll
    for (int i = 4; i < 34 + TOP; ++i) step<TOP>(i, sink);
  }
};

// The block's loop over its pieces: block i takes pieces i, i + grid, ...;
// each piece's window lands (the next one's copy issued once this one is
// mono), then walk(piece, mono) runs on every thread.
template <int KS, bool GRAY, bool TMA, class WalkFn>
__device__ __forceinline__ void piece_loop(const uint8_t* __restrict__ frames, const PackGeo& g,
                                           int nstrip, int ncb, int npieces,
                                           const CUtensorMap* tmap, WalkFn walk) {
  constexpr int C = GRAY ? 1 : 3;
  using W = Win<KS, C>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // TMA writes to 128-byte aligned shared memory.
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  uint8_t* stage = smem;
  uint8_t* mono = smem + W::STAGE;
  uint64_t* barp = reinterpret_cast<uint64_t*>(smem + W::STAGE + W::MR * W::MWP);
  const uint32_t bar = smem_addr(barp);
  if (TMA && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int t = blockIdx.x;
  if (t < npieces)
    issue_window<KS, GRAY, TMA>(frames, tmap, piece_at(t, g, nstrip, ncb), g.src, stage, bar);
  for (uint32_t parity = 0; t < npieces; parity ^= 1) {
    const Piece p = piece_at(t, g, nstrip, ncb);
    wait_window<TMA>(bar, parity);
    to_mono<KS, GRAY, TMA>(frames, p, g.src, stage, mono);
    __syncthreads();  // mono is whole; the stage is free for the next window
    const int tn = t + gridDim.x;
    if (tn < npieces)
      issue_window<KS, GRAY, TMA>(frames, tmap, piece_at(tn, g, nstrip, ncb), g.src, stage, bar);
    walk(p, mono);
    __syncthreads();  // every column walked before mono is overwritten
    t = tn;
  }
}

// cuTensorMapEncodeTiled, found through the CUDA runtime (the
// library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* out) {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  static cudaError_t err = cudaSuccess;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && (q != cudaDriverEntryPointSuccess || !p)) err = cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  });
  *out = fn;
  return err;
}

// Codes past this report a failed cuTensorMapEncodeTiled (the CUresult
// added), apart from the runtime's own codes (cc_error_string, ff_pack.cu).
constexpr int kEncodeError = 100000;

bool tma_route(const void* frames, int SW, int channels) {
  return reinterpret_cast<uintptr_t>(frames) % 16 == 0 && ((long long)channels * SW) % 16 == 0;
}

// The tensor map of the TMA route: the SB frames as (SB, SH, C SW / 4)
// 32-bit words; a box is a window's MR rows of SP bytes of one frame.
// Out-of-bounds words read 0. A failed encode sets *code.
template <int KS, int C>
cudaError_t frames_map(const uint8_t* fr, int SB, const Source& s, CUtensorMap* map, int* code) {
  using W = Win<KS, C>;
  EncodeTiled encode;
  cudaError_t e = encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)C * s.SW / 4, (cuuint64_t)s.SH, (cuuint64_t)SB};
  const cuuint64_t strides[2] = {(cuuint64_t)C * s.SW, (cuuint64_t)C * s.SW * s.SH};
  const cuuint32_t box[3] = {W::SP / 4, W::MR, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<uint8_t*>(fr), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) *code = kEncodeError + (int)r;
  return cudaSuccess;
}

// The persistent grid of a kernel (NTHR threads, smem bytes of dynamic
// shared memory) for `pieces` pieces on `device`: whole waves of the blocks
// a SM the occupancy calculator allows, or fewer blocks where there are
// fewer pieces. The caller keeps one cache per kernel instance.
struct GridCache {
  std::mutex mu;
  int per_sm[64] = {0};
  int sms[64] = {0};
};

template <class Kern>
cudaError_t persistent_grid(GridCache& c, Kern kern, int smem, int device, long long pieces,
                            int* grid) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (pieces > 0x7fffffff) return cudaErrorInvalidValue;
  {
    std::lock_guard<std::mutex> lock(c.mu);
    if (!c.per_sm[device]) {
      cudaError_t e = cudaDeviceGetAttribute(&c.sms[device], cudaDevAttrMultiProcessorCount, device);
      if (e == cudaSuccess && smem > 48 * 1024)
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm[device], kern, NTHR, smem);
      if (e != cudaSuccess) return e;
      if (c.per_sm[device] < 1) return cudaErrorInvalidConfiguration;
    }
  }
  const long long full = (long long)c.per_sm[device] * c.sms[device];
  *grid = (int)(pieces < full ? pieces : full);
  return cudaSuccess;
}

// One launch of `kern` over the pieces of SB source frames `fr` with
// geometry g: its persistent grid (`cache`: one a kernel instance), the
// tensor map on the TMA route, then kern(fr, args..., nstrip, ncb, pieces,
// map). A failed encode sets *code.
template <int KS, int C, bool TMA, class Kern, class... Args>
cudaError_t launch_pieces(GridCache& cache, Kern kern, int smem, const uint8_t* fr, int SB,
                          const PackGeo& g, int device, cudaStream_t stream, int* code,
                          Args... args) {
  const int nstrip = (g.EH + PH - 1) / PH, ncb = (g.EW + PW - 1) / PW;
  const long long pieces = (long long)SB * g.nty * g.ntx * nstrip * ncb;
  int grid;
  cudaError_t e = persistent_grid(cache, kern, smem, device, pieces, &grid);
  if (e != cudaSuccess) return e;
  CUtensorMap map = {};
  if (TMA) {
    e = frames_map<KS, C>(fr, SB, g.src, &map, code);
    if (e != cudaSuccess || *code) return e;
  }
  kern<<<grid, NTHR, smem, stream>>>(fr, args..., nstrip, ncb, (int)pieces, map);
  return cudaGetLastError();
}

// f(gray, tma) with std::bool_constant arguments for frames of `channels`
// bytes a pixel, SW pixels a row, at `frames`: the kernel instance's
// channels and load route. Returns f's code, or the encode's (*code).
template <class F>
int with_route(const void* frames, int SW, int channels, F f) {
  const bool tma = tma_route(frames, SW, channels);
  int code = 0;
  cudaError_t e;
  if (channels == 1)
    e = tma ? f(std::true_type{}, std::true_type{}, &code) : f(std::true_type{}, std::false_type{}, &code);
  else
    e = tma ? f(std::false_type{}, std::true_type{}, &code) : f(std::false_type{}, std::false_type{}, &code);
  return code ? code : (int)e;
}

}  // namespace
