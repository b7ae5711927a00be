// Hysteresis rounds on the packed planes, and the unpack to the edge map.
//
// Replaces the back half of the TPU megakernel (cudacam_tpu/ops/pallas/
// megakernel.py: _phase1_finalize, _unpack_out) and its phase-2
// continuation (_cont_kernel / _cont_call). Both phases execute the round
// schedule of cudacam_tpu/ops/bitpack.py::_make_ops exactly: the same
// dilate_steps with bitpack's default carry cadence (every 8th step exact
// across words) and an exact last step, the same 8 scan directions in the
// same order, the same round counting. So an output cut off by the
// max_iters cap is the JAX package's, bit for bit.
//
// Design: one cooperative persistent kernel per phase (route (a)), launched
// with cudaLaunchCooperativeKernel on a grid sized from the occupancy
// calculator, with grid.sync() between the steps that read other blocks'
// words. The 1080p planes are 34 x 1920 words (261 KB each): they fit L2 but
// not one SM's shared memory, and Hopper blocks carry nothing between them,
// so the state lives in device memory (L2) between barriers.
//
// * A round's dilate_steps dilations run in shared memory per tile (TR word
//   rows x TC columns core) with a halo as deep as the steps: dilate_steps
//   columns and ceil(dilate_steps / 32) word rows. The core of a tile after
//   the steps is exact; the halo is scratch. One grid barrier per round.
// * The 8 directional scans propagate across the whole frame, so each
//   doubling step (out = g | (pp & shifted(g))) is one pass over the plane
//   followed by a grid barrier, on ping-pong buffers (Jacobi: every step
//   reads only the previous step's words).
// * The per-round "changed" flag rotates over three slots: a slot is
//   cleared one round before it is written and two barriers after its last
//   read, so no reset races a write or a read.
// * Phase 1 writes flags[0..1] = (round count, still growing); phase 2 reads
//   them on the device and returns at once when the frame converged, so the
//   host never reads the flag back. Phase 2 writes flags[2..3].
//
// * The occupancy query and the shared-memory opt-in run once per (phase,
//   device, dilate_steps), on the first launch; later launches reuse the grid.
//
// Bound: grid barriers and L2 latency, not bytes or operations: a round moves
// a few hundred KB through L2 and does ~10 integer ops per word per step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TR = 4;    // tile core: packed word rows
constexpr int TC = 128;  // tile core: columns
constexpr int CARRY_EVERY = 8;  // bitpack._CARRY_EVERY: every 8th dilation step is exact
constexpr int MAX_DILATE_STEPS = 256;  // the tile halo (steps columns) fits shared memory

struct Params {
  uint32_t* f;        // (hw, w) FINAL plane, updated in place
  const uint32_t* p;  // (hw, w) CANDIDATE plane
  uint32_t* buf[4];   // scratch planes
  int* chg;           // [3] per-round change flags
  int* flags;         // [4]: phase-1 (it, growing), final (it, growing)
  int hw, w, h;       // plane rows, plane columns (= image columns), image rows
  int dilate_steps, cap;
  int halo_r, halo_c;  // tile halo: word rows, columns
};

__device__ __forceinline__ uint32_t ld(const uint32_t* x, int k, int c, int hw, int w) {
  return (k >= 0 && k < hw && c >= 0 && c < w) ? __ldcg(x + k * w + c) : 0u;
}

// bitpack._shift_px(x, s) at word (k, c): the packed stream shifted by s
// image rows, zero fill.
__device__ __forceinline__ uint32_t shift_px(const uint32_t* x, int k, int c, int s,
                                             int hw, int w) {
  if (c < 0 || c >= w) return 0u;
  if (s > 0) {
    int q = s >> 5, r = s & 31;
    uint32_t b = ld(x, k - q, c, hw, w);
    return r ? (b << r) | (ld(x, k - q - 1, c, hw, w) >> (32 - r)) : b;
  }
  s = -s;
  int q = s >> 5, r = s & 31;
  uint32_t b = ld(x, k + q, c, hw, w);
  return r ? (b >> r) | (ld(x, k + q + 1, c, hw, w) << (32 - r)) : b;
}

// The value s cells upstream of (k, c) along scan direction dir, in the
// order of bitpack._make_ops: left->right, right->left, top->bottom,
// bottom->top, down-right, up-left, down-left, up-right.
__device__ __forceinline__ uint32_t upstream(const uint32_t* x, int k, int c, int dir, int s,
                                             int hw, int w) {
  switch (dir) {
    case 0: return ld(x, k, c - s, hw, w);
    case 1: return ld(x, k, c + s, hw, w);
    case 2: return shift_px(x, k, c, s, hw, w);
    case 3: return shift_px(x, k, c, -s, hw, w);
    case 4: return shift_px(x, k, c - s, s, hw, w);
    case 5: return shift_px(x, k, c + s, -s, hw, w);
    case 6: return shift_px(x, k, c + s, s, hw, w);
    default: return shift_px(x, k, c - s, -s, hw, w);
  }
}

__device__ __forceinline__ uint32_t row_or(const uint32_t* A, int rr, int cc, int RW) {
  const uint32_t* row = A + rr * RW;
  return row[cc] | (cc > 0 ? row[cc - 1] : 0u) | (cc < RW - 1 ? row[cc + 1] : 0u);
}

// One round of dilate_steps dilations, src -> dst, tile by tile in shared
// memory. Returns (to every thread of the block) whether the block changed
// a word, when COMPARE.
template <bool COMPARE>
__device__ bool dilate_round(const Params& a, const uint32_t* src, uint32_t* dst,
                             uint32_t* sm) {
  const int RH = TR + 2 * a.halo_r, RW = TC + 2 * a.halo_c, RN = RH * RW;
  const int tiles_c = (a.w + TC - 1) / TC;
  const int n_tiles = ((a.hw + TR - 1) / TR) * tiles_c;
  bool changed = false;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int k0 = (t / tiles_c) * TR - a.halo_r;
    const int c0 = (t % tiles_c) * TC - a.halo_c;
    uint32_t* A = sm;
    uint32_t* B = sm + RN;
    uint32_t* P = sm + 2 * RN;
    for (int i = threadIdx.x; i < RN; i += NT) {
      int rr = i / RW, cc = i - rr * RW;
      A[i] = ld(src, k0 + rr, c0 + cc, a.hw, a.w);
      P[i] = ld(a.p, k0 + rr, c0 + cc, a.hw, a.w);
    }
    __syncthreads();
    for (int step = 1; step <= a.dilate_steps; ++step) {
      const bool exact = (step % CARRY_EVERY == 0) || step == a.dilate_steps;
      for (int i = threadIdx.x; i < RN; i += NT) {
        int rr = i / RW, cc = i - rr * RW;
        uint32_t v = row_or(A, rr, cc, RW);
        uint32_t h = v | (v << 1) | (v >> 1);
        if (exact) {  // cross-word carry: bit 31 of the word above, bit 0 below
          if (rr > 0) h |= row_or(A, rr - 1, cc, RW) >> 31;
          if (rr < RH - 1) h |= row_or(A, rr + 1, cc, RW) << 31;
        }
        B[i] = A[i] | (P[i] & h);
      }
      __syncthreads();
      uint32_t* T = A;
      A = B;
      B = T;
    }
    for (int i = threadIdx.x; i < TR * TC; i += NT) {
      int rr = i / TC + a.halo_r, cc = i % TC + a.halo_c;
      int k = k0 + rr, c = c0 + cc;
      if (k < a.hw && c < a.w) {
        uint32_t v = A[rr * RW + cc];
        if (COMPARE) changed |= v != __ldcg(src + k * a.w + c);
        dst[k * a.w + c] = v;
      }
    }
    __syncthreads();  // the next tile reuses the shared memory
  }
  return __syncthreads_or(changed);
}

// The 8 directional scans on the dilated plane in buf[0], then the result
// into a.f. Returns whether the block changed a word of a.f.
__device__ bool scan_round(const Params& a, cg::grid_group& grid) {
  const int n = a.hw * a.w;
  const int gtid = blockIdx.x * NT + threadIdx.x;
  const int gsize = gridDim.x * NT;
  const uint32_t* gs = a.buf[0];
  for (int dir = 0; dir < 8; ++dir) {
    const int extent = dir < 2 ? a.w : (dir < 4 ? a.h : min(a.h, a.w));
    const uint32_t* ps = a.p;
    for (int s = 1; s < extent; s *= 2) {
      const bool last = 2 * s >= extent;
      uint32_t* gd = gs == a.buf[0] ? a.buf[1] : a.buf[0];
      uint32_t* pd = ps == a.buf[2] ? a.buf[3] : a.buf[2];
      for (int idx = gtid; idx < n; idx += gsize) {
        int k = idx / a.w, c = idx - k * a.w;
        uint32_t gv = __ldcg(gs + idx), pv = __ldcg(ps + idx);
        gd[idx] = gv | (pv & upstream(gs, k, c, dir, s, a.hw, a.w));
        if (!last) pd[idx] = pv & upstream(ps, k, c, dir, s, a.hw, a.w);
      }
      grid.sync();
      gs = gd;
      ps = pd;
    }
  }
  bool changed = false;
  for (int idx = gtid; idx < n; idx += gsize) {
    uint32_t v = __ldcg(gs + idx);
    changed |= v != __ldcg(a.f + idx);
    a.f[idx] = v;
  }
  return __syncthreads_or(changed);
}

template <bool PHASE2>
__global__ void __launch_bounds__(NT) hyst_kernel(Params a) {
  extern __shared__ uint32_t sm[];
  cg::grid_group grid = cg::this_grid();
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  int it = 0;
  if (PHASE2) {
    it = a.flags[0];
    if (a.flags[1] == 0) {  // converged in phase 1: nothing to continue
      if (lead) {
        a.flags[2] = it;
        a.flags[3] = 0;
      }
      return;
    }
  }
  if (lead) a.chg[0] = a.chg[1] = a.chg[2] = 0;
  grid.sync();

  uint32_t* cur = a.f;
  uint32_t* nxt = a.buf[0];
  int changed = 1;
  for (int r = 0;; ++r) {
    // Phase 1 runs one round unconditionally; phase 2 starts still growing.
    if ((PHASE2 || r > 0) && !(changed && it < a.cap)) break;
    const int slot = r % 3;
    if (lead) a.chg[(r + 1) % 3] = 0;
    bool block_changed;
    if (PHASE2) {
      dilate_round<false>(a, a.f, a.buf[0], sm);
      grid.sync();
      block_changed = scan_round(a, grid);
    } else {
      block_changed = dilate_round<true>(a, cur, nxt, sm);
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (block_changed && threadIdx.x == 0) atomicOr(&a.chg[slot], 1);
    grid.sync();
    changed = *(volatile int*)&a.chg[slot];
    ++it;
  }
  if (!PHASE2 && cur != a.f) {
    const int n = a.hw * a.w;
    for (int idx = blockIdx.x * NT + threadIdx.x; idx < n; idx += gridDim.x * NT)
      a.f[idx] = __ldcg(cur + idx);
  }
  if (lead) {
    a.flags[PHASE2 ? 2 : 0] = it;
    a.flags[PHASE2 ? 3 : 1] = changed;
  }
}

__global__ void unpack_kernel(const uint32_t* __restrict__ f, uint8_t* __restrict__ out,
                              int h, int w) {
  const long long n = (long long)h * w;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int r = (int)(i / w), c = (int)(i - (long long)r * w);
    out[i] = ((f[(r >> 5) * w + c] >> (r & 31)) & 1u) ? 255 : 0;
  }
}

int scratch_planes(int phase) { return phase == 2 ? 4 : 1; }

// Dynamic shared memory of one tile: A, B and P planes with the halo.
size_t smem_bytes(int dilate_steps) {
  const int RH = TR + 2 * ((dilate_steps + 31) / 32), RW = TC + 2 * dilate_steps;
  return 3 * (size_t)RH * RW * sizeof(uint32_t);
}

// The most blocks of hyst_kernel<PHASE2> that can be co-resident on
// `device` (the cooperative grid's limit), computed on the first launch for
// each dilate_steps and cached.
template <bool PHASE2>
cudaError_t max_grid(int device, int dilate_steps, int* out) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(device, dilate_steps);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  auto kern = hyst_kernel<PHASE2>;
  // One opt-in for the largest tile serves every dilate_steps on the device.
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(MAX_DILATE_STEPS));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                      smem_bytes(dilate_steps));
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = cache[key] = per_sm * sms;
  return cudaSuccess;
}

template <bool PHASE2>
cudaError_t launch_rounds(Params a, int device, cudaStream_t stream) {
  if (a.dilate_steps < 1 || a.dilate_steps > MAX_DILATE_STEPS) return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = max_grid<PHASE2>(device, a.dilate_steps, &limit);
  if (err != cudaSuccess) return err;
  const int n_tiles = ((a.hw + TR - 1) / TR) * ((a.w + TC - 1) / TC);
  const int n_blocks_words = (a.hw * a.w + NT - 1) / NT;
  int grid = n_tiles > n_blocks_words ? n_tiles : n_blocks_words;
  if (grid > limit) grid = limit;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)hyst_kernel<PHASE2>, dim3(grid), dim3(NT), args,
                                    smem_bytes(a.dilate_steps), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Params make_params(void* f, const void* p, void* scratch, void* flags, int h, int w,
                   int dilate_steps, int cap, int phase) {
  Params a;
  a.hw = (h + 31) / 32;
  a.w = w;
  a.h = h;
  a.f = static_cast<uint32_t*>(f);
  a.p = static_cast<const uint32_t*>(p);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  const int planes = scratch_planes(phase);
  for (int i = 0; i < 4; ++i) a.buf[i] = s + (size_t)(i < planes ? i : 0) * a.hw * w;
  a.chg = reinterpret_cast<int*>(s + (size_t)planes * a.hw * w);
  a.flags = static_cast<int*>(flags);
  a.dilate_steps = dilate_steps;
  a.cap = cap;
  a.halo_r = (dilate_steps + 31) / 32;
  a.halo_c = dilate_steps;
  return a;
}

}  // namespace

// int32 words of scratch the phase needs: its scratch planes + 3 flags.
extern "C" long long cc_hyst_scratch_words(int h, int w, int phase) {
  return (long long)scratch_planes(phase) * ((h + 31) / 32) * w + 3;
}

extern "C" int cc_hyst_phase1(void* f, const void* p, void* scratch, void* flags, int h,
                              int w, int dilate_steps, int scan_after, int max_iters,
                              int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  int cap = scan_after < max_iters ? scan_after : max_iters;
  Params a = make_params(f, p, scratch, flags, h, w, dilate_steps, cap, 1);
  return launch_rounds<false>(a, device, static_cast<cudaStream_t>(stream));
}

extern "C" int cc_hyst_phase2(void* f, const void* p, void* scratch, void* flags, int h,
                              int w, int dilate_steps, int max_iters, int device,
                              void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  Params a = make_params(f, p, scratch, flags, h, w, dilate_steps, max_iters, 2);
  return launch_rounds<true>(a, device, static_cast<cudaStream_t>(stream));
}

extern "C" int cc_unpack(const void* f, void* out, int h, int w, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const long long n = (long long)h * w;
  const int grid = (int)((n + 255) / 256);
  unpack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<uint8_t*>(out), h, w);
  return cudaGetLastError();
}
