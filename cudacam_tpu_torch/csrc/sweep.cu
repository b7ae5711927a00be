// The threshold sweep's packs: every pair's packed FINAL / CANDIDATE planes
// from one read of the keep * g plane (sweep_pack_all), and the monotone
// warm start of one slot from the slot before (sweep_seed).
//
// Replaces the per-pair classify + pack and the monotone seed of the TPU
// sweep kernel (cudacam_tpu/ops/pallas/hysteresis_fused.py:729 pallas_call in
// sweep_fused :644 -> _sweep_kernel :478). On the TPU one launch runs all K
// pairs as K sequential grid steps over a VMEM-resident keep * g plane.
// Hopper blocks carry nothing from one launch to the next, so each slot's
// rounds are launches of their own (hyst_rounds.cu); but only the seed
// depends on the slot before, through that slot's converged plane, and the
// classification of every pair depends on keep * g and the bounds alone. So
// the sweep is sweep_pack_all once, then per sorted slot i: sweep_seed (i > 0,
// monotone mode), phase 1, phase 2, in stream order; one batched unpack
// writes every map at its original index (ops/cuda/hysteresis_fused.py::
// sweep_fused): 3K + 2 launches with ff_stages, 2K + 3 without seeds.
//
// sweep_pack_all: slot s classifies the int32 keep * g plane against
// bounds[2s], bounds[2s+1] clamped at 0: FINAL = kg > hi, CANDIDATE =
// lo < kg <= hi; bit j of word [k, c] is pixel [32k + j, c]; pixels past H
// are class 0. Design: the column walk of pack_walk.cuh (pack_thresh runs
// it too). Thread (k, c) loads the 32 values of column c in word row k (each
// load 128 contiguous bytes a warp), clamps them at 0 once, then for every
// slot (the bounds staged in shared memory, clamped, SWEEP_CHUNK pairs at a
// time) builds both words in registers and stores them, coalesced across
// the warp: 4 integer instructions a pixel and pair (two subtractions, two
// funnel shifts) and one and-not a word. 16-byte loads would cut the 32
// loads of a column, 1/(4K + 1) of its instructions, and need 4 columns (128
// values) a thread: not taken.
//
// Bound: one read of the kg plane and one write of the 2K planes (1080p,
// K = 16: 8.3 + 8.4 MB, 5.0 us at HBM rate); the walk's instructions (64 a
// pixel at K = 16, at the card's 32-bit integer rate ~9 us at 1080p) bind
// before them past K ~ 8.
//
// sweep_seed: when slot i-1's pair dominates slot i's (lo_{i-1} >= lo_i and
// hi_{i-1} >= hi_i, clamped; read here on the device, so the host decides
// nothing), slot i's FINAL words are ORed with slot i-1's plane, which the
// round kernels before this launch left converged or cut off by the cap;
// else every thread returns at once. Word-wise and coalesced. Bound: the two
// planes read and one written (0.8 MB at 1080p).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "pack_walk.cuh"

namespace {

constexpr int SWEEP_NT = 256;     // threads a block: 256 columns of one word row
constexpr int SWEEP_CHUNK = 256;  // pairs staged in shared memory at a time
constexpr int SEED_NT = 256;

__global__ void __launch_bounds__(SWEEP_NT) sweep_pack_all_kernel(
    const int* __restrict__ kg, const int* __restrict__ bounds, uint32_t* __restrict__ f,
    uint32_t* __restrict__ p, int k, int H, int W) {
  __shared__ int2 sb[SWEEP_CHUNK];
  const int kr = blockIdx.y, c = blockIdx.x * SWEEP_NT + threadIdx.x;
  const bool live = c < W;
  const size_t plane = (size_t)((H + 31) / 32) * W, at = (size_t)kr * W + c;
  int v[32];
  load_column([=](int y) { return max(__ldg(kg + (size_t)y * W + c), 0); }, kr, H, live, v);
  for (int s0 = 0; s0 < k; s0 += SWEEP_CHUNK) {
    const int n = min(SWEEP_CHUNK, k - s0);
    __syncthreads();  // every thread is done with the chunk before
    for (int i = threadIdx.x; i < n; i += SWEEP_NT)
      sb[i] = make_int2(max(bounds[2 * (s0 + i)], 0), max(bounds[2 * (s0 + i) + 1], 0));
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      uint32_t fw, pw;
      pack_words(v, sb[i].x, sb[i].y, &fw, &pw);
      const size_t o = (size_t)(s0 + i) * plane + at;
      f[o] = fw;
      p[o] = pw;
    }
  }
}

__global__ void __launch_bounds__(SEED_NT) sweep_seed_kernel(const int* __restrict__ bounds,
                                                             uint32_t* __restrict__ f, int slot,
                                                             size_t plane) {
  const int lo = max(bounds[2 * slot], 0), hi = max(bounds[2 * slot + 1], 0);
  if (max(bounds[2 * slot - 2], 0) < lo || max(bounds[2 * slot - 1], 0) < hi) return;
  const uint32_t* prev = f + (slot - 1) * plane;
  uint32_t* cur = f + slot * plane;
  for (size_t i = blockIdx.x * (size_t)SEED_NT + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * SEED_NT)
    cur[i] |= prev[i];
}

}  // namespace

extern "C" int cc_sweep_pack_all(const void* kg, const void* bounds, void* f, void* p, int k,
                                 int H, int W, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int hw = (H + 31) / 32;
  if (k < 1 || H < 1 || W < 1 || hw > 65535) return cudaErrorInvalidValue;  // grid.y
  sweep_pack_all_kernel<<<dim3((W + SWEEP_NT - 1) / SWEEP_NT, hw), SWEEP_NT, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(kg), static_cast<const int*>(bounds), static_cast<uint32_t*>(f),
      static_cast<uint32_t*>(p), k, H, W);
  return cudaGetLastError();
}

// f: the (K, hw, W) FINAL planes; slot >= 1.
extern "C" int cc_sweep_seed(const void* bounds, void* f, int slot, int hw, int W, int device,
                             void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (slot < 1 || hw < 1 || W < 1) return cudaErrorInvalidValue;
  const size_t plane = (size_t)hw * W;
  const size_t blocks = (plane + SEED_NT - 1) / SEED_NT;
  sweep_seed_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), SEED_NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bounds), static_cast<uint32_t*>(f), slot, plane);
  return cudaGetLastError();
}
