// The hysteresis-construct probes: each risky construct of the round kernels
// alone, on small planes, held to a plain version.
//
// Replaces the TPU feasibility probe tools/hyster_kernel_probe.py, whose four
// kernels try the Mosaic constructs of the fused hysteresis kernel one by
// one (pallas_call at :42 probe_pack, :68 probe_pack_loop, :114
// probe_loop_scratch, :150 probe_unpack). The contracts are the same; inside,
// each kernel tries the construct that is risky on Hopper instead:
//
//   probe_pack         (h, w) u8 mask -> (ceil(h/32), w) words, bit r of word
//                      row k = row 32k + r != 0 (TPU probe A). A 32-row x
//                      PROBE_TW-column tile staged in shared memory from
//                      coalesced loads, then transposed: thread c builds its
//                      column's word from 32 shared bytes (the staging of
//                      pack_tile.cuh, without its ballot).
//   probe_pack_ballot  the same pack by a loop over word rows with no shared
//                      memory (TPU probe A'): lane r of a warp holds row 32k + r
//                      of one column, and __ballot_sync is the word.
//   probe_loop         (hw, w) words, round f | roll(f, 1, rows) | roll(f, w-1,
//                      cols) | f << 1 (cyclic rolls, a shift inside each word)
//                      until nothing changes or the round budget, the first
//                      round unconditional; (rounds, changed) out (TPU probes
//                      B/C/D). One cooperative launch: the scratch plane in
//                      device memory, ping-pong between it and the output, one
//                      grid.sync() a round, and a device "changed" flag over
//                      three rotating slots that ends the loop with no
//                      readback. A sync-only mode runs the rounds' barriers
//                      alone: the cost of one grid.sync() against the grid.
//   probe_unpack       (hw, w) words -> (32 hw, w) u8 of 0 / 255 (TPU probe E):
//                      one thread per word writing its 32 bytes (a warp
//                      writes 32 neighbouring bytes of each row), or one
//                      thread per byte (as unpack and unpack_core).
//
// Bound: the probes' planes are small (a 40 x 256 plane is 40 KB); the loop
// is bound by its grid barriers, the packs and unpacks by their bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int PROBE_TW = 128;  // probe_pack tile columns

__global__ void __launch_bounds__(NT) pack_transpose_kernel(const uint8_t* __restrict__ x,
                                                            uint32_t* __restrict__ out, int h,
                                                            int w) {
  __shared__ uint8_t tile[32][PROBE_TW + 4];  // +4: a column's 32 bytes spread over banks
  const int k = blockIdx.y, r0 = 32 * k, c0 = blockIdx.x * PROBE_TW;
  for (int i = threadIdx.x; i < 32 * PROBE_TW; i += NT) {
    const int r = i / PROBE_TW, c = i - r * PROBE_TW;
    const int y = r0 + r, xc = c0 + c;
    tile[r][c] = (y < h && xc < w) ? x[(size_t)y * w + xc] : 0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < PROBE_TW; c += NT) {
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) word |= (uint32_t)(tile[r][c] != 0) << r;
    if (c0 + c < w) out[(size_t)k * w + c0 + c] = word;
  }
}

// One warp per (word row, 32 columns); the word rows in a loop.
__global__ void __launch_bounds__(NT) pack_ballot_kernel(const uint8_t* __restrict__ x,
                                                         uint32_t* __restrict__ out, int h, int w,
                                                         int hw) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * NT + threadIdx.x) >> 5;
  const int c0 = warp * 32;
  if (c0 >= w) return;  // the whole warp: c0 is uniform
  for (int k = 0; k < hw; ++k) {
    const int y = 32 * k + lane;
    uint32_t mine = 0;  // lane j keeps the word of column c0 + j
    for (int j = 0; j < 32 && c0 + j < w; ++j) {
      const bool bit = y < h && x[(size_t)y * w + c0 + j] != 0;
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == j) mine = word;
    }
    if (c0 + lane < w) out[(size_t)k * w + c0 + lane] = mine;
  }
}

// a: the input and the output plane; b: the scratch plane; chg: 3 ints;
// flags: (rounds, changed).
__global__ void __launch_bounds__(NT) loop_kernel(uint32_t* a, uint32_t* b, int* chg, int* flags,
                                                  int hw, int w, int max_rounds, int sync_only) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long gsize = (long long)gridDim.x * NT;
  if (sync_only) {
    for (int r = 0; r < max_rounds; ++r) grid.sync();
    if (gtid == 0) {
      flags[0] = max_rounds;
      flags[1] = 0;
    }
    return;
  }
  const long long n = (long long)hw * w;
  if (gtid == 0) chg[0] = chg[1] = chg[2] = 0;
  grid.sync();
  uint32_t* src = a;
  uint32_t* dst = b;
  int it = 0, changed = 1;
  do {  // the first round unconditional, as the probe's body before its while_loop
    const int slot = it % 3;
    if (gtid == 0) chg[(it + 1) % 3] = 0;  // read two barriers ago, written next round
    bool ch = false;
    for (long long e = gtid; e < n; e += gsize) {
      const int i = (int)(e / w), j = (int)(e - (long long)i * w);
      const uint32_t v = __ldcg(src + e);
      const uint32_t up = __ldcg(src + (long long)(i == 0 ? hw - 1 : i - 1) * w + j);
      const uint32_t right = __ldcg(src + (long long)i * w + (j == w - 1 ? 0 : j + 1));
      const uint32_t nv = v | up | right | (v << 1);
      dst[e] = nv;
      ch |= nv != v;
    }
    if (__syncthreads_or(ch) && threadIdx.x == 0) atomicOr(&chg[slot], 1);
    grid.sync();
    changed = *(volatile int*)&chg[slot];
    ++it;
    uint32_t* t = src;
    src = dst;
    dst = t;
  } while (changed && it < max_rounds);
  if (src != a)
    for (long long e = gtid; e < n; e += gsize) a[e] = __ldcg(src + e);
  if (gtid == 0) {
    flags[0] = it;
    flags[1] = changed;
  }
}

__global__ void __launch_bounds__(NT) unpack_word_kernel(const uint32_t* __restrict__ f,
                                                         uint8_t* __restrict__ out, int hw, int w) {
  const long long n = (long long)hw * w;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n;
       e += (long long)gridDim.x * NT) {
    const int k = (int)(e / w), c = (int)(e - (long long)k * w);
    const uint32_t word = f[e];
    uint8_t* o = out + (size_t)32 * k * w + c;
#pragma unroll
    for (int r = 0; r < 32; ++r) o[(size_t)r * w] = (word >> r) & 1u ? 255 : 0;
  }
}

__global__ void __launch_bounds__(NT) unpack_byte_kernel(const uint32_t* __restrict__ f,
                                                         uint8_t* __restrict__ out, int hw, int w) {
  const long long n = 32LL * hw * w;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n;
       e += (long long)gridDim.x * NT) {
    const int r = (int)(e / w), c = (int)(e - (long long)r * w);
    out[e] = (f[(size_t)(r >> 5) * w + c] >> (r & 31)) & 1u ? 255 : 0;
  }
}

unsigned blocks_for(long long items) {
  const long long b = (items + NT - 1) / NT;
  return (unsigned)(b < 1 ? 1 : (b > (1 << 20) ? (1 << 20) : b));
}

}  // namespace

extern "C" int cc_probe_pack(const void* x, void* out, int h, int w, int ballot, int device,
                             void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  const int hw = (h + 31) / 32;
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const uint8_t*>(x);
  auto op = static_cast<uint32_t*>(out);
  if (ballot)
    pack_ballot_kernel<<<blocks_for((w + 31) / 32 * 32LL), NT, 0, s>>>(xp, op, h, w, hw);
  else
    pack_transpose_kernel<<<dim3((w + PROBE_TW - 1) / PROBE_TW, hw), NT, 0, s>>>(xp, op, h, w);
  return cudaGetLastError();
}

// The most co-resident blocks of the loop kernel on `device`: the
// cooperative grid's limit.
extern "C" int cc_probe_loop_max_blocks(int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -(int)guard.err;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, loop_kernel, NT, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// plane: (hw, w) words, updated in place; scratch: hw * w + 3 words; flags:
// 2 ints. blocks < 1: cover the plane's words, up to the cooperative limit.
extern "C" int cc_probe_loop(void* plane, void* scratch, void* flags, int hw, int w,
                             int max_rounds, int sync_only, int blocks, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (hw < 1 || w < 1) return cudaErrorInvalidValue;
  const int limit = cc_probe_loop_max_blocks(device);
  if (limit < 1) return limit < 0 ? -limit : cudaErrorCooperativeLaunchTooLarge;
  long long grid = blocks >= 1 ? blocks : ((long long)hw * w + NT - 1) / NT;
  if (grid > limit) {
    if (blocks >= 1) return cudaErrorCooperativeLaunchTooLarge;  // asked for more than fits
    grid = limit;
  }
  uint32_t* a = static_cast<uint32_t*>(plane);
  uint32_t* b = static_cast<uint32_t*>(scratch);
  int* chg = reinterpret_cast<int*>(b + (long long)hw * w);
  int* fl = static_cast<int*>(flags);
  void* args[] = {&a, &b, &chg, &fl, &hw, &w, &max_rounds, &sync_only};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)loop_kernel, dim3((unsigned)grid), dim3(NT),
                                                args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int cc_probe_unpack(const void* f, void* out, int hw, int w, int per_word, int device,
                               void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (hw < 1 || w < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fp = static_cast<const uint32_t*>(f);
  auto op = static_cast<uint8_t*>(out);
  if (per_word)
    unpack_word_kernel<<<blocks_for((long long)hw * w), NT, 0, s>>>(fp, op, hw, w);
  else
    unpack_byte_kernel<<<blocks_for(32LL * hw * w), NT, 0, s>>>(fp, op, hw, w);
  return cudaGetLastError();
}
