// halo_exchange: one halo refresh of the packed planes of every tile of a
// sharded frame batch on one card, and the collective round's pending flag.
//
// The refresh itself (the reference's strip exchange and its flag) is
// halo.cuh's publish_band / apply_band; hyst_rounds.cu's sharded_loop runs
// the same functions in its own launch (both planes before its first round,
// FINAL once a collective round), so a sharded HYSTER call never launches
// this kernel. It serves each round of the host loop that a one-card mesh
// runs with an injected local operator.
//
// Design: each tile one band of halo.cuh's form, the grid's threads split
// between the tiles (publish_planes / apply_planes), about two words a
// thread up to the co-resident grid. Every tile publishes from global
// memory, one grid barrier, every tile ORs its halo words in (one thread a
// word, no atomics); then, where the caller wants the flag, a second
// barrier after which thread 0 of block 0 writes *pending = "some tile
// still growing (any of the n_grow ints at grow[g * grow_stride], e.g. the
// round kernels' flags[t][1][1]) or some new halo bit"
// (packed_halo.py:288-306).
//
// Bound: a refresh moves the word rows the strips span and 2 x 64 lanes of
// every tile with a neighbour there (a few hundred KB at 8K); the launch
// and its grid barriers dominate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

#include "device_guard.cuh"
#include "halo.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;  // threads a block

struct Refresh {
  uint32_t* x;        // (T, hw, w) planes, T = nb * ny * nx tiles in (b, y, x) order
  int* flag;          // scratch: "some new bit"
  const int* grow;    // null, or n_grow "still growing" ints, grow_stride apart
  int n_grow, grow_stride;
  int* pending;       // null, or: where the round's flag goes
  int tiles;
};

__global__ void __launch_bounds__(NT) exchange_kernel(halo::Strips s, Refresh a) {
  cg::grid_group grid = cg::this_grid();
  const int i = blockIdx.x * NT + threadIdx.x, n = gridDim.x * NT;
  if (a.pending && i == 0) *a.flag = 0;
  halo::publish_planes(s, a.x, a.tiles, i, n);
  grid.sync();  // every tile published; the flag is clear
  const int fresh = halo::apply_planes(s, a.x, a.tiles, i, n);
  if (!a.pending) return;
  if (__syncthreads_or(fresh) && threadIdx.x == 0) atomicOr(a.flag, 1);
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int p = __ldcg(a.flag);
    if (a.grow)
      for (int g = 0; g < a.n_grow; ++g) p |= __ldcg(a.grow + (size_t)g * a.grow_stride);
    *a.pending = p != 0;
  }
}

// The most co-resident blocks on `device` (the cooperative grid's limit),
// computed once per device.
cudaError_t max_grid(int device, int* out) {
  static std::mutex mu;
  static std::map<int, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(device);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exchange_kernel, NT, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *out = cache[device] = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// int32 words of scratch for T tiles of hw x w words: the published strips
// and lanes, and the flag.
extern "C" long long cc_exchange_scratch_words(int tiles, int hw, int w) {
  return halo::strips_words(tiles, hw, w) + 1;
}

// geo: 5 ints (e_top, h_loc, e_left, w_loc, ext_h).
extern "C" int cc_halo_exchange(void* x, void* scratch, const void* grow, int n_grow,
                                int grow_stride, void* pending, int nb, int ny, int nx, int hw,
                                int w, const int* geo, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nb < 1 || ny < 1 || nx < 1 || hw < 1 || w < 1) return cudaErrorInvalidValue;
  const int tiles = nb * ny * nx;
  halo::Strips s;
  s.rows = static_cast<uint32_t*>(scratch);
  s.lanes = s.rows + 4LL * tiles * w;
  s.ny = ny;
  s.nx = nx;
  s.hw = hw;
  s.w = w;
  s.e_top = geo[0];
  s.h_loc = geo[1];
  s.e_left = geo[2];
  s.w_loc = geo[3];
  s.ext_h = geo[4];
  Refresh a;
  a.x = static_cast<uint32_t*>(x);
  a.flag = reinterpret_cast<int*>(s.rows + halo::strips_words(tiles, hw, w));
  a.grow = static_cast<const int*>(grow);
  a.n_grow = n_grow;
  a.grow_stride = grow_stride;
  a.pending = static_cast<int*>(pending);
  a.tiles = tiles;
  int limit = 0;
  cudaError_t err = max_grid(device, &limit);
  if (err != cudaSuccess) return err;
  const long long want = (halo::refresh_items(tiles, hw, w, s.e_left) + 2 * NT - 1) / (2 * NT);
  const unsigned grid = (unsigned)(want < limit ? want : limit);
  void* args[] = {&s, &a};
  err = cudaLaunchCooperativeKernel((void*)exchange_kernel, dim3(grid), dim3(NT), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
