// halo_exchange: one halo refresh of the packed planes of every tile of a
// sharded frame batch on one card, and the collective round's pending flag.
//
// The refresh itself (the reference's strip exchange, its order and its
// flag) is halo.cuh's exchange_body; hyst_rounds.cu's sharded_loop runs its
// resident form once per collective round. This launch serves the two refreshes
// before that loop (the CANDIDATE plane once, then FINAL with the export's
// still-growing flags) and each round of the host loop that a one-card mesh
// runs with an injected local operator.
//
// Bound: a refresh moves two word rows and 2 x 64 lanes per tile (a few
// hundred KB at 8K); three grid barriers dominate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

#include "device_guard.cuh"
#include "halo.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) exchange_kernel(halo::Xchg a) {
  cg::grid_group grid = cg::this_grid();
  halo::exchange_body(a, grid);
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

// int32 words of scratch for T tiles of w lanes: the row strips and newbit.
extern "C" long long cc_exchange_scratch_words(int tiles, int w) {
  return halo::scratch_words(tiles, w);
}

// geo: 5 ints (e_top, h_loc, e_left, w_loc, ext_h).
extern "C" int cc_halo_exchange(void* x, void* scratch, const void* grow, int n_grow,
                                int grow_stride, void* pending, int nb, int ny, int nx, int hw,
                                int w, const int* geo, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nb < 1 || ny < 1 || nx < 1 || hw < 1 || w < 1) return cudaErrorInvalidValue;
  halo::Xchg a;
  a.x = static_cast<uint32_t*>(x);
  const long long T = (long long)nb * ny * nx;
  a.strips = static_cast<uint32_t*>(scratch);
  a.newbit = reinterpret_cast<int*>(a.strips + 2 * T * w);
  a.grow = static_cast<const int*>(grow);
  a.n_grow = n_grow;
  a.grow_stride = grow_stride;
  a.pending = static_cast<int*>(pending);
  a.nb = nb;
  a.ny = ny;
  a.nx = nx;
  a.hw = hw;
  a.w = w;
  a.e_top = geo[0];
  a.h_loc = geo[1];
  a.e_left = geo[2];
  a.w_loc = geo[3];
  a.ext_h = geo[4];
  int limit = 0;
  cudaError_t err = max_grid(device, &limit);
  if (err != cudaSuccess) return err;
  long long grid = (halo::work_items(a) + NT - 1) / NT;
  if (grid > limit) grid = limit;
  if (grid < 1) grid = 1;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)exchange_kernel, dim3((unsigned)grid), dim3(NT), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
