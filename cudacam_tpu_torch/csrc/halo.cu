// halo_exchange: one halo refresh of the packed planes of every tile of a
// sharded frame batch on one card, and the collective round's pending flag.
//
// Replaces the strip exchange of the sharded round loop, which the JAX
// package computes as XLA ops around jax.lax.ppermute (cudacam_tpu/parallel/
// packed_halo.py: exchange_packed :195, _extract32 :124, _or_place32 :150,
// and the psum'd flag of packed_hysteresis_loop :256). On one card every
// tile of the (b, y, x) mesh lives on the device as the leading axis of one
// (T, hw, w) tensor, so a neighbour hop is an index shift over that axis.
//
// The order is the reference's, in three steps over all tiles with a grid
// barrier between them (one cooperative launch):
//   1. rows: every tile's two 32-row strips, its bottom core rows (for the
//      tile below) and its top core rows (for the tile above), spanning all
//      lanes, into scratch, from the planes as they stand;
//   2. each strip ORed into the neighbour's halo rows, bits past the
//      extended tile dropped; atomicOr, because a small tile's two halo
//      slots can share a word;
//   3. columns: min(64, e_left) lanes of core columns over ALL word rows
//      (so they carry the corners just placed) into the left and right
//      neighbours' halo lanes. Core lanes are read and halo lanes written,
//      each by one thread, so this step needs no snapshot.
// A bit is new when the OR set it. The flag written to `pending` is "some
// tile still growing (any of the n_grow ints at grow[i * grow_stride], e.g.
// the round kernels' flags[t][1][1]) or some new halo bit", the loop's exit
// test (packed_halo.py:288-306). With a gate, the launch returns
// at once when *gate is 0, so a bounded chain of rounds runs without the
// host reading the flag.
//
// Bound: a round moves two word rows and 2 x 64 lanes per tile (a few
// hundred KB at 8K); three grid barriers dominate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;

struct Xchg {
  uint32_t* x;        // (T, hw, w) planes, T = nb * ny * nx tiles in (b, y, x) order
  uint32_t* strips;   // scratch: (T, 2, w) row strips
  int* newbit;        // scratch: one word
  const int* grow;    // null, or n_grow "still growing" ints, grow_stride apart
  int n_grow, grow_stride;
  const int* gate;    // null, or: return at once when *gate == 0
  int* pending;       // null, or: where the round's flag goes
  int* rounds;        // null, or: raised by one when the gate was open
  int nb, ny, nx, hw, w;
  int e_top, h_loc, e_left, w_loc, ext_h;
};

// _extract32: lane c of the 32-row strip of plane x starting at row b
// (b > -32; rows before the plane read as zero).
__device__ __forceinline__ uint32_t extract32(const uint32_t* x, int b, int c, int hw, int w) {
  if (b < 0) return __ldcg(x + c) << (-b);
  const int q = b >> 5, r = b & 31;
  uint32_t row = __ldcg(x + (size_t)q * w + c);
  if (r) {
    const uint32_t nxt = q + 1 < hw ? __ldcg(x + (size_t)(q + 1) * w + c) : 0u;
    row = (row >> r) | (nxt << (32 - r));
  }
  return row;
}

// The bits of word wi that lie in rows [b, min(cap, b + 32)).
__device__ __forceinline__ uint32_t word_mask(int b, int cap, int wi) {
  const int lo = max(b, wi * 32) - wi * 32;
  const int hi = min(min(cap, b + 32), (wi + 1) * 32) - wi * 32;
  if (hi <= lo) return 0u;
  return hi - lo >= 32 ? 0xffffffffu : ((1u << (hi - lo)) - 1u) << lo;
}

// _or_place32 of lane c: OR a 32-row strip into rows [b, b + 32) of plane x,
// dropping bits at rows >= cap. Returns whether a bit was new.
__device__ __forceinline__ bool or_place32(uint32_t* x, uint32_t strip, int b, int cap, int c,
                                           int hw, int w) {
  if (b < 0) {
    strip >>= -b;
    b = 0;
  }
  if (b >= cap) return false;
  const int q = b >> 5, r = b & 31;
  bool fresh = false;
  const uint32_t lo = (r ? strip << r : strip) & word_mask(b, cap, q);
  if (lo) fresh |= (lo & ~atomicOr(x + (size_t)q * w + c, lo)) != 0u;
  if (r && q + 1 < hw) {
    const uint32_t hi = (strip >> (32 - r)) & word_mask(b, cap, q + 1);
    if (hi) fresh |= (hi & ~atomicOr(x + (size_t)(q + 1) * w + c, hi)) != 0u;
  }
  return fresh;
}

__global__ void __launch_bounds__(NT) exchange_kernel(Xchg a) {
  if (a.gate && __ldcg(a.gate) == 0) return;  // every block: the pending flag is down
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long gsize = (long long)gridDim.x * NT;
  const int T = a.nb * a.ny * a.nx;
  const size_t plane = (size_t)a.hw * a.w;
  if (gtid == 0) *a.newbit = 0;
  if (a.ny > 1) {
    for (long long e = gtid; e < (long long)T * a.w; e += gsize) {
      const int t = (int)(e / a.w), c = (int)(e % a.w);
      const uint32_t* xt = a.x + t * plane;
      a.strips[(size_t)(2 * t) * a.w + c] = extract32(xt, a.e_top + a.h_loc - 32, c, a.hw, a.w);
      a.strips[(size_t)(2 * t + 1) * a.w + c] = extract32(xt, a.e_top, c, a.hw, a.w);
    }
  }
  grid.sync();  // the strips are out and newbit is clear
  bool fresh = false;
  if (a.ny > 1) {
    for (long long e = gtid; e < (long long)T * a.w; e += gsize) {
      const int t = (int)(e / a.w), c = (int)(e % a.w);
      const int i = (t / a.nx) % a.ny;
      uint32_t* xt = a.x + t * plane;
      if (i > 0)  // the upper neighbour's bottom rows -> my top halo slot
        fresh |= or_place32(xt, __ldcg(a.strips + (size_t)(2 * (t - a.nx)) * a.w + c),
                            a.e_top - 32, a.ext_h, c, a.hw, a.w);
      if (i < a.ny - 1)  // the lower neighbour's top rows -> my bottom halo slot
        fresh |= or_place32(xt, __ldcg(a.strips + (size_t)(2 * (t + a.nx) + 1) * a.w + c),
                            a.e_top + a.h_loc, a.ext_h, c, a.hw, a.w);
    }
    grid.sync();  // the column step carries the rows just placed
  }
  if (a.nx > 1) {
    const int k = min(64, a.e_left), c_r = a.e_left + a.w_loc;
    const long long n = 2LL * T * a.hw * k;
    for (long long e = gtid; e < n; e += gsize) {
      const int l = (int)(e % k);
      const long long rest = e / k;
      const int row = (int)(rest % a.hw);
      const int t = (int)((rest / a.hw) % T);
      const bool left = rest / ((long long)a.hw * T) == 0;
      const int j = t % a.nx;
      if (left ? j == 0 : j == a.nx - 1) continue;
      // left: the left neighbour's last core lanes -> my left halo lanes;
      // right: the right neighbour's first core lanes -> my right halo lanes.
      const uint32_t* src = a.x + (left ? t - 1 : t + 1) * plane + (size_t)row * a.w +
                            (left ? c_r - k : a.e_left) + l;
      uint32_t* dst = a.x + t * plane + (size_t)row * a.w + (left ? a.e_left - k : c_r) + l;
      const uint32_t v = __ldcg(src);
      const uint32_t old = __ldcg(dst);
      if (v & ~old) {
        fresh = true;
        *dst = old | v;
      }
    }
  }
  if (__syncthreads_or(fresh) && threadIdx.x == 0) atomicOr(a.newbit, 1);
  grid.sync();
  if (gtid == 0) {
    if (a.pending) {
      int p = __ldcg(a.newbit);
      if (a.grow)
        for (int i = 0; i < a.n_grow; ++i) p |= __ldcg(a.grow + (size_t)i * a.grow_stride);
      *a.pending = p != 0;
    }
    if (a.rounds) *a.rounds += 1;
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

// int32 words of scratch for T tiles of w lanes: the row strips and newbit.
extern "C" long long cc_exchange_scratch_words(int tiles, int w) {
  return 2LL * tiles * w + 1;
}

// geo: 5 ints (e_top, h_loc, e_left, w_loc, ext_h).
extern "C" int cc_halo_exchange(void* x, void* scratch, const void* grow, int n_grow,
                                int grow_stride, const void* gate, void* pending, void* rounds,
                                int nb, int ny, int nx, int hw, int w, const int* geo, int device,
                                void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (nb < 1 || ny < 1 || nx < 1 || hw < 1 || w < 1) return cudaErrorInvalidValue;
  Xchg a;
  a.x = static_cast<uint32_t*>(x);
  const long long T = (long long)nb * ny * nx;
  a.strips = static_cast<uint32_t*>(scratch);
  a.newbit = reinterpret_cast<int*>(a.strips + 2 * T * w);
  a.grow = static_cast<const int*>(grow);
  a.n_grow = n_grow;
  a.grow_stride = grow_stride;
  a.gate = static_cast<const int*>(gate);
  a.pending = static_cast<int*>(pending);
  a.rounds = static_cast<int*>(rounds);
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
  const long long k = a.e_left < 64 ? a.e_left : 64;
  long long work = T * w;
  if (2 * T * hw * k > work) work = 2 * T * hw * k;
  long long grid = (work + NT - 1) / NT;
  if (grid > limit) grid = limit;
  if (grid < 1) grid = 1;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)exchange_kernel, dim3((unsigned)grid), dim3(NT), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
