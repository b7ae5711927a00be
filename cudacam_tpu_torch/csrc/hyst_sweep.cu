// The legacy row-sweep hysteresis: a threshold map converged slab by slab.
//
// Replaces the TPU sweep kernel (cudacam_tpu/ops/pallas/hysteresis.py:157
// pallas_call in _make_sweep -> _sweep_kernel :75; entry hysteresis_pallas
// :194). There a sequential grid walks full-width row slabs: slab b is the
// window of rows [b bh - 8, b bh + bh + 8) of the map (zero outside it),
// saturated locally by 8-neighbour promotion steps (at most max_local_iters)
// and written back, halo rows included; the slabs of a sweep run in order on
// the updated map, sweeps alternate down and up, and a device loop ends at
// the first sweep that changes no slab or after 2 max_iters sweeps. This
// kernel gives the same bytes for the same block height, cut off or not.
//
// Design: the slab order is a true dependence, so the whole call is ONE
// persistent block that walks the slabs of every sweep, with no grid barrier
// and no readback: a window lives bit-packed in shared memory (bit r of word
// (r / 32, c) is window row r of column c: FINAL, a ping-pong copy, and
// CANDIDATE), so a promotion step is three neighbour words, two shifts and
// the carries across word rows, one __syncthreads_or a step, which is also
// the stop test. At the default block height of 16 a window is 32 rows: one
// word a column, no carries. The steps are Jacobi steps counted exactly, so
// the max_local_iters cut-off is the TPU kernel's too. Only promoted pixels
// are written back (the window's other bytes are unchanged by definition).
//
// Bound: latency of one SM, not bytes or operations: a step touches 3 words
// a column and costs a block barrier; the map is read and written a few
// times a sweep through L2. The other 131 SMs idle: the kernel is kept as
// the independently derived check of the fused hysteresis, not as a fast
// path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int NT = 1024;
constexpr int HALO = 8;  // rows of the neighbour slabs in a window, each side
constexpr uint8_t FINAL_EDGE = 255, CANDIDATE_EDGE = 128;

__device__ __forceinline__ uint32_t row_or(const uint32_t* A, int kr, int c, int w) {
  const uint32_t* row = A + kr * w;
  return row[c] | (c > 0 ? row[c - 1] : 0u) | (c < w - 1 ? row[c + 1] : 0u);
}

// info: [sweeps run, the last sweep changed a slab, promotion steps taken]
__global__ void __launch_bounds__(NT) sweeps_kernel(uint8_t* state, int* info, int h, int w,
                                                    int bh, int max_sweeps, int max_local_iters) {
  extern __shared__ uint32_t sm[];
  const int rows = bh + 2 * HALO, wr = (rows + 31) / 32, n = wr * w;
  uint32_t* A = sm;
  uint32_t* B = sm + n;
  uint32_t* P = sm + 2 * n;
  const int n_slabs = (h + bh - 1) / bh;
  int sweeps = 0, changed = 0;
  long long steps = 0;
  do {
    const bool down = (sweeps & 1) == 0;
    changed = 0;
    for (int j = 0; j < n_slabs; ++j) {
      const int r0 = (down ? j : n_slabs - 1 - j) * bh - HALO;  // map row of window row 0
      for (int i = threadIdx.x; i < n; i += NT) {
        const int kr = i / w, c = i - kr * w;
        uint32_t fin = 0, cand = 0;
        for (int b = 0; b < 32; ++b) {
          const int r = r0 + kr * 32 + b;
          if (kr * 32 + b < rows && r >= 0 && r < h) {
            const uint8_t v = state[(size_t)r * w + c];
            fin |= (uint32_t)(v == FINAL_EDGE) << b;
            cand |= (uint32_t)(v == CANDIDATE_EDGE) << b;
          }
        }
        A[i] = fin;
        P[i] = cand;
      }
      __syncthreads();
      uint32_t* src = A;
      uint32_t* dst = B;
      int grew = 1;
      for (int it = 0; grew && it < max_local_iters; ++it) {
        bool ch = false;
        for (int i = threadIdx.x; i < n; i += NT) {
          const int kr = i / w, c = i - kr * w;
          const uint32_t v = row_or(src, kr, c, w);
          uint32_t nb = v | (v << 1) | (v >> 1);
          if (kr > 0) nb |= row_or(src, kr - 1, c, w) >> 31;
          if (kr < wr - 1) nb |= row_or(src, kr + 1, c, w) << 31;
          const uint32_t old = src[i], nv = old | (P[i] & nb);
          ch |= nv != old;
          dst[i] = nv;
        }
        grew = __syncthreads_or(ch);
        uint32_t* t = src;
        src = dst;
        dst = t;
        ++steps;
      }
      bool wrote = false;
      for (int i = threadIdx.x; i < n; i += NT) {
        const int kr = i / w, c = i - kr * w;
        uint32_t promoted = src[i] & P[i];
        wrote |= promoted != 0;
        while (promoted) {
          const int b = __ffs(promoted) - 1;
          promoted &= promoted - 1;
          state[(size_t)(r0 + kr * 32 + b) * w + c] = FINAL_EDGE;
        }
      }
      // The barrier also orders the write-back before the next window's load.
      changed |= __syncthreads_or(wrote);
    }
    ++sweeps;
  } while (changed && sweeps < max_sweeps);
  if (threadIdx.x == 0) {
    info[0] = sweeps;
    info[1] = changed;
    info[2] = (int)(steps < 0x7fffffff ? steps : 0x7fffffff);
  }
}

size_t smem_bytes(int bh, int w) {
  return 3 * (size_t)((bh + 2 * HALO + 31) / 32) * w * sizeof(uint32_t);
}

}  // namespace

// Dynamic shared memory of a call: three packed planes of one window.
extern "C" long long cc_hyst_sweeps_smem(int bh, int w) { return (long long)smem_bytes(bh, w); }

// Converges the (h, w) uint8 threshold map ``state`` in place: FINAL_EDGE
// where a CANDIDATE was promoted, every other byte as it was.
extern "C" int cc_hyst_sweeps(void* state, void* info, int h, int w, int bh, int max_iters,
                              int max_local_iters, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (h < 1 || w < 1 || bh < 1) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(bh, w);
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;  // the window does not fit one SM
  err = cudaFuncSetAttribute(sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  const int max_sweeps = max_iters > 0 ? 2 * max_iters : 1;
  sweeps_kernel<<<1, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(state), static_cast<int*>(info), h, w, bh, max_sweeps,
      max_local_iters);
  return cudaGetLastError();
}
