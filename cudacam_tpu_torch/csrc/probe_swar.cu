// swar_stencil: the 16-bit stencil probe, two 16-bit lanes per 32-bit
// register, with an int32 mode of the same kernel.
//
// Replaces the TPU i16 probe tools/i16_swar_probe.py (_run :35, pallas_call
// :37, bodies p1-p4 :56-83), which asks whether the feed-forward chain's
// stencils can run on 16-bit lanes. Four bodies on an (H, W) plane, each
// result an int16 widened to int32 (jnp semantics: int16 arithmetic wraps,
// the rolls are cyclic):
//
//   P1  int16 x:  x * 3 + (x + x) * 2
//   P2  int16 x:  x + roll(x, 1, rows) + roll(x, H - 1, rows)
//   P3  int16 x:  2x + 3 roll(x, 1, cols) + roll(x, W - 1, cols)
//   P4  uint8 x:  v = x + roll(x, 1, rows) + roll(x, H - 1, rows) in int16,
//                 then 2v + roll(v, 1, cols) + roll(v, W - 1, cols)
//
// The Hopper construct under test is SIMD within a register: a thread holds
// the two columns (j, j + 1) of a row as the low and high half of one word
// and adds them with __vadd2 (each lane wraps mod 2^16, as int16 does, so
// the result is exact for any input); a constant multiply is a chain of
// __vadd2, which cannot carry out of a lane. A column roll is a byte permute
// of two neighbouring lane pairs (__byte_perm), a row roll a load of another
// row. With an even W a pair is one aligned 32-bit load (16-bit for the u8
// plane); an odd W assembles each pair lane by lane. The int32 mode computes
// the same two columns with one int32 per value and wraps to int16 at the
// end. Both write int32.
//
// Bound: bytes (an int16 or u8 read and an int32 write per pixel: 10 MB at
// 1080p for P4); a handful of integer operations per pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int NT = 256;

// v mod n in [0, n): the cyclic roll's index (a division only at the edges).
__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0) return v + n * ((n - 1 - v) / n);
  return v < n ? v : v % n;
}

// The 16 bits of x[i, j] (j in [0, W)).
template <typename T>
__device__ __forceinline__ uint32_t bits16(const T* x, int i, int j, int W) {
  return (uint32_t)(uint16_t)x[(size_t)i * W + j];
}

// Lanes (x[i, j mod W], x[i, (j + 1) mod W]) for an even j, as one word.
template <typename T>
__device__ __forceinline__ uint32_t pair(const T* x, int i, int j, int W) {
  j = wrap(j, W);
  if ((W & 1) == 0) {  // j even, W even: the pair is aligned and inside the row
    const T* at = x + (size_t)i * W + j;
    if (sizeof(T) == 2) return *reinterpret_cast<const uint32_t*>(at);
    const uint32_t v = *reinterpret_cast<const uint16_t*>(at);
    return (v & 0xffu) | ((v & 0xff00u) << 8);
  }
  return bits16(x, i, j, W) | (bits16(x, i, wrap(j + 1, W), W) << 16);
}

// (lanes of a).hi, (lanes of b).lo: the pair one column to the left of b.
__device__ __forceinline__ uint32_t left_of(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5432);
}

template <int BODY, typename T>
__device__ __forceinline__ uint32_t body_swar(const T* x, int i, int j, int H, int W) {
  const int up = wrap(i - 1, H), dn = wrap(i + 1, H);
  if constexpr (BODY == 1) {
    const uint32_t v = pair(x, i, j, W), t = __vadd2(v, v);
    return __vadd2(__vadd2(t, v), __vadd2(t, t));
  } else if constexpr (BODY == 2) {
    return __vadd2(__vadd2(pair(x, i, j, W), pair(x, up, j, W)), pair(x, dn, j, W));
  } else if constexpr (BODY == 3) {
    const uint32_t p = pair(x, i, j - 2, W), c = pair(x, i, j, W), n = pair(x, i, j + 2, W);
    const uint32_t l = left_of(p, c), r = left_of(c, n);
    return __vadd2(__vadd2(__vadd2(c, c), __vadd2(__vadd2(l, l), l)), r);
  } else {
    // P4: the 3-row sums of the pairs left, here and right, then the columns.
    uint32_t v[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int jj = j + 2 * (d - 1);
      v[d] = __vadd2(__vadd2(pair(x, i, jj, W), pair(x, up, jj, W)), pair(x, dn, jj, W));
    }
    return __vadd2(__vadd2(__vadd2(v[1], v[1]), left_of(v[0], v[1])), left_of(v[1], v[2]));
  }
}

template <typename T>
__device__ __forceinline__ int val(const T* x, int i, int j, int W) {
  return (int)x[(size_t)i * W + wrap(j, W)];
}

template <int BODY, typename T>
__device__ __forceinline__ int body_i32(const T* x, int i, int j, int H, int W) {
  const int up = wrap(i - 1, H), dn = wrap(i + 1, H);
  if constexpr (BODY == 1) {
    const int v = val(x, i, j, W), t = v + v;
    return (t + v) + (t + t);
  } else if constexpr (BODY == 2) {
    return val(x, i, j, W) + val(x, up, j, W) + val(x, dn, j, W);
  } else if constexpr (BODY == 3) {
    const int c = val(x, i, j, W), l = val(x, i, j - 1, W);
    return (c + c) + ((l + l) + l) + val(x, i, j + 1, W);
  } else {
    int v[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      v[d] = val(x, i, j + d - 1, W) + val(x, up, j + d - 1, W) + val(x, dn, j + d - 1, W);
    return (v[1] + v[1]) + v[0] + v[2];
  }
}

template <int BODY, bool SWAR, typename T>
__global__ void __launch_bounds__(NT) swar_kernel(const T* __restrict__ x, int* __restrict__ out,
                                                  int H, int W) {
  const int npair = (W + 1) / 2;
  const long long n = (long long)H * npair;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n;
       e += (long long)gridDim.x * NT) {
    const int i = (int)(e / npair), j = 2 * (int)(e - (long long)i * npair);
    int r0, r1;
    if (SWAR) {
      const uint32_t y = body_swar<BODY>(x, i, j, H, W);
      r0 = (int16_t)(y & 0xffffu);
      r1 = (int16_t)(y >> 16);
    } else {
      r0 = (int16_t)body_i32<BODY>(x, i, j, H, W);
      r1 = j + 1 < W ? (int16_t)body_i32<BODY>(x, i, j + 1, H, W) : 0;
    }
    int* o = out + (size_t)i * W + j;
    o[0] = r0;
    if (j + 1 < W) o[1] = r1;
  }
}

template <int BODY, typename T>
cudaError_t launch(const void* x, int* out, int H, int W, bool swar, cudaStream_t s) {
  const long long items = (long long)H * ((W + 1) / 2);
  long long blocks = (items + NT - 1) / NT;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  auto xp = static_cast<const T*>(x);
  if (swar)
    swar_kernel<BODY, true, T><<<(unsigned)blocks, NT, 0, s>>>(xp, out, H, W);
  else
    swar_kernel<BODY, false, T><<<(unsigned)blocks, NT, 0, s>>>(xp, out, H, W);
  return cudaGetLastError();
}

}  // namespace

// body 1-3: an (H, W) int16 plane; body 4: an (H, W) uint8 plane. out: (H, W)
// int32. swar 0 is the int32 mode.
extern "C" int cc_swar_stencil(const void* x, void* out, int H, int W, int body, int swar,
                               int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (H < 1 || W < 1) return cudaErrorInvalidValue;
  auto o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool sw = swar != 0;
  switch (body) {
    case 1: return launch<1, int16_t>(x, o, H, W, sw, s);
    case 2: return launch<2, int16_t>(x, o, H, W, sw, s);
    case 3: return launch<3, int16_t>(x, o, H, W, sw, s);
    case 4: return launch<4, uint8_t>(x, o, H, W, sw, s);
    default: return cudaErrorInvalidValue;
  }
}
