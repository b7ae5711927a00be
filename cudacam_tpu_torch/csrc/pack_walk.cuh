// The column walk of the packs, shared by pack_thresh (pack.cu) and
// sweep_pack_all (sweep.cu): thread (k, c) holds the 32 values of column c
// in word row k in registers (each load 32 neighbouring values a warp) and
// builds a FINAL and a CANDIDATE word from them, bit j of word [k, c] =
// pixel [32k + j, c]. No shared-memory tile, no ballot, no division.
//
// A value and a bound both lie in [0, 2^31) (clamped at 0 by the caller),
// so the sign of bound - value is "value > bound" with no overflow, and one
// funnel shift appends it to a word: FINAL = v > hi, CANDIDATE = lo < v <=
// hi, 4 integer instructions a pixel and pair and one and-not a word.

#pragma once

#include <stdint.h>

namespace {

// The 32 values of a column in word row kr: value(y) for rows y < H, 0 for
// rows past H and for a thread whose column is not live.
template <class Value>
__device__ __forceinline__ void load_column(Value value, int kr, int H, bool live, int (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int y = 32 * kr + j;
    v[j] = live && y < H ? value(y) : 0;
  }
}

// The FINAL and CANDIDATE words of a column's values against [lo, hi].
__device__ __forceinline__ void pack_words(const int (&v)[32], int lo, int hi, uint32_t* f,
                                           uint32_t* p) {
  uint32_t fw = 0, gw = 0;  // v > hi, v > lo
#pragma unroll
  for (int j = 31; j >= 0; --j) {  // row 31 first: it ends at bit 31
    fw = __funnelshift_l((uint32_t)(hi - v[j]), fw, 1);
    gw = __funnelshift_l((uint32_t)(lo - v[j]), gw, 1);
  }
  *f = fw;
  *p = gw & ~fw;
}

}  // namespace
