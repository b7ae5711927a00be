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
//                      PACK_TW-column tile staged in shared memory, then
//                      transposed (the packs of pack_walk.cuh hold a column
//                      in registers instead). A warp stages 512 bytes of a
//                      row a step: 16 bytes a lane by cp.async where every
//                      row's address is 16-byte aligned, else through
//                      registers: 16-byte loads for a row whose address is
//                      aligned, aligned 4-byte words cut by a funnel shift
//                      (the next word from the next lane) for any other,
//                      bytes only at the mask's own ends; thread t
//                      then builds the words of columns 4t..4t+3 from one
//                      32-bit shared word a row by SWAR (a byte's != 0 as
//                      its bit 7, shifted into bit r & 7 of that byte), a
//                      4 x 4 byte transpose by __byte_perm, one 16-byte
//                      store where the words' address allows.
//   probe_pack_ballot  the same pack with no shared memory (TPU probe A'):
//                      lane r of a warp holds row 32k + r, and __ballot_sync
//                      is the word. A warp's task is one word row x 32
//                      columns; the grid walks all tasks persistently, each
//                      warp with BALLOT_TASKS tasks' loads in flight. A lane
//                      reads its row's 32 bytes as two 16-byte loads (one
//                      sector) where the row's address is 16-byte aligned
//                      and the columns lie inside w, else byte by byte; 32
//                      ballots, one per byte position, give the 32 columns'
//                      words, lane b keeping word b, and the warp stores them
//                      as 128 contiguous bytes.
//   probe_loop         (hw, w) words, round f | roll(f, 1, rows) | roll(f, w-1,
//                      cols) | f << 1 (cyclic rolls, a shift inside each word)
//                      until nothing changes or the round budget, the first
//                      round unconditional; (rounds, changed) out (TPU probes
//                      B/C/D). Two routes, chosen from the plane's size before
//                      the launch (probe_loop_plan):
//                      - resident: the plane in registers for the whole
//                        launch on one block, where its threads hold it at
//                        up to LOOP_R rows of one column a thread. The column
//                        roll comes from the next lane by a shuffle and, at a
//                        warp's last lane or the plane's last column, from
//                        the column a warp publishes in shared memory; the
//                        row roll from the thread above's published last row
//                        (cyclic: row 0's from the plane's last row). A round
//                        ends on one __syncthreads_or; the published words
//                        alternate between two buffers, so no second barrier
//                        guards their reuse.
//                      - grid: one cooperative launch, the scratch plane in
//                        device memory, ping-pong between it and the output,
//                        one grid.sync() a round, and a device "changed" flag
//                        over three rotating slots that ends the loop with no
//                        readback. It takes planes the resident route does not
//                        hold, an explicit grid, and a sync-only mode that
//                        runs the rounds' barriers alone: the cost of one
//                        grid.sync() against the grid.
//   probe_unpack       (hw, w) words -> (32 hw, w) u8 of 0 / 255 (TPU probe E):
//                      one thread per word writing its 32 bytes (a warp
//                      writes 32 neighbouring bytes of each row), or, in the
//                      byte mode, a thread's work inside one output row: a
//                      16-byte run from 16 words, one vector store, a
//                      block's 32 rows sharing the words in L1
//                      (unpack_runs_kernel; heads and tails byte by byte).
//
// Bound: the probes' planes are small (a 40 x 256 plane is 40 KB); the grid
// loop is bound by its grid barriers, the resident loop by a thread's rows
// and its round's barrier, the packs and unpacks by their bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr unsigned FULL = 0xffffffffu;

// probe_pack: a block's tile is 32 rows x PACK_TW columns, a thread 4
// columns. Warp q stages segment q % PACK_SEGS (512 bytes) of rows q /
// PACK_SEGS + 4 j, j < 8: every thread makes 8 loads a tile.
constexpr int PACK_TW = 512;
constexpr int PACK_NT = PACK_TW / 4;
constexpr int PACK_SEGS = PACK_TW / 512;
constexpr int PACK_STEPS = 8;
static_assert(PACK_TW % 512 == 0 && PACK_NT / 32 / PACK_SEGS * PACK_STEPS == 32,
              "8 steps of 4 rows cover the tile's 32 rows");

// The aligned 4 bytes of a row at columns c .. c + 3 (c > -4; row + c
// 4-byte aligned) as a little-endian word, `at` the row's offset in the mask
// of n bytes: no load where they lie wholly past w; one 4-byte load where
// they lie inside the mask (bytes before 0 or from w on are the rows' before
// and after, shifted out or left in tile columns past w, which reach no
// stored word); byte by byte only at the mask's own first and last bytes.
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, long long at, long long n, int c,
                                             int w) {
  if (c >= w) return 0;
  if (at + c >= 0 && at + c + 4 <= n) return __ldg(reinterpret_cast<const uint32_t*>(row + c));
  uint32_t v = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (c + s >= 0 && c + s < w) v |= (uint32_t)__ldg(row + c + s) << (8 * s);
  return v;
}

// A lane's loads of the 512-byte segment of a row from column cs, the row
// at `at` in the mask of n bytes and a16 its address mod 16. A row whose
// address is 16-byte aligned: 16 bytes from cs + 16 lane, in v[0..3]. Any
// other row, a = a16 % 4: the aligned words at columns cs + 4 (32 q + lane)
// - a in v[q], and, at lane 31, the one at cs + 512 - a in *next;
// words_of_row cuts them into the row's own words. Where the segment and a
// word either side lie inside the mask (every segment but the mask's first
// and last), the loads go unchecked: bytes past w land in tile columns that
// reach no stored word. Elsewhere each word goes through row_word.
__device__ __forceinline__ void load_row_segment(const uint8_t* __restrict__ row, long long at,
                                                 long long n, int w, int cs, int lane, int a16,
                                                 uint32_t (&v)[4], uint32_t* next) {
  const int a = a16 & 3;
  if (at + cs - 4 >= 0 && at + cs + 516 <= n) {
    if (a16 == 0) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + cs) + lane);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(row + cs - a);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __ldg(p + 32 * q + lane);
      *next = lane == 31 ? __ldg(p + 128) : 0u;
    }
  } else if (a16 == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = row_word(row, at, n, cs + 16 * lane + 4 * q, w);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = row_word(row, at, n, cs + 4 * (32 * q + lane) - a, w);
    *next = lane == 31 ? row_word(row, at, n, cs + 512 - a, w) : 0u;
  }
}

// The row's words at columns cs + 4 (32 q + lane) .. + 3 from the aligned
// words load_row_segment read at a bytes before them: each is the high 4 - a
// bytes of its own aligned word and the low a bytes of the next (the next
// lane's, at lane 31 lane 0's of q + 1, past q = 3 the extra word).
__device__ __forceinline__ void words_of_row(uint32_t (&v)[4], uint32_t next, int a, int lane) {
  if (a == 0) return;  // the aligned words are the row's (a is the same on every lane)
  uint32_t hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t down = __shfl_down_sync(FULL, v[q], 1);
    const uint32_t wrap = q < 3 ? __shfl_sync(FULL, v[q < 3 ? q + 1 : 0], 0) : next;
    hi[q] = lane == 31 ? wrap : down;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = __funnelshift_r(v[q], hi[q], 8 * a);
}

// 16 bytes from global memory into shared memory with no registers
// between (cp.async.cg); `bytes` 0 writes 16 zeros and reads nothing.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int bytes) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(bytes));
}

// Word rows blockIdx.y (+ gridDim.y, ...) at columns blockIdx.x PACK_TW ..
// + PACK_TW - 1. VEC: every row's address is 16-byte aligned and w % 16 ==
// 0, so a lane's 16 bytes lie wholly inside w or past it: the tile is staged
// by cp.async (one commit and wait). Else through registers: 16-byte loads
// for a row whose address is 16-byte aligned, aligned 4-byte words cut by a
// funnel shift for any other, every load issued before the first shared
// store (and, past the first word row, before the barrier).
template <bool VEC>
__global__ void __launch_bounds__(PACK_NT) pack_tile_kernel(const uint8_t* __restrict__ x,
                                                            uint32_t* __restrict__ out, int h,
                                                            int w) {
  __shared__ __align__(16) uint32_t tile[32][PACK_TW / 4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = warp % PACK_SEGS, r0 = warp / PACK_SEGS;
  const int c0 = blockIdx.x * PACK_TW, cs = c0 + 512 * seg;
  const int hw = (h + 31) / 32;
  for (int k = blockIdx.y; k < hw; k += gridDim.y) {
    if (VEC) {
      if (k != (int)blockIdx.y) __syncthreads();  // the last word row's transpose is done
#pragma unroll
      for (int j = 0; j < PACK_STEPS; ++j) {
        const int y = 32 * k + r0 + 4 * j, c = cs + 16 * lane;
        const bool in = y < h && c < w;
        copy16_async(reinterpret_cast<uint8_t*>(tile[r0 + 4 * j]) + 512 * seg + 16 * lane,
                     in ? x + (size_t)y * w + c : x, in ? 16 : 0);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    } else {
      uint32_t v[PACK_STEPS][4], next[PACK_STEPS];
      int a[PACK_STEPS];  // the row's address mod 16 (c0 is a multiple of 512)
#pragma unroll
      for (int j = 0; j < PACK_STEPS; ++j) {
        const int y = 32 * k + r0 + 4 * j;
        const uint8_t* row = x + (size_t)y * w;
        a[j] = (int)(reinterpret_cast<uintptr_t>(row) & 15);
        if (y < h) {
          load_row_segment(row, (long long)y * w, (long long)h * w, w, cs, lane, a[j], v[j],
                           &next[j]);
        } else {
          a[j] = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) v[j][q] = 0;
        }
      }
      if (k != (int)blockIdx.y) __syncthreads();  // the last word row's transpose is done
#pragma unroll
      for (int j = 0; j < PACK_STEPS; ++j) {
        uint32_t* seg_at = tile[r0 + 4 * j] + 128 * seg;
        if (a[j] == 0) {
          *reinterpret_cast<uint4*>(seg_at + 4 * lane) =
              make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
        } else {
          words_of_row(v[j], next[j], a[j] & 3, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q) seg_at[32 * q + lane] = v[j][q];
        }
      }
    }
    __syncthreads();
    // Byte b of acc[g]: bit s is row 8 g + s of column 4 tid + b.
    uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const uint32_t b = tile[r][tid];  // a warp's lanes: consecutive words, no bank conflict
      const uint32_t nz = (((b & 0x7f7f7f7fu) + 0x7f7f7f7fu) | b) & 0x80808080u;  // bit 7: != 0
      acc[r >> 3] |= nz >> (7 - (r & 7));
    }
    // The 4 x 4 byte transpose: word b = byte b of acc[0..3].
    const uint32_t t0 = __byte_perm(acc[0], acc[1], 0x5140);
    const uint32_t t1 = __byte_perm(acc[0], acc[1], 0x7362);
    const uint32_t t2 = __byte_perm(acc[2], acc[3], 0x5140);
    const uint32_t t3 = __byte_perm(acc[2], acc[3], 0x7362);
    const uint32_t word[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                              __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
    const int c = c0 + 4 * tid;
    uint32_t* o = out + (size_t)k * w + c;
    if (c + 4 <= w && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<uint4*>(o) = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q < w) o[q] = word[q];
    }
  }
}

// probe_pack's grid: x the column tiles, y the word rows (a loop past 65535).
dim3 pack_grid(int h, int w) {
  const int hw = (h + 31) / 32;
  return dim3((w + PACK_TW - 1) / PACK_TW, hw < 65535 ? hw : 65535);
}

// probe_pack's route from the mask's address mod 16: the vector instance
// where every row's address is 16-byte aligned.
bool pack_vector(uintptr_t address, int w) { return w % 16 == 0 && (address & 15) == 0; }

constexpr int BALLOT_TASKS = 2;  // tasks a warp has in flight

// Lane r's 32 bytes of row y at columns c0..c0+31, as 8 words (byte j of the
// row in byte j % 4 of word j / 4); 0 past h and past w.
__device__ __forceinline__ void load_row32(const uint8_t* __restrict__ x, int h, int w, int y,
                                           int c0, uint32_t (&v)[8]) {
  const uint8_t* p = x + (size_t)y * w + c0;
  if (y >= h) {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = 0;
  } else if (c0 + 32 <= w && ((uintptr_t)p & 15) == 0) {  // the row's address, not its column
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        word |= (c0 + 4 * q + s < w ? (uint32_t)__ldg(p + 4 * q + s) : 0u) << (8 * s);
      v[q] = word;
    }
  }
}

// Tasks (word row k, 32 columns from c0), k-major, walked by every warp of
// the grid; BALLOT_TASKS tasks' loads are issued before their ballots.
__global__ void __launch_bounds__(NT) pack_ballot_kernel(const uint8_t* __restrict__ x,
                                                         uint32_t* __restrict__ out, int h, int w,
                                                         long long tasks) {
  const int lane = threadIdx.x & 31;
  const int groups = (w + 31) / 32;
  const long long warps = (long long)gridDim.x * (NT / 32);
  for (long long t = ((long long)blockIdx.x * NT + threadIdx.x) >> 5; t < tasks;
       t += BALLOT_TASKS * warps) {  // t is the same on every lane
    uint32_t v[BALLOT_TASKS][8];
#pragma unroll
    for (int i = 0; i < BALLOT_TASKS; ++i) {
      const long long ti = t + i * warps;
      const int k = (int)(ti / groups), c0 = (int)(ti - (long long)k * groups) * 32;
      load_row32(x, ti < tasks ? h : 0, w, 32 * k + lane, c0, v[i]);
    }
#pragma unroll
    for (int i = 0; i < BALLOT_TASKS; ++i) {
      const long long ti = t + i * warps;
      if (ti >= tasks) break;
      const int k = (int)(ti / groups), c0 = (int)(ti - (long long)k * groups) * 32;
      uint32_t mine = 0;  // lane b keeps the word of column c0 + b
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const uint32_t word = __ballot_sync(FULL, (v[i][b >> 2] >> (8 * (b & 3))) & 0xffu);
        mine = lane == b ? word : mine;
      }
      if (c0 + lane < w) out[(size_t)k * w + c0 + lane] = mine;
    }
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

// The resident route: one block, thread (g, c) = g tw + c (tw: w rounded up
// to a warp) holding rows g R .. g R + R - 1 of column c (fewer in the last
// group; none when c >= w).
constexpr int LOOP_NT = 1024;  // a block's threads at most
constexpr int LOOP_R = 10;     // rows a thread at most: no instance spills (PERF.md)

struct LoopPlan {
  int resident;  // 1: the resident route; 0: the grid route
  int blocks;
  int threads;   // a block's
  int words;     // words a thread at most (R on the resident route)
  int tw;        // resident: columns rounded up to a warp
};

struct LoopShared {
  uint32_t last[2][LOOP_NT];               // each thread's last row, by round parity
  uint32_t edge[2][LOOP_NT / 32][LOOP_R];  // each warp's lane 0 rows, by round parity
};

// One round of a thread's R rows (downwards: f[r - 1] is still the last
// round's): the next lane's word by a shuffle, or at an edge lane the
// published column. Rows at or past `mine` (the last group) stay 0 and count
// as no change when PARTIAL; in a full group every row is the plane's, and a
// lane past w only ever meets zeros. Returns the rows' changed bits.
template <int R, bool PARTIAL>
__device__ __forceinline__ uint32_t round_rows(uint32_t (&f)[R], uint32_t above, bool from_edge,
                                               const uint32_t* edge, int mine) {
  uint32_t diff = 0;
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const uint32_t next = __shfl_down_sync(FULL, f[r], 1);
    const uint32_t right = from_edge ? edge[r] : next;
    uint32_t nv = f[r] | (r > 0 ? f[r > 0 ? r - 1 : 0] : above) | right | (f[r] << 1);
    if (PARTIAL) nv = r < mine ? nv : 0u;
    diff |= nv ^ f[r];
    f[r] = nv;
  }
  return diff;
}

// The resident loop for a thread's rows R (1..LOOP_R): a thread's words stay
// in registers, indexed at compile time; a round reads the block's shared
// memory and ends on one barrier. ptxas's own register choice: a
// __launch_bounds__(1024, 1) hint cost the 10-row instance 12% (PERF.md §6).
template <int R>
__global__ void __launch_bounds__(LOOP_NT)
    loop_block_kernel(uint32_t* a, int* flags, int hw, int w, int max_rounds, int tw) {
  __shared__ LoopShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / tw, c = tid - g * tw;
  const int mine = c < w ? max(0, min(R, hw - g * R)) : 0;  // this thread's rows
  const bool partial = (g + 1) * R > hw;                     // the last group
  // The row above row 0 of this thread: the group above's last row, or at
  // g = 0 the last group's (the plane's last row; 0 past w).
  const uint32_t* up = &sh.last[0][(g > 0 ? g - 1 : blockDim.x / tw - 1) * tw + c];
  // The column right of c: the next lane's, or past a warp's last lane and at
  // the plane's last column (cyclic) the column a warp publishes.
  const bool wrap = c == w - 1;
  const bool from_edge = mine > 0 && (lane == 31 || wrap);
  const int src_warp = min(g * (tw / 32) + (wrap ? 0 : (c + 1) / 32), LOOP_NT / 32 - 1);

  uint32_t f[R];
#pragma unroll
  for (int r = 0; r < R; ++r) f[r] = r < mine ? a[(size_t)(g * R + r) * w + c] : 0u;
  auto publish = [&](int buf) {
    uint32_t last = f[R - 1];
    if (partial)
#pragma unroll
      for (int r = 0; r < R; ++r) last = r == mine - 1 ? f[r] : last;
    sh.last[buf][tid] = last;
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < R; ++r) sh.edge[buf][warp][r] = f[r];
  };
  publish(0);
  __syncthreads();
  int it = 0, changed = 1;
  do {  // the first round unconditional, as the probe's body before its while_loop
    const int buf = it & 1;
    const uint32_t above = up[buf * LOOP_NT];
    const uint32_t* edge = sh.edge[buf][src_warp];
    const uint32_t diff = partial ? round_rows<R, true>(f, above, from_edge, edge, mine)
                                  : round_rows<R, false>(f, above, from_edge, edge, mine);
    publish(buf ^ 1);
    changed = __syncthreads_or(diff != 0);
    ++it;
  } while (changed && it < max_rounds);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < mine) a[(size_t)(g * R + r) * w + c] = f[r];
  if (tid == 0) {
    flags[0] = it;
    flags[1] = changed;
  }
}

using ResidentKernel = void (*)(uint32_t*, int*, int, int, int, int);

template <int... Rs>
ResidentKernel resident_kernel(int R, std::integer_sequence<int, Rs...>) {
  static const ResidentKernel table[] = {&loop_block_kernel<Rs + 1>...};
  return table[R - 1];
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

// The byte mode's runs: a block takes the 32 image rows of word row
// blockIdx.y (+ gridDim.y, ...) at runs 8 blockIdx.x .. + 7 of each row, so
// the rows' re-reads of the same words hit the block's L1 (no shared
// memory: the contrast with unpack.cu's staging). Warp q of the block takes
// rows 8 (q & 3) .. + 7, runs 4 (q >> 2) .. + 3 (lane: row lane >> 2, run
// lane & 3): eight rows share each 16-byte word load (a warp of 4 rows x 8
// runs took 19.6 us against 15.2 at 8K on an H100, PERF.md §6). Run m of
// row r is its 16 bytes from column d + 16 m, d the row's first 16-byte
// boundary as a column (the row's address, not its column): one 16-byte
// store of the 16 words' bit r & 31, read as four 16-byte loads where the
// words' address is 16-byte aligned, else one by one. The head (columns
// before d, by run 0's thread) and a tail past w go byte by byte.
constexpr int RUNS_X = 8;  // runs a block along a row

__device__ __forceinline__ uint32_t expand_nibble(uint32_t n) {  // 4 bits -> 4 bytes 0 / 255
  return ((n * 0x00204081u) & 0x01010101u) * 0xffu;
}

__global__ void __launch_bounds__(NT) unpack_runs_kernel(const uint32_t* __restrict__ f,
                                                         uint8_t* __restrict__ out, int hw, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = 8 * (warp & 3) + (lane >> 2);                         // the bit: row 32 k + j
  const int m = RUNS_X * blockIdx.x + 4 * (warp >> 2) + (lane & 3);  // the run of the row
  for (int k = blockIdx.y; k < hw; k += gridDim.y) {
    const uint32_t* fr = f + (size_t)k * w;
    uint8_t* row = out + ((size_t)32 * k + j) * w;
    const int d = (16 - (int)(reinterpret_cast<uintptr_t>(row) & 15)) & 15;
    if (m == 0)
      for (int c = 0; c < d && c < w; ++c) row[c] = (__ldg(fr + c) >> j) & 1u ? 255 : 0;
    const int c = d + 16 * m;
    if (c >= w) continue;
    if (c + 16 > w) {
      for (int cc = c; cc < w; ++cc) row[cc] = (__ldg(fr + cc) >> j) & 1u ? 255 : 0;
      continue;
    }
    const uint32_t* wp = fr + c;
    uint32_t bits = 0;
    if ((reinterpret_cast<uintptr_t>(wp) & 15) == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(wp) + q);
        bits |= (((v.x >> j) & 1u) | (((v.y >> j) & 1u) << 1) | (((v.z >> j) & 1u) << 2) |
                 (((v.w >> j) & 1u) << 3)) << (4 * q);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) bits |= ((__ldg(wp + i) >> j) & 1u) << i;
    }
    *reinterpret_cast<uint4*>(row + c) =
        make_uint4(expand_nibble(bits & 15u), expand_nibble((bits >> 4) & 15u),
                   expand_nibble((bits >> 8) & 15u), expand_nibble(bits >> 12));
  }
}

// The byte mode's grid: x the runs of a row (ceil(w / 16) at most, RUNS_X a
// block), y the word rows (a loop past 65535).
dim3 runs_grid(int hw, int w) {
  const int runs = (w + 15) / 16;
  return dim3((runs + RUNS_X - 1) / RUNS_X, hw < 65535 ? hw : 65535);
}

unsigned blocks_for(long long items) {
  const long long b = (items + NT - 1) / NT;
  return (unsigned)(b < 1 ? 1 : (b > (1 << 20) ? (1 << 20) : b));
}

// Co-resident blocks of `kernel` a multiprocessor times the multiprocessors,
// or a negative CUDA error.
int resident_blocks(const void* kernel, int threads, int device) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// The ballot pack's grid: enough blocks that each warp holds BALLOT_TASKS
// tasks, up to the blocks that fill the card. Cached per device.
int ballot_blocks(long long tasks, int device) {
  static int fill[64];
  if (device < 0 || device >= 64) return -(int)cudaErrorInvalidDevice;
  if (fill[device] == 0) fill[device] = resident_blocks((const void*)pack_ballot_kernel, NT, device);
  if (fill[device] < 0) return fill[device];
  const long long want = (tasks + BALLOT_TASKS * (NT / 32) - 1) / (BALLOT_TASKS * (NT / 32));
  return (int)(want < 1 ? 1 : (want < fill[device] ? want : fill[device]));
}

// The loop's route. Resident: one block, where ceil(hw / (LOOP_NT / tw))
// rows a thread is at most LOOP_R (a 40 x 256 plane at most; the fastest form
// on it, PERF.md §6); else the grid route over `limit` blocks at most.
// blocks >= 1 or sync_only: the grid route with that grid.
LoopPlan probe_loop_plan(int hw, int w, int blocks, int sync_only, int limit) {
  LoopPlan p{};
  const int tw = (w + 31) / 32 * 32;
  if (blocks < 1 && !sync_only && w <= LOOP_NT) {
    const int groups = LOOP_NT / tw;
    const int R = (hw + groups - 1) / groups;
    if (R <= LOOP_R) {
      p.resident = 1;
      p.blocks = 1;
      p.threads = (hw + R - 1) / R * tw;
      p.words = R;
      p.tw = tw;
      return p;
    }
  }
  const long long n = (long long)hw * w;
  long long grid = blocks >= 1 ? blocks : (n + NT - 1) / NT;
  if (grid > limit && blocks < 1) grid = limit;
  p.blocks = (int)grid;
  p.threads = NT;
  p.words = (int)((n + grid * NT - 1) / (grid * NT));
  return p;
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
  if (ballot) {
    const long long tasks = (long long)hw * ((w + 31) / 32);
    const int blocks = ballot_blocks(tasks, device);
    if (blocks < 0) return -blocks;
    pack_ballot_kernel<<<blocks, NT, 0, s>>>(xp, op, h, w, tasks);
  } else if (pack_vector(reinterpret_cast<uintptr_t>(x), w)) {
    pack_tile_kernel<true><<<pack_grid(h, w), PACK_NT, 0, s>>>(xp, op, h, w);
  } else {
    pack_tile_kernel<false><<<pack_grid(h, w), PACK_NT, 0, s>>>(xp, op, h, w);
  }
  return cudaGetLastError();
}

// The launch probe_pack makes for an (h, w) mask whose first byte lies
// `offset` bytes past a 16-byte boundary: out[0] 1 the vector instance / 0
// the general one, out[1] threads a block, out[2] blocks, out[3] a tile's
// columns, out[4] columns a thread, out[5] a block's shared memory in bytes.
extern "C" int cc_probe_pack_layout(int h, int w, int offset, int* out) {
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  const dim3 g = pack_grid(h, w);
  out[0] = pack_vector((uintptr_t)offset, w) ? 1 : 0;
  out[1] = PACK_NT;
  out[2] = (int)(g.x * g.y);
  out[3] = PACK_TW;
  out[4] = 4;
  out[5] = 32 * PACK_TW;
  return cudaSuccess;
}

// The ballot pack's grid for an (h, w) mask on `device`: out[0] blocks,
// out[1] threads a block, out[2] tasks (word rows x 32-column groups),
// out[3] tasks a warp has in flight.
extern "C" int cc_probe_ballot_grid(int h, int w, int device, int* out) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (h < 1 || w < 1) return cudaErrorInvalidValue;
  const long long tasks = (long long)((h + 31) / 32) * ((w + 31) / 32);
  const int blocks = ballot_blocks(tasks, device);
  if (blocks < 0) return -blocks;
  out[0] = blocks;
  out[1] = NT;
  out[2] = (int)tasks;
  out[3] = BALLOT_TASKS;
  return cudaSuccess;
}

// The most co-resident blocks of the grid route's kernel on `device`: the
// cooperative grid's limit.
extern "C" int cc_probe_loop_max_blocks(int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -(int)guard.err;
  return resident_blocks((const void*)loop_kernel, NT, device);
}

// The route probe_loop takes for an (hw, w) plane with its default grid on
// `device`: out[0] 1 resident / 0 grid, out[1] blocks, out[2] threads a
// block, out[3] words a thread at most, out[4] a block's static shared memory
// in bytes, out[5] barriers a round (the resident route: one
// __syncthreads_or; the grid route: a __syncthreads_or and a grid.sync()).
extern "C" int cc_probe_loop_layout(int hw, int w, int device, int* out) {
  if (hw < 1 || w < 1) return cudaErrorInvalidValue;
  const int limit = cc_probe_loop_max_blocks(device);
  if (limit < 1) return limit < 0 ? -limit : cudaErrorCooperativeLaunchTooLarge;
  const LoopPlan p = probe_loop_plan(hw, w, 0, 0, limit);
  out[0] = p.resident;
  out[1] = p.blocks;
  out[2] = p.threads;
  out[3] = p.words;
  out[4] = p.resident ? (int)sizeof(LoopShared) : 0;
  out[5] = p.resident ? 1 : 2;
  return cudaSuccess;
}

// plane: (hw, w) words, updated in place; scratch: hw * w + 3 words (the
// grid route's); flags: 2 ints. blocks < 1 and not sync_only: the route by
// the plane's size (probe_loop_plan), the grid route covering the plane's
// words up to the cooperative limit; blocks >= 1: the grid route on exactly
// that grid.
extern "C" int cc_probe_loop(void* plane, void* scratch, void* flags, int hw, int w,
                             int max_rounds, int sync_only, int blocks, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (hw < 1 || w < 1) return cudaErrorInvalidValue;
  const int limit = cc_probe_loop_max_blocks(device);
  if (limit < 1) return limit < 0 ? -limit : cudaErrorCooperativeLaunchTooLarge;
  if (blocks > limit) return cudaErrorCooperativeLaunchTooLarge;  // asked for more than fits
  const LoopPlan p = probe_loop_plan(hw, w, blocks, sync_only, limit);
  uint32_t* a = static_cast<uint32_t*>(plane);
  int* fl = static_cast<int*>(flags);
  auto s = static_cast<cudaStream_t>(stream);
  if (p.resident) {  // one block of the instance for R = p.words
    const ResidentKernel kernel =
        resident_kernel(p.words, std::make_integer_sequence<int, LOOP_R>());
    kernel<<<1, p.threads, 0, s>>>(a, fl, hw, w, max_rounds, p.tw);
    return cudaGetLastError();
  }
  uint32_t* b = static_cast<uint32_t*>(scratch);
  int* chg = reinterpret_cast<int*>(b + (long long)hw * w);
  void* args[] = {&a, &b, &chg, &fl, &hw, &w, &max_rounds, &sync_only};
  const cudaError_t err = cudaLaunchCooperativeKernel((void*)loop_kernel, dim3((unsigned)p.blocks),
                                                      dim3(NT), args, 0, s);
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
    unpack_runs_kernel<<<runs_grid(hw, w), NT, 0, s>>>(fp, op, hw, w);
  return cudaGetLastError();
}

// The grid probe_unpack launches for (hw, w) words: out[0] 1 the byte
// mode's runs / 0 a thread per word, out[1] threads a block, out[2] blocks,
// out[3] output bytes a thread (16 a run; 32 a word).
extern "C" int cc_probe_unpack_layout(int hw, int w, int per_word, int* out) {
  if (hw < 1 || w < 1) return cudaErrorInvalidValue;
  const dim3 g = runs_grid(hw, w);
  out[0] = per_word ? 0 : 1;
  out[1] = NT;
  out[2] = per_word ? (int)blocks_for((long long)hw * w) : (int)(g.x * g.y);
  out[3] = per_word ? 32 : 16;
  return cudaSuccess;
}
