// int8_mma.cuh: the pipelined int8 tensor-core mainloop of the wide
// matmuls: quant_matmul and nm_spmm (quant_matmul.cu, rows 3 and 4) and
// seq_policy_matmul under policy wide (seq_policy_matmul.cu, row 1). It
// computes out[m, n] = sum_k x[m, k] * w[n, k] in int32 from x (M, K) int8
// and weight rows w[n, :] that a loader stages into shared memory as
// (N, K) rows; quant_matmul.cu's header says what each loader replaces and
// what bounds the kernels.
//
// The sum is an int32 dot_general's bit for bit: int8 products are exact,
// the mma adds in int32 without .satfinite, so a sum past 2^31 wraps
// (two's complement) instead of saturating, and the partial sums of a
// split K are added with atomicAdd, also modulo 2^32, in any order.
//
// The body: a block owns a (16 MT) x 64 output tile (MT = 1 for M <= 16,
// decode, 4 warps of 16 columns; MT = 8 above, 8 warps, a 2 x 4 grid of 64
// rows by 16 columns) and walks its share of K in slabs of 64 through a
// ring of shared-memory stages (3 at decode, where smaller stages let more
// blocks share an SM; 4 above). A stage holds the slab's x rows,
// its 64 weight rows over K (the tile the tensor cores read) and, for the
// loaders that rebuild that tile, the raw bytes they rebuild it from:
// - x's rows are copied by cp.async, 16 bytes at a time where x and K allow
//   it, else 4 (cp.async's zero fill masks K), else loaded by bytes and
//   stored; rows past M are never copied (their outputs are never stored);
// - the loader copies its slab the same way, either straight into the
//   weight tile (dense (N, K) rows, kLead 0) or into the stage's raw bytes
//   (kLead 1), from which each thread builds its part of the tile of the
//   next slab, reading only bytes it copied itself (so no barrier sits
//   between its wait and its build), while other warps may still run the
//   tensor cores on this one;
// - the stage S - 1 ahead (S stages) is started right after the one
//   barrier of a slab, which ends the reads of that stage's last use, and
//   the wait for the next slab's copies comes after this slab's mmas: S - 1
//   slabs' copies are in flight while the tensor cores work;
// - fragments are read with ldmatrix (no .trans): x rows are the .row A
//   operand and the (N, K) rows the .col B operand of
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32, both K-contiguous, so no byte
//   permutes; rows are padded to 80 bytes, so the 8 rows one ldmatrix phase
//   reads fall in distinct banks;
// - each warp runs the mma for every 16-row tile of its rows that holds a
//   row below M.
// When the output tiles alone leave the card room for more blocks at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs, at most 4
// an SM at decode and 2 above), K is split among as many blocks as fill
// that one wave, and the partial sums are added with atomicAdd into an
// output zeroed first.
//
// The epilogue is the kernel's template parameter E:
// - WholeK (rows 1 `wide`, 3 and 4, row 5 `wide`): the (M, N) sums over
//   the block's share of K, stored (or added atomically, K split) after
//   its last slab;
// - WrapK (row 5 `wrap`, nm_seq_policy_matmul.cu): the same sums, each
//   output then the acc_bits register of its exact sum, one floor mod
//   (a sign extension of its low acc_bits bits, which the int32 sum's
//   wrap modulo 2^32 does not change): in the store where K is not split,
//   else in wrap_kernel, a pass over the (M, N) output after the atomics;
// - TileSums (row 9, sorted_stream.cu): the (M, N, T) sums of each k_tile
//   tile, contiguous along T (k_tile a power-of-two multiple of kBK).
//   After every k_tile / kBK slabs the block puts its accumulators in
//   shared memory as that tile's sums and zeroes them; every kHeld tiles
//   (and after its last) it writes the held tiles out, 8 lanes to an
//   output's run of tiles, so a warp's store covers 4 runs and not 32
//   outputs T words apart (stored from the fragments, those scattered
//   words took most of the kernel's time at M = 128). K is split on whole
//   tiles (launch_tile_sums), so each (m, n, t) has one writer: no
//   atomics, no memset. The held tiles of a 16-row block take 35 KB;
//   above decode, blocks of 32 rows keep them at 70 KB (128-row blocks
//   would need 278 KB).
//
// A loader W provides:
//   static constexpr int kLead;                 0 or 1, as above
//   static constexpr bool kExact;               whether build may flag
//   int raw_bytes() const;                      a stage's raw bytes (a
//                                               multiple of 16)
//   template <int NT> void start(uint8_t* tile, uint8_t* raw, int n0,
//                                int k0) const;
//   template <int NT> void build(uint8_t* tile, const uint8_t* raw,
//                                int n0, int k0, int* flag) const;
// (NT the block's threads) so that after start's copies land (and, with
// kLead 1, build) tile[r * kRow + j] holds weight row n0 + r at position
// k0 + j for r < kBN, j < kBK: rows at or past N are free (their outputs
// are never stored), and so are positions at or past K, which multiply
// x's zero fill. A loader whose weights are sums that may leave int8
// (kExact: nm_chunks.cuh's, on slabs whose slots name one position
// twice) sets the block's shared *flag to 1 in build where the tile it
// built is not those sums, and provides
//   int exact(const int8_t* xrow, int n, int k_begin, int k_end) const;
// the exact int32 sum of x's row times weight row n over [k_begin,
// k_end): a flagged block takes it for each of its outputs instead of the
// tensor cores' sums. The flag is a route the data picks (canonical slabs
// never set it), read after the mainloop's last barrier, so it costs
// the block one barrier where it is set to 0 and nothing else.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace mma8 {

constexpr int kBK = 64;           // K of a slab
constexpr int kBN = 64;           // output columns of a block
constexpr int kRow = kBK + 16;    // bytes of a staged row (80)
constexpr int kPrefillTiles = 8;  // MT above decode: 128 rows a block
constexpr int kTileSumsTiles = 2;  // TileSums' MT above decode: 32 rows

// A block of MT 16-row tiles: its warps (4 over the tile's columns, times 2
// over its rows at a prefill cohort) and the stages of its ring.
template <int MT>
struct Shape {
  static constexpr int kWarpsM = MT >= 4 ? 2 : 1;
  static constexpr int kThreads = 128 * kWarpsM;
  static constexpr int kTiles = MT / kWarpsM;  // 16-row tiles of a warp
  static constexpr int kStages = MT == 1 ? 3 : 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// B bytes (16, 8 or 4) from src to shared dst, the first `bytes` of them
// read and the rest zero-filled (bytes 0 reads nothing).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(B), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 16-byte matrices from shared memory, lanes 8i .. 8i + 7 giving
// the row addresses of matrix i; lane l receives bytes 4 (l % 4) .. + 3 of
// row l / 4 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 x 32 int8 tile, exact int32 (wrapping) adds.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes p[0 .. n) packed little-endian into a word (0 past n).
__device__ __forceinline__ uint32_t pack_bytes(const int8_t* p, int n) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j)))
           << (8 * j);
  return v;
}

// A 4 x 4 byte block transposed: y[r] byte s = x[s] byte r (8 byte
// permutes).
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4],
                                           uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t2 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t1, 0x5410);
  y[1] = __byte_perm(t0, t1, 0x7632);
  y[2] = __byte_perm(t2, t3, 0x5410);
  y[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// The widest copy that src's rows of K bytes allow: 16 (cp.async of 16
// bytes), 4 (of 4) or 1 (byte loads).
inline int copy_mode(const void* src, int K) {
  const auto a = reinterpret_cast<uintptr_t>(src);
  return a % 16 == 0 && K % 16 == 0 ? 16 : a % 4 == 0 && K % 4 == 0 ? 4 : 1;
}

// Rows r < min(R, rows) of a byte matrix, kBK bytes each, by NT threads:
// dst[r kRow + c] = src[r src_ld + c] for c < valid, 0 for valid <= c <
// kBK, by copies of `mode` bytes: 16 or 4 (cp.async; src and src_ld
// multiples of it) or 1 (byte loads, stored as words).
template <int R, int NT>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const int8_t* src,
                                          int64_t src_ld, int rows, int valid,
                                          int mode) {
  const int shift = mode == 16 ? 2 : 4;  // log2 of a row's copies
  const int step = kBK >> shift;
  const int c = step * (threadIdx.x & ((1 << shift) - 1));
  const int bytes = min(max(valid - c, 0), step);
  rows = min(rows, R);
  for (int r = threadIdx.x >> shift; r < rows; r += NT >> shift) {
    const int8_t* row = src + r * src_ld;
    uint8_t* to = dst + r * kRow + c;
    if (mode == 16)
      cp_async<16>(to, bytes ? row + c : row, bytes);
    else if (mode == 4)
      cp_async<4>(to, bytes ? row + c : row, bytes);
    else
      store_word(to, pack_bytes(row + c, bytes));
  }
}

// One contiguous run of a thread's own: dst[0 .. len) = src[0 .. valid)
// then zeros, by copies of `mode` bytes (16, 8 or 4: cp.async, src, dst and
// len multiples of it; 1: byte loads and stores). valid > 0.
__device__ __forceinline__ void copy_run(uint8_t* dst, const int8_t* src,
                                         int len, int valid, int mode) {
  if (mode == 1) {
    for (int o = 0; o < len; ++o) dst[o] = o < valid ? src[o] : 0;
    return;
  }
  for (int o = 0; o < len; o += mode) {
    const int bytes = min(max(valid - o, 0), mode);
    const int8_t* from = bytes ? src + o : src;
    if (mode == 16)
      cp_async<16>(dst + o, from, bytes);
    else if (mode == 8)
      cp_async<8>(dst + o, from, bytes);
    else
      cp_async<4>(dst + o, from, bytes);
  }
}

// The loader of dense (N, K) weight rows: copied like x, straight into the
// tile.
struct DenseRows {
  const int8_t* w;
  int N, K, mode;
  static constexpr int kLead = 0;
  __host__ __device__ __forceinline__ int raw_bytes() const { return 0; }
  template <int NT>
  __device__ __forceinline__ void start(uint8_t* tile, uint8_t*, int n0,
                                        int k0) const {
    copy_tile<kBN, NT>(tile, w + static_cast<int64_t>(n0) * K + k0, K,
                       N - n0, K - k0, mode);
  }
  static constexpr bool kExact = false;
  template <int NT>
  __device__ __forceinline__ void build(uint8_t*, const uint8_t*, int,
                                        int, int*) const {}
};

// The epilogues (see the header).
struct WholeK {
  static constexpr bool kTiled = false;
  static constexpr bool kWrap = false;
  __device__ __forceinline__ int value(int sum) const { return sum; }
};

// The acc_bits register of a sum (2 <= acc_bits <= 30): its low acc_bits
// bits, sign-extended, the floor mod of policy wrap.
__device__ __forceinline__ int wrap_bits(int sum, int acc_bits) {
  return static_cast<int>(static_cast<unsigned>(sum) << (32 - acc_bits)) >>
         (32 - acc_bits);
}

struct WrapK {
  static constexpr bool kTiled = false;
  static constexpr bool kWrap = true;
  int acc_bits;
  __device__ __forceinline__ int value(int sum) const {
    return wrap_bits(sum, acc_bits);
  }
};

struct TileSums {
  static constexpr bool kTiled = true;
  static constexpr bool kWrap = false;
  static constexpr int kHeld = 8;            // tiles held before a write
  static constexpr int kRowWords = kBN + 4;  // a held row's int32 words
  // a held tile: 16 MT rows, 4 words more so that the 8 lanes of a run
  // (8 tiles) and 4 columns read 32 banks
  template <int MT>
  __host__ __device__ static constexpr int tile_words() {
    return 16 * MT * kRowWords + 4;
  }
  // the held tiles' bytes, after the ring
  template <int MT>
  __host__ __device__ static constexpr int smem_bytes() {
    return kHeld * tile_words<MT>() * 4;
  }
  int shift;    // log2(k_tile / kBK): a tile's slabs
  int T;        // tiles of an output row (kp / k_tile)
  int tiles_k;  // tiles holding a position below K; the rest sum to 0
};

// TileSums: a thread's accumulators (acc[mt][j][e] at the block's row 16
// (mt0 + mt) + g + 8 (e >> 1), column wn * 16 + 8 j + 2 t + (e & 1), for
// mt0 + mt < live) put in a held tile, then zeroed.
template <int TW>
__device__ __forceinline__ void hold_tile(int (&acc)[TW][2][4],
                                          int32_t* tile, int mt0, int wn,
                                          int g, int t, int live) {
#pragma unroll
  for (int mt = 0; mt < TW; ++mt) {
    if (mt0 + mt >= live) break;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (mt0 + mt) + g + 8 * (e >> 1);
        tile[r * TileSums::kRowWords + wn * 16 + 8 * j + 2 * t + (e & 1)] =
            acc[mt][j][e];
        acc[mt][j][e] = 0;
      }
  }
}

// TileSums: the block's `count` held tiles written out as tiles tile0 ..
// tile0 + count - 1 of out (M, N, T): lanes 8c .. 8c + 7 of a warp write
// one output's run of up to kHeld tiles. Every thread of the block calls
// it.
template <int MT, int NT>
__device__ __forceinline__ void write_held(const int32_t* held,
                                           int32_t* __restrict__ out, int M,
                                           int N, int T, int tile0, int count,
                                           int m0, int n0) {
  const int p = threadIdx.x & 7;
  for (int rc = threadIdx.x >> 3; rc < 16 * MT * kBN; rc += NT >> 3) {
    const int r = rc / kBN, c = rc % kBN;
    const int m = m0 + r, n = n0 + c;
    if (p < count && m < M && n < N)
      out[(static_cast<int64_t>(m) * N + n) * T + tile0 + p] =
          held[p * TileSums::tile_words<MT>() + r * TileSums::kRowWords + c];
  }
}

// Bytes of a ring stage: x rows, weight rows, the loader's raw bytes.
template <int MT, typename W>
__host__ __device__ __forceinline__ int stage_bytes(const W& wl) {
  return (16 * MT + kBN) * kRow + wl.raw_bytes();
}

// A flagged block's outputs (W::kExact): each of its (16 MT) x kBN tile's
// outputs the loader's exact sum over [k_begin, k_end), stored as the
// epilogue stores the tensor cores' (added atomically where K is split).
// Out of line, so that the mainloop's epilogue stays as it is.
template <int MT, typename W, typename E>
__device__ __noinline__ void exact_sums(const W& wl, const int8_t* x,
                                        int32_t* out, E epi, int M, int N,
                                        int K, int m0, int n0, int k_begin,
                                        int k_end, int split) {
  for (int i = threadIdx.x; i < 16 * MT * kBN; i += Shape<MT>::kThreads) {
    const int m = m0 + i / kBN, n = n0 + i % kBN;
    if (m >= M || n >= N) continue;
    const int sum = wl.exact(x + static_cast<int64_t>(m) * K, n, k_begin,
                             k_end);
    int32_t* o = out + static_cast<int64_t>(m) * N + n;
    if (split)
      atomicAdd(o, sum);
    else
      *o = epi.value(sum);
  }
}

// One block: the (16 MT) x kBN output tile at (blockIdx.y, blockIdx.x) over
// slabs [blockIdx.z * per, (blockIdx.z + 1) * per) of K. `split`: K is
// split among blocks, whose sums are added atomically (WholeK). Dynamic
// shared memory: Shape<MT>::kStages * stage_bytes<MT>(wl) bytes.
template <int MT, typename W, typename E = WholeK>
__global__ void __launch_bounds__(Shape<MT>::kThreads)
    mma_kernel(const int8_t* __restrict__ x, int x_mode, W wl,
               int32_t* __restrict__ out, int M, int N, int K, int per,
               int split, E epi) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int flagged;  // W::kExact: a build met a tile it cannot hold
  constexpr int NT = Shape<MT>::kThreads;
  constexpr int TW = Shape<MT>::kTiles;
  constexpr int kStages = Shape<MT>::kStages;
  constexpr int kXBytes = 16 * MT * kRow;
  constexpr int kTileBytes = kXBytes + kBN * kRow;  // x rows, weight rows
  const int stage = stage_bytes<MT>(wl);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp & 3, mt0 = (warp >> 2) * TW;  // the warp's columns, rows
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' groupID etc.
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * 16 * MT;
  const int live = min(MT, (M - m0 + 15) / 16);  // tiles with a row < M
  const int k_begin = blockIdx.z * per * kBK;
  const int k_end = min(K, k_begin + per * kBK);
  const int slabs = (k_end - k_begin + kBK - 1) / kBK;
  const int8_t* xs = x + static_cast<int64_t>(m0) * K;

  int acc[TW][2][4];
#pragma unroll
  for (int mt = 0; mt < TW; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // slab s: copies of x and of the loader into stage s % kStages
  auto start = [&](int s) {
    uint8_t* st = ring + (s % kStages) * stage;
    const int k0 = k_begin + s * kBK;
    copy_tile<16 * MT, NT>(st, xs + k0, K, M - m0, K - k0, x_mode);
    wl.template start<NT>(st + kXBytes, st + kTileBytes, n0, k0);
  };
  auto build = [&](int s) {
    uint8_t* st = ring + (s % kStages) * stage;
    wl.template build<NT>(st + kXBytes, st + kTileBytes, n0,
                          k_begin + s * kBK, &flagged);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) start(s);
    cp_async_commit();
  }
  if constexpr (W::kExact) {
    if (threadIdx.x == 0) flagged = 0;
    __syncthreads();  // before any build may set it; the copies fly
  }
  cp_async_wait<kStages - 2>();  // slab 0's copies by this thread landed
  if (W::kLead) build(0);

  // ldmatrix row addresses: A rows 16 mt + (lane & 7) + 8 (lane >> 3 & 1)
  // at K offset 16 (lane >> 4); B rows (columns of the tile) wn * 16 +
  // (lane & 7) + 8 (lane >> 4) at K offset 16 (lane >> 3 & 1), so that
  // b[0], b[1] are the 8-column tile 0's fragments and b[2], b[3] tile 1's.
  const int a_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kRow +
                    16 * (lane >> 4);
  const int b_off = (wn * 16 + (lane & 7) + 8 * (lane >> 4)) * kRow +
                    16 * ((lane >> 3) & 1);
  // TileSums: tiles held after the ring, the first tile not yet written
  int32_t* held = reinterpret_cast<int32_t*>(ring + kStages * stage);
  int held_n = 0, tile0 = k_begin / kBK;
  if constexpr (E::kTiled) tile0 >>= epi.shift;
  for (int i = 0; i < slabs; ++i) {
    // every thread's copies (and builds) of slab i are done, and its
    // reads of slab i - 1's stage
    __syncthreads();
    if (i + kStages - 1 < slabs) start(i + kStages - 1);  // slab i - 1's
    cp_async_commit();
    const uint8_t* sa = ring + (i % kStages) * stage;
    const uint8_t* sb = sa + kXBytes;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t b[4];
      ldmatrix_x4(b, sb + b_off + ks);
#pragma unroll
      for (int mt = 0; mt < TW; ++mt) {
        if (mt0 + mt < live) {
          uint32_t a[4];
          ldmatrix_x4(a, sa + 16 * (mt0 + mt) * kRow + a_off + ks);
          mma_s8(acc[mt][0], a, b[0], b[1]);
          mma_s8(acc[mt][1], a, b[2], b[3]);
        }
      }
    }
    if constexpr (E::kTiled) {
      // slab i closes its tile: the block's last slab, or the tile's
      const int s = k_begin / kBK + i;  // the slab's index over K
      if (i + 1 == slabs || ((s + 1) & ((1 << epi.shift) - 1)) == 0) {
        hold_tile(acc, held + held_n * E::template tile_words<MT>(), mt0, wn,
                  g, t, live);
        if (++held_n == E::kHeld || i + 1 == slabs) {
          // every thread's part of the held tiles is in; the next tile's
          // writes come after the next slab's barrier
          __syncthreads();
          write_held<MT, NT>(held, out, M, N, epi.T, tile0, held_n, m0, n0);
          tile0 += held_n;
          held_n = 0;
        }
      }
    }
    cp_async_wait<kStages - 2>();  // slab i + 1's copies by this thread
    if (W::kLead && i + 1 < slabs) build(i + 1);
  }

  if constexpr (E::kTiled) {
    // the last split also writes the tiles past K, whose sums are 0
    const int past = epi.T - epi.tiles_k;
    if (blockIdx.z + 1 == gridDim.z && past > 0)
      for (int i = threadIdx.x; i < 16 * MT * kBN * past; i += NT) {
        const int rc = i / past, m = m0 + rc / kBN, n = n0 + rc % kBN;
        if (m < M && n < N)
          out[(static_cast<int64_t>(m) * N + n) * epi.T + epi.tiles_k +
              i % past] = 0;
      }
  } else {
    if constexpr (W::kExact) {
      // every build came before the last slab's barrier, so the flag is
      // read here with no barrier of its own
      if (flagged) {
        exact_sums<MT>(wl, x, out, epi, M, N, K, m0, n0, k_begin, k_end,
                       split);
        return;
      }
    }
#pragma unroll
    for (int mt = 0; mt < TW; ++mt) {
      if (mt0 + mt >= live) break;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // e: (row g or g + 8) x (column pair)
          const int m = m0 + 16 * (mt0 + mt) + g + 8 * (e >> 1);
          const int n = n0 + wn * 16 + 8 * j + 2 * t + (e & 1);
          if (m < M && n < N) {
            int32_t* o = out + static_cast<int64_t>(m) * N + n;
            if (split)
              atomicAdd(o, acc[mt][j][e]);
            else
              *o = epi.value(acc[mt][j][e]);
          }
        }
    }
  }
}

// WrapK where K was split: each output's sum, added up by the atomics,
// replaced by its acc_bits register.
__global__ void wrap_kernel(int32_t* __restrict__ out, int64_t n,
                            int acc_bits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = wrap_bits(out[i], acc_bits);
}

inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Blocks of mma_kernel<MT, W, E> with `smem` bytes of shared memory that
// one SM holds at once (the last answer kept: a loader's smem rarely
// changes).
template <int MT, typename W, typename E = WholeK>
int resident_blocks(int smem) {
  static int known_smem = -1, known = 1;
  if (smem != known_smem) {
    int n = 1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, mma_kernel<MT, W, E>, Shape<MT>::kThreads, smem) !=
        cudaSuccess)
      n = 1;
    known_smem = smem;
    known = n > 0 ? n : 1;
  }
  return known;
}

// The (tiles_n, tiles_m) output tiles of (16 MT)-row blocks, K split among
// as many blocks as the card holds at once (one wave), at most 4 an SM at
// decode and 2 above (each split adds M N atomics) and at least a slab a
// block, the partial sums added atomically into a zeroed output (and,
// under WrapK, then wrapped by wrap_kernel).
template <int MT, typename W, typename E = WholeK>
int launch_tiles(const int8_t* x, const W& wl, int32_t* out, int M, int N,
                 int K, int64_t tiles_n, int64_t tiles_m, cudaStream_t s,
                 E epi = E{}) {
  const int smem = Shape<MT>::kStages * stage_bytes<MT>(wl);
  if (smem > 232448) return cudaErrorInvalidValue;  // 227 KB a block
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mma_kernel<MT, W, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const int slabs = (K + kBK - 1) / kBK;
  const int64_t tiles = tiles_n * tiles_m;
  const int64_t wave =
      std::min(resident_blocks<MT, W, E>(smem), MT == 1 ? 4 : 2) *
      static_cast<int64_t>(sm_count());
  int splits = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(slabs, wave / tiles)));
  const int per = (slabs + splits - 1) / splits;
  splits = (slabs + per - 1) / per;
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(int32_t) * static_cast<size_t>(M) * N, s);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(tiles_n),
                  static_cast<unsigned>(tiles_m), splits);
  mma_kernel<MT, W, E><<<grid, Shape<MT>::kThreads, smem, s>>>(
      x, copy_mode(x, K), wl, out, M, N, K, per, splits > 1, epi);
  if constexpr (E::kWrap) {
    if (splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const int64_t n = static_cast<int64_t>(M) * N;
      wrap_kernel<<<static_cast<unsigned>(
                        std::min<int64_t>((n + 255) / 256, 4 * sm_count())),
                    256, 0, s>>>(out, n, epi.acc_bits);
    }
  }
  return cudaGetLastError();
}

// out (M, N) int32 = x (M, K) int8 times the loader's (N, K) rows, through
// the epilogue `epi` (WholeK or WrapK); M, N >= 1, K >= 0. Returns the
// launch's error.
template <typename W, typename E = WholeK>
int launch(const int8_t* x, const W& wl, int32_t* out, int M, int N, int K,
           cudaStream_t s, E epi = E{}) {
  if (K == 0)
    return cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(M) * N,
                           s);
  const bool decode = M <= 16;
  const int bm = decode ? 16 : 16 * kPrefillTiles;
  const int64_t tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + bm - 1) / bm;
  if (tiles_m > 65535 || tiles_n > 0x7fffffff) return cudaErrorInvalidValue;
  return decode ? launch_tiles<1>(x, wl, out, M, N, K, tiles_n, tiles_m, s,
                                  epi)
                : launch_tiles<kPrefillTiles>(x, wl, out, M, N, K, tiles_n,
                                              tiles_m, s, epi);
}

// TileSums at (16 MT)-row blocks: the tiles_k tiles of K split among as
// many blocks as the card holds at once, as launch_tiles, but on whole
// tiles, each block storing its own tiles' sums.
template <int MT, typename W>
int launch_tile_split(const int8_t* x, const W& wl, int32_t* out, int M,
                      int N, int K, int64_t tiles_n, int64_t tiles_m,
                      const TileSums& epi, cudaStream_t s) {
  const int smem = Shape<MT>::kStages * stage_bytes<MT>(wl) +
                   TileSums::smem_bytes<MT>();
  if (smem > 232448) return cudaErrorInvalidValue;  // 227 KB a block
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mma_kernel<MT, W, TileSums>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles = tiles_n * tiles_m;
  const int64_t wave =
      std::min(resident_blocks<MT, W, TileSums>(smem), MT == 1 ? 4 : 2) *
      static_cast<int64_t>(sm_count());
  int splits = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(epi.tiles_k, wave / tiles)));
  const int per = (epi.tiles_k + splits - 1) / splits;  // tiles a block
  splits = (epi.tiles_k + per - 1) / per;
  if (splits > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles_n),
                  static_cast<unsigned>(tiles_m), splits);
  mma_kernel<MT, W, TileSums><<<grid, Shape<MT>::kThreads, smem, s>>>(
      x, copy_mode(x, K), wl, out, M, N, K, per << epi.shift, 0, epi);
  return cudaGetLastError();
}

// out (M, N, T) int32: out[m, n, t] = the sum over tile t, [t k_tile,
// (t + 1) k_tile), of x (M, K) times the loader's (N, K) rows, zero past
// K; k_tile a power-of-two multiple of kBK, T k_tile >= K >= 1, M, N >= 1.
// Returns the launch's error.
template <typename W>
int launch_tile_sums(const int8_t* x, const W& wl, int32_t* out, int M,
                     int N, int K, int k_tile, int T, cudaStream_t s) {
  int shift = 0;
  while ((kBK << shift) < k_tile) ++shift;
  if ((kBK << shift) != k_tile || K < 1 ||
      static_cast<int64_t>(T) * k_tile < K)
    return cudaErrorInvalidValue;
  const TileSums epi{shift, T, (K + k_tile - 1) / k_tile};
  const bool decode = M <= 16;
  const int bm = decode ? 16 : 16 * kTileSumsTiles;
  const int64_t tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + bm - 1) / bm;
  if (tiles_m > 65535 || tiles_n > 0x7fffffff) return cudaErrorInvalidValue;
  return decode ? launch_tile_split<1>(x, wl, out, M, N, K, tiles_n,
                                       tiles_m, epi, s)
                : launch_tile_split<kTileSumsTiles>(x, wl, out, M, N, K,
                                                    tiles_n, tiles_m, epi, s);
}

}  // namespace mma8
