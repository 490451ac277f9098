// nm_tile_sums.cuh: pass 1 of the two-pass `sorted_tiled` on N:M
// compressed weights, the (M, N, T) int32 sums of each output's k_tile
// tiles, read from the slabs' kept slots: one body for the gather twin
// (nm_sort_matmul.cu: nm_gather_tile_sums, row 11) and the expand twin
// (nm_expand_sort.cu: nm_tile_sums_matmul, row 10), which differ only in
// a slot whose index lies outside its group (the template parameter
// kDrop):
// - gather (kDrop false) reads x where such a slot points, as
//   gather_nm_products does: its position leaves the tile, so its quad
//   leaves the fast path and reads x in device memory below K (a position
//   in [-kp, 0) at position + kp, pqs::gathered_pos; one outside the row
//   adds nothing);
// - expand (kDrop true) adds nothing for it, as expand_nm_slab's one-hot
//   expansion drops it: its value is zeroed and its position clamped into
//   the tile, so every quad stays on the fast path.
// Both sum raw products in int32 without clipping, so for any slabs,
// canonical or not, the sum over the kept slots of x[pos] * value equals
// x times the int32 scatter-add of the slots (the expand reference):
// unsorted and duplicate indices are only more products.
//
// What bounds it on this card: at decode (M = 4) one read of the slabs,
// 5 bytes (int8 value, int32 index) a kept product, 34.4 MB at w_out (N
// 1536, K 8960, 8:16), of which the int32 indices are 27.5 MB (device
// memory); at a prefill cohort (M = 128) the 880 M gathered products of
// w_out, each an x byte read from where its index points, and the
// (M, N, T) int32 output (27.5 MB at k_tile 256).
//
// What the design does about it: a block takes one tile and a run of
// output columns (32 up to 16 rows of x, 64 above) and stages x's columns
// of the tile in shared memory transposed: the word of position p holds 4
// rows' bytes. Each kept slot's value and index are read once for all of
// x's rows:
// - up to 16 rows of x (decode), the block first copies its columns'
//   slots of the tile into shared memory with cp.async (16 bytes of
//   indices and 4 of values a copy, all in flight while x is staged);
//   then the lanes split a column's tile: lane l takes kept slots 4l ..
//   4l + 3 (and + 128 j), reads the 4 positions' words, turns them into
//   each row's 4 bytes with a byte transpose (8 PRMT), and adds each row's
//   4 products with one __dp4a; a shuffle reduce-scatter leaves each
//   row's sum in one lane (6 shuffles for 4 rows). A warp takes two
//   columns at a time. Slabs that are not 16-byte aligned or tiles of more
//   than 128 kept slots load straight from device memory;
// - above, each lane owns 4 rows of a 128-row chunk of x (its own word of
//   each staged position, so the warp's reads of one position hit 32
//   banks) and the lanes that load a quad of slots broadcast its positions
//   and values by shuffles: no reduction, 4 transposed reads, 8 PRMT and 4
//   __dp4a for 16 products.
// Positions are (slot / n_keep) * m_group + index, by shifts where both
// are powers of two. A slot past the tile's lc, past G or with a zero
// value adds nothing; x's staged columns are zero past K. Tiles stage at
// most kMaxTile positions (128 KB of x words above 16 rows).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "pqs_accum.cuh"

namespace nmsums {

constexpr int kThreads = 256;
constexpr int kSumCols = 64;    // output columns of a many-rows block
constexpr int kFewCols = 32;    // of a few-rows block, 4 a warp
constexpr int kFewRows = 16;    // rows of x up to which the lanes split slots
constexpr int kManyRows = 128;  // rows of x a block stages at once above
constexpr int kStagedSlots = 128;  // lc up to which decode stages slabs
constexpr int kMaxTile = 1024;     // positions a tile may stage

// The tiles of pass 1: lc = (k_tile / m_group) n_keep kept slots a tile of
// a compressed row of `kept` = G n_keep slots; lk, lm the log2 of n_keep
// and m_group where both are powers of two. vec: kept and lc multiples of
// 4 and the slabs 16- (indices) and 4-byte (values) aligned, so a quad of
// slots is one 16-byte and one 4-byte load. staged: vec, lc up to
// kStagedSlots and few rows of x: a block copies its columns' slots of
// the tile into shared memory with cp.async first.
struct SumTile {
  int lc, kept, k_tile, n_keep, m_group, lk, lm;
  int width;  // x's padded row (kp) a gathered position wraps within
  bool vec, staged;
};

// Columns [k0, k0 + len) of x's rows [0, rows) into shared words, by the
// block: xs[(p << lrw) + g] holds position k0 + p of rows 4g .. 4g + 3, row
// 4g + r in byte r (1 << lrw words a position); zero past `rows` and past
// K. words: x, K and k0 multiples of 4, so rows are read a word at a time.
__device__ __forceinline__ void stage_x(uint32_t* xs,
                                        const int8_t* __restrict__ x,
                                        int rows, int K, int k0, int len,
                                        int lrw, bool words) {
  const int rw = 1 << lrw;
  for (int i = threadIdx.x; i < ((len + 3) >> 2) << lrw; i += blockDim.x) {
    const int g = i & (rw - 1), p = (i >> lrw) << 2;
    uint32_t in[4], out[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * g + r;
      if (row >= rows) {
        in[r] = 0;
        continue;
      }
      const int8_t* src = x + static_cast<int64_t>(row) * K + k0 + p;
      in[r] = words && k0 + p + 4 <= K
                  ? __ldg(reinterpret_cast<const unsigned int*>(src))
                  : mma8::pack_bytes(src, K - k0 - p);
    }
    mma8::transpose4(in, out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p + j < len) xs[((p + j) << lrw) + g] = out[j];
  }
}

// x[0 .. rows) (rows <= 4) at position pos of rows K long, row r in byte
// r: a staged word read from device memory.
__device__ __forceinline__ uint32_t x_word(const int8_t* __restrict__ x,
                                           int pos, int K, int rows) {
  uint32_t v = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r < rows)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(
               __ldg(x + static_cast<int64_t>(r) * K + pos)))
           << (8 * r);
  return v;
}

// Kept slots q .. q + 3 (q a multiple of 4) of tile t of one compressed row.
struct Quad {
  int pos[4];   // positions in the tile (0 for a slot that adds nothing)
  uint32_t v;   // values, slot q + s in byte s (0 past lc or past G)
  bool odd;     // a nonzero slot whose position lies outside the tile
};

// The quad of in-tile slots q .. q + 3 with indices i4 and values v (0
// for a slot past lc or past G). kDrop: a slot whose index lies outside
// [0, m_group) adds nothing (value zeroed, position 0), so `odd` stays
// false (a tile holds whole groups).
template <bool P2, bool kDrop>
__device__ __forceinline__ Quad make_quad(int4 i4, uint32_t v, int q,
                                          const SumTile& st) {
  const int iv[4] = {i4.x, i4.y, i4.z, i4.w};
  Quad d;
  d.odd = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int qs = q + s;
    const int p = (P2 ? (qs >> st.lk) << st.lm : (qs / st.n_keep) * st.m_group)
                  + iv[s];
    bool live = (v >> (8 * s)) & 0xff;
    if (kDrop && static_cast<unsigned>(iv[s]) >=
                     static_cast<unsigned>(st.m_group)) {
      v &= ~(0xffu << (8 * s));
      live = false;
    }
    d.pos[s] = live ? p : 0;
    if (!kDrop)
      d.odd |= live && static_cast<unsigned>(p) >=
                           static_cast<unsigned>(st.k_tile);
  }
  d.v = v;
  return d;
}

// Slots q .. q + 3 of tile t of a compressed row (vr, ir) from device
// memory.
template <bool P2, bool kDrop>
__device__ __forceinline__ Quad load_quad(const int8_t* __restrict__ vr,
                                          const int32_t* __restrict__ ir,
                                          int t, int q, const SumTile& st) {
  const int g0 = t * st.lc + q;  // slot q's index in the row
  if (st.vec && q < st.lc && g0 < st.kept)
    return make_quad<P2, kDrop>(
        __ldg(reinterpret_cast<const int4*>(ir + g0)),
        __ldg(reinterpret_cast<const unsigned int*>(vr + g0)), q, st);
  int iv[4];
  uint32_t v = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool in = q + s < st.lc && g0 + s < st.kept;
    iv[s] = in ? __ldg(ir + g0 + s) : 0;
    if (in)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(vr + g0 + s)))
           << (8 * s);
  }
  return make_quad<P2, kDrop>(make_int4(iv[0], iv[1], iv[2], iv[3]), v, q,
                              st);
}

// Staged (st.staged): the slots of tile t of rows [n_begin, n_end), lc
// each, copied by cp.async into sidx / sval (row c at c * lc), 16 bytes of
// indices and 4 of values at a time, zero past G. Committed as one group.
__device__ __forceinline__ void stage_slabs(int32_t* sidx, uint8_t* sval,
                                            const int8_t* __restrict__ val,
                                            const int32_t* __restrict__ idx,
                                            int n_begin, int n_end, int t,
                                            const SumTile& st) {
  const int quads = st.lc >> 2;
  for (int i = threadIdx.x; i < (n_end - n_begin) * quads; i += blockDim.x) {
    const int c = i / quads, j = (i - c * quads) << 2;  // column c, slot j
    const int g = t * st.lc + j;
    const int64_t row = static_cast<int64_t>(n_begin + c) * st.kept;
    const bool in = g < st.kept;
    mma8::cp_async<16>(sidx + c * st.lc + j, in ? idx + row + g : idx,
                       in ? 16 : 0);
    mma8::cp_async<4>(sval + c * st.lc + j, in ? val + row + g : val,
                      in ? 4 : 0);
  }
  mma8::cp_async_commit();
}

// x[row, k0 + p] where the slot's position p lies outside the tile (a
// gathered position, pqs::gathered_pos's rule in a row of `width`): read
// from device memory where it lies in [0, K), else 0.
__device__ __forceinline__ int x_outside(const int8_t* __restrict__ x,
                                         int row, int M, int K, int k0,
                                         int p, int width) {
  const int pos = pqs::gathered_pos(1, k0, p, width);
  return row < M && static_cast<unsigned>(pos) < static_cast<unsigned>(K)
             ? __ldg(x + static_cast<int64_t>(row) * K + pos)
             : 0;
}

// Each of 4 values a[r] summed over the warp, the sum of a[r] left in the
// lanes with bits 4, 3 equal to r's bits 1, 0 (reduce-scatter, then a
// reduction over the 8 lanes of each quarter): 6 shuffles.
__device__ __forceinline__ int reduce4(const int (&a)[4], int lane) {
  const bool hi = lane & 16;
  int k0 = hi ? a[2] : a[0], k1 = hi ? a[3] : a[1];
  k0 += __shfl_xor_sync(pqs::kFull, hi ? a[0] : a[2], 16);
  k1 += __shfl_xor_sync(pqs::kFull, hi ? a[1] : a[3], 16);
  const bool hi8 = lane & 8;
  int k = hi8 ? k1 : k0;
  k += __shfl_xor_sync(pqs::kFull, hi8 ? k0 : k1, 8);
#pragma unroll
  for (int d = 4; d > 0; d >>= 1) k += __shfl_xor_sync(pqs::kFull, k, d);
  return k;
}

// A quad's products added to acc (RG groups of 4 rows of x staged at
// xs, RG words a position): its 4 positions' words turned into each row's
// 4 bytes by a byte transpose, each row's 4 products added by one __dp4a;
// a quad with a slot outside the tile (gather only) adds slot by slot.
template <int RG, bool kDrop>
__device__ __forceinline__ void add_quad(int (&acc)[RG][4], const Quad& d,
                                         const uint32_t* xs,
                                         const int8_t* __restrict__ x, int M,
                                         int K, int k0, int k_tile,
                                         int width) {
  if constexpr (!kDrop) {
    if (d.odd) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int v = static_cast<int8_t>(d.v >> (8 * s));
        const int p = d.pos[s];
        const bool in =
            static_cast<unsigned>(p) < static_cast<unsigned>(k_tile);
#pragma unroll
        for (int rg = 0; rg < RG; ++rg)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[rg][r] +=
                v * (in ? static_cast<int8_t>(xs[p * RG + rg] >> (8 * r))
                        : x_outside(x, 4 * rg + r, M, K, k0, p, width));
      }
      return;
    }
  }
#pragma unroll
  for (int rg = 0; rg < RG; ++rg) {
    const uint32_t w[4] = {xs[d.pos[0] * RG + rg], xs[d.pos[1] * RG + rg],
                           xs[d.pos[2] * RG + rg], xs[d.pos[3] * RG + rg]};
    uint32_t y[4];  // y[r]: row 4 rg + r's bytes at the 4 positions
    mma8::transpose4(w, y);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      acc[rg][r] = __dp4a(static_cast<int>(y[r]), static_cast<int>(d.v),
                          acc[rg][r]);
  }
}

// Words of x's staged tile at RG words a position, rounded to 16 bytes.
__host__ __device__ __forceinline__ int x_words(int k_tile, int rg) {
  return (k_tile * rg + 3) & ~3;
}

// Up to kFewRows rows of x: a block per (tile blockIdx.x, columns
// blockIdx.y * kFewCols ..), staged: their slots of the tile copied into
// shared memory while x's tile is staged; a warp per kCols columns at a
// time, its lanes over the tile's slots; RG words (4 RG rows) a staged
// position.
template <int RG, bool P2, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    nm_sums_few_rows_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ val,
                            const int32_t* __restrict__ idx,
                            int32_t* __restrict__ out, int M, int N, int K,
                            int T, SumTile st, bool words) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kCols = 2;
  // x's tile (st.k_tile * RG words), then, staged, the slabs' slots
  uint32_t* xs = pqs::dynamic_smem<uint32_t>();
  int32_t* sidx = reinterpret_cast<int32_t*>(xs + x_words(st.k_tile, RG));
  uint8_t* sval = reinterpret_cast<uint8_t*>(sidx + kFewCols * st.lc);
  const int t = blockIdx.x, k0 = t * st.k_tile;
  const int lane = threadIdx.x & 31;
  const int n_begin = blockIdx.y * kFewCols;
  const int n_end = min(N, n_begin + kFewCols);
  if (st.staged) stage_slabs(sidx, sval, val, idx, n_begin, n_end, t, st);
  stage_x(xs, x, M, K, k0, st.k_tile, RG == 1 ? 0 : RG == 2 ? 1 : 2, words);
  mma8::cp_async_wait<0>();
  __syncthreads();
  for (int n = n_begin + (threadIdx.x >> 5); n < n_end; n += kCols * kWarps) {
    // columns n, n + kWarps, ..., below n_end
    const int cols = min(kCols, (n_end - n + kWarps - 1) / kWarps);
    int acc[kCols][RG][4] = {};
    for (int q = 4 * lane; q < st.lc; q += 128) {
      Quad d[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c >= cols) break;
        const int nc = n + c * kWarps;
        if (st.staged) {
          const int off = (nc - n_begin) * st.lc + q;
          d[c] = make_quad<P2, kDrop>(
              *reinterpret_cast<const int4*>(sidx + off),
              *reinterpret_cast<const uint32_t*>(sval + off), q, st);
        } else {
          const int64_t row = static_cast<int64_t>(nc) * st.kept;
          d[c] = load_quad<P2, kDrop>(val + row, idx + row, t, q, st);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < cols)
          add_quad<RG, kDrop>(acc[c], d[c], xs, x, M, K, k0, st.k_tile,
                              st.width);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= cols) break;
#pragma unroll
      for (int rg = 0; rg < RG; ++rg) {
        const int sum = reduce4(acc[c][rg], lane);
        const int row = 4 * rg + 2 * ((lane >> 4) & 1) + ((lane >> 3) & 1);
        if ((lane & 7) == 0 && row < M)
          out[(static_cast<int64_t>(row) * N + n + c * kWarps) * T + t] = sum;
      }
    }
  }
}

// Above kFewRows rows of x: as the few-rows kernel, but each lane owns 4
// rows (its own word of each staged position) of each kManyRows-row chunk
// of x, and the lanes that load a quad of slots broadcast it.
template <bool P2, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    nm_sums_many_rows_kernel(const int8_t* __restrict__ x,
                             const int8_t* __restrict__ val,
                             const int32_t* __restrict__ idx,
                             int32_t* __restrict__ out, int M, int N, int K,
                             int T, SumTile st, bool words) {
  uint32_t* xs = pqs::dynamic_smem<uint32_t>();  // st.k_tile * 32 words
  const int t = blockIdx.x, k0 = t * st.k_tile;
  const int lane = threadIdx.x & 31;
  const uint32_t* mine = xs + lane;  // position p's word: mine[p << 5]
  const int n_end = min(N, (blockIdx.y + 1) * kSumCols);
  for (int m0 = 0; m0 < M; m0 += kManyRows) {
    __syncthreads();  // the last chunk's reads of xs are done
    stage_x(xs, x + static_cast<int64_t>(m0) * K, min(kManyRows, M - m0), K,
            k0, st.k_tile, 5, words);
    __syncthreads();
    for (int n = blockIdx.y * kSumCols + (threadIdx.x >> 5); n < n_end;
         n += kThreads / 32) {
      const int8_t* vr = val + static_cast<int64_t>(n) * st.kept;
      const int32_t* ir = idx + static_cast<int64_t>(n) * st.kept;
      int acc[4] = {};
      for (int q0 = 0; q0 < st.lc; q0 += 128) {
        const Quad d = load_quad<P2, kDrop>(vr, ir, t, q0 + 4 * lane, st);
        const int srcs = min(32, (st.lc - q0 + 3) >> 2);
        if (kDrop || !__any_sync(pqs::kFull, d.odd)) {
          // positions < k_tile <= kMaxTile: two to a word
          const uint32_t p01 = d.pos[0] | (d.pos[1] << 16);
          const uint32_t p23 = d.pos[2] | (d.pos[3] << 16);
#pragma unroll 4
          for (int src = 0; src < srcs; ++src) {
            const uint32_t a = __shfl_sync(pqs::kFull, p01, src);
            const uint32_t b = __shfl_sync(pqs::kFull, p23, src);
            const int v = __shfl_sync(pqs::kFull, static_cast<int>(d.v), src);
            const uint32_t w[4] = {
                mine[(a & 0xffff) << 5], mine[(a >> 16) << 5],
                mine[(b & 0xffff) << 5], mine[(b >> 16) << 5]};
            uint32_t y[4];  // y[r]: row m0 + 4 lane + r's 4 bytes
            mma8::transpose4(w, y);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[r] = __dp4a(static_cast<int>(y[r]), v, acc[r]);
          }
        } else if constexpr (!kDrop) {
          for (int src = 0; src < srcs; ++src) {
            const uint32_t vs =
                __shfl_sync(pqs::kFull, static_cast<int>(d.v), src);
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const int p = __shfl_sync(pqs::kFull, d.pos[s], src);
              const int v = static_cast<int8_t>(vs >> (8 * s));
              const bool in = static_cast<unsigned>(p) <
                              static_cast<unsigned>(st.k_tile);
#pragma unroll
              for (int r = 0; r < 4; ++r)
                acc[r] += v * (in ? static_cast<int8_t>(mine[p << 5] >> (8 * r))
                                  : x_outside(x, m0 + 4 * lane + r, M, K, k0,
                                              p, st.width));
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + 4 * lane + r;
        if (row < M) out[(static_cast<int64_t>(row) * N + n) * T + t] = acc[r];
      }
    }
  }
}

template <typename... Params>
int launch_sums(void (*kernel)(Params...), dim3 grid, size_t smem,
                cudaStream_t s, const pqs::Slabs& a, int32_t* out, int T,
                const SumTile& st, bool words) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, s>>>(a.x, a.val, a.idx, out, a.M, a.N, a.K,
                                      T, st, words);
  return cudaGetLastError();
}

// Pass 1's launch: a block per tile and run of columns (grid.x tiles).
template <bool P2, bool kDrop>
int launch_pass1(int T, cudaStream_t s, const pqs::Slabs& a, int32_t* out,
                 SumTile st, bool words) {
  const int cols = a.M <= kFewRows ? kFewCols : kSumCols;
  const int64_t col_blocks = (a.N + cols - 1) / cols;
  if (col_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(T, static_cast<unsigned>(col_blocks));
  st.staged = st.vec && st.lc <= kStagedSlots && a.M <= kFewRows;
  // the few-rows kernels' x words, then the staged slots (5 bytes each)
  const size_t slabs = st.staged ? static_cast<size_t>(kFewCols) * st.lc * 5
                                 : 0;
  auto few = [&](int rg) {
    return 4 * static_cast<size_t>(x_words(st.k_tile, rg)) + slabs;
  };
  if (a.M <= 4)
    return launch_sums(nm_sums_few_rows_kernel<1, P2, kDrop>, grid, few(1), s,
                       a, out, T, st, words);
  if (a.M <= 8)
    return launch_sums(nm_sums_few_rows_kernel<2, P2, kDrop>, grid, few(2), s,
                       a, out, T, st, words);
  if (a.M <= kFewRows)
    return launch_sums(nm_sums_few_rows_kernel<4, P2, kDrop>, grid, few(4), s,
                       a, out, T, st, words);
  const size_t smem = static_cast<size_t>(st.k_tile) * 4 * (kManyRows / 4);
  if (smem > pqs::kSmemCap) return cudaErrorInvalidValue;
  return launch_sums(nm_sums_many_rows_kernel<P2, kDrop>, grid, smem, s, a,
                     out, T, st, words);
}

// out (M, N, kp / k_tile) int32, the tile sums of the kept slots of the
// slabs `a` (valid_slabs(a, kp, k_tile), k_tile up to kMaxTile), under
// kDrop's rule for a slot outside its group. Returns the launch's error.
template <bool kDrop>
int tile_sums(const pqs::Slabs& a, int32_t* out, int kp, int k_tile,
              cudaStream_t s) {
  if (k_tile > kMaxTile) return cudaErrorInvalidValue;
  SumTile st{(k_tile / a.m_group) * a.n_keep, a.G * a.n_keep, k_tile,
             a.n_keep, a.m_group, 0, 0, kp, false, false};
  while ((1 << st.lk) < a.n_keep) ++st.lk;
  while ((1 << st.lm) < a.m_group) ++st.lm;
  const bool p2 = (1 << st.lk) == a.n_keep && (1 << st.lm) == a.m_group;
  st.vec = st.kept % 4 == 0 && st.lc % 4 == 0 &&
           reinterpret_cast<uintptr_t>(a.val) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(a.idx) % 16 == 0;
  const bool words = a.K % 4 == 0 && k_tile % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(a.x) % 4 == 0;
  return p2 ? launch_pass1<true, kDrop>(kp / k_tile, s, a, out, st, words)
            : launch_pass1<false, kDrop>(kp / k_tile, s, a, out, st, words);
}

}  // namespace nmsums
