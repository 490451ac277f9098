// nm_sort_matmul.cu: the PQS global-sort policies (`sorted`,
// `sorted_tiled`) on N:M compressed weights, from the kept products only;
// four kernels.
//
// Replaces:
//   nm_sort_sorted_kernel  <- repro/kernels/nm_spmm.py:nm_gather_sort_matmul
//     under `sorted` (the Pallas _nm_gather_sort_kernel with
//     gather_nm_products, pad_last_pow2 and bitonic.sorted_order_bitonic),
//     and repro/kernels/sorted_stream.py:nm_gather_chunked_sort_matmul
//     (`sorted` at long K, _nm_gather_chunked_sort_kernel): one block holds
//     all of an output's kept keys, so the TPU's VMEM split into two
//     kernels does not carry over, as for the dense sort_matmul.cu;
//   nm_sort_tiled_kernel   <- nm_gather_sort_matmul under `sorted_tiled`
//     (tiled_sorted_order over the pow2-padded kept tiles);
//   nm_sums_few_rows_kernel, nm_sums_many_rows_kernel <-
//     repro/kernels/sorted_stream.py:nm_gather_tile_sums (pass 1 of the
//     two-pass `sorted_tiled`; the first up to 16 rows of x, the second
//     above);
//   nm_paired_accum_kernel <- repro/kernels/sorted_stream.py:
//     nm_gather_paired_accum_matmul (pass 2, fed the pairing permutation).
//
// Operands: x (M, K) int8; values (N, G, n_keep) int8 and indices
// (N, G, n_keep) int32 in canonical form (pruning.nm_compress); kp >= K and
// kp >= G * m is the padded K of the dense path (a power of two for
// `sorted`, whole k_tile tiles for `sorted_tiled`). Kept slot q of row n is
// x[m, (q / n_keep) * m + idx[n, q]] * val[n, q]; a slot of a group past G,
// at a position at or past K, or in the power-of-two pad of a tile is a zero
// product, masked in the kernel (pqs_accum.cuh GatheredProducts), so
// neither x nor the slabs are padded or copied on the host.
//
// Exactness: the dense product stream of a row is its kept products with
// zeros at the pruned positions. A split/sort/pair round maps a stream with
// extra zeros to the same ordered stream followed by zeros (the prefix
// property), for any number of rounds; zeros add nothing to a saturating
// register and nothing to a tile sum. So
// - `sorted` sorts L = next_pow2(G * n_keep) kept keys (1024 at K = 1536
//   and 8192 at K = 8960 under 8:16, against the dense kernel's kp = 2048
//   and 16384), and its ordered stream is the dense one's prefix;
// - `sorted_tiled` takes a k_tile tile as its lc = (k_tile / m) * n_keep
//   kept slots, sorted as a tile of lp = next_pow2(lc) (128 at 8:16, k_tile
//   256). The tile sums equal the dense ones, so the pairing permutation is
//   the dense one, and each interleaved pair is the dense pair with zero
//   pairs dropped.
//
// What bounds it on this card: as for the dense kernels, the integer work
// of the sorts and of the ordered saturating adds, far above the bytes
// bound at decode. Gathering is about n_keep / m of the dense work: half
// the sort length under 8:16. Pass 1 is an exact dot per tile over 5
// bytes of slab (int8 value, int32 index) a kept product: at decode (M =
// 4) one read of the slabs, 34.4 MB at w_out (N 1536, K 8960, 8:16), of
// which the int32 indices are 27.5 MB, bounds it (device memory); at a
// prefill cohort (M = 128) the 880 M gathered products of w_out, each an
// x byte read from wherever its index points, and the (M, N, T) int32
// output (27.5 MB at k_tile 256).
//
// What the design does about it:
// - The sort bodies are the dense kernels' (pqs_accum.cuh sorted_dot,
//   sorted_tiled_dot, paired_dot), reading products through the gathered
//   loader instead of the dense row pair: one block per output element.
// - `sorted`: L / 8 threads (32 to 1024) sort L int16 keys in shared
//   memory (2 KB at L = 1024, 16 KB at 8192).
// - `sorted_tiled` one-pass: 4 warps rank the T = kp / k_tile tile sums in
//   shared memory, then sort each pair slot's two kept tiles in registers.
// - Pass 1: a block takes one tile and a run of output columns (32 up to
//   16 rows of x, 64 above) and stages x's columns of the tile in shared
//   memory transposed: the word of position p holds 4 rows' bytes. Each
//   kept slot's value and index are read once for all of x's rows (the
//   old body, one warp per (n, tile), re-read them once per row):
//   - up to 16 rows of x (decode), the block first copies its columns'
//     slots of the tile into shared memory with cp.async (16 bytes of
//     indices and 4 of values a copy, all in flight while x is staged);
//     then the lanes split a column's tile: lane l takes kept slots 4l ..
//     4l + 3 (and + 128 j), reads the 4 positions' words, turns them into
//     each row's 4 bytes with a byte transpose (8 PRMT), and adds each
//     row's 4 products with one __dp4a; a shuffle reduce-scatter leaves
//     each row's sum in one lane (6 shuffles for 4 rows). A warp takes two
//     columns at a time. Slabs that are not 16-byte aligned or tiles of
//     more than 128 kept slots load straight from device memory;
//   - above, each lane owns 4 rows of a 128-row chunk of x (its own word
//     of each staged position, so the warp's reads of one position hit 32
//     banks) and the lanes that load a quad of slots broadcast its
//     positions and values by shuffles: no reduction, 4 transposed reads,
//     8 PRMT and 4 __dp4a for 16 products.
//   Positions are (slot / n_keep) * m_group + index, by shifts where both
//   are powers of two. A slot past the tile's lc, past G or with a zero
//   value adds nothing; x's staged columns are zero past K. A nonzero
//   slot whose index points outside its group (so outside the tile) is
//   read from x in device memory where that position lies below K, as
//   before; such a quad leaves the fast path.
//   At w_out (8:16) it takes 0.0263 ms at M = 4 and 0.2005 at M = 128,
//   against a float32 bmm of the same sums on the decompressed weight at
//   0.0345 / 0.0975 and the old body at 0.0846 / 2.2635 (chip_smoke.py
//   phase 5 with --baseline-csrc, NVIDIA H100 80GB HBM3, 700.00 W). At
//   M = 128 its gathers (an x word a slot and 4 rows, a byte transpose
//   and 4 __dp4a) set its time, not its bytes; the alternative, row 4's
//   slab build on the int8 mainloop with row 9's held-tile epilogue, was
//   slower at M = 4, 64 and 128 when both were timed in one process.
// - Pass 2: 8 warps per output, the one-pass body fed perm.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "pqs_accum.cuh"

namespace {

using pqs::Slabs;
using pqs::slabs;
using pqs::valid_slabs;

constexpr int kTiledThreads = 128;
constexpr int kPairThreads = 256;
constexpr int kSumThreads = 256;

// The kept products of output (m, n).
__device__ __forceinline__ pqs::GatheredProducts gathered(
    const int8_t* x, const int8_t* val, const int32_t* idx, int64_t m,
    int64_t n, int K, int G, int n_keep, int m_group, int tile_len) {
  const int kept = G * n_keep;
  return pqs::GatheredProducts{x + m * K, val + n * kept, idx + n * kept, K,
                               kept, n_keep, m_group, tile_len};
}

__global__ void nm_sort_sorted_kernel(const int8_t* __restrict__ x,
                                      const int8_t* __restrict__ val,
                                      const int32_t* __restrict__ idx,
                                      int32_t* __restrict__ out, int N, int K,
                                      int G, int n_keep, int m_group, int L,
                                      int acc_bits, int rounds) {
  __shared__ pqs::Clamp scratch[32];
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, G, n_keep, m_group,
                          G * n_keep);
  const int r = pqs::sorted_dot(p, L, pqs::dynamic_smem<int16_t>(), scratch,
                                acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

template <int E, int LT>
__global__ void nm_sort_tiled_kernel(const int8_t* __restrict__ x,
                                     const int8_t* __restrict__ val,
                                     const int32_t* __restrict__ idx,
                                     int32_t* __restrict__ out, int N, int K,
                                     int G, int n_keep, int m_group, int T,
                                     int lc, int acc_bits, int rounds) {
  __shared__ pqs::Clamp scratch[kTiledThreads / 32];
  int* sums = pqs::dynamic_smem<int>();
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, G, n_keep, m_group,
                          lc);
  const int r = pqs::sorted_tiled_dot<E, LT>(p, sums, sums + T, T, scratch,
                                             acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

// ---------------------------------------------------------------------------
// Pass 1: the (M, N, T) sums of each output's k_tile tiles of kept products
// ---------------------------------------------------------------------------

constexpr int kSumCols = 64;    // output columns of a many-rows block
constexpr int kFewCols = 32;    // of a few-rows block, 4 a warp
constexpr int kFewRows = 16;    // rows of x up to which the lanes split slots
constexpr int kManyRows = 128;  // rows of x a block stages at once above

constexpr int kStagedSlots = 128;  // lc up to which decode stages slabs

// The tiles of pass 1: lc = (k_tile / m_group) n_keep kept slots a tile of
// a compressed row of `kept` = G n_keep slots; lk, lm the log2 of n_keep
// and m_group where both are powers of two. vec: kept and lc multiples of
// 4 and the slabs 16- (indices) and 4-byte (values) aligned, so a quad of
// slots is one 16-byte and one 4-byte load. staged: vec, lc up to
// kStagedSlots and few rows of x: a block copies its columns' slots of
// the tile into shared memory with cp.async first.
struct SumTile {
  int lc, kept, k_tile, n_keep, m_group, lk, lm;
  bool vec, staged;
};

// y[r] byte s = x[s] byte r.
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

// Bytes p[0 .. n) packed little-endian into a word (0 past n, n <= 0: 0).
__device__ __forceinline__ uint32_t load_bytes(const int8_t* p, int n) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j)))
           << (8 * j);
  return v;
}

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
                  : load_bytes(src, K - k0 - p);
    }
    transpose4(in, out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p + j < len) xs[((p + j) << lrw) + g] = out[j];
  }
}

// Kept slots q .. q + 3 (q a multiple of 4) of tile t of one compressed row.
struct Quad {
  int pos[4];   // positions in the tile (0 for a zero-valued slot)
  uint32_t v;   // values, slot q + s in byte s (0 past lc or past G)
  bool odd;     // a nonzero slot whose position lies outside the tile
};

// The quad of in-tile slots q .. q + 3 with indices i4 and values v (0
// for a slot past lc or past G).
template <bool P2>
__device__ __forceinline__ Quad make_quad(int4 i4, uint32_t v, int q,
                                          const SumTile& st) {
  const int iv[4] = {i4.x, i4.y, i4.z, i4.w};
  Quad d;
  d.v = v;
  d.odd = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int qs = q + s;
    const int p = (P2 ? (qs >> st.lk) << st.lm : (qs / st.n_keep) * st.m_group)
                  + iv[s];
    const bool live = (v >> (8 * s)) & 0xff;
    d.pos[s] = live ? p : 0;
    d.odd |= live && static_cast<unsigned>(p) >= static_cast<unsigned>(
                                                     st.k_tile);
  }
  return d;
}

// Slots q .. q + 3 of tile t of a compressed row (vr, ir) from device
// memory.
template <bool P2>
__device__ __forceinline__ Quad load_quad(const int8_t* __restrict__ vr,
                                          const int32_t* __restrict__ ir,
                                          int t, int q, const SumTile& st) {
  const int g0 = t * st.lc + q;  // slot q's index in the row
  if (st.vec && q < st.lc && g0 < st.kept)
    return make_quad<P2>(__ldg(reinterpret_cast<const int4*>(ir + g0)),
                         __ldg(reinterpret_cast<const unsigned int*>(vr + g0)),
                         q, st);
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
  return make_quad<P2>(make_int4(iv[0], iv[1], iv[2], iv[3]), v, q, st);
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

// x[row, k0 + p] where the slot's position p lies outside the tile: read
// from device memory below K, else 0.
__device__ __forceinline__ int x_outside(const int8_t* __restrict__ x,
                                         int row, int M, int K, int k0,
                                         int p) {
  const int pos = k0 + p;
  return row < M && pos >= 0 && pos < K
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
// a quad with a slot outside the tile adds slot by slot.
template <int RG>
__device__ __forceinline__ void add_quad(int (&acc)[RG][4], const Quad& d,
                                         const uint32_t* xs,
                                         const int8_t* __restrict__ x, int M,
                                         int K, int k0, int k_tile) {
  if (!d.odd) {
#pragma unroll
    for (int rg = 0; rg < RG; ++rg) {
      const uint32_t w[4] = {xs[d.pos[0] * RG + rg], xs[d.pos[1] * RG + rg],
                             xs[d.pos[2] * RG + rg], xs[d.pos[3] * RG + rg]};
      uint32_t y[4];  // y[r]: row 4 rg + r's bytes at the 4 positions
      transpose4(w, y);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[rg][r] = __dp4a(static_cast<int>(y[r]), static_cast<int>(d.v),
                            acc[rg][r]);
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int v = static_cast<int8_t>(d.v >> (8 * s));
    const int p = d.pos[s];
    const bool in = static_cast<unsigned>(p) < static_cast<unsigned>(k_tile);
#pragma unroll
    for (int rg = 0; rg < RG; ++rg)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[rg][r] += v * (in ? static_cast<int8_t>(xs[p * RG + rg] >> (8 * r))
                              : x_outside(x, 4 * rg + r, M, K, k0, p));
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
template <int RG, bool P2>
__global__ void __launch_bounds__(kSumThreads)
    nm_sums_few_rows_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ val,
                            const int32_t* __restrict__ idx,
                            int32_t* __restrict__ out, int M, int N, int K,
                            int T, SumTile st, bool words) {
  constexpr int kWarps = kSumThreads / 32;
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
          d[c] = make_quad<P2>(*reinterpret_cast<const int4*>(sidx + off),
                               *reinterpret_cast<const uint32_t*>(sval + off),
                               q, st);
        } else {
          const int64_t row = static_cast<int64_t>(nc) * st.kept;
          d[c] = load_quad<P2>(val + row, idx + row, t, q, st);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < cols) add_quad<RG>(acc[c], d[c], xs, x, M, K, k0, st.k_tile);
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
template <bool P2>
__global__ void __launch_bounds__(kSumThreads)
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
         n += kSumThreads / 32) {
      const int8_t* vr = val + static_cast<int64_t>(n) * st.kept;
      const int32_t* ir = idx + static_cast<int64_t>(n) * st.kept;
      int acc[4] = {};
      for (int q0 = 0; q0 < st.lc; q0 += 128) {
        const Quad d = load_quad<P2>(vr, ir, t, q0 + 4 * lane, st);
        const int srcs = min(32, (st.lc - q0 + 3) >> 2);
        if (!__any_sync(pqs::kFull, d.odd)) {
          // positions < k_tile <= 1024: two to a word
          const uint32_t p01 = d.pos[0] | (d.pos[1] << 16);
          const uint32_t p23 = d.pos[2] | (d.pos[3] << 16);
#pragma unroll 4
          for (int src = 0; src < srcs; ++src) {
            const uint32_t a = __shfl_sync(pqs::kFull, p01, src);
            const uint32_t b = __shfl_sync(pqs::kFull, p23, src);
            const int v = __shfl_sync(pqs::kFull, static_cast<int>(d.v), src);
            const uint32_t w[4] = {mine[(a & 0xffff) << 5], mine[(a >> 16) << 5],
                                   mine[(b & 0xffff) << 5],
                                   mine[(b >> 16) << 5]};
            uint32_t y[4];  // y[r]: row m0 + 4 lane + r's 4 bytes
            transpose4(w, y);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[r] = __dp4a(static_cast<int>(y[r]), v, acc[r]);
          }
        } else {
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
                                              p));
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
                cudaStream_t s, const Slabs& a, int32_t* out, int T,
                const SumTile& st, bool words) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kSumThreads, smem, s>>>(a.x, a.val, a.idx, out, a.M, a.N,
                                         a.K, T, st, words);
  return cudaGetLastError();
}

// Pass 1's launch: a block per tile and run of columns (grid.x tiles).
template <bool P2>
int launch_pass1(int T, cudaStream_t s, const Slabs& a, int32_t* out,
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
    return launch_sums(nm_sums_few_rows_kernel<1, P2>, grid, few(1), s, a,
                       out, T, st, words);
  if (a.M <= 8)
    return launch_sums(nm_sums_few_rows_kernel<2, P2>, grid, few(2), s, a,
                       out, T, st, words);
  if (a.M <= kFewRows)
    return launch_sums(nm_sums_few_rows_kernel<4, P2>, grid, few(4), s, a,
                       out, T, st, words);
  const size_t smem = static_cast<size_t>(st.k_tile) * 4 * (kManyRows / 4);
  if (smem > pqs::kSmemCap) return cudaErrorInvalidValue;
  return launch_sums(nm_sums_many_rows_kernel<P2>, grid, smem, s, a, out, T,
                     st, words);
}

template <int E, int LT>
__global__ void nm_paired_accum_kernel(const int8_t* __restrict__ x,
                                       const int8_t* __restrict__ val,
                                       const int32_t* __restrict__ idx,
                                       const int32_t* __restrict__ perm,
                                       int32_t* __restrict__ out, int N,
                                       int K, int G, int n_keep, int m_group,
                                       int T, int lc, int acc_bits,
                                       int rounds) {
  __shared__ pqs::Clamp scratch[kPairThreads / 32];
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, G, n_keep, m_group,
                          lc);
  const int r = pqs::paired_dot<E, LT>(p, perm + o * T, T, scratch, acc_bits,
                                       rounds);
  if (threadIdx.x == 0) out[o] = r;
}

struct TiledLaunch {
  Slabs a;
  int32_t* out;
  int T, lc, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    pqs::launch_smem(nm_sort_tiled_kernel<E, LT>,
                     static_cast<int64_t>(a.M) * a.N, kTiledThreads,
                     2 * sizeof(int) * static_cast<size_t>(T), s, a.x, a.val,
                     a.idx, out, a.N, a.K, a.G, a.n_keep, a.m_group, T, lc,
                     acc_bits, rounds);
  }
};

struct PairedLaunch {
  Slabs a;
  const int32_t* perm;
  int32_t* out;
  int T, lc, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    nm_paired_accum_kernel<E, LT>
        <<<static_cast<unsigned>(static_cast<int64_t>(a.M) * a.N),
           kPairThreads, 0, s>>>(a.x, a.val, a.idx, perm, out, a.N, a.K, a.G,
                                 a.n_keep, a.m_group, T, lc, acc_bits,
                                 rounds);
  }
};

}  // namespace

// Plain C entry points, loaded with ctypes. x (M, K) int8, values and
// indices (N, G, n_keep) int8 / int32, perm (M, N, kp/k_tile) int32 and the
// outputs ((M, N) registers, (M, N, kp/k_tile) sums, int32) are contiguous
// device buffers. Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments the kernel does not take (the Python
// wrappers check first).

// policy 0: sorted (kp a power of two), 1: sorted_tiled.
extern "C" int pqs_nm_gather_sort_matmul(const void* x, const void* val,
                                         const void* idx, void* out, int M,
                                         int N, int K, int G, int n_keep,
                                         int m_group, int kp, int policy,
                                         int acc_bits, int rounds, int k_tile,
                                         void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const Slabs a = slabs(x, val, idx, M, N, K, G, n_keep, m_group);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (acc_bits < 2 || acc_bits > 30 || rounds < 0 || kp <= 0)
    return cudaErrorInvalidValue;
  if (policy == 0) {
    if (!valid_slabs(a, kp, 0) || (kp & (kp - 1)))
      return cudaErrorInvalidValue;
    const int L = pqs::next_pow2(G * n_keep);
    return pqs::launch_sorted(nm_sort_sorted_kernel,
                              static_cast<int64_t>(M) * N, L, s, a.x, a.val,
                              a.idx, op, N, K, G, n_keep, m_group, L,
                              acc_bits, rounds);
  }
  if (policy != 1 || k_tile <= 0 || !valid_slabs(a, kp, k_tile))
    return cudaErrorInvalidValue;
  const int lc = (k_tile / m_group) * n_keep;
  return pqs::dispatch_tile(
      pqs::next_pow2(lc),
      TiledLaunch{a, op, kp / k_tile, lc, acc_bits, rounds, s});
}

extern "C" int pqs_nm_gather_tile_sums(const void* x, const void* val,
                                       const void* idx, void* out, int M,
                                       int N, int K, int G, int n_keep,
                                       int m_group, int kp, int k_tile,
                                       void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const Slabs a = slabs(x, val, idx, M, N, K, G, n_keep, m_group);
  if (k_tile <= 0 || !valid_slabs(a, kp, k_tile))
    return cudaErrorInvalidValue;
  SumTile st{(k_tile / m_group) * n_keep, G * n_keep, k_tile, n_keep,
             m_group, 0, 0, false, false};
  while ((1 << st.lk) < n_keep) ++st.lk;
  while ((1 << st.lm) < m_group) ++st.lm;
  const bool p2 = (1 << st.lk) == n_keep && (1 << st.lm) == m_group;
  st.vec = st.kept % 4 == 0 && st.lc % 4 == 0 &&
           reinterpret_cast<uintptr_t>(val) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  const bool words = K % 4 == 0 && k_tile % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 4 == 0;
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return p2 ? launch_pass1<true>(kp / k_tile, s, a, o, st, words)
            : launch_pass1<false>(kp / k_tile, s, a, o, st, words);
}

extern "C" int pqs_nm_gather_paired_accum(const void* x, const void* val,
                                          const void* idx, const void* perm,
                                          void* out, int M, int N, int K,
                                          int G, int n_keep, int m_group,
                                          int kp, int acc_bits, int rounds,
                                          int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const Slabs a = slabs(x, val, idx, M, N, K, G, n_keep, m_group);
  if (k_tile <= 0 || !valid_slabs(a, kp, k_tile) || acc_bits < 2 ||
      acc_bits > 30 || rounds < 0)
    return cudaErrorInvalidValue;
  const int lc = (k_tile / m_group) * n_keep;
  return pqs::dispatch_tile(
      pqs::next_pow2(lc),
      PairedLaunch{a, static_cast<const int32_t*>(perm),
                   static_cast<int32_t*>(out), kp / k_tile, lc, acc_bits,
                   rounds, static_cast<cudaStream_t>(stream)});
}
