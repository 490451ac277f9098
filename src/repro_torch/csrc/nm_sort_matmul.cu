// nm_sort_matmul.cu: the PQS global-sort policies (`sorted`,
// `sorted_tiled`) on N:M compressed weights, from the kept products only;
// five kernels.
//
// Replaces:
//   nm_sort_sorted_rows_kernel, nm_sort_sorted_kernel <-
//     repro/kernels/nm_spmm.py:nm_gather_sort_matmul under `sorted` (the
//     Pallas _nm_gather_sort_kernel with gather_nm_products, pad_last_pow2
//     and bitonic.sorted_order_bitonic), and repro/kernels/sorted_stream.py:
//     nm_gather_chunked_sort_matmul (`sorted` at long K,
//     _nm_gather_chunked_sort_kernel): one block holds all of an output's
//     kept keys, so the TPU's VMEM split into two kernels does not carry
//     over, as for the dense sort_matmul.cu; the first kernel up to 2048
//     kept keys, the second above;
//   nm_sort_tiled_kernel   <- nm_gather_sort_matmul under `sorted_tiled`
//     (tiled_sorted_order over the pow2-padded kept tiles);
//   nm_sums_few_rows_kernel<RG, P2, false>,
//   nm_sums_many_rows_kernel<P2, false> (nm_tile_sums.cuh) <-
//     repro/kernels/sorted_stream.py:nm_gather_tile_sums (pass 1 of the
//     two-pass `sorted_tiled`; the first up to 16 rows of x, the second
//     above);
//   nm_paired_rows_kernel, and past kStagePositions nm_paired_accum_kernel
//     <- repro/kernels/sorted_stream.py:nm_gather_paired_accum_matmul (pass
//     2, fed the pairing permutation).
//
// Operands: x (M, K) int8; values (N, G, n_keep) int8 and indices
// (N, G, n_keep) int32 (pruning.nm_compress); kp >= K and kp >= G * m is
// the padded K of the dense path (a power of two for `sorted`, whole
// k_tile tiles for `sorted_tiled`). Kept slot q of row n is x[m, pos] *
// val[n, q] at pos = (q / n_keep) * m + idx[n, q] (pqs::gathered_pos: a
// position in [-kp, 0) wraps from the end of x's row padded to kp, as the
// plain versions do; one outside [0, K) after that is a zero product, so
// no kernel reads outside x); a slot of a group past G or in the
// power-of-two pad of a tile is a zero product, masked in the kernel, so
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
// bytes of slab (int8 value, int32 index) a kept product (nm_tile_sums.cuh
// says what bounds it). Before this design one block computed one output:
// at decode the 4 rows of x each read the same compressed row (5 bytes a
// slot), each decoded its slots' groups and gathered an x byte a slot;
// `sorted` ran one-warp blocks (32 of an SM's 64 warps at most) whose
// gathers waited on latency, and `sorted_tiled` gathered each product
// twice, for the tile sums and for the pair sorts.
//
// What the design does about it:
// - The one-pass kernels (nm_sort_sorted_rows_kernel,
//   nm_sort_tiled_kernel): a block takes one compressed row n and up to 4
//   rows of x (grid.y walks M in 4s; odd M and M > 4 too), decodes the row
//   once and forms every product once, into shared memory as int16 (a
//   gathered product is one int8 x int8 product): x's rows are staged as
//   one word a position (row r in byte r, up to K = 16384), and a warp
//   takes a tile of slots, a lane 4 of them: their 4 x words
//   byte-transposed into each row's 4 bytes, one slot's value, index and
//   word serve all rows (decode_products). 1.5 KB of products an output at
//   K = 1536. Copying the row's slots into shared memory first (cp.async,
//   in flight while x is staged) measured within 0.5% of reading them
//   once from device memory, so the decode reads them there
//   (scripts/nm_sort_ab.py).
// - `sorted` up to 2048 kept keys: one warp an output builds its keys from
//   the stored products and runs the dense kernels' register body
//   (pqs_accum.cuh sorted_dot: 16 keys a lane at 1024, no shared memory);
//   4 warps a block at decode. Above 2048 (row 17, w_out's 8192) the body
//   needs the block (the radix body over the G n_keep real keys, L / 2048
//   warps, or 16 warps of the network at 65536), so
//   nm_sort_sorted_kernel keeps one output a block and gathers through
//   pqs::GatheredProducts; the lanes read the kept slots coalesced and a
//   slot's group is a multiply-high (pqs::div_magic).
// - `sorted_tiled`: the tile sums of all rows come from the decode pass
//   (one __dp4a a row and 4 slots, a shuffle reduce-scatter), each row's
//   T = kp / k_tile sums are ranked in shared memory, and up to 4 warps an
//   output (one per pair slot) sort each slot's two stored tiles in
//   registers as the halves of packed int16x2 keys (pqs::paired_run).
// - Pass 1: the body of nm_tile_sums.cuh, which the expand twin's pass 1
//   (nm_expand_sort.cu) shares; here a nonzero slot whose index points
//   outside its group (so outside the tile) is read from x in device
//   memory where its position lies in [0, K), as gather_nm_products reads
//   it. A block takes one tile and a run of output columns and stages x's
//   columns of the tile transposed in shared memory, so each kept slot is
//   read once for all rows of x (the lanes split a tile's slots up to 16
//   rows of x, own rows above). At w_out (8:16) it takes 0.0263 ms at M =
//   4 and 0.2005 at M = 128, against a float32 bmm of the same sums on the
//   decompressed weight at 0.0345 / 0.0975 (chip_smoke.py phase 5 with
//   --baseline-csrc, NVIDIA H100 80GB HBM3, 700.00 W).
// - Pass 2 (row 14), nm_paired_rows_kernel: the one-pass `sorted_tiled`
//   block fed perm. It stages x and decodes compressed row n once into
//   int16 products for up to 4 rows of x (decode_products), as the one-pass
//   kernel does, loads the rows' perm into shared memory where that kernel
//   keeps its sums, and runs pass2.cuh's block body on the stored products
//   (two pair slots a warp step, a kept tile on 16 lanes read as 16-byte
//   words, up to 16 warps a block in contiguous runs of steps; the
//   network with the directions folded into the keys). Before it a block
//   of up to 8 warps took one output, and each product cost an index, a
//   value, a multiply-high for its group and a dependent byte of x, for
//   every row of x. Past kStagePositions (x not staged) nm_paired_accum_kernel
//   keeps that design, gathering through pqs::GatheredProducts.
//   At w_out (8:16) it takes 0.125 ms at M = 4 and 3.51 at M = 128,
//   0.182 and 5.31 before; tiles on 32 lanes took 0.154 at M = 4, on 8
//   lanes 0.131, 8 warps a block 0.140, the directions as selects 0.153
//   (chip_smoke.py phase 5 with --baseline-csrc and scripts/pass2_ab.py,
//   NVIDIA H100 80GB HBM3, 700.00 W).
// Over qwen2-1.5b's six K = 1536 sites at decode (M = 4, 8:16) the
// one-pass kernel takes 0.45 ms under `sorted_tiled` and 0.45 under
// `sorted`, 12.6 under `sorted` at M = 128; before this design (one
// output a block, gathered products) 0.69, 0.63 and 15.5 (chip_smoke.py
// phase 5 with --baseline-csrc, NVIDIA H100 80GB HBM3, 700.00 W). Two rows
// of x a block took 0.49 / 0.50 (scripts/nm_sort_ab.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "nm_tile_sums.cuh"
#include "pass2.cuh"
#include "pqs_accum.cuh"

namespace {

using pqs::Clamp;
using pqs::Slabs;
using pqs::slabs;
using pqs::valid_slabs;

constexpr int kTiledWarps = 4;  // warps an output of the one-pass tiled
constexpr int kPairWarps = 8;   // of pass 2 past kStagePositions
constexpr int kPairLanes = 16;  // lanes a pass-2 sort tile: 2 a warp
constexpr int kRowsPairWarps = 16;  // warps a pass-2 row block at most
constexpr int kRows = 4;        // rows of x a one-pass block serves
constexpr int kStagePositions = 16384;  // x staged up to this K (64 KB)
constexpr int kSortedTile = 128;  // `sorted`: slots a decode step takes
constexpr int kMaxSortedRowsL = 2048;  // `sorted` keys of the rows kernel

// The kept products of output (m, n), gathered from device memory (rows 14
// and 17, and `sorted` above 2048 kept keys).
__device__ __forceinline__ pqs::GatheredProducts gathered(
    const int8_t* x, const int8_t* val, const int32_t* idx, int64_t m,
    int64_t n, int K, int width, int G, int n_keep, int m_group,
    int tile_len) {
  const int kept = G * n_keep;
  return pqs::GatheredProducts{x + m * K, val + n * kept, idx + n * kept, K,
                               width, kept, n_keep, m_group, tile_len,
                               pqs::div_magic(n_keep, kept)};
}

// One output's products decoded into shared memory by its block
// (decode_products): product j of tile t at s[t * tile_len + j].
struct StagedProducts {
  const int16_t* s;
  int tile_len;
  __device__ __forceinline__ int tile(int t, int j) const {
    return j < tile_len ? s[t * tile_len + j] : 0;
  }
};

// The one-pass block's shared memory (byte offsets), in this order: x's
// rows staged (4 K bytes, up to kStagePositions), the rows' products (2
// bytes each, `stride` a row), then 2 T ints a row (sums, perm;
// `sorted_tiled` only).
struct RowsLayout {
  int prods, sums, total;
  bool stage_x;
};

inline int round16(int64_t b) { return static_cast<int>((b + 15) & ~15); }

inline RowsLayout rows_layout(const Slabs& a, int rows, int stride, int T,
                              bool stage) {
  RowsLayout l{};
  l.stage_x = stage && a.K <= kStagePositions;
  l.prods = l.stage_x ? round16(4 * static_cast<int64_t>(a.K)) : 0;
  l.sums = l.prods + round16(2 * static_cast<int64_t>(rows) * stride);
  l.total = l.sums + 2 * static_cast<int>(sizeof(int)) * rows * T;
  return l;
}

// The arguments of the one-pass kernels.
struct RowsArgs {
  const int8_t* x;
  const int8_t* val;
  const int32_t* idx;
  int32_t* out;
  int M, N, K, width, G, n_keep, m_group, acc_bits, rounds;
  int rows;      // rows of x a block serves (grid.y = ceil(M / rows))
  int stride;    // products a row holds: a multiple of 4
  int T;         // tiles (`sorted_tiled`)
  int tile_len;  // kept slots a tile
  int wpo;       // warps an output (`sorted_tiled`)
  RowsLayout l;
  const int32_t* perm;  // pass 2: (M, N, T) pairing permutation
};

// What a one-pass block has at hand: compressed row n's slots and its rows
// of x (staged as one word a position, row r in byte r, or read from
// device memory).
struct RowSlots {
  const int8_t* val;
  const int32_t* idx;
  const uint32_t* xs;  // null: read xb
  const int8_t* xb;    // x's first row of the block
  int rows, K, width, kept, n_keep, m_group;
  unsigned magic;

  // The word of x's rows at kept slot q, and its value in v (both 0 for a
  // slot past kept, of value 0 or at a position outside [0, K)).
  __device__ __forceinline__ uint32_t word(int q, int& v) const {
    v = 0;
    if (q >= kept) return 0;
    const int vq = __ldg(val + q);
    if (vq == 0) return 0;
    const int g = magic ? static_cast<int>(__umulhi(
                              static_cast<unsigned>(q), magic))
                        : q / n_keep;
    const int pos = pqs::gathered_pos(g, m_group, __ldg(idx + q), width);
    if (static_cast<unsigned>(pos) >= static_cast<unsigned>(K)) return 0;
    v = vq;
    return xs ? xs[pos] : nmsums::x_word(xb, pos, K, rows);
  }
};

// The block's row n = blockIdx.x and rows m0 = blockIdx.y * a.rows ..,
// x's rows staged where a.l says. Ends with the block in step.
__device__ __forceinline__ RowSlots stage_block(const RowsArgs& a,
                                                unsigned char* smem) {
  const int kept = a.G * a.n_keep;
  const int64_t n = blockIdx.x;
  const int m0 = blockIdx.y * a.rows;
  RowSlots rs{a.val + n * kept, a.idx + n * kept, nullptr,
              a.x + static_cast<int64_t>(m0) * a.K, min(a.rows, a.M - m0),
              a.K, a.width, kept, a.n_keep, a.m_group,
              pqs::div_magic(a.n_keep, kept)};
  if (a.l.stage_x) {
    auto* xs = reinterpret_cast<uint32_t*>(smem);
    nmsums::stage_x(xs, rs.xb, rs.rows, a.K, 0, a.K, 0,
                    (a.K & 3) == 0 &&
                        (reinterpret_cast<uintptr_t>(a.x) & 3) == 0);
    rs.xs = xs;
    __syncthreads();
  }
  return rs;
}

// The block's products: prods[r * stride + q] = x[m0 + r, pos(q)] *
// val[q] for its rows r and the slots q in [0, len) (zero past kept), in
// tiles of tile_len slots, a warp a tile and a lane 4 consecutive slots of
// it: their x words byte-transposed into each row's 4 bytes, so one
// slot's value, index and x word serve all rows. With kSums, sums[r * T +
// t] is tile t's sum of row r's products (one __dp4a a row and 4 slots, a
// shuffle reduce-scatter). Ends with the block in step.
template <bool kSums>
__device__ __forceinline__ void decode_products(const RowSlots& rs,
                                                int16_t* prods, int stride,
                                                int* sums, int len,
                                                int tile_len) {
  const int lane = threadIdx.x & 31;
  const int T = (len + tile_len - 1) / tile_len;
  const bool vec = (tile_len & 3) == 0 && (stride & 3) == 0;
  for (int t = threadIdx.x >> 5; t < T; t += blockDim.x >> 5) {
    int acc[4] = {0, 0, 0, 0};
    for (int j = 4 * lane; j < tile_len; j += 128) {
      const int q0 = t * tile_len + j;
      uint32_t w[4], v = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        int vs = 0;
        w[s] = j + s < tile_len ? rs.word(q0 + s, vs) : 0;
        v |= static_cast<uint32_t>(static_cast<uint8_t>(vs)) << (8 * s);
      }
      uint32_t y[4];  // y[r]: row r's x bytes at the 4 slots
      mma8::transpose4(w, y);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rs.rows) break;
        if (kSums)
          acc[r] = __dp4a(static_cast<int>(y[r]), static_cast<int>(v),
                          acc[r]);
        int p[4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
          p[s] = static_cast<int>(static_cast<int8_t>(y[r] >> (8 * s))) *
                 static_cast<int>(static_cast<int8_t>(v >> (8 * s)));
        int16_t* out = prods + r * stride + q0;
        if (vec && q0 + 4 <= len) {
          *reinterpret_cast<uint2*>(out) =
              make_uint2(pqs::pack2(p[0], p[1]), pqs::pack2(p[2], p[3]));
        } else {
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (j + s < tile_len && q0 + s < len)
              out[s] = static_cast<int16_t>(p[s]);
        }
      }
    }
    if (kSums) {
      const int sum = nmsums::reduce4(acc, lane);
      const int r = 2 * ((lane >> 4) & 1) + ((lane >> 3) & 1);
      if ((lane & 7) == 0 && r < rs.rows) sums[r * T + t] = sum;
    }
  }
  __syncthreads();
}

// `sorted` up to kMaxSortedRowsL kept keys: a warp an output (row m0 + r
// of the block's rows), L = 64 E keys from the stored products.
template <int E>
__global__ void __launch_bounds__(32 * kRows)
    nm_sort_sorted_rows_kernel(RowsArgs a) {
  unsigned char* smem = pqs::dynamic_smem<unsigned char>();
  const RowSlots rs = stage_block(a, smem);
  auto* prods = reinterpret_cast<int16_t*>(smem + a.l.prods);
  decode_products<false>(rs, prods, a.stride, nullptr, 64 * E, kSortedTile);
  const int r = threadIdx.x >> 5;
  if (r >= rs.rows) return;  // whole warp; no block barrier follows
  const int v = pqs::sorted_dot<E, 1>(pqs::SharedKeys{prods + r * a.stride},
                                      nullptr, nullptr, a.acc_bits,
                                      a.rounds);
  if ((threadIdx.x & 31) == 0)
    a.out[static_cast<int64_t>(blockIdx.y * a.rows + r) * a.N + blockIdx.x] =
        v;
}

// `sorted` above kMaxSortedRowsL kept keys: one output a block.
template <int E, int W>
__global__ void __launch_bounds__(32 * W)
    nm_sort_sorted_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ val,
                          const int32_t* __restrict__ idx,
                          int32_t* __restrict__ out, int N, int K, int width,
                          int G, int n_keep, int m_group, int acc_bits,
                          int rounds) {
  __shared__ Clamp scratch[2 * W];
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, width, G, n_keep,
                          m_group, G * n_keep);
  int r;
  if constexpr (pqs::radix_regime(E, W))
    r = pqs::radix_sorted_shared<W>(p, G * n_keep, scratch, acc_bits, rounds);
  else
    r = pqs::sorted_dot<E, W>(p, pqs::dynamic_smem<uint32_t>(), scratch,
                              acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

// `sorted_tiled` one-pass: a.wpo warps an output (row m0 + r of the
// block's rows); the tile sums from the decode pass, each row's pairing in
// shared memory, the pair slots sorted on packed keys.
template <int E, int LT>
__global__ void __launch_bounds__(32 * kRows * kTiledWarps)
    nm_sort_tiled_kernel(RowsArgs a) {
  __shared__ Clamp scratch[kRows * kTiledWarps];
  unsigned char* smem = pqs::dynamic_smem<unsigned char>();
  const RowSlots rs = stage_block(a, smem);
  auto* prods = reinterpret_cast<int16_t*>(smem + a.l.prods);
  int* sums = reinterpret_cast<int*>(smem + a.l.sums);
  int* perm = sums + a.rows * a.T;
  decode_products<true>(rs, prods, a.stride, sums, a.T * a.tile_len,
                        a.tile_len);
  pqs::pair_permutation(sums, perm, a.T, rs.rows);
  const int warp = threadIdx.x >> 5, r = warp / a.wpo;
  if (r < rs.rows) {
    const Clamp run = pqs::paired_run<E, LT, true>(
        StagedProducts{prods + r * a.stride, a.tile_len}, perm + r * a.T,
        a.T, warp - r * a.wpo, a.wpo, a.acc_bits, a.rounds);
    if ((threadIdx.x & 31) == 0) scratch[warp] = run;
  }
  __syncthreads();
  if (r < rs.rows && warp == r * a.wpo && (threadIdx.x & 31) == 0) {
    Clamp f = scratch[warp];
    for (int i = 1; i < a.wpo; ++i) f = pqs::clamp_then(f, scratch[warp + i]);
    a.out[static_cast<int64_t>(blockIdx.y * a.rows + r) * a.N + blockIdx.x] =
        pqs::clamp_apply(f, 0);
  }
}

template <int E, int LT>
__global__ void nm_paired_accum_kernel(const int8_t* __restrict__ x,
                                       const int8_t* __restrict__ val,
                                       const int32_t* __restrict__ idx,
                                       const int32_t* __restrict__ perm,
                                       int32_t* __restrict__ out, int N,
                                       int K, int width, int G, int n_keep,
                                       int m_group, int T, int lc,
                                       int acc_bits, int rounds) {
  __shared__ Clamp scratch[kPairWarps];
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, width, G, n_keep,
                          m_group, lc);
  const int r = pqs::paired_dot<E, LT, true>(p, perm + o * T, T, scratch,
                                             acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

// Pass 2 (row 14) up to kStagePositions: the one-pass tiled block fed the
// pairing. Compressed row n = blockIdx.x is decoded once into int16
// products for the block's rows (m0 = blockIdx.y * a.rows ..), their rows
// of perm go to shared memory (where the one-pass kernel keeps its sums),
// and pass2::block_rows runs the pair slots on the stored products. One
// block an SM is all the launch bounds ask: with the register allocator's
// own target the instances of 16 and fewer kept keys a tile held 32
// registers and spilled (scripts/pass2_ab.py).
template <int E, int LT>
__global__ void __launch_bounds__(32 * kRowsPairWarps, 1)
    nm_paired_rows_kernel(RowsArgs a) {
  __shared__ Clamp acc[kRowsPairWarps * pass2::kRows];
  unsigned char* smem = pqs::dynamic_smem<unsigned char>();
  const RowSlots rs = stage_block(a, smem);
  auto* prods = reinterpret_cast<int16_t*>(smem + a.l.prods);
  int* perm = reinterpret_cast<int*>(smem + a.l.sums);
  const int64_t n = blockIdx.x;
  const int m0 = blockIdx.y * a.rows;
  const int32_t* pm = a.perm + (static_cast<int64_t>(m0) * a.N + n) * a.T;
  for (int k = threadIdx.x; k < rs.rows * a.T; k += blockDim.x) {
    const int r = k / a.T;
    perm[k] = __ldg(pm + static_cast<int64_t>(r) * a.N * a.T + (k - r * a.T));
  }
  decode_products<false>(rs, prods, a.stride, nullptr, a.T * a.tile_len,
                         a.tile_len);
  pass2::block_rows<E, LT, false>(
      pass2::StagedRows{prods, a.stride, a.tile_len},
      pass2::PermRows{perm, a.T}, rs.rows, a.T, acc, nullptr, a.acc_bits,
      a.rounds);
  if (threadIdx.x < rs.rows)
    a.out[static_cast<int64_t>(m0 + threadIdx.x) * a.N + n] =
        pass2::rows_register(acc, threadIdx.x, blockDim.x >> 5);
}

// The one-pass arguments r for up to kRows rows of x a block, with `stride`
// products a row and T tiles: staging x where the shared memory stays
// within pqs::kSmemCap, fewer rows a block where the products do not fit,
// no staging last (none with staged_only). False where one row's products
// and tiles do not fit either.
bool rows_args(RowsArgs& r, const Slabs& a, int stride, int T,
               bool staged_only = false) {
  for (int unstaged = 0; unstaged < (staged_only ? 1 : 2); ++unstaged)
    for (int rows = a.M < kRows ? a.M : kRows; rows >= 1; rows >>= 1) {
      const RowsLayout l = rows_layout(a, rows, stride, T, !unstaged);
      if (l.total <= static_cast<int>(pqs::kSmemCap) &&
          (a.M + rows - 1) / rows <= 65535) {
        r.rows = rows;
        r.stride = stride;
        r.T = T;
        r.l = l;
        return true;
      }
    }
  return false;
}

template <typename Kernel>
void launch_rows(Kernel kernel, const RowsArgs& r, int threads,
                 cudaStream_t s) {
  if (r.l.total > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         r.l.total);
  kernel<<<dim3(r.N, (r.M + r.rows - 1) / r.rows), threads, r.l.total, s>>>(
      r);
}

struct SortedLaunch {
  Slabs a;
  RowsArgs r;
  cudaStream_t s;

  template <int E, int W>
  void operator()() const {
    if constexpr (W == 1) {
      launch_rows(nm_sort_sorted_rows_kernel<E>, r, 32 * r.rows, s);
    } else {
      pqs::launch_smem(nm_sort_sorted_kernel<E, W>,
                       static_cast<int64_t>(a.M) * a.N, 32 * W,
                       pqs::sorted_smem_bytes(E, W, a.G * a.n_keep), s, a.x,
                       a.val, a.idx, r.out, a.N, a.K, r.width, a.G, a.n_keep,
                       a.m_group, r.acc_bits, r.rounds);
    }
  }
};

struct TiledLaunch {
  RowsArgs r;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    RowsArgs b = r;
    b.wpo = pqs::paired_threads(b.T, E * LT, kTiledWarps) / 32;
    launch_rows(nm_sort_tiled_kernel<E, LT>, b, 32 * b.rows * b.wpo, s);
  }
};

struct RowsPairedLaunch {
  RowsArgs r;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    const int steps = ((r.T + 1) / 2 + 32 / LT - 1) / (32 / LT);
    launch_rows(nm_paired_rows_kernel<E, LT>, r,
                32 * pass2::balanced_warps(r.rows * steps, kRowsPairWarps),
                s);
  }
};

struct PairedLaunch {
  Slabs a;
  const int32_t* perm;
  int32_t* out;
  int width, T, lc, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    nm_paired_accum_kernel<E, LT>
        <<<static_cast<unsigned>(static_cast<int64_t>(a.M) * a.N),
           pqs::paired_threads(T, E * LT, kPairWarps), 0, s>>>(
            a.x, a.val, a.idx, perm, out, a.N, a.K, width, a.G, a.n_keep,
            a.m_group, T, lc, acc_bits, rounds);
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
  auto s = static_cast<cudaStream_t>(stream);
  if (acc_bits < 2 || acc_bits > 30 || rounds < 0 || kp <= 0)
    return cudaErrorInvalidValue;
  RowsArgs r{a.x, a.val, a.idx, static_cast<int32_t*>(out), M, N, K, kp,
             G, n_keep, m_group, acc_bits, rounds};
  if (policy == 0) {
    if (!valid_slabs(a, kp, 0) || (kp & (kp - 1)))
      return cudaErrorInvalidValue;
    const int L = pqs::next_pow2(G * n_keep);
    if (L <= kMaxSortedRowsL && !rows_args(r, a, L < 64 ? 64 : L, 1))
      return cudaErrorInvalidValue;
    return pqs::dispatch_sorted(L, SortedLaunch{a, r, s});
  }
  if (policy != 1 || k_tile <= 0 || !valid_slabs(a, kp, k_tile))
    return cudaErrorInvalidValue;
  const int lc = (k_tile / m_group) * n_keep;
  const int T = kp / k_tile;
  r.tile_len = lc;
  if (!rows_args(r, a, (T * lc + 3) & ~3, T)) return cudaErrorInvalidValue;
  return pqs::dispatch_tile(pqs::next_pow2(lc), TiledLaunch{r, s});
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
  return nmsums::tile_sums<false>(a, static_cast<int32_t*>(out), kp, k_tile,
                                  static_cast<cudaStream_t>(stream));
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
  const int T = kp / k_tile;
  auto s = static_cast<cudaStream_t>(stream);
  RowsArgs r{a.x, a.val, a.idx, static_cast<int32_t*>(out), M, N, K, kp,
             G, n_keep, m_group, acc_bits, rounds};
  r.tile_len = lc;
  r.perm = static_cast<const int32_t*>(perm);
  if (K <= kStagePositions && rows_args(r, a, (T * lc + 7) & ~7, T, true))
    return pass2::dispatch<kPairLanes>(pqs::next_pow2(lc),
                                       RowsPairedLaunch{r, s});
  return pqs::dispatch_tile(
      pqs::next_pow2(lc),
      PairedLaunch{a, static_cast<const int32_t*>(perm),
                   static_cast<int32_t*>(out), kp, T, lc, acc_bits, rounds,
                   s});
}
