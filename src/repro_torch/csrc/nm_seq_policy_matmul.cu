// nm_seq_policy_matmul.cu: the PQS K-streaming policies on N:M compressed
// weights from the kept products, the gather kernel (row 6); its expand
// twin (row 5) is nm_expand_seq.cu.
//
// Replaces:
//   nm_gather_kernel <- repro/kernels/nm_spmm.py:nm_gather_seq_policy_matmul
//     (the Pallas kernel _nm_gather_seq_kernel with gather_nm_products and
//     pad_last_pow2): only the kept products are formed and accumulated.
//
// Operands: x (M, K) int8; values (N, G, n_keep) int8 and indices
// (N, G, n_keep) int32 in canonical form (pruning.nm_compress: indices
// ascend in [0, m), padded slots carry value 0), K <= G * m. out (M, N)
// int32 holds the acc_bits register under wide / clip / wrap /
// sorted_tiled_seq (pqs_accum.cuh). The result equals the dense kernel on
// the decompressed weight bit for bit: the dense product stream is the
// kept-product stream with zeros at the pruned positions, zeros are inert
// under every policy, and a pairwise sort round maps a tile with extra
// zeros to the same ordered stream followed by zeros (the prefix
// property), for any number of rounds. So
// - wide, clip and wrap accumulate the kept products in ascending dense
//   position (the order in which canonical slabs store them);
// - sorted_tiled_seq takes the tile of k_tile dense positions, which is
//   bg = k_tile / m groups, as its bg * n_keep kept products zero-padded
//   to the next power of two (8:16 at k_tile 256: 128 products a tile).
//
// What bounds it on this card: as for the dense kernel, the integer work
// of the per-tile sort and the ordered saturating adds, far above the
// memory roofline at decode. The compressed slabs are 5 bytes per kept
// weight (int8 value, int32 index), 2.5 bytes per dense weight at 8:16, so
// the bytes bound is 2.5x the dense one; the gather sorts tiles of
// L = bg * n_keep products instead of k_tile, n_keep/m of the dense work.
// At decode the sites with few outputs or a long K were bound by latency
// besides: one warp an output walked all of its tiles (35 at w_out, whose
// 192 blocks left 12 warps an SM; wk and wv ran 32 blocks on 132 SMs).
//
// What the gather's design does about it (nm_gather_kernel):
// - Packed keys: rows m, m + 1 and m + 2, m + 3 are two streams whose
//   products are the low and high int16 halves of one register (a
//   gathered product is one int8 x int8 product, so it fits int16 on any
//   slabs; a missing partner row is zero), sorted by the packed network
//   of the dense kernel (pqs_accum.cuh sort_desc2, pairwise_round2): two
//   sorts of a tile for 4 rows, half the compare-exchange and shuffle
//   instructions of four int32 sorts.
// - The tiles split over warps: a block of 8 warps takes 8 / split
//   outputs of 4 rows, and each output's tiles go to `split` warps (1, 2,
//   4 or 8, doubled while the launch has fewer than kFillWarps warps and
//   an output more warp steps), each a contiguous run. A warp composes its
//   run's saturating adds (Clamp) without applying them, and the runs are
//   composed in tile order through shared memory, then applied to 0: the
//   composition the lanes already do, so exact. One launch a call.
// - x in shared memory: the block's 4 rows are staged once as one word a
//   position (row r in byte r), a window of whole steps of at most 16384
//   positions at a time (all of K up to there: 35,840 bytes at w_out), so
//   a gathered position is one shared load for all 4 rows; the value and
//   the index of a slot are two independent loads. A slot that points
//   outside the window (an index outside its group) reads x in device
//   memory where its position lies in [0, K); one before x's row wraps
//   within the slabs' dense row of G * m (pqs::gathered_pos, the rule of
//   the plain version), so nothing outside x is read.
// - With a round the tile's layout in the lanes is free (a sort's result
//   does not depend on where a key starts), so the lanes read the slots
//   coalesced; with none (and under clip) each lane reads its E slots in
//   order. wide and wrap add each row's products in int32 (wrap: one
//   floor mod of the exact sum at the end).
// - Tile shape: 8:16 at k_tile 256 is 128 keys a tile, on 32 lanes of E =
//   4 (one tile a warp step, 15 shuffle stages a sort; pqs::dispatch_tile).
//   16 lanes of E = 8 (two tiles a step, 10 stages) was slower overall
//   (scripts/int8_mma_ab.py keeps it as the variant gather_lt16).
// At decode (M = 4, 8:16) the gather takes 0.57 ms over qwen2-1.5b's 7
// sites (1.03 before this design): w_out 0.161 (0.331), wk 0.0146
// (0.0457); at a prefill cohort (M = 128) 13.2 (23.4). Two tiles of 16
// lanes took 0.59 and 13.7 (chip_smoke.py phase 5 with --baseline-csrc,
// NVIDIA H100 80GB HBM3, 700.00 W).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "nm_seq.cuh"
#include "nm_tile_sums.cuh"
#include "pqs_accum.cuh"

namespace {

using nmseq::Args;
using nmseq::kFillWarps;
using pqs::kRowsPerWarp;
using pqs::Clamp;

constexpr int kGatherWarps = 8;
// x positions a gather block stages at once: 4 rows, 64 KB
constexpr int kStagePositions = 16384;

// The gather kernel (row 6): output n of the block's 4 rows of x takes
// `split` warps, each a contiguous run of the stream's tiles (tile_len =
// bg * n_keep kept slots, zero-padded to the sort tile S = E * LT; 32 / LT
// tiles a warp step). Rows m0, m0 + 1 and m0 + 2, m0 + 3 are two packed
// streams. x is staged a window of tiles at a time; the warps' functions
// are composed in tile order through shared memory, window by window.
template <int E, int LT>
__global__ void __launch_bounds__(32 * kGatherWarps)
    nm_gather_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ vals,
                     const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out, int M, int N, int K, int G,
                     int n_keep, int m_group, int width, int policy,
                     int acc_bits, int rounds, int tile_len, int split) {
  constexpr int TW = 32 / LT;  // tiles a warp step
  __shared__ Clamp part[kGatherWarps][kRowsPerWarp];
  __shared__ Clamp run[kGatherWarps][kRowsPerWarp];
  uint32_t* xs = pqs::dynamic_smem<uint32_t>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane & (LT - 1), g = lane / LT;
  const int outs = kGatherWarps / split, piece = warp % split;
  const int n = blockIdx.x * outs + warp / split;
  const int m0 = blockIdx.y * kRowsPerWarp;
  const int rows = min(kRowsPerWarp, M - m0);
  const bool live = n < N;
  const int kept = G * n_keep;
  const int tiles = (kept + tile_len - 1) / tile_len;
  const int steps = (tiles + TW - 1) / TW;
  // steps a window of x holds: a step's slots reach this many groups
  const int reach = (TW * tile_len + n_keep - 1) / n_keep + 1;
  const int window = max(1, kStagePositions / (reach * m_group));
  const bool sorted = policy == 3 && rounds > 0;
  const bool sums = policy == 0 || policy == 2;
  // with a round the tile's layout is free: the lanes read it coalesced
  const int first = sorted ? l : l * E, stride = sorted ? LT : 1;
  const unsigned magic = pqs::div_magic(n_keep, kept);
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  const int8_t* vrow = vals + static_cast<int64_t>(live ? n : 0) * kept;
  const int32_t* irow = idx + static_cast<int64_t>(live ? n : 0) * kept;
  const int8_t* xb = x + static_cast<int64_t>(m0) * K;
  const bool words = (K & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  if (threadIdx.x < outs * kRowsPerWarp)
    run[threadIdx.x >> 2][threadIdx.x & 3] = pqs::clamp_identity(qmin, qmax);

  for (int w0 = 0; w0 < steps; w0 += window) {
    const int w1 = min(w0 + window, steps);
    // the dense positions of the window's groups, at most kStagePositions;
    // a slot that points elsewhere reads x in device memory
    const int q1 = min(w1 * TW * tile_len, kept);
    const int k0 = (w0 * TW * tile_len / n_keep) * m_group;
    const int k1 = min((q1 + n_keep - 1) / n_keep * m_group, K);
    const int len = max(0, min(k1, k0 + kStagePositions) - k0);
    __syncthreads();  // the last window's words and pieces are read
    if (len > 0)
      nmsums::stage_x(xs, xb, rows, K, k0, len, 0, words && (k0 & 3) == 0);
    __syncthreads();
    const int s0 = w0 + piece * (w1 - w0) / split;
    const int s1 = w0 + (piece + 1) * (w1 - w0) / split;
    Clamp f[kRowsPerWarp];
    unsigned sum[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      f[i] = pqs::clamp_identity(qmin, qmax);
      sum[i] = 0;
    }
    for (int st = live ? s0 : s1; st < s1; ++st) {
      const int tile = st * TW + g;
      uint32_t v[2][E];
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int j = first + r * stride;
        int a[kRowsPerWarp] = {0, 0, 0, 0};
        const int q = tile * tile_len + j;
        if (tile < tiles && j < tile_len && q < kept) {
          const int wv = __ldg(vrow + q), ix = __ldg(irow + q);
          const int gq = magic ? static_cast<int>(__umulhi(
                                     static_cast<unsigned>(q), magic))
                               : q / n_keep;
          const int pos = pqs::gathered_pos(gq, m_group, ix, width);
          uint32_t xw = 0;
          if (static_cast<unsigned>(pos - k0) < static_cast<unsigned>(len))
            xw = xs[pos - k0];
          else if (static_cast<unsigned>(pos) < static_cast<unsigned>(K))
            xw = nmsums::x_word(xb, pos, K, rows);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            a[i] = static_cast<int>(static_cast<int8_t>(xw >> (8 * i))) * wv;
        }
        v[0][r] = pqs::pack2(a[0], a[1]);
        v[1][r] = pqs::pack2(a[2], a[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * h >= rows) continue;  // uniform across the block
        if (sorted)
          for (int rd = 0; rd < rounds; ++rd)
            pqs::pairwise_round2<E, LT>(v[h], l);
        if (sums) {
#pragma unroll
          for (int r = 0; r < E; ++r) {
            sum[2 * h] += pqs::lo16(v[h][r]);
            sum[2 * h + 1] += pqs::hi16(v[h][r]);
          }
        } else {
          Clamp lo = pqs::clamp_identity(qmin, qmax), hi = lo;
#pragma unroll
          for (int r = 0; r < E; ++r) {
            lo = pqs::clamp_then(lo, pqs::clamp_step(pqs::lo16(v[h][r]), qmin,
                                                     qmax));
            hi = pqs::clamp_then(hi, pqs::clamp_step(pqs::hi16(v[h][r]), qmin,
                                                     qmax));
          }
          f[2 * h] = pqs::clamp_then(f[2 * h], pqs::warp_compose(lo, lane));
          f[2 * h + 1] =
              pqs::clamp_then(f[2 * h + 1], pqs::warp_compose(hi, lane));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (sums) {
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          sum[i] += __shfl_xor_sync(pqs::kFull, sum[i], d);
        f[i].c = static_cast<int>(sum[i]);
      }
      if (lane == 0) part[warp][i] = f[i];
    }
    __syncthreads();
    if (threadIdx.x < outs * kRowsPerWarp) {
      const int o = threadIdx.x >> 2, i = threadIdx.x & 3;
      Clamp c = run[o][i];
      for (int p = 0; p < split; ++p) {
        const Clamp d = part[o * split + p][i];
        if (sums)
          c.c = static_cast<int>(static_cast<unsigned>(c.c) +
                                 static_cast<unsigned>(d.c));
        else
          c = pqs::clamp_then(c, d);
      }
      run[o][i] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x < outs * kRowsPerWarp) {
    const int o = threadIdx.x >> 2, i = threadIdx.x & 3;
    const int nn = blockIdx.x * outs + o;
    if (nn < N && i < rows) {
      const Clamp c = run[o][i];
      int r;
      if (policy == 0) {
        r = c.c;
      } else if (policy == 2) {  // one floor mod of the exact sum
        const unsigned span_bits = (1u << acc_bits) - 1;
        r = static_cast<int>((static_cast<unsigned>(c.c) -
                              static_cast<unsigned>(qmin)) & span_bits) +
            qmin;
      } else {
        r = pqs::clamp_apply(c, 0);
      }
      out[static_cast<int64_t>(m0 + i) * N + nn] = r;
    }
  }
}

struct GatherLaunch {
  Args a;
  int tile_len;

  template <int E, int LT>
  void operator()() const {
    // split an output's steps over warps until the launch fills the card
    const int tiles = (a.G * a.n_keep + tile_len - 1) / tile_len;
    const int steps = (tiles + 32 / LT - 1) / (32 / LT);
    const int64_t warps = static_cast<int64_t>(a.N) *
                          ((a.M + kRowsPerWarp - 1) / kRowsPerWarp);
    int split = 1;
    while (split < kGatherWarps && split < steps &&
           warps * split < kFillWarps)
      split *= 2;
    const size_t smem = sizeof(uint32_t) * min(a.K, kStagePositions);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(nm_gather_kernel<E, LT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    nm_gather_kernel<E, LT>
        <<<a.grid(kGatherWarps / split), 32 * kGatherWarps, smem, a.s>>>(
            a.x, a.vals, a.idx, a.out, a.M, a.N, a.K, a.G, a.n_keep,
            a.m_group,
            static_cast<int>(std::min<int64_t>(
                static_cast<int64_t>(a.G) * a.m_group, INT32_MAX)),
            a.policy, a.acc_bits, a.rounds, tile_len, split);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. x (M, K) int8, values and
// indices (N, G, n_keep) int8 / int32 and out (M, N) int32 are contiguous
// device buffers. Returns cudaGetLastError() after its launch.

extern "C" int pqs_nm_gather_seq_policy_matmul(
    const void* x, const void* vals, const void* idx, void* out, int M,
    int N, int K, int G, int n_keep, int m_group, int policy, int acc_bits,
    int rounds, int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int bad = nmseq::check(M, N, K, G, n_keep, m_group, policy,
                               acc_bits, k_tile);
  if (bad) return bad;
  const Args a = nmseq::args(x, vals, idx, out, M, N, K, G, n_keep, m_group,
                             policy, acc_bits, rounds, stream);
  // sorted_tiled_seq's tile: the bg = k_tile / m groups of a dense k_tile
  // tile; the other policies stream the kept slots in runs of 256
  const int tile_len = policy == 3 ? (k_tile / m_group) * n_keep : 256;
  return pqs::dispatch_tile(pqs::next_pow2(tile_len),
                            GatherLaunch{a, tile_len});
}
