// nm_expand_seq.cu: the PQS K-streaming policies on N:M compressed
// weights with each compressed row expanded to its dense positions, the
// expand kernel (row 5); its gather twin (row 6) is
// nm_seq_policy_matmul.cu.
//
// Replaces:
//   nm_expand_kernel (clip, sorted_tiled_seq) and mma_kernel<MT, NmChunks /
//     NmBytes> (wide; wrap through mma8::WrapK) <-
//     repro/kernels/nm_spmm.py:nm_seq_policy_matmul (the Pallas kernel
//     _nm_seq_kernel with expand_nm_slab): the compressed row is expanded
//     to its dense positions, then accumulated exactly as the dense kernel
//     does; the exactness oracle of the gather.
//
// Operands and policies as nm_seq_policy_matmul.cu's header gives them;
// the result is the dense kernel's on the decompressed weight, bit for
// bit, and, on canonical slabs, the gather's.
//
// What bounds it on this card: the integer work of the per-tile sorts and
// the ordered saturating adds, as for the dense kernel (row 1) and the
// gather; its bytes are the compressed slabs' (5 bytes a kept weight).
// One warp an output walking all of K leaves the sites with few outputs
// bound by latency (32 blocks on 132 SMs at wk and wv); a row expanded
// again for every chunk and every 4 rows of x, and tiles of k_tile dense
// keys sorted as four int32 streams, spend the issue slots on zeros and
// on work the 4 rows share; `wide` wants the tensor cores.
//
// What the design does about it:
// - wide and wrap are the exact int32 sum on the int8 tensor-core
//   mainloop of int8_mma.cuh with row 4's loaders (nm_chunks.cuh: each
//   slab's bytes built in shared memory from the values and indices), the
//   same launch as nm_spmm; wrap's floor mod of the exact sum is its
//   epilogue (mma8::WrapK). A block whose slabs name a position twice
//   takes the exact int32 sums from the slots (nm_chunks.cuh).
// - clip and sorted_tiled_seq (nm_expand_kernel) take the gather's shape:
//   a block of 8 warps takes 8 / split outputs of 4 rows of x, each
//   output's warp steps (TW = 32 / LT sort tiles a step) split over
//   `split` warps in contiguous runs, their Clamps composed in tile order
//   through shared memory; rows m, m + 1 and m + 2, m + 3 packed as
//   int16x2 keys, as rows 1 and 6 do; x staged as one word a position for
//   4 rows. Where the launch has the warps with no split (a prefill
//   cohort), a block takes up to 4 groups of 4 rows instead and 8 / groups
//   outputs, a warp an output's group, so that a row expanded once serves
//   16 rows of x.
// - Each output's compressed row is expanded once a window (as many
//   dense positions as kExpandBytes of shared memory hold) for its 4 rows
//   of x: the block zeroes a row of int8 weights and a bit a position,
//   then each nonzero slot whose index lies in its group sets its
//   position's bit (atomicOr) and stores its value there. Its products
//   come from the expanded row, never from the gather's slots, so the two
//   kernels stay independent oracles of each other.
// - A zero product adds nothing under a saturating add, and with a round
//   a sorted tile is its nonzero products followed by zeros whatever zeros
//   it held (the prefix property), so the block lists each tile's nonzero
//   positions in order, a position's rank the popcount of the tile's bits
//   before it, and a step takes those: at 8:16 and k_tile 256 (or clip's
//   256), 128 keys a tile where the dense tile has 256 (the gather's
//   network; a tile of whole groups never has more nonzero positions than
//   kept slots, lc = (tile / m) n_keep). With a round the lanes read the
//   list coalesced; else a lane takes E consecutive entries (stream
//   order, which clip needs). Where lc fills the tile a step takes the
//   tile's dense positions, E consecutive a lane by vector loads.
// - The sorts run pass2.cuh's network with its directions folded into
//   the keys and its add-then-max saturating adds (pairwise_round_folded,
//   then_step), which took pass 2 1.2-1.4x.
// - A bit already set means a second nonzero slot at that position (never
//   on canonical slabs): the weight is their int32 sum, which may leave
//   int8 and its products int16. The block then takes that window on the
//   int32 route, as rows 7 and 16 have one: each key's weight is summed
//   from its group's slots, and each row's int32 products are sorted on
//   their own (pairwise_round). A route the data picks; the flag is a
//   shared word set between plain barriers.
// - A slot whose index leaves its group adds nothing (expand_slots and the
//   reference's one-hot drop it); positions past K and groups past G are
//   masked in the kernel, so ragged G, M, N and K need no host padding.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "nm_chunks.cuh"
#include "nm_seq.cuh"
#include "nm_tile_sums.cuh"
#include "pass2.cuh"
#include "pqs_accum.cuh"

namespace {

using nmseq::Args;
using nmseq::kFillWarps;
using pqs::kRowsPerWarp;
using pqs::Clamp;

constexpr int kExpandWarps = 8;
// shared memory a window of an expand block takes at most: x's words and
// each output's weights, occupancy bits and lists (4 blocks an SM)
constexpr int kExpandBytes = 56 * 1024;

// E consecutive words of shared memory at p (aligned to min(E, 4) words).
template <int E>
__device__ __forceinline__ void load_words(uint32_t (&d)[E],
                                           const uint32_t* p) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[q];
      d[4 * q] = t.x;
      d[4 * q + 1] = t.y;
      d[4 * q + 2] = t.z;
      d[4 * q + 3] = t.w;
    }
  } else if constexpr (E == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    d[0] = t.x;
    d[1] = t.y;
  } else {
    d[0] = p[0];
  }
}

// E consecutive int8 weights of shared memory at p (aligned to E bytes,
// at most 16).
template <int E>
__device__ __forceinline__ void load_weights(int (&d)[E], const int8_t* p) {
  if constexpr (E % 4 == 0) {
    uint32_t u[E / 4];
    load_words<E / 4>(u, reinterpret_cast<const uint32_t*>(p));
#pragma unroll
    for (int r = 0; r < E; ++r)
      d[r] = static_cast<int8_t>(u[r >> 2] >> (8 * (r & 3)));
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) d[r] = p[r];
  }
}

// Byte i of a staged x word (row m0 + i), sign-extended.
__device__ __forceinline__ int x_row(uint32_t w, int i) {
  return static_cast<int8_t>(w >> (8 * i));
}

// The expanded weight of window position p (int32: the sum of the slots
// that name it) read from the slabs, for the int32 route: zero where no
// nonzero slot landed (its occupancy bit clear).
__device__ __forceinline__ int slot_sum(const int8_t* vrow,
                                        const int32_t* irow,
                                        const uint32_t* bits, int n_keep,
                                        int m_group, int k0, int p) {
  if (!((bits[p >> 5] >> (p & 31)) & 1u)) return 0;
  const int g = (k0 + p) / m_group, j = k0 + p - g * m_group;
  int w = 0;
  for (int q = g * n_keep; q < (g + 1) * n_keep; ++q)
    if (__ldg(irow + q) == j) w += __ldg(vrow + q);
  return w;
}

// The expand kernel (row 5) under clip (policy 1) and sorted_tiled_seq
// (3): output n of each of the block's 1 << lrg groups of 4 rows of x
// takes `split` warps, each a contiguous run of the dense stream's warp
// steps, a step TW = 32 / LT tiles of `tile` dense positions (k_tile
// under sorted_tiled_seq, 256 under clip). A window of `window` positions
// (whole steps) at a time, the block stages x and expands each output's
// row into int8 weights and a bit a position. With `compact` (a tile's
// kept slots fewer than its positions) each tile's nonzero positions are
// then listed in order, L = E LT of them at most (the rest of the list is
// padding), and a step takes those; else a step takes the tile's dense
// positions, E LT = tile. A window where two nonzero slots name one
// position takes the int32 route. The warps' functions are composed in
// tile order through shared memory, window by window.
template <int E, int LT>
__global__ void __launch_bounds__(32 * kExpandWarps)
    nm_expand_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ vals,
                     const int32_t* __restrict__ idx,
                     int32_t* __restrict__ out, int M, int N, int K, int G,
                     int n_keep, int m_group, int policy, int acc_bits,
                     int rounds, int tile, bool compact, int split, int lrg,
                     int window) {
  constexpr int L = E * LT;   // keys of a sort tile
  constexpr int TW = 32 / LT;  // tiles of a warp step
  __shared__ Clamp part[kExpandWarps][kRowsPerWarp];
  __shared__ Clamp run[kExpandWarps][kRowsPerWarp];
  __shared__ int wide_window;  // the last window (from 1) with a collision
  const int rg = 1 << lrg;            // groups of 4 rows of x a block
  const int outs = kExpandWarps / (split * rg);
  const int P = TW * tile;          // dense positions of a warp step
  const int tiles = window / tile;  // tiles of a window
  const int nw = window >> 5;       // occupancy words of an output
  // x's words, then each output's int8 weights, occupancy bits and (with
  // `compact`) its tiles' lists of nonzero positions (p + 1; 0 pads)
  uint32_t* xs = pqs::dynamic_smem<uint32_t>();
  int8_t* ws = reinterpret_cast<int8_t*>(xs + window * rg);
  uint32_t* occ = reinterpret_cast<uint32_t*>(ws + outs * window);
  uint16_t* list = reinterpret_cast<uint16_t*>(occ + outs * nw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane & (LT - 1), seg = lane / LT;
  // warp = (output o, row group gr, piece of the output's steps)
  const int o = warp / (rg * split), gr = warp / split % rg;
  const int piece = warp % split;
  const int n = blockIdx.x * outs + o;
  const int mb = blockIdx.y * kRowsPerWarp * rg;  // the block's first row
  const int m0 = mb + kRowsPerWarp * gr;
  const int rows = min(kRowsPerWarp, M - m0);
  const bool live = n < N && rows > 0;
  const int kept = G * n_keep;
  const int steps = (K + P - 1) / P, wsteps = window / P;
  const bool sorted = policy == 3;
  const bool any_order = sorted && rounds > 0;  // keys in any layout
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  const unsigned magic = pqs::div_magic(n_keep, kept);
  const int8_t* vrow = vals + static_cast<int64_t>(live ? n : 0) * kept;
  const int32_t* irow = idx + static_cast<int64_t>(live ? n : 0) * kept;
  const int8_t* xb = x + static_cast<int64_t>(mb) * K;
  const bool words = (K & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  // the zeroed bytes of a window: weights, bits and lists
  const int zero_words =
      (outs * (window + 4 * nw + (compact ? 2 * tiles * L : 0)) + 3) / 4;
  if (threadIdx.x < outs * rg * kRowsPerWarp)
    run[threadIdx.x >> 2][threadIdx.x & 3] = pqs::clamp_identity(qmin, qmax);
  if (threadIdx.x == 0) wide_window = 0;

  for (int w0 = 0, wi = 1; w0 < steps; w0 += wsteps, ++wi) {
    const int w1 = min(w0 + wsteps, steps);
    const int k0 = w0 * P, len = min(w1 * P, K) - k0;
    __syncthreads();  // the last window's words, weights and pieces are read
    nmsums::stage_x(xs, xb, min(kRowsPerWarp * rg, M - mb), K, k0, len,
                    lrg, words);
    for (int i = threadIdx.x; i < zero_words; i += blockDim.x)
      reinterpret_cast<uint32_t*>(ws)[i] = 0;
    __syncthreads();
    // the slots of the groups that reach the window, every output's
    const int q0 = (k0 / m_group) * n_keep;
    const int q1 = min(G, (k0 + len + m_group - 1) / m_group) * n_keep;
    for (int oo = 0; oo < outs; ++oo) {
      const int nn = blockIdx.x * outs + oo;
      if (nn >= N) break;
      const int8_t* vr = vals + static_cast<int64_t>(nn) * kept;
      const int32_t* ir = idx + static_cast<int64_t>(nn) * kept;
      for (int q = q0 + static_cast<int>(threadIdx.x); q < q1;
           q += blockDim.x) {
        const int v = __ldg(vr + q);
        if (v == 0) continue;  // a padded slot adds nothing
        const int j = __ldg(ir + q);
        if (static_cast<unsigned>(j) >= static_cast<unsigned>(m_group))
          continue;  // an index outside its group adds nothing
        const int g = magic ? static_cast<int>(__umulhi(
                                  static_cast<unsigned>(q), magic))
                            : q / n_keep;
        const int p = g * m_group + j - k0;
        if (static_cast<unsigned>(p) >= static_cast<unsigned>(len)) continue;
        const uint32_t bit = 1u << (p & 31);
        if (atomicOr(occ + oo * nw + (p >> 5), bit) & bit)
          wide_window = wi;  // a second slot here: the int32 route
        else
          ws[oo * window + p] = static_cast<int8_t>(v);
      }
    }
    __syncthreads();
    if (compact) {
      // each nonzero position at its rank among its tile's: the popcount
      // of the tile's bits before it
      for (int i = threadIdx.x; i < outs * nw; i += blockDim.x) {
        const int oo = i / nw, wd = i - oo * nw;
        const uint32_t* bits = occ + oo * nw;
        uint32_t left = bits[wd];
        if (left == 0) continue;
        int before = 0;  // a tile of 32 or more: its words before this one
        for (int q = ((wd << 5) / tile * tile) >> 5; q < wd; ++q)
          before += __popc(bits[q]);
        uint16_t* lr = list + oo * tiles * L;
        while (left) {
          const int b = __ffs(left) - 1;
          left &= left - 1;
          const int p = (wd << 5) + b, t = p / tile;
          const int s = max(t * tile - (wd << 5), 0);  // the tile's first bit
          const int rank = before + __popc(bits[wd] & ((1u << b) - 1) &
                                           ~((1u << s) - 1));
          lr[t * L + rank] = static_cast<uint16_t>(p + 1);
        }
      }
      __syncthreads();
    }
    const bool wide = wide_window == wi;
    const int s0 = w0 + piece * (w1 - w0) / split;
    const int s1 = w0 + (piece + 1) * (w1 - w0) / split;
    const int8_t* wrow = ws + o * window;
    const uint32_t* brow = occ + o * nw;
    Clamp f[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      f[i] = pqs::clamp_identity(qmin, qmax);
    for (int st = live ? s0 : s1; st < s1; ++st) {
      // the lane's keys: window positions (-1: a zero key). Compacted: key
      // r of the segment's tile at r LT + l of its list with a round (the
      // layout is free; consecutive lanes, consecutive words), else at l E
      // + r (stream order); dense: E consecutive positions
      int pk[E];
      if (compact) {
        const uint16_t* lt = list + (o * tiles + (st - w0) * TW + seg) * L;
#pragma unroll
        for (int r = 0; r < E; ++r)
          pk[r] = static_cast<int>(lt[any_order ? r * LT + l : l * E + r]) -
                  1;
      } else {
#pragma unroll
        for (int r = 0; r < E; ++r) pk[r] = (st - w0) * P + lane * E + r;
      }
      if (!wide) {
        uint32_t xw[E];
        int wv[E];
        if (compact) {
#pragma unroll
          for (int r = 0; r < E; ++r) {
            xw[r] = pk[r] >= 0 ? xs[(pk[r] << lrg) + gr] : 0u;
            wv[r] = pk[r] >= 0 ? wrow[pk[r]] : 0;
          }
        } else {
          load_weights<E>(wv, wrow + pk[0]);
          if (rg == 1) {
            load_words<E>(xw, xs + pk[0]);
          } else {
#pragma unroll
            for (int r = 0; r < E; ++r) xw[r] = xs[(pk[r] << lrg) + gr];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * h >= rows) continue;  // uniform across the block
          uint32_t v[E];
#pragma unroll
          for (int r = 0; r < E; ++r)
            v[r] = pqs::pack2(x_row(xw[r], 2 * h) * wv[r],
                              x_row(xw[r], 2 * h + 1) * wv[r]);
          if (sorted)
            for (int rd = 0; rd < rounds; ++rd)
              pass2::pairwise_round_folded<E, LT>(v, l);
          Clamp lo = pqs::clamp_identity(qmin, qmax), hi = lo;
#pragma unroll
          for (int r = 0; r < E; ++r) {
            lo = pass2::then_step(lo, pqs::lo16(v[r]), qmin, qmax);
            hi = pass2::then_step(hi, pqs::hi16(v[r]), qmin, qmax);
          }
          f[2 * h] = pass2::then(f[2 * h], pass2::lanes_then(lo, lane));
          f[2 * h + 1] =
              pass2::then(f[2 * h + 1], pass2::lanes_then(hi, lane));
        }
      } else {
        // the int32 route: each key's weight summed from its slots, each
        // row's int32 products sorted on their own; one sort in the code
        // for the 4 rows (a fault path: size, not speed), f[i] picked by
        // unrolled compares to stay in registers
        int wv[E];
#pragma unroll
        for (int r = 0; r < E; ++r)
          wv[r] = pk[r] >= 0 && k0 + pk[r] < K
                      ? slot_sum(vrow, irow, brow, n_keep, m_group, k0, pk[r])
                      : 0;
#pragma unroll 1
        for (int i = 0; i < rows; ++i) {  // uniform across the block
          int v[E];
#pragma unroll
          for (int r = 0; r < E; ++r)
            v[r] = wv[r] ? x_row(xs[(pk[r] << lrg) + gr], i) * wv[r] : 0;
          if (sorted)
            for (int rd = 0; rd < rounds; ++rd)
              pqs::pairwise_round<E, LT>(v, l);
          Clamp c = pqs::clamp_identity(qmin, qmax);
#pragma unroll
          for (int r = 0; r < E; ++r)
            c = pqs::clamp_then(c, pqs::clamp_step(v[r], qmin, qmax));
          c = pqs::warp_compose(c, lane);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            if (r == i) f[r] = pqs::clamp_then(f[r], c);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) part[warp][i] = f[i];
    }
    __syncthreads();
    // run u = (output, row group): its warps' pieces in order
    if (threadIdx.x < outs * rg * kRowsPerWarp) {
      const int u = threadIdx.x >> 2, i = threadIdx.x & 3;
      Clamp c = run[u][i];
      for (int p = 0; p < split; ++p)
        c = pqs::clamp_then(c, part[u * split + p][i]);
      run[u][i] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x < outs * rg * kRowsPerWarp) {
    const int u = threadIdx.x >> 2, i = threadIdx.x & 3;
    const int nn = blockIdx.x * outs + (u >> lrg);
    const int m = mb + kRowsPerWarp * (u & (rg - 1)) + i;
    if (nn < N && m < M)
      out[static_cast<int64_t>(m) * N + nn] = pqs::clamp_apply(run[u][i], 0);
  }
}

struct ExpandLaunch {
  Args a;
  int tile;      // dense positions of a sort tile
  bool compact;  // a tile sorts its nonzero positions, E LT of them

  template <int E, int LT>
  void operator()() const {
    // split an output's steps over warps until the launch fills the card
    const int P = 32 / LT * tile;
    const int steps = (a.K + P - 1) / P;
    const int64_t warps = static_cast<int64_t>(a.N) *
                          ((a.M + kRowsPerWarp - 1) / kRowsPerWarp);
    int split = 1;
    while (split < kExpandWarps && split < steps &&
           warps * split < kFillWarps)
      split *= 2;
    // where the launch has the warps without a split, up to 4 groups of 4
    // rows a block share each output's expanded row (half the outputs a
    // block for each doubling)
    int lrg = 0;
    while (split == 1 && lrg < 2 && (kRowsPerWarp << lrg) < a.M) ++lrg;
    const int outs = kExpandWarps / (split << lrg);
    // a window as long as kExpandBytes hold: x's words a position, each
    // output's weight byte, occupancy bit and (compact) list entries
    const double per = (4 << lrg) +
                       outs * (1.125 + (compact ? 2.0 * E * LT / tile : 0.0));
    const int fit = static_cast<int>(kExpandBytes / per) / P;
    const int window = P * std::max(1, std::min(steps, fit));
    const size_t smem =
        (4 << lrg) * static_cast<size_t>(window) + 4 +  // + zeroing's last
        static_cast<size_t>(outs) *
            (window + window / 8 +
             (compact ? 2 * static_cast<size_t>(window / tile) * E * LT : 0));
    if (smem > 46 * 1024)  // 48 KB with the static Clamps
      cudaFuncSetAttribute(nm_expand_kernel<E, LT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    const dim3 grid((a.N + outs - 1) / outs,
                    (a.M + (kRowsPerWarp << lrg) - 1) / (kRowsPerWarp << lrg));
    nm_expand_kernel<E, LT><<<grid, 32 * kExpandWarps, smem, a.s>>>(
        a.x, a.vals, a.idx, a.out, a.M, a.N, a.K, a.G, a.n_keep, a.m_group,
        a.policy, a.acc_bits, a.rounds, tile, compact, split, lrg, window);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. x (M, K) int8, values and
// indices (N, G, n_keep) int8 / int32 and out (M, N) int32 are contiguous
// device buffers. Returns cudaGetLastError() after its launch.
extern "C" int pqs_nm_seq_policy_matmul(
    const void* x, const void* vals, const void* idx, void* out, int M,
    int N, int K, int G, int n_keep, int m_group, int policy, int acc_bits,
    int rounds, int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int bad = nmseq::check(M, N, K, G, n_keep, m_group, policy,
                               acc_bits, k_tile);
  if (bad) return bad;
  const Args a = nmseq::args(x, vals, idx, out, M, N, K, G, n_keep, m_group,
                             policy, acc_bits, rounds, stream);
  if (policy == 0)
    return nmload::launch_nm(a.x, a.vals, a.idx, a.out, M, N, K, G, n_keep,
                             m_group, a.s, mma8::WholeK{});
  if (policy == 2)
    return nmload::launch_nm(a.x, a.vals, a.idx, a.out, M, N, K, G, n_keep,
                             m_group, a.s, mma8::WrapK{acc_bits});
  // a tile of whole groups has at most lc = (tile / m) n_keep nonzero
  // positions, its kept slots: a tile of fewer keys where that is fewer
  const int tile = policy == 3 ? k_tile : 256;
  const int lc = tile % m_group == 0 ? (tile / m_group) * n_keep : tile;
  const int keys = pqs::next_pow2(lc);
  const bool compact = keys < tile;
  return pqs::dispatch_tile(compact ? keys : tile,
                            ExpandLaunch{a, tile, compact});
}
