// pass2.cuh: the block body of pass 2 of the two-pass `sorted_tiled`, shared
// by the dense kernel (sorted_stream.cu, row 12) and its gather twin
// (nm_sort_matmul.cu, row 14).
//
// A block takes up to kRows rows of x against one weight row (dense, or
// compressed and decoded once into shared memory) and walks the rows' pair
// slots as warp steps: G = 32 / LT slots a step, one on each LT-lane
// segment, a step inside one row. The block's warps split the rows x steps
// list into contiguous runs (balanced to one step), so the warps' runs in
// order are each row's stream order; a warp keeps one run of saturating
// adds a row it touches (acc in shared memory) and the block composes them
// by row at the end. A slot sorts its two tiles as the halves of packed
// int16x2 keys, lane l holding the products at tile positions l E .. l E +
// E - 1, which it loads as words.
//
// The sorts and the saturating adds are integer instructions, which the
// card issues at half its instruction rate (64 lanes a clock an SM), so
// the body spends fewer of them than pqs_accum.cuh's pairwise_round2 and
// clamp_then: a level whose direction follows the lane holds an ascending
// lane's keys complemented, so no compare-exchange inside a lane selects
// (sort_desc_folded), and the saturating adds and the pair round use
// Hopper's add-then-max (__viaddmax_s32, __viaddmax_s16x2).
//
// Sorting on the nonzero products (kCompact, with at least one round):
// after a round a tile sorted descending holds its P positives at the front
// and its Q negatives at the back, and element e becomes max(s_e, 0) +
// min(s_{S-1-e}, 0), so out[i] is the i-th largest positive plus the i-th
// most negative and is zero from max(P, Q) on, for any tile length S >=
// P + Q; a later round sorts that same multiset again. So a tile of S keys
// sorts as its nnz nonzero products padded with zeros to any length L >=
// nnz, its result the dense one's first L places, the rest zeros; two tiles
// padded to one L interleave to the dense stream less some zero pairs, and
// zero pairs add nothing to a saturating register. The warp counts the
// step's nonzero products (a segment prefix by shuffles), and where the
// most of any tile is at most S / 2 it writes them compacted into its
// buffer in shared memory (a_k at half 2k, b_k at half 2k + 1) and sorts
// the smallest packed network that holds them: 64, 128, .. S / 2 keys
// (warp-uniform, one instance each in the kernel). An all-zero step adds
// nothing and is skipped. With no round the tiles stay in position order,
// whose interleave compaction would change (tests/test_torch_sorted_order
// .py pins that), so they run as loaded.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace pass2 {

using pqs::Clamp;

constexpr int kRows = 4;  // rows of x a block serves

// The lanes of a sort tile of S products: S below kLanes (one product a
// lane), else kLanes, or more where a lane would hold above 32 products.
template <int S, int kLanes>
constexpr int tile_lanes() {
  return S < kLanes ? S : S / 32 > kLanes ? S / 32 : kLanes;
}

// Calls fn.template operator()<E, LT>() for the sort tile S = E * LT of
// `s`, LT = tile_lanes<s, kLanes>, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a size no instance covers.
template <int kLanes, typename Fn>
int dispatch(int s, Fn&& fn) {
#define PASS2_CASE(S) \
  case S:             \
    fn.template operator()<S / tile_lanes<S, kLanes>(), \
                           tile_lanes<S, kLanes>()>();  \
    break;
  switch (s) {
    PASS2_CASE(1) PASS2_CASE(2) PASS2_CASE(4) PASS2_CASE(8) PASS2_CASE(16)
    PASS2_CASE(32) PASS2_CASE(64) PASS2_CASE(128) PASS2_CASE(256)
    PASS2_CASE(512) PASS2_CASE(1024)
    default: return cudaErrorInvalidValue;
  }
#undef PASS2_CASE
  return cudaGetLastError();
}

// Warps of a block over `tasks` warp steps: the fewest that keep the
// longest run at ceil(tasks / max_warps) steps.
inline int balanced_warps(int tasks, int max_warps) {
  const int per = (tasks + max_warps - 1) / max_warps;
  return per < 1 ? 1 : (tasks + per - 1) / per;
}

// Words of a warp's compaction buffer for sort tiles of S: S / 2 a slot
// (the compacted tiles hold at most S / 2 keys each), G = 32 / LT slots.
inline int buffer_words(int S, int LT) { return S >= 128 ? 16 * S / LT : 0; }

// Words of E = 4 n bytes at p (a multiple of 4 bytes from an address
// aligned to `align`, 4 to 16), by the widest loads it allows.
template <int E>
__device__ __forceinline__ void load_words(const int8_t* p,
                                           uint32_t (&w)[E / 4], int align) {
  if constexpr (E % 16 == 0) {
    if (align >= 16) {
#pragma unroll
      for (int i = 0; i < E / 16; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z,
        w[4 * i + 3] = u.w;
      }
      return;
    }
  }
  if constexpr (E % 8 == 0) {
    if (align >= 8) {
#pragma unroll
      for (int i = 0; i < E / 8; ++i) {
        const uint2 u = reinterpret_cast<const uint2*>(p)[i];
        w[2 * i] = u.x, w[2 * i + 1] = u.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < E / 4; ++i)
    w[i] = reinterpret_cast<const uint32_t*>(p)[i];
}

__device__ __forceinline__ int sbyte(uint32_t w, int s) {
  return static_cast<int8_t>(w >> (8 * s));
}

// The dense products of the block's rows of x (row r at x + r K, device
// memory) and one weight row w (shared or device memory): position i of a
// tile is x[i] w[i], zero at or past K. xa, wa: the alignment in bytes
// (1, 4, 8 or 16) of every row of x and of w.
struct DenseRows {
  const int8_t* x;
  const int8_t* w;
  int K, k_tile, xa, wa;
  template <int E>
  __device__ __forceinline__ void operator()(int r, int t, int l,
                                             int (&p)[E]) const {
    const int base = t * k_tile + l * E;
    const int8_t* xr = x + static_cast<int64_t>(r) * K;
    if constexpr (E % 4 == 0) {
      if (base + E <= K && xa >= 4 && wa >= 4) {
        uint32_t xw[E / 4], ww[E / 4];
        load_words<E>(xr + base, xw, xa);
        load_words<E>(w + base, ww, wa);
#pragma unroll
        for (int i = 0; i < E / 4; ++i)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            p[4 * i + s] = sbyte(xw[i], s) * sbyte(ww[i], s);
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int pos = base + i;
      p[i] = pos < K ? static_cast<int>(xr[pos]) * static_cast<int>(w[pos])
                     : 0;
    }
  }
};

// Products already formed in shared memory (int16, row r at s + r stride,
// tile t's tile_len products at t tile_len, zero in the power-of-two pad).
// Words where stride and tile_len are multiples of 8.
struct StagedRows {
  const int16_t* s;
  int stride, tile_len;
  template <int E>
  __device__ __forceinline__ void operator()(int r, int t, int l,
                                             int (&p)[E]) const {
    const int j0 = l * E;
    const int16_t* q = s + r * stride + t * tile_len + j0;
    if constexpr (E % 4 == 0) {
      if (j0 + E <= tile_len && ((stride | tile_len) & 7) == 0) {
        uint32_t w[E / 2];
        if constexpr (E % 8 == 0) {
#pragma unroll
          for (int i = 0; i < E / 8; ++i) {
            const uint4 u = reinterpret_cast<const uint4*>(q)[i];
            w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z,
            w[4 * i + 3] = u.w;
          }
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(q);
          w[0] = u.x, w[1] = u.y;
        }
#pragma unroll
        for (int i = 0; i < E / 2; ++i) {
          p[2 * i] = pqs::lo16(w[i]);
          p[2 * i + 1] = pqs::hi16(w[i]);
        }
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < E; ++i) p[i] = j0 + i < tile_len ? q[i] : 0;
  }
};

// A row's pairing: entry i of row r at p[r * stride + i].
struct PermRows {
  const int* p;
  int64_t stride;
  __device__ __forceinline__ int operator()(int r, int i) const {
    return p[r * stride + i];
  }
};

// pqs::sort_desc2 with the directions folded into the keys. In a level k
// >= E the direction of element l E + r depends on its lane only, so a
// lane whose block ascends holds its keys complemented (~v reverses the
// int16 order of both halves) and every stage of the level sorts
// descending: an in-lane compare-exchange is one 16x2 max and one min, no
// select. A level changes the complement with one xor a register; the
// last level (k = S) descends everywhere, so the keys end uncomplemented.
template <int E, int LT>
__device__ __forceinline__ void sort_desc_folded(uint32_t (&v)[E], int l) {
  constexpr int S = E * LT;
  uint32_t cm = 0;  // the lane's complement in the current level
#pragma unroll
  for (int k = 2; k <= S; k <<= 1) {
    if (k >= E) {
      const uint32_t nm = (l * E) & k ? 0xffffffffu : 0u;
#pragma unroll
      for (int r = 0; r < E; ++r) v[r] ^= cm ^ nm;
      cm = nm;
    }
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < E) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int p = r ^ j;
          if (p > r) {
            // below E a level's direction follows r: known here
            const bool desc = k >= E || (r & k) == 0;
            const uint32_t hi = pqs::max2(v[r], v[p]);
            const uint32_t lo = pqs::min2(v[r], v[p]);
            v[r] = desc ? hi : lo;
            v[p] = desc ? lo : hi;
          }
        }
      } else {
        const int lj = j / E;
        const bool lower = (l & lj) == 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const uint32_t other = __shfl_xor_sync(pqs::kFull, v[r], lj);
          // the lower index keeps the larger key: every block descends
          v[r] = lower ? pqs::max2(v[r], other) : pqs::min2(v[r], other);
        }
      }
    }
  }
}

// pqs::pairwise_round2 on sort_desc_folded; max(s, 0) + m (m = min(mirror,
// 0) <= 0, the sum within int16) as the one add-then-max max(s + m, m).
template <int E, int LT>
__device__ __forceinline__ void pairwise_round_folded(uint32_t (&v)[E],
                                                      int l) {
  sort_desc_folded<E, LT>(v, l);
  uint32_t out[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    // element S-1-e lives in lane LT-1-l, register E-1-r
    const uint32_t mirror = __shfl_xor_sync(pqs::kFull, v[E - 1 - r], LT - 1);
    const uint32_t m = pqs::min2(mirror, 0u);
    out[r] = __viaddmax_s16x2(v[r], m, m);
  }
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = out[r];
}

// The run f followed by the saturating add of v on [qmin, qmax]: equal to
// pqs::clamp_then(f, pqs::clamp_step(v, qmin, qmax)) where f.lo <= f.hi
// (every run's), each bound by one add-then-max and one min.
__device__ __forceinline__ Clamp then_step(Clamp f, int v, int qmin,
                                           int qmax) {
  return Clamp{f.c + v, min(__viaddmax_s32(f.lo, v, qmin), qmax),
               min(__viaddmax_s32(f.hi, v, qmin), qmax)};
}

// pqs::clamp_then (first f, then g) by add-then-max.
__device__ __forceinline__ Clamp then(Clamp f, Clamp g) {
  const int lo = __viaddmax_s32(f.lo, g.c, g.lo);
  const int hi = min(__viaddmax_s32(f.hi, g.c, g.lo), g.hi);
  return Clamp{f.c + g.c, min(lo, hi), hi};
}

// pqs::warp_compose on then: the lanes' runs in lane order, in lane 0.
__device__ __forceinline__ Clamp lanes_then(Clamp f, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Clamp g;
    g.c = __shfl_down_sync(pqs::kFull, f.c, d);
    g.lo = __shfl_down_sync(pqs::kFull, f.lo, d);
    g.hi = __shfl_down_sync(pqs::kFull, f.hi, d);
    if ((lane & (2 * d - 1)) == 0) f = then(f, g);
  }
  return f;
}

// `rounds` pair rounds of the packed keys, then the lane's run of
// saturating adds over its places (low half, then high, register by
// register).
template <int E, int LT>
__device__ __forceinline__ Clamp sorted_pairs(uint32_t (&v)[E], int l,
                                              int rounds, int qmin,
                                              int qmax) {
  for (int rd = 0; rd < rounds; ++rd) pairwise_round_folded<E, LT>(v, l);
  Clamp f = pqs::clamp_identity(qmin, qmax);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    f = then_step(f, pqs::lo16(v[r]), qmin, qmax);
    f = then_step(f, pqs::hi16(v[r]), qmin, qmax);
  }
  return f;
}

// The compacted tiles of a segment (na and nb keys in the halves of sb's
// words) sorted on the smallest network of E2 LT keys, halving from E2
// while n (the step's most) fits half of it and it stays at 64 or more.
template <int E2, int LT>
__device__ __forceinline__ Clamp compact_pairs(const uint32_t* sb, int na,
                                               int nb, int n, int l,
                                               int rounds, int qmin,
                                               int qmax) {
  if constexpr (E2 * LT > 64) {
    if (2 * n <= E2 * LT)
      return compact_pairs<E2 / 2, LT>(sb, na, nb, n, l, rounds, qmin, qmax);
  }
  uint32_t v[E2];
#pragma unroll
  for (int r = 0; r < E2; ++r) {
    const int i = r * LT + l;
    v[r] = sb[i] & ((i < na ? 0xffffu : 0u) | (i < nb ? 0xffff0000u : 0u));
  }
  return sorted_pairs<E2, LT>(v, l, rounds, qmin, qmax);
}

// One pair slot a segment: a[r], b[r] its tiles' products at the lane's E
// positions. Sets f to the lane's run of saturating adds and returns true,
// or returns false where the whole step holds no nonzero product (kCompact
// only; it adds nothing). sb: the segment's compaction buffer (S / 2
// words). Every lane of the warp calls it.
template <int E, int LT, bool kCompact>
__device__ __forceinline__ bool slot_run(const int (&a)[E], const int (&b)[E],
                                         uint32_t* sb, int l, int rounds,
                                         int qmin, int qmax, Clamp& f) {
  constexpr int S = E * LT;
  if (rounds == 0) {
    f = pqs::clamp_identity(qmin, qmax);
#pragma unroll
    for (int r = 0; r < E; ++r) {
      f = then_step(f, a[r], qmin, qmax);
      f = then_step(f, b[r], qmin, qmax);
    }
    return true;
  }
  if constexpr (kCompact && S >= 128) {
    uint32_t c = 0;
#pragma unroll
    for (int r = 0; r < E; ++r)
      c += (a[r] != 0 ? 1u : 0u) + (b[r] != 0 ? 0x10000u : 0u);
    uint32_t inc = c;  // the segment's inclusive prefix, both counts
#pragma unroll
    for (int d = 1; d < LT; d <<= 1) {
      const uint32_t t = __shfl_up_sync(pqs::kFull, inc, d, LT);
      if (l >= d) inc += t;
    }
    const uint32_t tot = __shfl_sync(pqs::kFull, inc, LT - 1, LT);
    const int na = static_cast<int>(tot & 0xffffu);
    const int nb = static_cast<int>(tot >> 16);
    int n = max(na, nb);
#pragma unroll
    for (int d = LT; d < 32; d <<= 1)
      n = max(n, __shfl_xor_sync(pqs::kFull, n, d));
    if (n == 0) return false;
    if (2 * n <= S) {
      auto* h = reinterpret_cast<int16_t*>(sb);
      int pa = static_cast<int>((inc - c) & 0xffffu);
      int pb = static_cast<int>((inc - c) >> 16);
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (a[r] != 0) h[2 * pa++] = static_cast<int16_t>(a[r]);
        if (b[r] != 0) h[2 * pb++ + 1] = static_cast<int16_t>(b[r]);
      }
      __syncwarp();
      f = compact_pairs<E / 2, LT>(sb, na, nb, n, l, rounds, qmin, qmax);
      __syncwarp();  // the buffer is read before the next step writes it
      return true;
    }
  }
  uint32_t v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = pqs::pack2(a[r], b[r]);
  f = sorted_pairs<E, LT>(v, l, rounds, qmin, qmax);
  return true;
}

// The block's rows' pair slots (the list above): load(r, t, l, p) the
// products of tile t of row r at lane position l, perm(r, i) row r's
// pairing, T tiles a row. acc: kRows runs a warp (shared memory); buf:
// buffer_words(S, LT) words a warp (kCompact). Leaves in acc[w kRows + r]
// warp w's run over row r (the identity where it has none) and ends with
// the block in step; rows_register gives a row's register.
template <int E, int LT, bool kCompact, typename Load, typename Perm>
__device__ __forceinline__ void block_rows(const Load& load,
                                           const Perm& perm, int rows, int T,
                                           Clamp* acc, uint32_t* buf,
                                           int acc_bits, int rounds) {
  constexpr int G = 32 / LT;
  constexpr int S = E * LT;
  const int lane = threadIdx.x & 31, l = lane & (LT - 1), g = lane / LT;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  const int slots = (T + 1) >> 1;
  const int steps = (slots + G - 1) / G;
  const int tasks = rows * steps;
  const int k0 = warp * tasks / nw, k1 = (warp + 1) * tasks / nw;
  if (lane == 0)
    for (int r = 0; r < kRows; ++r)
      acc[warp * kRows + r] = pqs::clamp_identity(qmin, qmax);
  uint32_t* sb = nullptr;
  if constexpr (kCompact) sb = buf + (warp * G + g) * (S / 2);
  Clamp run = pqs::clamp_identity(qmin, qmax);
  int cur = k0 / steps;
  for (int k = k0; k < k1; ++k) {
    const int r = k / steps;
    const int s = (k - r * steps) * G + g;
    if (r != cur) {
      if (lane == 0) acc[warp * kRows + cur] = run;
      run = pqs::clamp_identity(qmin, qmax);
      cur = r;
    }
    int a[E], b[E];
#pragma unroll
    for (int i = 0; i < E; ++i) a[i] = b[i] = 0;
    if (s < slots) {
      load(r, perm(r, 2 * s), l, a);
      if (2 * s + 1 < T) load(r, perm(r, 2 * s + 1), l, b);
    }
    Clamp f;
    if (slot_run<E, LT, kCompact>(a, b, sb, l, rounds, qmin, qmax, f))
      run = then(run, lanes_then(f, lane));
  }
  if (lane == 0 && k0 < k1) acc[warp * kRows + cur] = run;
  __syncthreads();
}

// Row r's register from the warps' runs block_rows left in acc.
__device__ __forceinline__ int rows_register(const Clamp* acc, int r,
                                             int nw) {
  Clamp f = acc[r];
  for (int w = 1; w < nw; ++w) f = then(f, acc[w * kRows + r]);
  return pqs::clamp_apply(f, 0);
}

// Shared memory: bytes rounded up to 16.
inline int round16(int64_t b) { return static_cast<int>((b + 15) & ~15); }

}  // namespace pass2
