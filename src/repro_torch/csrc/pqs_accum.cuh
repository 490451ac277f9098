// pqs_accum.cuh: the accumulation body shared by the port's K-streaming
// kernels (seq_policy_matmul.cu, nm_seq_policy_matmul.cu).
//
// A warp streams the products of one dot product in chunks of 32*E, E to
// a lane in stream order (lane l holds elements l*E .. l*E + E-1), and
// adds each chunk to an acc_bits-bit register under one policy:
//   0 wide             exact int32 sum
//   1 clip             stream order, saturating add after every product
//   2 wrap             stream order, two's-complement wrap at acc_bits
//                      (a floor mod, not C's truncating %)
//   3 sorted_tiled_seq each segment of S = E*LT products (LT lanes) is one
//                      sort tile: `rounds` split/sort/pair rounds, then
//                      saturating adds in the resulting order
//
// - One descending bitonic sort per round does the split: positives come
//   first in descending order, negatives last with the most negative at
//   the end, so out[i] = max(s[i], 0) + min(s[S-1-i], 0) is exactly the
//   reference's pos_sorted[i] + neg_sorted[i]. Exchanges inside a lane
//   are register swaps, between lanes __shfl_xor_sync; no shared memory.
// - The saturating adds run as a parallel ordered reduction: a run of
//   saturating adds, x -> min(max(x + c, L), H), is closed under
//   composition, so each lane composes its E steps and the warp composes
//   the lanes' functions in order with shuffles. This is the stepwise
//   clamp of the reference exactly, not cumsum-then-clip. Wrap adds are a
//   ring homomorphism, so wrap(acc + chunk sum) equals the stepwise wraps.
// - A zero product is neither positive nor negative and adds nothing
//   under any policy, so callers mask edges and padding with zeros.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pqs {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerWarp = 4;  // MR: rows of x one warp serves

// x -> min(max(x + c, lo), hi): a run of saturating adds.
struct Clamp {
  int c, lo, hi;
};

__device__ __forceinline__ Clamp clamp_step(int v, int qmin, int qmax) {
  return Clamp{v, qmin, qmax};
}

// First f, then g.
__device__ __forceinline__ Clamp clamp_then(Clamp f, Clamp g) {
  int lo = max(f.lo + g.c, g.lo);
  int hi = min(max(f.hi + g.c, g.lo), g.hi);
  return Clamp{f.c + g.c, min(lo, hi), hi};
}

__device__ __forceinline__ int clamp_apply(Clamp f, int x) {
  return min(max(x + f.c, f.lo), f.hi);
}

// Descending bitonic sort of segments of S = LT * E values. Lane l of a
// segment holds elements l*E .. l*E + E-1 in v[0..E-1].
template <int E, int LT>
__device__ __forceinline__ void sort_desc(int (&v)[E], int l) {
  constexpr int S = E * LT;
#pragma unroll
  for (int k = 2; k <= S; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < E) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int p = r ^ j;
          if (p > r) {
            // descending inside a (e & k) == 0 block, ascending otherwise
            const bool desc = ((l * E + r) & k) == 0;
            const bool swap = desc ? (v[r] < v[p]) : (v[r] > v[p]);
            if (swap) {
              const int t = v[r];
              v[r] = v[p];
              v[p] = t;
            }
          }
        }
      } else {
        const int lj = j / E;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int other = __shfl_xor_sync(kFull, v[r], lj);
          const int e = l * E + r;
          const bool desc = (e & k) == 0;
          const bool lower = (e & j) == 0;
          // the lower index keeps the larger value in a descending block
          v[r] = (desc == lower) ? max(v[r], other) : min(v[r], other);
        }
      }
    }
  }
}

// One split/sort/pair round over each segment (sorted_accum.pairwise_round).
template <int E, int LT>
__device__ __forceinline__ void pairwise_round(int (&v)[E], int l) {
  sort_desc<E, LT>(v, l);
  int out[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    // element S-1-e lives in lane LT-1-l, register E-1-r
    const int mirror = __shfl_xor_sync(kFull, v[E - 1 - r], LT - 1);
    out[r] = max(v[r], 0) + min(mirror, 0);
  }
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = out[r];
}

// Adds one chunk of 32*E products to the register `acc` under `policy`
// and returns the new register: in every lane for wide and wrap, in lane
// 0 only for clip and sorted_tiled_seq. Every lane of the warp calls it.
template <int E, int LT>
__device__ __forceinline__ int accumulate_chunk(int (&v)[E], int acc,
                                                int policy, int acc_bits,
                                                int rounds, int lane) {
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  if (policy == 0 || policy == 2) {
    int s = 0;
#pragma unroll
    for (int r = 0; r < E; ++r) s += v[r];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
    if (policy == 0) return acc + s;
    const int span = 1 << acc_bits;
    int t = (acc + s - qmin) % span;  // floor mod: fix the sign
    if (t < 0) t += span;
    return t + qmin;
  }
  if (policy == 3) {
    const int l = lane & (LT - 1);
    for (int rd = 0; rd < rounds; ++rd) pairwise_round<E, LT>(v, l);
  }
  Clamp f = clamp_step(v[0], qmin, qmax);
#pragma unroll
  for (int r = 1; r < E; ++r) f = clamp_then(f, clamp_step(v[r], qmin, qmax));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Clamp g;
    g.c = __shfl_down_sync(kFull, f.c, d);
    g.lo = __shfl_down_sync(kFull, f.lo, d);
    g.hi = __shfl_down_sync(kFull, f.hi, d);
    // lane i (a multiple of 2d) covers [i, i+d); lane i+d follows it
    if ((lane & (2 * d - 1)) == 0) f = clamp_then(f, g);
  }
  return clamp_apply(f, acc);
}

// The sort tile S = E * LT of a kernel instance: 32 lanes of E products
// for S >= 32, one product on each of S lanes (32/S tiles per chunk)
// below. Calls fn.template operator()<E, LT>() for the S given, and
// returns cudaErrorInvalidValue for a size no instance covers.
template <typename Fn>
int dispatch_tile(int s, Fn&& fn) {
  switch (s) {
    case 1: fn.template operator()<1, 1>(); break;
    case 2: fn.template operator()<1, 2>(); break;
    case 4: fn.template operator()<1, 4>(); break;
    case 8: fn.template operator()<1, 8>(); break;
    case 16: fn.template operator()<1, 16>(); break;
    case 32: fn.template operator()<1, 32>(); break;
    case 64: fn.template operator()<2, 32>(); break;
    case 128: fn.template operator()<4, 32>(); break;
    case 256: fn.template operator()<8, 32>(); break;
    case 512: fn.template operator()<16, 32>(); break;
    case 1024: fn.template operator()<32, 32>(); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace pqs
