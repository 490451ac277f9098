// pqs_accum.cuh: the accumulation bodies shared by the port's kernels:
// the K-streaming one (seq_policy_matmul.cu, nm_seq_policy_matmul.cu) and,
// at the end of this file, the global-sort ones (sort_matmul.cu,
// sorted_stream.cu, nm_sort_matmul.cu, nm_expand_sort.cu).
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
// - The packed body (sort_desc2, pairwise_round2; the sorted_tiled_seq of
//   seq_policy_matmul.cu and of nm_seq_policy_matmul.cu's gather kernel)
//   runs the same network on the keys of two streams at
//   once, one int16 half of a 32-bit register each. Products of int8
//   carriers lie in [-16256, 16384] and a pair round adds a non-negative
//   key to a non-positive one, which stays in that range, so every key of
//   every round fits in 16 bits. The network's directions depend only on
//   the element index, so both halves follow one select; compare-exchanges
//   are 16x2 max / min, cross-lane stages move both halves in one
//   shuffle, and the pairing's max(s, 0) + min(mirror, 0) is 16x2 too: half
//   the instructions of two int32 sorts. Each half is unpacked to int32 for
//   the saturating adds, whose registers reach 30 bits.

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

// x -> x on the register's range [qmin, qmax]: where a composition
// starts, and what a lane with no products contributes.
__device__ __forceinline__ Clamp clamp_identity(int qmin, int qmax) {
  return Clamp{0, qmin, qmax};
}

// The lanes' functions composed in lane order (lane 0 first), in lane 0.
__device__ __forceinline__ Clamp warp_compose(Clamp f, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Clamp g;
    g.c = __shfl_down_sync(kFull, f.c, d);
    g.lo = __shfl_down_sync(kFull, f.lo, d);
    g.hi = __shfl_down_sync(kFull, f.hi, d);
    // lane i (a multiple of 2d) covers [i, i+d); lane i+d follows it
    if ((lane & (2 * d - 1)) == 0) f = clamp_then(f, g);
  }
  return f;
}

// The warps' functions (each in its lane 0) composed in warp order, in
// thread 0. scratch holds one Clamp per warp in shared memory. Every
// thread of the block calls it.
__device__ __forceinline__ Clamp block_compose_warps(Clamp f,
                                                     Clamp* scratch) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = f;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i)
      f = clamp_then(f, scratch[i]);
  }
  return f;
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

// The sum of a warp's chunk of 32*E products, in every lane.
template <int E>
__device__ __forceinline__ int chunk_sum(const int (&v)[E]) {
  int s = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) s += v[r];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
  return s;
}

// The acc_bits register `acc` after the wrapping adds of a chunk summing
// to s (a ring homomorphism: one floor mod of the sum).
__device__ __forceinline__ int wrap_add(int acc, int s, int acc_bits) {
  const int qmin = -(1 << (acc_bits - 1));
  const int span = 1 << acc_bits;
  int t = (acc + s - qmin) % span;  // floor mod: fix the sign
  if (t < 0) t += span;
  return t + qmin;
}

// The acc_bits register `acc` after the saturating adds of a chunk of
// 32*E products in stream order, in lane 0.
template <int E>
__device__ __forceinline__ int saturate_chunk(const int (&v)[E], int acc,
                                              int acc_bits, int lane) {
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  Clamp f = clamp_step(v[0], qmin, qmax);
#pragma unroll
  for (int r = 1; r < E; ++r) f = clamp_then(f, clamp_step(v[r], qmin, qmax));
  return clamp_apply(warp_compose(f, lane), acc);
}

// Adds one chunk of 32*E products to the register `acc` under `policy`
// and returns the new register: in every lane for wide and wrap, in lane
// 0 only for clip and sorted_tiled_seq. Every lane of the warp calls it.
template <int E, int LT>
__device__ __forceinline__ int accumulate_chunk(int (&v)[E], int acc,
                                                int policy, int acc_bits,
                                                int rounds, int lane) {
  if (policy == 0 || policy == 2) {
    const int s = chunk_sum<E>(v);
    return policy == 0 ? acc + s : wrap_add(acc, s, acc_bits);
  }
  if (policy == 3) {
    const int l = lane & (LT - 1);
    for (int rd = 0; rd < rounds; ++rd) pairwise_round<E, LT>(v, l);
  }
  return saturate_chunk<E>(v, acc, acc_bits, lane);
}

// ---------------------------------------------------------------------
// The packed body: two streams' int16 keys in one 32-bit register, the
// low half one stream's, the high half the other's.

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return __byte_perm(static_cast<uint32_t>(lo), static_cast<uint32_t>(hi),
                     0x5410);
}

__device__ __forceinline__ int lo16(uint32_t v) {
  return static_cast<int16_t>(v & 0xffffu);
}

__device__ __forceinline__ int hi16(uint32_t v) {
  return static_cast<int>(v) >> 16;
}

// Signed 16x2 max, min and (wrapping) add.
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  return __vmaxs2(a, b);
}

__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  return __vmins2(a, b);
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return __vadd2(a, b);
}

// sort_desc on packed keys: both halves of each register through one
// network.
template <int E, int LT>
__device__ __forceinline__ void sort_desc2(uint32_t (&v)[E], int l) {
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
            const uint32_t hi = max2(v[r], v[p]), lo = min2(v[r], v[p]);
            v[r] = desc ? hi : lo;
            v[p] = desc ? lo : hi;
          }
        }
      } else {
        const int lj = j / E;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const uint32_t other = __shfl_xor_sync(kFull, v[r], lj);
          const int e = l * E + r;
          const bool desc = (e & k) == 0;
          const bool lower = (e & j) == 0;
          // the lower index keeps the larger value in a descending block
          v[r] = (desc == lower) ? max2(v[r], other) : min2(v[r], other);
        }
      }
    }
  }
}

// pairwise_round on packed keys.
template <int E, int LT>
__device__ __forceinline__ void pairwise_round2(uint32_t (&v)[E], int l) {
  sort_desc2<E, LT>(v, l);
  uint32_t out[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    // element S-1-e lives in lane LT-1-l, register E-1-r
    const uint32_t mirror = __shfl_xor_sync(kFull, v[E - 1 - r], LT - 1);
    out[r] = add2(max2(v[r], 0u), min2(mirror, 0u));
  }
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = out[r];
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

// ---------------------------------------------------------------------
// The global-sort policies (sort_matmul.cu, sorted_stream.cu,
// nm_sort_matmul.cu, nm_expand_sort.cu). One block computes one output
// element; every thread of the block calls these. The bodies read one
// output's products through a product loader, so the dense kernels and
// their N:M gather and expand twins run the same sorts and adds:
//   at(i)       product i of the output's stream, zero past its end;
//   tile(t, j)  product j of k_tile tile t, zero in the power-of-two pad
//               of the sort tile S (none for dense rows, where S is k_tile);
//   tile_len    products of one k_tile tile (S is tile_len padded to a
//               power of two).
//
// `sorted` over the whole axis (sorted_dot): what bounds it is the
// bitonic network, L/2 * log2(L) (log2(L) + 1) / 2 compare-exchanges an
// output (67,584 at L = 2048, 860,160 at 16384), not memory. The body
// keeps them in registers:
// - The L keys of one output are int16 (products of int8 carriers lie in
//   [-16256, 16384] and a pair round stays in it), packed two to a
//   register: position i in the low half, i + L/2 in the high half. A
//   block of W warps holds the P = L/2 packed positions, E a lane, lane t
//   of the block positions t*E .. t*E + E-1 of each half. The halves of
//   one output, not two outputs, share a register, so one layout holds
//   every kp up to 65536 without a cut (two outputs' 65536 keys would
//   fill an SM's 65,536 registers) and no pairing of rows is needed.
// - The network sorts both halves descending as two streams through one
//   16x2 max / min per compare-exchange pair (the packed body above),
//   then merges them: position i of the low half against position
//   P-1-i of the high half (the halves' flip), then the half-cleaners of
//   length P. Its count is the one network over L keys.
// - A stage whose distance j is below E is a register compare-exchange,
//   below 32 E a shuffle, from 32 E on a shared-memory exchange between
//   warps (two barriers). Directions follow the global index: in a level
//   whose blocks are wider than a lane, a lane of an ascending block
//   complements its keys (~v reverses the int16 order) and every stage
//   runs descending.
// - The pair round's mirror L-1-i of position i sits in the other half at
//   P-1-i: register E-1-r of lane 31-l of warp W-1-w, a shuffle inside one
//   warp, an exchange across warps.
// - The saturating adds: each lane composes its E low keys and E high keys
//   in order (Clamp), the warps compose the lanes' functions, and thread 0
//   the warps' in stream order, low halves before high.
// - Shape (dispatch_sorted): one warp of E = L/64 up to L = 2048 (no
//   barrier) and, at 65536, 16 warps of E = 64 (512 threads, at most 128
//   registers each); the cross-warp exchange takes 4 bytes a packed
//   position, 2 bytes a key: 128 KB at 65536. From 4096 to 32768 the W =
//   L/2048 warps run the radix body below instead (radix_regime), which
//   at kp 16384 took w_out to 0.32 ms from this network's 0.72. Below 64
//   keys the body pads with zero keys, which a round maps to zeros past
//   the sorted prefix and which add nothing.
// - A sort's result does not depend on where each key starts, so with at
//   least one round the lanes read the stream coalesced (position r * 32
//   W + t); with no round each lane reads its own E positions in order.
// At decode (M = 4) the dense body takes 0.84 ms over qwen2-1.5b's six K
// = 1536 sites (kp 2048) and 0.72 at w_out (kp 16384), against 6.16 and
// 5.09 for the shared-memory network with a barrier a stage that it
// replaced (chip_smoke.py phase 5 with --baseline-csrc, NVIDIA H100 80GB
// HBM3, 700.00 W). One lane-instruction a compare-exchange at the card's
// instruction rate (132 SMs x 4 x 32 lanes at 1.98 GHz) would take 0.17
// and 0.16 ms: the shuffles, the complements, the pair round and the adds
// (7 instructions a key) come on top.

// The dense row pair x[m, :], w[n, :]: product i is x[i] * w[i], zero at
// or past K (so kp > K needs no padded operand).
struct DenseProducts {
  const int8_t* x;
  const int8_t* w;
  int K;
  int tile_len;  // k_tile
  __device__ __forceinline__ int at(int i) const {
    return i < K ? static_cast<int>(__ldg(x + i)) *
                       static_cast<int>(__ldg(w + i))
                 : 0;
  }
  __device__ __forceinline__ int tile(int t, int j) const {
    return at(t * tile_len + j);
  }
};

// q / n for 0 <= q < qmax as __umulhi(q, magic) (a round-up reciprocal,
// exact while qmax * n <= 2^32); 0 where that does not hold (n = 1, or a
// stream too long), and the division stands.
__host__ __device__ inline unsigned div_magic(int n, int64_t qmax) {
  return n >= 2 && qmax * n <= (int64_t{1} << 32) ? 0xffffffffu / n + 1 : 0u;
}

// The dense position of a gathered slot of group g with in-group index j
// (g * m_group + j, wrapping in 32 bits as the index may be any int32),
// under the port's rule for a position outside x's row of `width`
// (kernels/nm_spmm.py gather_nm_products): one in [-width, 0) reads
// position + width; the caller reads x only below K (x is zero from K to
// width), so one below -width or at or past width is a zero product, and
// nothing outside x is read.
__device__ __forceinline__ int gathered_pos(int g, int m_group, int j,
                                            int width) {
  const int pos = static_cast<int>(static_cast<unsigned>(g * m_group) +
                                   static_cast<unsigned>(j));
  return pos < 0 ? pos + width : pos;
}

// The kept products of x[m, :] and compressed row n (N:M slabs,
// pruning.nm_compress): slot q of the row's kept = G * n_keep is
// x[gathered_pos(q / n_keep, m_group, idx[q], width)] * val[q]. A slot past
// kept (a group past G) or at a position outside [0, K) is a zero
// product, so neither x nor the slabs are padded on the host. A k_tile
// tile is its k_tile / m_group groups, tile_len = (k_tile / m_group) *
// n_keep kept slots.
struct GatheredProducts {
  const int8_t* x;
  const int8_t* val;
  const int32_t* idx;
  int K, width, kept, n_keep, m_group;
  int tile_len;
  unsigned magic;  // div_magic(n_keep, kept)
  __device__ __forceinline__ int at(int q) const {
    if (q >= kept) return 0;
    const int g = magic ? static_cast<int>(__umulhi(
                              static_cast<unsigned>(q), magic))
                        : q / n_keep;
    const int pos = gathered_pos(g, m_group, __ldg(idx + q), width);
    return static_cast<unsigned>(pos) < static_cast<unsigned>(K)
               ? static_cast<int>(__ldg(x + pos)) *
                     static_cast<int>(__ldg(val + q))
               : 0;
  }
  __device__ __forceinline__ int tile(int t, int j) const {
    return j < tile_len ? at(t * tile_len + j) : 0;
  }
};

// The dense row pair x[m, :], w[0 .. K) where w is a compressed row
// expanded into shared memory (expand_slots): product i is x[i] * w[i],
// zero at or past K, as DenseProducts.
struct ExpandedProducts {
  const int8_t* x;
  const int16_t* w;
  int K;
  int tile_len;  // k_tile
  __device__ __forceinline__ int at(int i) const {
    return i < K ? static_cast<int>(__ldg(x + i)) * static_cast<int>(w[i])
                 : 0;
  }
  __device__ __forceinline__ int tile(int t, int j) const {
    return at(t * tile_len + j);
  }
};

// Keys already in shared memory (an expanded N:M row's products).
struct SharedKeys {
  const int16_t* s;
  __device__ __forceinline__ int at(int i) const { return s[i]; }
};

// *a += v in 16 bits, atomically (a compare-and-swap loop: shared memory
// has no 16-bit atomicAdd); returns the value it added to. On canonical
// slabs no two nonzero slots name one position, so the first swap
// succeeds.
__device__ __forceinline__ int atomic_add_i16(int16_t* a, int v) {
  auto* p = reinterpret_cast<unsigned short*>(a);
  unsigned short seen = *p, want;
  do {
    want = seen;
    seen = atomicCAS(p, want, static_cast<unsigned short>(want + v));
  } while (seen != want);
  return static_cast<int16_t>(want);
}

// nm_decompress's scatter-add of a compressed row into w: w[0 .. len) is
// zeroed, then each slot q in [q0, q1) (group q / n_keep, value val[q],
// in-group position idx[q]) adds x[pos] * value (with x null: the value)
// at pos - base, pos its dense position, where pos lies in [base, base +
// len) and below K. A value-0 slot (a padded one: value 0, index 0) adds
// nothing, so it never disturbs a kept value at position 0 of its group;
// nor does a slot whose index lies outside [0, m_group), which the
// reference's one-hot expansion drops. The team of `size` threads, this
// one of rank `r`, runs it together (a slot reads its index only for a
// nonzero value); kWarp says whether the team is one warp (else the whole
// block), which is synchronised before and after the adds. Returns, in
// every thread of the team, whether an add landed on a nonzero entry
// (never on canonical slabs): with x, then, an entry may hold a sum past
// int16.
template <bool kWarp>
__device__ __forceinline__ bool expand_slots(int16_t* w, int len, int base,
                                             const int8_t* x,
                                             const int8_t* val,
                                             const int32_t* idx, int q0,
                                             int q1, int K, int n_keep,
                                             int m_group, int r, int size) {
  if ((len & 7) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    for (int i = r; i < (len >> 3); i += size)
      reinterpret_cast<uint4*>(w)[i] = make_uint4(0, 0, 0, 0);
  } else {
    for (int i = r; i < len; i += size) w[i] = 0;
  }
  if (kWarp) __syncwarp(); else __syncthreads();
  int hit = 0;
  for (int q = q0 + r; q < q1; q += size) {
    int v = __ldg(val + q), pos = K;
    if (v != 0) {
      const int j = __ldg(idx + q);
      pos = (q / n_keep) * m_group + j;
      v = static_cast<unsigned>(j) < static_cast<unsigned>(m_group) ? v : 0;
    }
    if (v != 0 && pos < K &&
        static_cast<unsigned>(pos - base) < static_cast<unsigned>(len))
      hit |= atomic_add_i16(w + (pos - base),
                            x ? static_cast<int>(__ldg(x + pos)) * v : v);
  }
  if (kWarp) return __any_sync(kFull, hit != 0);
  // a flag in shared memory between plain barriers: __syncthreads_or took
  // the one-warp `sorted` kernel from 64 registers to 75 and cost it 6-12%
  // on the card; every thread has read the last call's flag before it is
  // cleared here, past the zeroing barrier
  __shared__ int any_hit;
  if (threadIdx.x == 0) any_hit = 0;
  __syncthreads();
  if (hit) any_hit = 1;
  __syncthreads();
  return any_hit != 0;
}

// Row n's expanded weights w[0 .. K) (expand_slots over the row's slots),
// by the whole block.
__device__ __forceinline__ void expand_row(int16_t* w, const int8_t* val,
                                           const int32_t* idx, int64_t n,
                                           int K, int G, int n_keep,
                                           int m_group) {
  const int64_t kept = static_cast<int64_t>(G) * n_keep;
  expand_slots<false>(w, K, 0, nullptr, val + n * kept, idx + n * kept, 0,
                      G * n_keep, K, n_keep, m_group, threadIdx.x,
                      blockDim.x);
}

// Whether every weight of an expanded row w[0 .. K) is an int8 value (on
// canonical slabs always; a position that several slots name holds their
// sum), so that its products are exact int16 keys. By the whole block.
__device__ __forceinline__ bool int8_weights(const int16_t* w, int K) {
  int wide = 0;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    wide |= w[i] != static_cast<int8_t>(w[i]);
  return !__syncthreads_or(wide);
}

// The block's dynamic shared memory, as an array of T.
template <typename T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char pqs_smem[];
  return reinterpret_cast<T*>(pqs_smem);
}

// Both int16 halves swapped.
__device__ __forceinline__ uint32_t swap_halves(uint32_t v) {
  return __byte_perm(v, 0, 0x1032);
}

// A descending compare-exchange of packed keys: a (the lower position)
// keeps the larger key of each half.
__device__ __forceinline__ void cx_desc(uint32_t& a, uint32_t& b) {
  const uint32_t hi = max2(a, b);
  b = min2(a, b);
  a = hi;
}

// The stages j = k/2 .. 1 of a descending bitonic merge of blocks of k
// positions (k >= E): across warps through buf while j >= 32 E, across
// lanes by shuffles while j >= E, then inside the lane.
template <int E, int W>
__device__ __forceinline__ void merge_desc(uint32_t (&v)[E], int k,
                                           uint32_t* buf) {
  constexpr int T = 32 * W;
  const int t = threadIdx.x;
  int tj = (k >> 1) / E;  // the partner's distance in threads
  if constexpr (W > 1) {
#pragma unroll 1
    for (; tj >= 32; tj >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) buf[r * T + t] = v[r];
      __syncthreads();
      const bool lower = (t & tj) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const uint32_t o = buf[r * T + (t ^ tj)];
        v[r] = lower ? max2(v[r], o) : min2(v[r], o);
      }
      __syncthreads();
    }
  }
#pragma unroll 1
  for (; tj >= 1; tj >>= 1) {
    const bool lower = (t & tj) == 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const uint32_t o = __shfl_xor_sync(kFull, v[r], tj);
      v[r] = lower ? max2(v[r], o) : min2(v[r], o);
    }
  }
#pragma unroll
  for (int j = E >> 1; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < E; ++r)
      if ((r & j) == 0) cx_desc(v[r], v[r | j]);
  }
}

// v[r] = op(v[r], m) with m the packed key at the mirror position P-1-e
// (register E-1-r of thread 32 W - 1 - t): a shuffle inside one warp, an
// exchange through buf across warps.
template <int E, int W, typename Op>
__device__ __forceinline__ void with_mirror(uint32_t (&v)[E], uint32_t* buf,
                                            Op op) {
  if constexpr (W == 1) {
#pragma unroll
    for (int r = 0; r < (E + 1) / 2; ++r) {
      const int q = E - 1 - r;
      const uint32_t a = __shfl_xor_sync(kFull, v[q], 31);
      if (q == r) {
        v[r] = op(v[r], a);
      } else {
        const uint32_t b = __shfl_xor_sync(kFull, v[r], 31);
        v[r] = op(v[r], a);
        v[q] = op(v[q], b);
      }
    }
  } else {
    constexpr int T = 32 * W;
    const int t = threadIdx.x;
#pragma unroll
    for (int r = 0; r < E; ++r) buf[r * T + t] = v[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < E; ++r)
      v[r] = op(v[r], buf[(E - 1 - r) * T + (T - 1 - t)]);
    __syncthreads();
  }
}

// The halves' flip: low position e keeps max(low e, high P-1-e), high
// position P-1-e the min (both halves sorted descending before).
struct FlipHalves {
  __device__ __forceinline__ uint32_t operator()(uint32_t v,
                                                 uint32_t m) const {
    const uint32_t ms = swap_halves(m);
    return __byte_perm(max2(v, ms), min2(v, ms), 0x7610);
  }
};

// A pair round on the sorted keys: out[i] = max(s[i], 0) + min(s[L-1-i], 0),
// s[L-1-i] being the other half of the mirror.
struct PairHalves {
  __device__ __forceinline__ uint32_t operator()(uint32_t v,
                                                 uint32_t m) const {
    return add2(max2(v, 0u), min2(swap_halves(m), 0u));
  }
};

// Descending bitonic sort of the block's L = 64 W E keys (see above).
template <int E, int W>
__device__ __forceinline__ void sort_desc_halves(uint32_t (&v)[E],
                                                 uint32_t* buf) {
  constexpr int P = 32 * W * E;
  // levels 2 .. E/2: inside the lane, the direction by register
#pragma unroll
  for (int k = 2; k < E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if ((r & j) == 0) {
          if ((r & k) == 0) cx_desc(v[r], v[r | j]);
          else cx_desc(v[r | j], v[r]);
        }
      }
    }
  }
  // levels E .. P: one direction a lane; ascending blocks complemented
  uint32_t flip = 0;
#pragma unroll 1
  for (int k = E > 2 ? E : 2; k <= P; k <<= 1) {
    const uint32_t want =
        k < P && (threadIdx.x & (k / E)) ? 0xffffffffu : 0u;
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] ^= flip ^ want;
    flip = want;
    merge_desc<E, W>(v, k, buf);
  }
  with_mirror<E, W>(v, buf, FlipHalves{});
  merge_desc<E, W>(v, P, buf);
}

// The `sorted` policy over the block's keys v (see above): `rounds`
// split/sort/pair rounds, then the saturating adds in order. Returns the
// register in thread 0.
template <int E, int W>
__device__ __forceinline__ int sorted_halves(uint32_t (&v)[E], uint32_t* buf,
                                             Clamp* scratch, int acc_bits,
                                             int rounds) {
  for (int rd = 0; rd < rounds; ++rd) {
    sort_desc_halves<E, W>(v, buf);
    with_mirror<E, W>(v, buf, PairHalves{});
  }
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  Clamp lo = clamp_identity(qmin, qmax), hi = lo;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    lo = clamp_then(lo, clamp_step(lo16(v[r]), qmin, qmax));
    hi = clamp_then(hi, clamp_step(hi16(v[r]), qmin, qmax));
  }
  const int lane = threadIdx.x & 31;
  lo = warp_compose(lo, lane);
  hi = warp_compose(hi, lane);
  if constexpr (W == 1) {
    return clamp_apply(clamp_then(lo, hi), 0);
  } else {
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
      scratch[warp] = lo;
      scratch[W + warp] = hi;
    }
    __syncthreads();
    Clamp f = scratch[0];
    if (threadIdx.x == 0)
      for (int i = 1; i < 2 * W; ++i) f = clamp_then(f, scratch[i]);
    return clamp_apply(f, 0);
  }
}

// The `sorted` policy for one output: products p.at(0 .. L), L = 64 W E
// (past the stream's end they are zero keys), in registers; buf is the
// cross-warp exchange (sorted_exchange_bytes; W = 1 uses none), scratch
// 2 W Clamps. Dense rows sort L = kp keys; kept products L =
// next_pow2(G * n_keep), whose ordered stream is the dense one's prefix
// (the rest of the dense stream is zeros, which add nothing). Returns the
// register in thread 0.
template <int E, int W, typename P>
__device__ __forceinline__ int sorted_dot(const P& p, uint32_t* buf,
                                          Clamp* scratch, int acc_bits,
                                          int rounds) {
  constexpr int T = 32 * W;
  constexpr int half = T * E;
  // one warp may be one of several outputs of its block
  const int t = W == 1 ? threadIdx.x & 31 : threadIdx.x;
  const int first = rounds > 0 ? t : t * E;
  const int step = rounds > 0 ? T : 1;
  uint32_t v[E];
#pragma unroll
  for (int r = 0; r < E; ++r)
    v[r] = pack2(p.at(first + r * step), p.at(half + first + r * step));
  if constexpr (W > 1) __syncthreads();  // buf may alias the keys read
  return sorted_halves<E, W>(v, buf, scratch, acc_bits, rounds);
}

// ---------------------------------------------------------------------
// `sorted` by a block-wide radix sort of the real keys (radix_sorted_dot):
// the body of W > 1 warps from kp 4096 to 32768 (radix_regime) and, at
// every kp, the expand twin's route for a row whose weights leave int8.
//
// - What it rests on: with at least one round, the nonzero stream of the
//   order does not depend on how many zero keys pad the row. A round maps
//   p positive and q negative keys among any number of zeros to out[i] =
//   P[i] + Q[i] (the i-th largest positive and the i-th most negative,
//   zero past p and q) for i < max(p, q), then zeros; zeros add nothing
//   under saturation (tests/test_torch_sorted_order.py pins it against the
//   JAX package). So the body sorts only the real keys (K of a dense row,
//   G n_keep of a gathered one, not kp), drops the zeros in the first
//   pass of each round, and pairs the m sorted nonzero keys as out[i] =
//   max(s[i], 0) + min(s[m-1-i], 0); no power-of-two padding is carried.
// - The sort: LSD, 8-bit digits of the biased key u = kBias - k,
//   ascending, which is k descending: 2 passes for int16 keys (products of
//   int8 carriers lie in [-16256, 16384], a pair round stays in it), 3 for
//   the int32 keys of an expanded row with weights past int8 (|x w| <=
//   2^22). Warp w counts the digits of its contiguous segment of the
//   stream into its own counts (shared atomics), one block scan turns the
//   digit-major counts into each (digit, warp)'s first place, and each
//   warp scatters its segment. The first pass may place a digit's keys in
//   any order (atomics): keys that differ only above it are ordered by the
//   later passes, which keep the stream's order within a digit (the live
//   lanes of a warp that share a digit, radix_peers, take consecutive
//   places after those of the warp's earlier steps).
// - Two key buffers of the n keys: shared memory for int16 (4 n bytes
//   beside the control block), a slot of a device-memory pool for int32
//   (its control block too, so that the int16 bodies' shared memory is
//   what it was without the route).
// - The adds: each lane composes the saturating adds of a contiguous run
//   of the final stream (the last pair round computed as it reads), the
//   warps compose the lanes' functions and thread 0 the warps', in order.
//   With no round, the natural order from the loader.

// Whether the `sorted` body of W warps of E packed keys a lane is the
// radix sort (kp 4096 to 32768); one warp (kp <= 2048) keeps the
// register network, and so does kp 65536, whose two key buffers (256 KB)
// would not fit a block.
__host__ __device__ constexpr bool radix_regime(int E, int W) {
  return W > 1 && E == 32;
}

constexpr int kRadixDigits = 256;

// Ints of a radix body's control block: 256 W counts (digit-major: entry d
// W + w is warp w's count of digit d) and 32 warp totals of the scans.
__host__ __device__ constexpr int radix_ctl_ints(int W) {
  return kRadixDigits * W + 32;
}

// Bytes of a shared-memory buffer of n keys, rounded to 16.
__host__ __device__ constexpr size_t radix_buffer_bytes(int n, int key_bytes) {
  return (static_cast<size_t>(n) * key_bytes + 15) & ~static_cast<size_t>(15);
}

// The shared memory of radix_sorted_shared: the control block and two
// buffers of n int16 keys.
inline size_t radix_smem_bytes(int W, int n) {
  return sizeof(int) * radix_ctl_ints(W) + 2 * radix_buffer_bytes(n, 2);
}

// Warp w's segment of a stream of m keys is [w S, min(w S + S, m)).
__device__ __forceinline__ int radix_span(int m, int W) {
  return ((m + W - 1) / W + 31) & ~31;
}

// Zeroes counts[0 .. 4 V blockDim.x), 4 V a thread.
template <int V>
__device__ __forceinline__ void radix_zero(int* counts) {
  int4* h = reinterpret_cast<int4*>(counts) + V * threadIdx.x;
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = make_int4(0, 0, 0, 0);
}

// The exclusive scan of counts[0 .. 4 V blockDim.x) in place (each count
// becomes the place of its first key), 4 V a thread, W warps; totals
// holds W ints. Returns the total. Ends with the block in step.
template <int V, int W>
__device__ __forceinline__ int radix_scan(int* counts, int* totals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4* h = reinterpret_cast<int4*>(counts) + V * threadIdx.x;
  int4 c[V];
  int own = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    c[i] = h[i];
    own += c[i].x + c[i].y + c[i].z + c[i].w;
  }
  int inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) totals[warp] = inc;
  __syncthreads();
  int run = inc - own, total = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int t = totals[i];
    run += i < warp ? t : 0;
    total += t;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    int4 v = c[i];
    v.x = run;
    v.y = (run += c[i].x);
    v.z = (run += c[i].y);
    v.w = (run += c[i].z);
    run += c[i].w;
    h[i] = v;
  }
  __syncthreads();
  return total;
}

// The register after the saturating adds of key(0 .. m) in order, in
// thread 0: a lane a contiguous run, then the lanes and the warps.
template <int W, typename Fn>
__device__ __forceinline__ int radix_compose(int m, Fn key, Clamp* scratch,
                                             int acc_bits) {
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int run = radix_span(m, W) >> 5;
  const int i0 = warp * (run << 5) + lane * run, i1 = min(i0 + run, m);
  Clamp f = clamp_identity(qmin, qmax);
  for (int i = i0; i < i1; ++i)
    f = clamp_then(f, clamp_step(key(i), qmin, qmax));
  f = warp_compose(f, lane);
  if constexpr (W == 1) {
    return clamp_apply(f, 0);
  } else {
    if (lane == 0) scratch[warp] = f;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 1; i < W; ++i) f = clamp_then(f, scratch[i]);
    return clamp_apply(f, 0);
  }
}

// A round's pair step in place, out[i] = max(s[i], 0) + min(s[m-1-i], 0).
template <typename Key>
__device__ __forceinline__ void radix_pairs(Key* s, int m) {
  for (int i = threadIdx.x; i < (m + 1) / 2; i += blockDim.x) {
    const int j = m - 1 - i, u = s[i], v = s[j];
    s[i] = static_cast<Key>(max(u, 0) + min(v, 0));
    if (j != i) s[j] = static_cast<Key>(max(v, 0) + min(u, 0));
  }
}

template <typename Key>
struct RadixKey;
template <>
struct RadixKey<int16_t> {  // products of int8 carriers: u < 2^15
  static constexpr int kPasses = 2, kBias = 1 << 14;
};
template <>
struct RadixKey<int32_t> {  // an expanded row past int8: u < 2^23
  static constexpr int kPasses = 3, kBias = 1 << 22;
};

template <typename Key>
__device__ __forceinline__ int radix_digit(int k, int pass) {
  return ((RadixKey<Key>::kBias - k) >> (8 * pass)) & (kRadixDigits - 1);
}

// The lanes of the warp whose 8-bit digit equals this lane's, from one
// ballot a bit (8 ballots: 10-15% faster than __match_any_sync in the
// `sorted` rows on the card).
__device__ __forceinline__ unsigned radix_peers(int digit) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned v = __ballot_sync(kFull, (digit >> b) & 1);
    m &= ((digit >> b) & 1) ? v : ~v;
  }
  return m;
}

// Each warp counts the pass's digits of its segment of s[0 .. m) (the
// first pass skips zero keys).
template <typename Key, int W>
__device__ __forceinline__ void radix_count(const Key* s, int m, int pass,
                                            int* counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = radix_span(m, W), i1 = min(warp * span + span, m);
#pragma unroll 4
  for (int i = warp * span + lane; i < i1; i += 32) {
    const int k = s[i];
    if (pass > 0 || k != 0)
      atomicAdd(counts + radix_digit<Key>(k, pass) * W + warp, 1);
  }
}

// Each warp moves its segment of s[0 .. m) to its places in d (counts
// scanned): the first pass drops zero keys and places a digit's keys in
// any order, the later ones keep the stream's order within a digit.
template <typename Key, int W>
__device__ __forceinline__ void radix_scatter(const Key* s, Key* d, int m,
                                              int pass, int* counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = radix_span(m, W), i0 = warp * span;
  const int i1 = min(i0 + span, m);
  if (pass == 0) {
#pragma unroll 4
    for (int i = i0 + lane; i < i1; i += 32) {
      const int k = s[i];
      if (k != 0)
        d[atomicAdd(counts + radix_digit<Key>(k, 0) * W + warp, 1)] =
            static_cast<Key>(k);
    }
    return;
  }
  for (int j = i0; j < i1; j += 32) {
    const int i = j + lane;
    const bool live = i < i1;
    const int k = live ? static_cast<int>(s[i]) : 0;
    const int dg = radix_digit<Key>(k, pass);
    const unsigned peers = radix_peers(dg) & __ballot_sync(kFull, live);
    const int first = __ffs(peers) - 1;
    int* h = counts + dg * W + warp;
    int base = lane == first && live ? *h : 0;
    base = __shfl_sync(kFull, base, first);
    if (live) {
      d[base + __popc(peers & ((1u << lane) - 1))] = static_cast<Key>(k);
      if (lane == first) *h = base + __popc(peers);
    }
    __syncwarp();
  }
}

// The `sorted` policy by the radix sort: products p.at(0 .. n) (the real
// keys), buffers a and b of n keys (a may be the memory p reads: the
// load writes a[i] after reading key i, in the same thread), ctl
// radix_ctl_ints(W) ints, 16-byte aligned (shared or device memory),
// scratch W Clamps. Returns the register in thread 0.
template <typename Key, int W, typename P>
__device__ __forceinline__ int radix_sorted_dot(const P& p, int n, Key* a,
                                                Key* b, int* ctl,
                                                Clamp* scratch, int acc_bits,
                                                int rounds) {
  if (rounds == 0)
    return radix_compose<W>(n, [&](int i) { return p.at(i); }, scratch,
                            acc_bits);
  int* counts = ctl;  // 256 W, digit-major
  int* totals = ctl + kRadixDigits * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  radix_zero<2>(counts);
  __syncthreads();
  {  // a <- the stream, in the first pass's segments, counting its digits
    const int span = radix_span(n, W), i1 = min(warp * span + span, n);
#pragma unroll 4
    for (int i = warp * span + lane; i < i1; i += 32) {
      const int k = p.at(i);
      a[i] = static_cast<Key>(k);
      if (k != 0) atomicAdd(counts + radix_digit<Key>(k, 0) * W + warp, 1);
    }
  }
  __syncthreads();
  int m = n;
  Key* s = a;
  Key* d = b;
  for (int rd = 0;;) {
#pragma unroll 1
    for (int pass = 0; pass < RadixKey<Key>::kPasses; ++pass) {
      if (pass > 0) {
        radix_zero<2>(counts);
        __syncthreads();
        radix_count<Key, W>(s, m, pass, counts);
        __syncthreads();
      }
      const int total = radix_scan<2, W>(counts, totals);
      radix_scatter<Key, W>(s, d, m, pass, counts);
      if (pass == 0) m = total;
      __syncthreads();
      Key* t = s;
      s = d;
      d = t;
    }
    if (++rd == rounds) break;
    radix_pairs(s, m);
    radix_zero<2>(counts);
    __syncthreads();
    radix_count<Key, W>(s, m, 0, counts);
    __syncthreads();
  }
  // the last round's pairs, composed as they are read
  return radix_compose<W>(
      m,
      [&](int i) {
        return max(static_cast<int>(s[i]), 0) +
               min(static_cast<int>(s[m - 1 - i]), 0);
      },
      scratch, acc_bits);
}

// radix_sorted_dot on int16 keys with its control block and buffers in
// the block's dynamic shared memory (radix_smem_bytes(W, n)).
template <int W, typename P>
__device__ __forceinline__ int radix_sorted_shared(const P& p, int n,
                                                   Clamp* scratch,
                                                   int acc_bits, int rounds) {
  unsigned char* smem = dynamic_smem<unsigned char>();
  int* ctl = reinterpret_cast<int*>(smem);
  auto* a = reinterpret_cast<int16_t*>(smem + sizeof(int) * radix_ctl_ints(W));
  auto* b = reinterpret_cast<int16_t*>(reinterpret_cast<unsigned char*>(a) +
                                       radix_buffer_bytes(n, 2));
  return radix_sorted_dot<int16_t, W>(p, n, a, b, ctl, scratch, acc_bits,
                                      rounds);
}

// A slot of a device-memory pool of `slots` scratch areas: busy[s] is 1
// while a block holds slot s. Thread 0 takes the first free slot from
// blockIdx.x % slots on; a holder never waits for another block, so a
// block that waits for a slot is only ever behind running ones. The block
// calls release_slot when it is done with the slot.
__device__ __forceinline__ int claim_slot(int* busy, int slots, int* held) {
  if (threadIdx.x == 0) {
    int s = static_cast<int>(blockIdx.x % static_cast<unsigned>(slots));
    while (atomicCAS(busy + s, 0, 1) != 0) {
      s = s + 1 == slots ? 0 : s + 1;
      __nanosleep(100);
    }
    __threadfence();
    *held = s;
  }
  __syncthreads();
  return *held;
}

__device__ __forceinline__ void release_slot(int* busy, int s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(busy + s, 0);
  }
}

// The exact sum of tile t's raw products, in every lane of the calling
// warp: the lanes take consecutive products of the tile and reduce by
// shuffles (sorting never changes a tile's sum).
template <typename P>
__device__ __forceinline__ int warp_tile_sum(const P& p, int t) {
  int s = 0;
  for (int j = threadIdx.x & 31; j < p.tile_len; j += 32) s += p.tile(t, j);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
  return s;
}

// The sums of T tiles into sums[0 .. T), a warp a tile.
template <typename P>
__device__ __forceinline__ void tile_sums(const P& p, int* sums, int T) {
  for (int t = threadIdx.x >> 5; t < T; t += blockDim.x >> 5) {
    const int s = warp_tile_sum(p, t);
    if ((threadIdx.x & 31) == 0) sums[t] = s;
  }
  __syncthreads();
}

// pair_permutation (core/sorted_accum.py) of T tile sums into perm, for
// each of `rows` outputs (row r's sums and perm at r * T), by the block:
// `asc` is the stable ascending order of the sums and `desc` its reverse
// (so among equal sums desc takes the higher tile index first); even
// slots take desc[0 .. half), odd slots asc[0 .. T - half). Tile i's
// stable ascending rank p counts the tiles below it, and the equal ones
// before it; it lands in odd slot 2p + 1 if p < T - half, else in even
// slot 2 (T - 1 - p).
__device__ __forceinline__ void pair_permutation(const int* sums, int* perm,
                                                 int T, int rows = 1) {
  const int half = (T + 1) >> 1;
  for (int k = threadIdx.x; k < rows * T; k += blockDim.x) {
    const int r = k / T, i = k - r * T;
    const int* s = sums + r * T;
    const int si = s[i];
    int p = 0;
    for (int j = 0; j < T; ++j) {
      const int sj = s[j];
      p += (sj < si) | ((sj == si) & (j < i));
    }
    perm[r * T + (p < T - half ? 2 * p + 1 : 2 * (T - 1 - p))] = i;
  }
  __syncthreads();
}

// Products of tile `tile` (sort tile S = E * LT) that segment lane l holds.
template <int E, int LT, typename P>
__device__ __forceinline__ void tile_products(int (&v)[E], const P& p,
                                              int tile, int l) {
#pragma unroll
  for (int r = 0; r < E; ++r) v[r] = p.tile(tile, l * E + r);
}

// The `sorted_tiled` stream of one output, level 2, as nw warps: T tiles
// of sort tile S = E * LT (tile_len products, zero-extended), paired by
// perm (T tile indices, in shared or device memory). Pair slot s
// interleaves tiles perm[2s] and perm[2s+1] (a0, b0, a1, b1, ...), each
// sorted `rounds` rounds first; an odd last tile perm[T-1] is the last
// slot, paired with a zero tile (a0, 0, a1, 0, ...: zeros add nothing, so
// it follows un-interleaved). Warp w of the nw takes the contiguous slots
// [w I / nw, (w+1) I / nw) of the I = (T+1)/2 slots, so composing the
// warps in order is the stream order (paired_threads sizes the block so
// that no warp is left without a slot). With kPacked each slot's two tiles
// run one
// network as the halves of packed int16x2 keys (pairwise_round2; products
// of int8 carriers), else two int32 networks (an expanded row with a
// weight outside int8). A lane holds a[r], b[r] for its E tile positions,
// which are its 2E consecutive places in the interleaved stream. Tiles
// shorter than 32 (LT < 32) put 32 / LT slots in one warp step, one per
// LT-lane segment in slot order; a segment with no slot holds zero
// products, which add nothing. Returns the register in thread 0. On kept
// products (S = next_pow2(tile_len) < k_tile) each sorted tile is the
// sorted dense tile's prefix and the interleaved zero pairs dropped add
// nothing, so the register is the dense one. Returns the warp's run of
// saturating adds, composed in lane 0.
template <int E, int LT, bool kPacked, typename P>
__device__ __forceinline__ Clamp paired_run(const P& p, const int* perm,
                                            int T, int warp, int nw,
                                            int acc_bits, int rounds) {
  constexpr int G = 32 / LT;
  const int lane = threadIdx.x & 31;
  const int l = lane & (LT - 1);
  const int g = lane / LT;
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
  const int slots = (T + 1) >> 1;
  const int s1 = (warp + 1) * slots / nw;
  Clamp run = clamp_identity(qmin, qmax);
  for (int s0 = warp * slots / nw; s0 < s1; s0 += G) {
    const int s = s0 + g;
    int a[E], b[E];
#pragma unroll
    for (int r = 0; r < E; ++r) a[r] = b[r] = 0;
    if (s < s1) {
      tile_products<E, LT>(a, p, perm[2 * s], l);
      if (2 * s + 1 < T) tile_products<E, LT>(b, p, perm[2 * s + 1], l);
    }
    Clamp f = clamp_identity(qmin, qmax);
    if constexpr (kPacked) {
      uint32_t v[E];
#pragma unroll
      for (int r = 0; r < E; ++r) v[r] = pack2(a[r], b[r]);
      for (int rd = 0; rd < rounds; ++rd) pairwise_round2<E, LT>(v, l);
#pragma unroll
      for (int r = 0; r < E; ++r) {
        f = clamp_then(f, clamp_step(lo16(v[r]), qmin, qmax));
        f = clamp_then(f, clamp_step(hi16(v[r]), qmin, qmax));
      }
    } else {
      for (int rd = 0; rd < rounds; ++rd) {
        pairwise_round<E, LT>(a, l);
        pairwise_round<E, LT>(b, l);
      }
#pragma unroll
      for (int r = 0; r < E; ++r) {
        f = clamp_then(f, clamp_step(a[r], qmin, qmax));
        f = clamp_then(f, clamp_step(b[r], qmin, qmax));
      }
    }
    run = clamp_then(run, warp_compose(f, lane));  // meaningful in lane 0
  }
  return run;
}

// paired_run on every warp of the block, one output: the register in
// thread 0.
template <int E, int LT, bool kPacked, typename P>
__device__ __forceinline__ int paired_dot(const P& p, const int* perm, int T,
                                          Clamp* scratch, int acc_bits,
                                          int rounds) {
  const Clamp run = paired_run<E, LT, kPacked>(
      p, perm, T, threadIdx.x >> 5, blockDim.x >> 5, acc_bits, rounds);
  return clamp_apply(block_compose_warps(run, scratch), 0);
}

// The one-pass `sorted_tiled` of one output: T tile sums ranked in shared
// memory (sums, perm: T ints each) with pair_permutation's tie rule, then
// paired_dot. Returns the register in thread 0.
template <int E, int LT, bool kPacked, typename P>
__device__ __forceinline__ int sorted_tiled_dot(const P& p, int* sums,
                                                int* perm, int T,
                                                Clamp* scratch, int acc_bits,
                                                int rounds) {
  tile_sums(p, sums, T);
  pair_permutation(sums, perm, T);
  return paired_dot<E, LT, kPacked>(p, perm, T, scratch, acc_bits, rounds);
}

// ---------------------------------------------------------------------
// Host side of the global-sort launches.

inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Calls fn.template operator()<E, W>() for the `sorted` body that holds L
// keys (a power of two; below 64 the body pads to 64 with zero keys; see
// the shape above), and returns cudaGetLastError(), or
// cudaErrorInvalidValue above 65536.
template <typename Fn>
int dispatch_sorted(int L, Fn&& fn) {
  switch (L < 64 ? 64 : L) {
    case 64: fn.template operator()<1, 1>(); break;
    case 128: fn.template operator()<2, 1>(); break;
    case 256: fn.template operator()<4, 1>(); break;
    case 512: fn.template operator()<8, 1>(); break;
    case 1024: fn.template operator()<16, 1>(); break;
    case 2048: fn.template operator()<32, 1>(); break;
    case 4096: fn.template operator()<32, 2>(); break;
    case 8192: fn.template operator()<32, 4>(); break;
    case 16384: fn.template operator()<32, 8>(); break;
    case 32768: fn.template operator()<32, 16>(); break;
    case 65536: fn.template operator()<64, 16>(); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The shared memory a `sorted` body of W warps of E keys a lane exchanges
// through: 4 bytes a packed position (2 a key), none for one warp.
inline size_t sorted_exchange_bytes(int E, int W) {
  return W > 1 ? sizeof(uint32_t) * 32 * W * E : 0;
}

// The dynamic shared memory of a `sorted` kernel of W warps of E keys a
// lane over n real keys: the radix body's buffers in its regime, else the
// register network's exchange.
inline size_t sorted_smem_bytes(int E, int W, int n) {
  return radix_regime(E, W) ? radix_smem_bytes(W, n)
                            : sorted_exchange_bytes(E, W);
}

// Threads of a paired_dot block over T tiles of sort tile S: a warp per
// warp step of slots (32 / S slots a step below S = 32), at most
// max_warps.
inline int paired_threads(int T, int S, int max_warps) {
  const int per = S >= 32 ? 1 : 32 / S;
  const int steps = ((T + 1) / 2 + per - 1) / per;
  return 32 * (steps < 1 ? 1 : steps > max_warps ? max_warps : steps);
}

// Launches kernel<<<blocks, threads, smem, s>>>(args...), first raising
// the kernel's dynamic shared-memory limit where smem is above the
// default 48 KB.
template <typename... Params, typename... Args>
void launch_smem(void (*kernel)(Params...), int64_t blocks, int threads,
                 size_t smem, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(args...);
}

// The shared memory the global-sort kernels give their keys and rows at
// most, of the 227 KB a block may use (sorted_matmul.SORT_SMEM_BYTES): the
// `sorted` exchange at 65536 keys, 2 bytes a key. The `sorted` kernels
// add the radix body's control block (16.5 KB at 16 warps) and, in the
// radix regime, a second key buffer: 144.5 KB at kp 32768.
constexpr size_t kSmemCap = 128 * 1024;

// The operands of the N:M kernels (nm_sort_matmul.cu, nm_expand_sort.cu):
// x (M, K) int8, values / indices (N, G, n_keep) int8 / int32.
struct Slabs {
  const int8_t* x;
  const int8_t* val;
  const int32_t* idx;
  int M, N, K, G, n_keep, m_group;
};

inline Slabs slabs(const void* x, const void* val, const void* idx, int M,
                   int N, int K, int G, int n_keep, int m_group) {
  return Slabs{static_cast<const int8_t*>(x), static_cast<const int8_t*>(val),
               static_cast<const int32_t*>(idx), M, N, K, G, n_keep, m_group};
}

// The slabs and the tiling every N:M global-sort entry point takes: n_keep
// in [1, m], K and G * m within kp (x's columns past G * m are never
// read), whole k_tile tiles of whole groups (k_tile <= 0 skips the tile
// checks, for `sorted`), one block per output.
inline bool valid_slabs(const Slabs& a, int kp, int k_tile) {
  if (a.K < 0 || a.G < 0 || a.m_group < 1 || a.n_keep < 1 ||
      a.n_keep > a.m_group)
    return false;
  const int64_t dense = static_cast<int64_t>(a.G) * a.m_group;
  if (a.K > kp || dense > kp || static_cast<int64_t>(a.M) * a.N > 0x7fffffff)
    return false;
  return k_tile <= 0 || (kp % k_tile == 0 && k_tile % a.m_group == 0);
}

}  // namespace pqs
