// nm_chunks.cuh: the loaders of int8_mma.cuh's mainloop for N:M
// compressed slabs, which rebuild each ring stage's weight tile from the
// values and indices: row 4 (nm_spmm, quant_matmul.cu) and row 5 under
// `wide` and `wrap` (nm_seq_policy_matmul.cu), and launch_nm, which picks
// the loader and its copy widths for the slabs.
//
// Slabs: values / indices (N, G, n_keep) int8 / int32, K <= G * m_group.
// The tile holds the expanded weight, the int32 sum of the slots at each
// dense position (the reference's one-hot expansion); a slot whose index
// lies outside [0, m_group) adds nothing, and a value-0 slot adds nothing,
// so a padded (0, 0) slot never disturbs a kept value at position 0.
//
// Where two nonzero slots name one position (never on canonical slabs,
// pruning.nm_compress's) the sum may leave int8, which the tile's bytes
// cannot hold. The build then sets the block's flag (int8_mma.cuh: a
// shared word, set to 0 behind one barrier and read after the mainloop's
// last), and the flagged block takes its outputs from exact(), the int32
// sum of the slots' products over its share of K, instead of the tensor
// cores' sums. A route the data picks; canonical slabs never take it.
//
// - NmChunks (m_group dividing 16, so every shape of chip_smoke.py's
//   WIDE_SLABS: 8:16, 4:16, 2:8, 16:16): a thread owns whole 16-position
//   chunks of a row, each 16 / m_group whole groups whose slots lie
//   consecutive in the slabs. It copies their indices and values (16-, 8-
//   or 4-byte copies where the slabs' strides allow), then builds the
//   chunk's 16 bytes in 4 registers, each kept value at its position,
//   and writes them with one 16-byte store. With at most 8 slots and no
//   two nonzero ones at a position (a 16-bit occupancy mask, `twice`),
//   each word is one byte permute of the chunk's values, masked; with
//   more slots (16:16) the values add byte by byte, and a second nonzero
//   slot at a position flags the block. No int16 tile, compare-and-swap
//   or narrowing pass.
// - NmBytes (other m_group): a thread builds a 4-byte word of a row from
//   device memory, each byte the int32 sum of its group's slots at that
//   position, and flags the block where a sum leaves int8; slow (every
//   byte scans its group's slots), and taken by no WIDE_SLABS shape.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

// Internal linkage in each source that includes it: mma8's function-local
// statics on these loaders' types (resident_blocks) then belong to that
// build, so two builds loaded into one process keep their own.
namespace {
namespace nmload {

using mma8::copy_run;
using mma8::kBK;
using mma8::kBN;
using mma8::kRow;
using mma8::store_word;

// a + b byte by byte, modulo 2^8 (no carry between bytes).
__device__ __forceinline__ uint32_t add_bytes(uint32_t a, uint32_t b) {
  return ((a & 0x7f7f7f7fu) + (b & 0x7f7f7f7fu)) ^ ((a ^ b) & 0x80808080u);
}

// The exact int32 sum (wrapping as a dot_general) of xrow[p] * value over
// the slots of row n whose position p = g * m_group + index lies in
// [k_begin, k_end): the weight row's expanded sums times x, slot by slot.
__device__ __forceinline__ int exact_slots(const int8_t* val,
                                           const int32_t* idx, int G,
                                           int n_keep, int m_group,
                                           const int8_t* xrow, int n,
                                           int k_begin, int k_end) {
  unsigned sum = 0;
  const int g1 = min(G, (k_end + m_group - 1) / m_group);
  for (int g = k_begin / m_group; g < g1; ++g) {
    const int64_t first = (static_cast<int64_t>(n) * G + g) * n_keep;
    for (int q = 0; q < n_keep; ++q) {
      const int v = __ldg(val + first + q), j = __ldg(idx + first + q);
      if (v == 0 || static_cast<unsigned>(j) >= static_cast<unsigned>(m_group))
        continue;
      const int p = g * m_group + j;
      if (p >= k_begin && p < k_end)
        sum += static_cast<unsigned>(static_cast<int>(xrow[p]) * v);
    }
  }
  return static_cast<int>(sum);
}

// The loader for m_group = 2^lm dividing 16. A thread owns (row,
// 16-position chunk) pairs of the slab, each 16 / m_group whole groups of
// the row, cpc = 16 / m_group * n_keep consecutive slots of the slabs. It
// copies the chunk's indices and values into the raw bytes (rows of the
// slab's 4 cpc indices, padded by 16 bytes so that a quarter warp's 16-byte
// reads of 2 rows fall in distinct banks, then rows of its 4 cpc values),
// then builds the chunk's 16 bytes from its own copies. `imode` / `vmode`:
// the copies' widths for the indices (16 or 4) and the values (16, 8, 4
// or 1), copy_run's.
struct NmChunks {
  const int8_t* val;
  const int32_t* idx;
  int N, G, n_keep, lm, imode, vmode;
  static constexpr int kLead = 1;
  static constexpr bool kExact = true;
  static constexpr int kPer = kBK / 16;  // chunks of a row
  __host__ __device__ __forceinline__ int cpc() const {
    return (16 >> lm) * n_keep;
  }
  __host__ __device__ __forceinline__ int id_ld() const {
    return 16 * cpc() + 16;
  }
  __host__ __device__ __forceinline__ int raw_bytes() const {
    return kBN * (id_ld() + kPer * cpc());
  }
  // Slots of chunk (r, c) of the slab at k0 (0 past N and G), and the slab
  // offset of its first.
  __device__ __forceinline__ int slots(int n0, int k0, int r, int c,
                                       int64_t* first) const {
    const int g = (k0 >> lm) + (c << (4 - lm));  // the chunk's first group
    *first = (static_cast<int64_t>(n0 + r) * G + g) * n_keep;
    return n0 + r < N ? min(max(G - g, 0), 16 >> lm) * n_keep : 0;
  }
  template <int NT>
  __device__ __forceinline__ void start(uint8_t*, uint8_t* raw, int n0,
                                        int k0) const {
    for (int task = threadIdx.x; task < kBN * kPer; task += NT) {
      const int r = task / kPer, c = task % kPer;
      int64_t first;
      const int cnt = slots(n0, k0, r, c, &first);
      if (cnt == 0) continue;
      copy_run(raw + r * id_ld() + 4 * c * cpc(),
               reinterpret_cast<const int8_t*>(idx + first), 4 * cpc(),
               4 * cnt, imode);
      copy_run(raw + kBN * id_ld() + (r * kPer + c) * cpc(), val + first,
               cpc(), cnt, vmode);
    }
  }
  template <int NT>
  __device__ __forceinline__ void build(uint8_t* tile, const uint8_t* raw,
                                        int n0, int k0, int* flag) const {
    const int m_group = 1 << lm;
    for (int task = threadIdx.x; task < kBN * kPer; task += NT) {
      const int r = task / kPer, c = task % kPer;
      int64_t first;
      const int cnt = slots(n0, k0, r, c, &first);
      const auto* id =
          reinterpret_cast<const int32_t*>(raw + r * id_ld()) + c * cpc();
      const uint8_t* vv = raw + kBN * id_ld() + (r * kPer + c) * cpc();
      int j[16];
      uint32_t v[4] = {0, 0, 0, 0};  // the values, 4 to a word
      if (cpc() % 4 == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (4 * q < cnt) {
            const int4 i4 = reinterpret_cast<const int4*>(id)[q];
            j[4 * q] = i4.x;
            j[4 * q + 1] = i4.y;
            j[4 * q + 2] = i4.z;
            j[4 * q + 3] = i4.w;
            v[q] = reinterpret_cast<const uint32_t*>(vv)[q];
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          if (s < cnt) {
            j[s] = id[s];
            v[s >> 2] |= static_cast<uint32_t>(vv[s]) << (8 * (s & 3));
          }
        }
      }
      uint32_t b[4] = {0, 0, 0, 0};
      // Up to 8 slots (the values of v[0], v[1]): the slot of each
      // position into a nibble of `from`, then each word's 4 bytes picked
      // by one byte permute and the empty positions masked; where two
      // nonzero slots meet at a position (non-canonical slabs) or more
      // slots are kept, byte-wise adds below.
      uint64_t from = 0;
      uint32_t taken = 0, twice = 0;
      int pos = 0, slot = 0;  // the slot's group's first position, its rank
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s < cnt) {
          if (((v[s >> 2] >> (8 * (s & 3))) & 0xffu) &&
              static_cast<unsigned>(j[s]) < static_cast<unsigned>(m_group)) {
            const int p = pos + j[s];
            twice |= taken & (1u << p);
            taken |= 1u << p;
            from |= static_cast<uint64_t>(s) << (4 * p);
          }
          if (++slot == n_keep) {
            slot = 0;
            pos += m_group;
          }
        }
      }
      if (cnt <= 8 && !twice) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const uint32_t m4 = (taken >> (4 * w)) & 0xfu;  // a byte's 0xff
          const uint32_t keep = ((m4 * 0x204081u) & 0x01010101u) * 0xffu;
          b[w] = __byte_perm(v[0], v[1],
                             static_cast<uint32_t>(from >> (16 * w))) &
                 keep;
        }
      } else {
        // every slot, the occupancy mask again: a second nonzero slot at
        // a position flags the block (its byte sum may leave int8)
        pos = slot = 0;
        taken = twice = 0;
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          if (s < cnt) {
            const uint32_t byte = (v[s >> 2] >> (8 * (s & 3))) & 0xffu;
            if (static_cast<unsigned>(j[s]) <
                static_cast<unsigned>(m_group)) {
              const int p = pos + j[s];
              if (byte) {
                twice |= taken & (1u << p);
                taken |= 1u << p;
              }
#pragma unroll
              for (int w = 0; w < 4; ++w)
                b[w] = add_bytes(b[w], (p >> 2) == w ? byte << (8 * (p & 3))
                                                     : 0u);
            }
            if (++slot == n_keep) {
              slot = 0;
              pos += m_group;
            }
          }
        }
        if (twice) *flag = 1;
      }
      *reinterpret_cast<uint4*>(tile + r * kRow + 16 * c) =
          make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
  __device__ __forceinline__ int exact(const int8_t* xrow, int n,
                                       int k_begin, int k_end) const {
    return exact_slots(val, idx, G, n_keep, 1 << lm, xrow, n, k_begin,
                       k_end);
  }
};

// The loader for any other m_group: the build reads the slabs from device
// memory, a thread a 4-byte word of a row at a time, each byte the int32
// sum of the slots of its group at its position, narrowed; a sum that
// leaves int8 flags the block.
struct NmBytes {
  const int8_t* val;
  const int32_t* idx;
  int N, G, n_keep, m_group;
  static constexpr int kLead = 1;
  static constexpr bool kExact = true;
  __host__ __device__ __forceinline__ int raw_bytes() const { return 0; }
  template <int NT>
  __device__ __forceinline__ void start(uint8_t*, uint8_t*, int, int) const {}
  template <int NT>
  __device__ __forceinline__ void build(uint8_t* tile, const uint8_t*,
                                        int n0, int k0, int* flag) const {
    for (int i = threadIdx.x; i < kBN * kBK / 4; i += NT) {
      const int r = i / (kBK / 4), q = 4 * (i % (kBK / 4));
      const int n = n0 + r;
      uint32_t word = 0;
      for (int e = 0; n < N && e < 4; ++e) {
        const int pos = k0 + q + e, g = pos / m_group;
        if (g >= G) break;
        const int64_t base = (static_cast<int64_t>(n) * G + g) * n_keep;
        const int at = pos - g * m_group;
        int sum = 0;
        for (int s = 0; s < n_keep; ++s)
          sum += __ldg(idx + base + s) == at ? __ldg(val + base + s) : 0;
        if (sum != static_cast<int8_t>(sum)) *flag = 1;
        word |= static_cast<uint32_t>(sum & 0xff) << (8 * e);
      }
      store_word(tile + r * kRow + q, word);
    }
  }
  __device__ __forceinline__ int exact(const int8_t* xrow, int n,
                                       int k_begin, int k_end) const {
    return exact_slots(val, idx, G, n_keep, m_group, xrow, n, k_begin,
                       k_end);
  }
};

// out (M, N) int32 = x (M, K) int8 times the expanded slabs on the int8
// mainloop through the epilogue `epi` (mma8::WholeK or mma8::WrapK): the
// loader for m_group (NmChunks where it divides 16, else NmBytes) and the
// widest copies the slabs' addresses and strides allow. M, N >= 1; the
// caller checks the shapes. Returns the launch's error.
template <typename E>
int launch_nm(const int8_t* x, const int8_t* val, const int32_t* idx,
              int32_t* out, int M, int N, int K, int G, int n_keep,
              int m_group, cudaStream_t s, E epi) {
  if (16 % m_group != 0)
    return mma8::launch(x, NmBytes{val, idx, N, G, n_keep, m_group}, out, M,
                        N, K, s, epi);
  // a chunk's slots start at a multiple of cpc, rows G n_keep slots apart
  int lm = 0;
  while ((1 << lm) < m_group) ++lm;
  const int cpc = (16 >> lm) * n_keep, row = G * n_keep;
  const auto ia = reinterpret_cast<uintptr_t>(idx);
  const auto va = reinterpret_cast<uintptr_t>(val);
  const int imode = ia % 16 == 0 && row % 4 == 0 && cpc % 4 == 0 ? 16 : 4;
  int vmode = 1;
  for (int b : {16, 8, 4})
    if (vmode == 1 && va % b == 0 && row % b == 0 && cpc % b == 0) vmode = b;
  return mma8::launch(x, NmChunks{val, idx, N, G, n_keep, lm, imode, vmode},
                      out, M, N, K, s, epi);
}

}  // namespace nmload
}  // namespace
