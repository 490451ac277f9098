// quant_matmul.cu: the wide int8 matmuls for Hopper on the int8 tensor
// cores, quant_matmul (dense (K, N) weight) and nm_spmm (N:M compressed
// weight): two loaders of the pipelined mainloop of int8_mma.cuh, which
// seq_policy_matmul.cu's policy wide runs with a third (dense (N, K) rows).
//
// Replaces:
//   mma_kernel<MT, KnRows> <- repro/kernels/quant_matmul.py:quant_matmul
//     (the Pallas _kernel: an int32 dot_general of each (bm, bk) x (bk, bn)
//     block pair, the output block revisited along the K grid axis);
//   mma_kernel<MT, NmChunks / NmBytes> <- repro/kernels/nm_spmm.py:nm_spmm
//     (the Pallas _kernel: each (bn, bg, n_keep) slab expanded by
//     expand_nm_slab, then the same dot).
//
// Both compute out[m, n] = sum_k x[m, k] * w[k, n] in int32 as an int32
// dot_general does (int8_mma.cuh says how the sum wraps). Operands: x
// (M, K) int8; quant_matmul's w (K, N) int8, in-by-out (the layout of
// QTensor.values, unlike the (N, K) weights of the policy kernels);
// nm_spmm's values / indices (N, G, n_keep) int8 / int32 with K <= G *
// m_group. Rows past M, columns past N and positions past K are masked in
// the kernel and groups past G do not exist, so nothing is padded on the
// host.
//
// nm_spmm's slabs must be canonical, as pruning.nm_compress packs them:
// indices in [0, m_group), and at most one nonzero slot at a dense
// position. A slot whose index lies outside its group adds nothing, as the
// reference's one-hot expansion drops it. Two nonzero slots at one
// position add byte-wise in 32-bit registers, which is their int32 sum
// narrowed to int8 for the mma: it wraps modulo 2^8, where the plain
// version and the reference's one-hot sum them in int32. Nothing checks
// the slabs at launch (pruning.nm_assert_canonical does, for tests).
//
// The loaders, each filling a ring stage's 64 weight rows over a slab of
// K = 64 as (N, K) rows (the mma's .col B operand), from raw bytes that each
// thread copies by cp.async into the ring two or three slabs ahead and
// builds from, one slab ahead, reading only its own copies:
// - KnRows (quant_matmul): the (K, N) slab as 4 x 4 byte blocks (one
//   32-bit word of 4 columns from each of 4 rows of K), transposed by byte
//   permutes (prmt) into rows of N over K: integer mma exists only as
//   .row.col, and ldmatrix .trans moves only 16-bit elements on sm_90.
// - NmChunks (nm_spmm, m_group dividing 16, so every WIDE_SLABS shape:
//   8:16, 4:16, 2:8, 16:16): a thread owns whole 16-position chunks of a
//   row, each 16 / m_group whole groups whose slots lie consecutive in the
//   slabs. It copies their indices and values (16-, 8- or 4-byte copies
//   where the slabs' strides allow), then builds the chunk's 16 bytes in 4
//   registers, each kept value at its position (a value-0 slot adds
//   nothing, so a padded (0, 0) slot never disturbs a kept value at
//   position 0; a slot whose index is >= m_group or negative is skipped),
//   and writes them with one 16-byte store. With at most 8 slots and no
//   two nonzero ones at a position, each word is one byte permute of the
//   chunk's values, masked; else the values add byte by byte (modulo 2^8).
//   No int16 tile, compare-and-swap or narrowing pass.
// - NmBytes (nm_spmm, other m_group): a thread builds a 4-byte word of a
//   row from device memory, each byte the int32 sum of its group's slots
//   at that position, narrowed; slow (every byte scans its group's
//   slots), and taken by no WIDE_SLABS shape.
// Positions at or past K multiply x's zero fill, so no loader masks them.
//
// What bounds it on this card: device memory. At decode (M = 4) a weight
// byte feeds 8 operations, and at M = 128 256, both below the ~590 a byte
// at which the int8 tensor cores (1979 TOP/s over 3.35 TB/s) become the
// limit: the weight's bytes (5 a kept value when compressed) are the
// bound. The ring keeps two (decode) or three slabs' copies in flight
// while the tensor cores work on one; nm_spmm's build of the slab's bytes
// is integer work on top (a kept value sets a nibble of a byte-permute
// selector and a bit of a mask, then a chunk takes 4 permutes), paid once
// per block and slab whatever M.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using mma8::copy_run;
using mma8::cp_async;
using mma8::kBK;
using mma8::kBN;
using mma8::kRow;
using mma8::pack_bytes;
using mma8::store_word;

// quant_matmul's loader: the slab w[k0 .. k0 + kBK)[n0 .. n0 + kBN) of the
// (K, N) weight as 4 x 4 byte blocks (a 32-bit word of 4 columns from each
// of 4 rows of K), each copied by one thread into the raw bytes (rows of K
// over N, kRow bytes apart) and transposed by it into the tile with byte
// permutes. `mode`: 4 (w and N multiples of 4: cp.async of each word) or 1
// (byte loads).
struct KnRows {
  const int8_t* w;
  int N, K, mode;
  static constexpr int kLead = 1;
  static constexpr int kBlocks = (kBN / 4) * (kBK / 4);
  __host__ __device__ __forceinline__ int raw_bytes() const {
    return kBK * kRow;
  }
  template <int NT>
  __device__ __forceinline__ void start(uint8_t*, uint8_t* raw, int n0,
                                        int k0) const {
    for (int b = threadIdx.x; b < kBlocks; b += NT) {
      const int nq = b % (kBN / 4), kq = b / (kBN / 4);
      const int n = n0 + 4 * nq, cols = min(max(N - n, 0), 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * kq + j;
        if (k < K && cols) {  // past K: x's zero fill; past N: not stored
          const int8_t* p = w + static_cast<int64_t>(k) * N + n;
          uint8_t* to = raw + (4 * kq + j) * kRow + 4 * nq;
          if (mode == 4)
            cp_async<4>(to, p, cols);
          else
            store_word(to, pack_bytes(p, cols));
        }
      }
    }
  }
  // Word c of block (kq, nq) after the permutes holds byte c of the
  // block's 4 row words q[0 .. 3]: column 4 nq + c over rows 4 kq .. + 3.
  template <int NT>
  __device__ __forceinline__ void build(uint8_t* tile, const uint8_t* raw,
                                        int, int) const {
    for (int b = threadIdx.x; b < kBlocks; b += NT) {
      const int nq = b % (kBN / 4), kq = b / (kBN / 4);
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = *reinterpret_cast<const uint32_t*>(raw + (4 * kq + j) * kRow +
                                                  4 * nq);
      // t01 = (q0.0, q1.0, q0.1, q1.1), t23 = (q0.2, q1.2, q0.3, q1.3)
      const uint32_t t01 = __byte_perm(q[0], q[1], 0x5140);
      const uint32_t t23 = __byte_perm(q[0], q[1], 0x7362);
      const uint32_t u01 = __byte_perm(q[2], q[3], 0x5140);
      const uint32_t u23 = __byte_perm(q[2], q[3], 0x7362);
      uint8_t* dst = tile + 4 * nq * kRow + 4 * kq;
      store_word(dst, __byte_perm(t01, u01, 0x5410));
      store_word(dst + kRow, __byte_perm(t01, u01, 0x7632));
      store_word(dst + 2 * kRow, __byte_perm(t23, u23, 0x5410));
      store_word(dst + 3 * kRow, __byte_perm(t23, u23, 0x7632));
    }
  }
};

// a + b byte by byte, modulo 2^8 (no carry between bytes).
__device__ __forceinline__ uint32_t add_bytes(uint32_t a, uint32_t b) {
  return ((a & 0x7f7f7f7fu) + (b & 0x7f7f7f7fu)) ^ ((a ^ b) & 0x80808080u);
}

// nm_spmm's loader for m_group = 2^lm dividing 16. A thread owns (row,
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
                                        int n0, int k0) const {
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
        pos = slot = 0;
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          if (s < cnt) {
            if (static_cast<unsigned>(j[s]) <
                static_cast<unsigned>(m_group)) {
              const int p = pos + j[s];
              const uint32_t add = ((v[s >> 2] >> (8 * (s & 3))) & 0xffu)
                                   << (8 * (p & 3));
#pragma unroll
              for (int w = 0; w < 4; ++w)
                b[w] = add_bytes(b[w], (p >> 2) == w ? add : 0u);
            }
            if (++slot == n_keep) {
              slot = 0;
              pos += m_group;
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(tile + r * kRow + 16 * c) =
          make_uint4(b[0], b[1], b[2], b[3]);
    }
  }
};

// nm_spmm's loader for any other m_group: the build reads the slabs from
// device memory, a thread a 4-byte word of a row at a time, each byte the
// int32 sum of the slots of its group at its position, narrowed.
struct NmBytes {
  const int8_t* val;
  const int32_t* idx;
  int N, G, n_keep, m_group;
  static constexpr int kLead = 1;
  __host__ __device__ __forceinline__ int raw_bytes() const { return 0; }
  template <int NT>
  __device__ __forceinline__ void start(uint8_t*, uint8_t*, int, int) const {}
  template <int NT>
  __device__ __forceinline__ void build(uint8_t* tile, const uint8_t*,
                                        int n0, int k0) const {
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
        word |= static_cast<uint32_t>(sum & 0xff) << (8 * e);
      }
      store_word(tile + r * kRow + q, word);
    }
  }
};

}  // namespace

// Plain C entry points, loaded with ctypes; every buffer is a contiguous
// device buffer, out (M, N) int32. Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take (the Python wrappers check them first).

// x (M, K) int8, w (K, N) int8.
extern "C" int pqs_quant_matmul(const void* x, const void* w, void* out,
                                int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0) return cudaErrorInvalidValue;
  const auto* w8 = static_cast<const int8_t*>(w);
  return mma8::launch(static_cast<const int8_t*>(x),
                      KnRows{w8, N, K, mma8::copy_mode(w8, N) == 1 ? 1 : 4},
                      static_cast<int32_t*>(out), M, N, K,
                      static_cast<cudaStream_t>(stream));
}

// x (M, K) int8, values (N, G, n_keep) int8, indices (N, G, n_keep) int32,
// K <= G * m_group.
extern "C" int pqs_nm_spmm(const void* x, const void* val, const void* idx,
                           void* out, int M, int N, int K, int G, int n_keep,
                           int m_group, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || G < 0 || m_group < 1 || n_keep < 1 || n_keep > m_group ||
      static_cast<int64_t>(G) * m_group < K ||
      static_cast<int64_t>(G) * n_keep > 0x7fffffff)
    return cudaErrorInvalidValue;
  const auto* x8 = static_cast<const int8_t*>(x);
  const auto* v8 = static_cast<const int8_t*>(val);
  const auto* i32 = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (16 % m_group != 0)
    return mma8::launch(x8, NmBytes{v8, i32, N, G, n_keep, m_group}, o, M, N,
                        K, s);
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
  return mma8::launch(
      x8, NmChunks{v8, i32, N, G, n_keep, lm, imode, vmode}, o, M, N, K, s);
}
