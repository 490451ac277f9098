// quant_matmul.cu: the wide int8 matmuls for Hopper on the int8 tensor
// cores, quant_matmul (dense weight) and nm_spmm (N:M compressed weight),
// two instances of one body.
//
// Replaces:
//   wide_kernel<MT, 0> <- repro/kernels/quant_matmul.py:quant_matmul (the
//     Pallas _kernel: an int32 dot_general of each (bm, bk) x (bk, bn)
//     block pair, the output block revisited along the K grid axis);
//   wide_kernel<MT, 1> <- repro/kernels/nm_spmm.py:nm_spmm (the Pallas
//     _kernel: each (bn, bg, n_keep) slab expanded by expand_nm_slab, then
//     the same dot).
//
// Both compute out[m, n] = sum_k x[m, k] * w[k, n] in int32, as an int32
// dot_general does: int8 products are exact, and the mma adds in int32
// without .satfinite, so a sum past 2^31 wraps (two's complement) as the
// reference's does instead of saturating. That takes |sum| > 2^31, i.e.
// K > 131072 at extreme int8 values. Partial sums of a split K are added
// with atomicAdd, also modulo 2^32, so the result is the same bit for bit
// in any order.
//
// Operands: x (M, K) int8; quant_matmul's w (K, N) int8, in-by-out (the
// layout of QTensor.values, unlike the (N, K) weights of the policy
// kernels); nm_spmm's values / indices (N, G, n_keep) int8 / int32 with
// K <= G * m_group. Rows past M, columns past N and positions past K load
// as zeros and groups past G do not exist, so nothing is padded on the
// host.
//
// nm_spmm's slabs must be canonical, as pruning.nm_compress packs them:
// indices in [0, m_group), and at most one nonzero slot at a dense
// position. A slot whose index lies outside its group adds nothing, as the
// reference's one-hot expansion drops it. Two nonzero slots at one
// position add in the int16 tile, which is then narrowed to int8 for the
// mma: their sum wraps modulo 2^8, where the plain version and the
// reference's one-hot sum them in int32. Nothing checks the slabs at
// launch (pruning.nm_assert_canonical does, for tests).
//
// The body: a block of 4 warps owns a (16 MT) x 64 output tile (MT = 1 for
// M <= 16, decode; 8 above) and walks its share of K in slabs of 64, each
// slab's loads issued into registers before the tensor cores work on the
// slab before it:
// - x's slab is staged into shared memory as rows over K (the mma's .row
//   A operand);
// - quant_matmul's 64 (K) x 64 (N) weight slab is read a 4 x 4 byte block
//   a thread (one 32-bit word of 4 columns from each of 4 rows of K) and
//   transposed by byte permutes (prmt) into rows of N over K, the .col B
//   operand: integer mma exists only as .row.col, and ldmatrix .trans moves
//   only 16-bit elements on sm_90;
// - nm_spmm's slab rebuilds its 64 rows at their dense positions from the
//   compressed slots by nm_decompress's scatter-add (pqs_accum.cuh
//   expand_slots: a value-0 slot adds nothing, so a padded (0, 0) slot
//   never disturbs a kept value at position 0 of its group) into an int16
//   tile, the whole block's slots at once, then narrows it to int8;
// - each warp runs mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on its 16
//   columns for every 16-row tile that holds a row below M, its fragments
//   read as 32-bit words from shared-memory rows padded to 80 bytes, so
//   that the 8 rows one fragment load touches fall in distinct banks.
// When the output tiles alone would give the card's SMs fewer than two
// blocks each at decode (24 tiles at N = 1536), or fewer than one at a
// prefill cohort, K is split among blocks and the partial sums are added
// with atomicAdd into an output zeroed first.
//
// What bounds it on this card: device memory. At decode (M = 4) a weight
// byte feeds 8 operations, and at M = 128 256, both below the ~590 a byte
// at which the int8 tensor cores (1979 TOP/s over 3.35 TB/s) become the
// limit: the weight's bytes (5 a kept value when compressed) are the
// bound. The slabs pass through registers (one slab ahead), not a cp.async
// or TMA ring of shared-memory stages; that ring is later work.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace {

constexpr int kBK = 64;                // K of a slab
constexpr int kBN = 64;                // output columns of a block
constexpr int kWarps = 4;              // 16 of the block's columns each
constexpr int kThreads = 32 * kWarps;
constexpr int kRow = kBK + 16;         // bytes of a staged row (20 words)
constexpr int kPrefillTiles = 8;       // MT above decode: 128 rows a block

// Bytes p[0 .. n) packed little-endian into a word (0 past n).
__device__ __forceinline__ uint32_t pack_bytes(const int8_t* p, int n) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j)))
           << (8 * j);
  return v;
}

__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t smem_word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// One slab of x and of quant_matmul's weight in registers, between their
// loads from device memory and their stores into shared memory: the next
// slab's loads are issued before the tensor cores work on this one, and a
// thread's loads of a slab are all in flight together.
template <int MT>
struct Slab {
  static constexpr int kX = 16 * MT * (kBK / 4) / kThreads;  // x words
  static constexpr int kW = (kBN / 4) * (kBK / 4) / kThreads;  // 4x4 blocks
  uint32_t x[kX];
  uint32_t w[kW][4];  // w[b][j] byte c: row 4 kq + j, column 4 nq + c
};

// Rows m0 .. m0 + 16 MT of x over [k0, k0 + kBK), zero past M and K.
// `words`: x is 4-byte aligned and K a multiple of 4.
template <int MT>
__device__ __forceinline__ void load_x(Slab<MT>& s, const int8_t* x, int M,
                                       int K, int m0, int k0, bool words) {
#pragma unroll
  for (int j = 0; j < Slab<MT>::kX; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int m = m0 + i / (kBK / 4), k = k0 + 4 * (i % (kBK / 4));
    s.x[j] = 0;
    if (m < M && k < K) {
      const int8_t* p = x + static_cast<int64_t>(m) * K + k;
      s.x[j] = words ? load_word(p) : pack_bytes(p, K - k);
    }
  }
}

template <int MT>
__device__ __forceinline__ void store_x(const Slab<MT>& s,
                                        uint8_t (*sa)[kRow]) {
#pragma unroll
  for (int j = 0; j < Slab<MT>::kX; ++j) {
    const int i = threadIdx.x + j * kThreads;
    store_word(&sa[i / (kBK / 4)][4 * (i % (kBK / 4))], s.x[j]);
  }
}

// quant_matmul's slab w[k0 .. k0 + kBK)[n0 .. n0 + kBN) of the (K, N)
// weight, zero past N and K: 4 x 4 byte blocks, one 32-bit word of 4
// columns from each of 4 rows, lanes along N. `words`: w is 4-byte aligned
// and N a multiple of 4.
template <int MT>
__device__ __forceinline__ void load_w(Slab<MT>& s, const int8_t* w, int N,
                                       int K, int n0, int k0, bool words) {
#pragma unroll
  for (int b = 0; b < Slab<MT>::kW; ++b) {
    const int i = threadIdx.x + b * kThreads;
    const int n = n0 + 4 * (i % (kBN / 4)), kq = i / (kBN / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * kq + j;
      s.w[b][j] = 0;
      if (k < K && n < N) {
        const int8_t* p = w + static_cast<int64_t>(k) * N + n;
        s.w[b][j] = words ? load_word(p) : pack_bytes(p, N - n);
      }
    }
  }
}

// The blocks of load_w into sb as rows of N over K (the mma's .col B):
// each 4 x 4 block transposed by byte permutes, word c of the result
// holding byte c of w[b][0 .. 3].
template <int MT>
__device__ __forceinline__ void store_w(const Slab<MT>& s,
                                        uint8_t (*sb)[kRow]) {
#pragma unroll
  for (int b = 0; b < Slab<MT>::kW; ++b) {
    const int i = threadIdx.x + b * kThreads;
    const uint32_t* r = s.w[b];
    // t01 = (r0.0, r1.0, r0.1, r1.1), t23 = (r0.2, r1.2, r0.3, r1.3)
    const uint32_t t01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t23 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t u01 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t u23 = __byte_perm(r[2], r[3], 0x7362);
    uint8_t* dst = &sb[4 * (i % (kBN / 4))][4 * (i / (kBN / 4))];
    store_word(dst, __byte_perm(t01, u01, 0x5410));
    store_word(dst + kRow, __byte_perm(t01, u01, 0x7632));
    store_word(dst + 2 * kRow, __byte_perm(t23, u23, 0x5410));
    store_word(dst + 3 * kRow, __byte_perm(t23, u23, 0x7632));
  }
}

constexpr int kChunk = 8;  // slots a thread loads before it adds them

// nm_spmm's slab: rows n0 .. n0 + kBN of the compressed weight at their
// dense positions [k0, k0 + kBK) into sb, zero past N and K, by the whole
// block: pqs_accum.cuh expand_slots adds every slot of the slab's groups
// into the int16 tile s16 (nm_decompress's scatter-add, all rows at once,
// kChunk slots a thread in flight), then the tile is narrowed to int8.
__device__ __forceinline__ void stage_w_nm(uint8_t (*sb)[kRow],
                                           int16_t (*s16)[kBK],
                                           const pqs::Slabs& a, int n0,
                                           int k0) {
  const int g0 = k0 / a.m_group;
  const int g1 = min(a.G, (k0 + kBK + a.m_group - 1) / a.m_group);
  const int64_t row = static_cast<int64_t>(a.G) * a.n_keep;
  pqs::expand_slots<false, kBN, kChunk>(
      &s16[0][0], kBK, k0, nullptr, a.val + n0 * row, a.idx + n0 * row,
      g0 * a.n_keep, g1 * a.n_keep, a.K, a.n_keep, a.m_group, threadIdx.x,
      kThreads, min(kBN, a.N - n0), row);
  for (int i = threadIdx.x; i < kBN * kBK / 4; i += kThreads) {
    const int r = i / (kBK / 4), q = 4 * (i % (kBK / 4));
    const uint32_t lo = smem_word(reinterpret_cast<const uint8_t*>(
        &s16[r][q]));
    const uint32_t hi = smem_word(reinterpret_cast<const uint8_t*>(
        &s16[r][q + 2]));
    store_word(&sb[r][q], __byte_perm(lo, hi, 0x6420));  // the low bytes
  }
}

// d += a b for one 16 x 8 x 32 int8 tile, exact int32 (wrapping) adds.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: the (16 MT) x kBN output tile at (blockIdx.y, blockIdx.x) over
// slabs [blockIdx.z * per, (blockIdx.z + 1) * per) of K. NM = 0: w is the
// (K, N) weight; NM = 1: w and idx are the compressed values and indices.
// `split`: K is split among blocks, whose sums are added atomically.
template <int MT, int NM>
__global__ void __launch_bounds__(kThreads) wide_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ idx, int32_t* __restrict__ out, int M, int N,
    int K, int G, int n_keep, int m_group, int per, int split, int x_words,
    int w_words) {
  __shared__ __align__(16) uint8_t sa[16 * MT][kRow];
  __shared__ __align__(16) uint8_t sb[kBN][kRow];
  __shared__ __align__(16) int16_t s16[NM ? kBN : 1][kBK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' groupID etc.
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * 16 * MT;
  const int live = min(MT, (M - m0 + 15) / 16);  // tiles with a row < M
  const int k_begin = blockIdx.z * per * kBK;
  const int k_end = min(K, k_begin + per * kBK);
  const pqs::Slabs a{x, w, idx, M, N, K, G, n_keep, m_group};

  int acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  Slab<MT> slab;
  load_x(slab, x, M, K, m0, k_begin, x_words);
  if constexpr (!NM) load_w(slab, w, N, K, n0, k_begin, w_words);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous slab's fragments are read
    store_x(slab, sa);
    if constexpr (NM)
      stage_w_nm(sb, s16, a, n0, k0);
    else
      store_w(slab, sb);
    __syncthreads();
    if (k0 + kBK < k_end) {  // the next slab's loads fly during the mmas
      load_x(slab, x, M, K, m0, k0 + kBK, x_words);
      if constexpr (!NM) load_w(slab, w, N, K, n0, k0 + kBK, w_words);
    }
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint8_t* col = &sb[warp * 16 + 8 * j + g][ks + 4 * t];
        b[j][0] = smem_word(col);
        b[j][1] = smem_word(col + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < live) {
          const uint8_t* r0 = &sa[16 * mt + g][ks + 4 * t];
          const uint8_t* r8 = &sa[16 * mt + g + 8][ks + 4 * t];
          const uint32_t af[4] = {smem_word(r0), smem_word(r8),
                                  smem_word(r0 + 16), smem_word(r8 + 16)};
          mma_s8(acc[mt][0], af, b[0][0], b[0][1]);
          mma_s8(acc[mt][1], af, b[1][0], b[1][1]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= live) break;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // e: (row g or g + 8) x (column pair)
        const int m = m0 + 16 * mt + g + 8 * (e >> 1);
        const int n = n0 + warp * 16 + 8 * j + 2 * t + (e & 1);
        if (m < M && n < N) {
          int32_t* o = out + static_cast<int64_t>(m) * N + n;
          if (split)
            atomicAdd(o, acc[mt][j][e]);
          else
            *o = acc[mt][j][e];
        }
      }
  }
}

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int NM>
int launch_wide(const int8_t* x, const int8_t* w, const int32_t* idx,
                int32_t* out, int M, int N, int K, int G, int n_keep,
                int m_group, cudaStream_t s) {
  const size_t out_bytes = sizeof(int32_t) * static_cast<size_t>(M) * N;
  if (K == 0) return cudaMemsetAsync(out, 0, out_bytes, s);
  const bool decode = M <= 16;
  const int bm = decode ? 16 : 16 * kPrefillTiles;
  const int64_t tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + bm - 1) / bm;
  if (tiles_m > 65535 || tiles_n > 0x7fffffff) return cudaErrorInvalidValue;
  const int slabs = (K + kBK - 1) / kBK;
  // two blocks an SM at decode; one wave at a prefill cohort, where every
  // split adds M N atomics
  const int64_t tiles = tiles_n * tiles_m;
  const int64_t want = (decode ? 2 : 1) * static_cast<int64_t>(sm_count());
  int splits = tiles >= want
                   ? 1
                   : static_cast<int>(
                         std::min<int64_t>(slabs, (want + tiles - 1) / tiles));
  const int per = (slabs + splits - 1) / splits;
  splits = (slabs + per - 1) / per;
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, s);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(tiles_n),
                  static_cast<unsigned>(tiles_m), splits);
  const int x_words = reinterpret_cast<uintptr_t>(x) % 4 == 0 && K % 4 == 0;
  const int w_words =
      !NM && reinterpret_cast<uintptr_t>(w) % 4 == 0 && N % 4 == 0;
  if (decode)
    wide_kernel<1, NM><<<grid, kThreads, 0, s>>>(
        x, w, idx, out, M, N, K, G, n_keep, m_group, per, splits > 1,
        x_words, w_words);
  else
    wide_kernel<kPrefillTiles, NM><<<grid, kThreads, 0, s>>>(
        x, w, idx, out, M, N, K, G, n_keep, m_group, per, splits > 1,
        x_words, w_words);
  return cudaGetLastError();
}

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
  return launch_wide<0>(static_cast<const int8_t*>(x),
                        static_cast<const int8_t*>(w), nullptr,
                        static_cast<int32_t*>(out), M, N, K, 0, 1, 1,
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
  return launch_wide<1>(static_cast<const int8_t*>(x),
                        static_cast<const int8_t*>(val),
                        static_cast<const int32_t*>(idx),
                        static_cast<int32_t*>(out), M, N, K, G, n_keep,
                        m_group, static_cast<cudaStream_t>(stream));
}
