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
//   nm_sums_few_rows_kernel<RG, P2, false>,
//   nm_sums_many_rows_kernel<P2, false> (nm_tile_sums.cuh) <-
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
// bytes of slab (int8 value, int32 index) a kept product (nm_tile_sums.cuh
// says what bounds it).
//
// What the design does about it:
// - The sort bodies are the dense kernels' (pqs_accum.cuh sorted_dot,
//   sorted_tiled_dot, paired_dot), reading products through the gathered
//   loader instead of the dense row pair: one block per output element.
// - `sorted`: the dense kernels' bodies over the L = next_pow2(G n_keep)
//   kept keys: the register network on one warp up to L = 2048 (16 keys a
//   lane at 1024, no shared memory) and at 65536; from 4096 to 32768 the
//   radix body over the G n_keep real keys (L / 2048 warps: 4 at w_out's
//   8192), zeros dropped. The lanes read the kept slots coalesced (a
//   sort's result does not depend on where each key starts), and a slot's
//   group q / n_keep is a multiply-high by a reciprocal (pqs::div_magic),
//   not a division. At w_out (M = 4, 4480 kept keys) the radix body takes
//   0.27 ms, the network 0.37 (chip_smoke.py phase 5 with --baseline-csrc,
//   NVIDIA H100 80GB HBM3, 700.00 W).
// - `sorted_tiled` one-pass: up to 4 warps (one per pair slot) rank the T
//   = kp / k_tile tile sums in shared memory, then sort each pair slot's
//   two kept tiles in registers as the halves of packed int16x2 keys.
// - At decode (M = 4, 8:16) over the six K = 1536 sites `sorted` takes
//   0.62 ms and `sorted_tiled` 0.69 (2.73 and 1.11 for the shared-memory
//   body and the int32 pairs before); at w_out `sorted` 0.37 (2.43) and
//   pass 2 0.18 (0.30) (chip_smoke.py phase 5 with --baseline-csrc,
//   NVIDIA H100 80GB HBM3, 700.00 W).
// - Pass 1: the body of nm_tile_sums.cuh, which the expand twin's pass 1
//   (nm_expand_sort.cu) shares; here a nonzero slot whose index points
//   outside its group (so outside the tile) is read from x in device
//   memory where that position lies below K, as gather_nm_products reads
//   it. A block takes one tile and a run of output columns and stages x's
//   columns of the tile transposed in shared memory, so each kept slot is
//   read once for all rows of x (the lanes split a tile's slots up to 16
//   rows of x, own rows above). At w_out (8:16) it takes 0.0263 ms at M =
//   4 and 0.2005 at M = 128, against a float32 bmm of the same sums on the
//   decompressed weight at 0.0345 / 0.0975 and the old body, one warp per
//   (n, tile), at 0.0846 / 2.2635 (chip_smoke.py phase 5 with
//   --baseline-csrc, NVIDIA H100 80GB HBM3, 700.00 W). At M = 128 its
//   gathers (an x word a slot and 4 rows, a byte transpose and 4 __dp4a)
//   set its time, not its bytes; the alternative, row 4's slab build on
//   the int8 mainloop with row 9's held-tile epilogue, was slower at M =
//   4, 64 and 128 when both were timed in one process.
// - Pass 2: up to 8 warps per output, the one-pass body fed perm.

#include <cstdint>
#include <cuda_runtime.h>

#include "nm_tile_sums.cuh"
#include "pqs_accum.cuh"

namespace {

using pqs::Slabs;
using pqs::slabs;
using pqs::valid_slabs;

constexpr int kTiledWarps = 4;
constexpr int kPairWarps = 8;

// The kept products of output (m, n).
__device__ __forceinline__ pqs::GatheredProducts gathered(
    const int8_t* x, const int8_t* val, const int32_t* idx, int64_t m,
    int64_t n, int K, int G, int n_keep, int m_group, int tile_len) {
  const int kept = G * n_keep;
  return pqs::GatheredProducts{x + m * K, val + n * kept, idx + n * kept, K,
                               kept, n_keep, m_group, tile_len,
                               pqs::div_magic(n_keep, kept)};
}

template <int E, int W>
__global__ void __launch_bounds__(32 * W)
    nm_sort_sorted_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ val,
                          const int32_t* __restrict__ idx,
                          int32_t* __restrict__ out, int N, int K, int G,
                          int n_keep, int m_group, int acc_bits, int rounds) {
  __shared__ pqs::Clamp scratch[2 * W];
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, G, n_keep, m_group,
                          G * n_keep);
  int r;
  if constexpr (pqs::radix_regime(E, W))
    r = pqs::radix_sorted_shared<W>(p, G * n_keep, scratch, acc_bits, rounds);
  else
    r = pqs::sorted_dot<E, W>(p, pqs::dynamic_smem<uint32_t>(), scratch,
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
  __shared__ pqs::Clamp scratch[kTiledWarps];
  int* sums = pqs::dynamic_smem<int>();
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, G, n_keep, m_group,
                          lc);
  const int r = pqs::sorted_tiled_dot<E, LT, true>(p, sums, sums + T, T,
                                                   scratch, acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
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
  __shared__ pqs::Clamp scratch[kPairWarps];
  const int64_t o = blockIdx.x;
  const auto p = gathered(x, val, idx, o / N, o % N, K, G, n_keep, m_group,
                          lc);
  const int r = pqs::paired_dot<E, LT, true>(p, perm + o * T, T, scratch,
                                             acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

struct SortedLaunch {
  Slabs a;
  int32_t* out;
  int acc_bits, rounds;
  cudaStream_t s;

  template <int E, int W>
  void operator()() const {
    pqs::launch_smem(nm_sort_sorted_kernel<E, W>,
                     static_cast<int64_t>(a.M) * a.N, 32 * W,
                     pqs::sorted_smem_bytes(E, W, a.G * a.n_keep), s, a.x,
                     a.val, a.idx, out, a.N, a.K, a.G, a.n_keep, a.m_group,
                     acc_bits, rounds);
  }
};

struct TiledLaunch {
  Slabs a;
  int32_t* out;
  int T, lc, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    pqs::launch_smem(nm_sort_tiled_kernel<E, LT>,
                     static_cast<int64_t>(a.M) * a.N,
                     pqs::paired_threads(T, E * LT, kTiledWarps),
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
           pqs::paired_threads(T, E * LT, kPairWarps), 0, s>>>(
            a.x, a.val, a.idx, perm, out, a.N, a.K, a.G, a.n_keep, a.m_group,
            T, lc, acc_bits, rounds);
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
    return pqs::dispatch_sorted(pqs::next_pow2(G * n_keep),
                                SortedLaunch{a, op, acc_bits, rounds, s});
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
  return pqs::dispatch_tile(
      pqs::next_pow2(lc),
      PairedLaunch{a, static_cast<const int32_t*>(perm),
                   static_cast<int32_t*>(out), kp / k_tile, lc, acc_bits,
                   rounds, static_cast<cudaStream_t>(stream)});
}
