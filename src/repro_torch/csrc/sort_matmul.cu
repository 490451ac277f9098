// sort_matmul: the PQS global-sort policies with the whole K of an output
// at hand, for Hopper.
//
// Replaces: repro/kernels/sorted_matmul.py:sort_matmul (the Pallas kernel
// _sort_kernel / _sort_body, with bitonic.sorted_order_bitonic and
// sorted_accum.tiled_sorted_order) and, through the same `sorted` kernel,
// repro/kernels/sorted_stream.py:chunked_sort_matmul (`sorted` at long K,
// the Pallas _chunked_sort_kernel): one block holds one output's keys at
// any K up to 65536, so the TPU's VMEM split into two kernels does not
// carry over.
//
// Computes out[m, n] = the dot product of x[m, :] and w[n, :] (int8 values,
// int32 products, rows K long) accumulated into an acc_bits-bit register,
// one saturating add per product, over kp >= K positions (the policy's
// padded K; positions at or past K are zero products, masked in the
// kernel, so the caller pads nothing), in the order
//   sorted        `rounds` split/sort/pair rounds over the whole kp (a
//                 power of two)
//   sorted_tiled  per k_tile tile `rounds` such rounds; the tiles ranked by
//                 their sums and paired largest with most negative
//                 (pair_permutation), each pair element-interleaved
//                 (a0, b0, a1, b1, ...), an odd last tile appended
//                 (the paper's two-level sort, section 6)
//
// What bounds it on this card: the integer work of the sorts and of the
// ordered saturating adds, not device memory. `sorted` at kp = 2048 is a
// bitonic network of 66 stages of 1024 compare-exchanges an output
// (67,584), 2.4 times the 27,648 of sorting K = 1536 in six tiles of 256;
// both sit far above the bytes bound at decode, where the weights are
// about one byte per product. With the keys in registers what sets the
// time is the count of compare-exchanges (one 16x2 max and one 16x2 min
// for two of them) and of shuffles, no longer the barriers between
// stages. Across warps (kp 4096 to 32768) the network's cross-warp
// exchanges and its padding of K to kp held it (at kp 16384: 8 warps of
// 32 packed keys a lane, 35 shuffle stages, 11 exchanges through shared
// memory, 7,424 of the 16,384 keys zeros of the pad).
//
// What the design does about it (pqs_accum.cuh holds the bodies, which
// read the products through a loader, DenseProducts here; the N:M gather
// twins in nm_sort_matmul.cu run the same bodies on kept products):
// - One block per output element. The TPU kernel kept a (bm, bn, K)
//   product cube in VMEM; here a block keeps only its own output's work.
// - sorted, one warp (kp <= 2048; sorted_dot): the kp keys as int16, two to
//   a register (positions i and i + kp/2), 32 keys a lane at 2048: no
//   shared memory, no barrier. Stages inside a lane are register
//   compare-exchanges, across lanes shuffles. The pair round pairs each
//   key with its mirror in the other half, and the saturating adds are
//   composed a lane, a warp, then the warps.
// - sorted, kp 4096 to 32768 (kp / 2048 warps; pqs::radix_sorted_dot): an
//   LSD radix sort of the K real keys in shared memory, not of kp, on
//   8-bit digits of the biased key, 2 passes for int16 keys. Zeros are
//   dropped in the first pass (with a round, the nonzero stream does not
//   depend on them). Each warp counts its segment's digits, one block scan
//   places them, and the later, stable pass orders the lanes of a warp
//   that share a digit by 8 ballots. Each further round pairs and sorts
//   again; the last round's pairs are composed as they are read (with no
//   round, the natural order). 2 K bytes a buffer, two buffers beside a
//   control block of 16.5 KB at 16 warps.
// - sorted, kp 65536: 16 warps of 64 packed keys a lane hold the network
//   in registers (two radix buffers of 65536 keys would not fit a block),
//   exchanging across warps through 128 KB of shared memory.
// - sorted_tiled: up to 4 warps, one per pair slot of tiles at most
//   (pqs::paired_threads: 3 at K = 1536, where 4 left one idle). The tile
//   sums are taken from the raw products (sorting never changes a tile's
//   sum) and ranked in shared memory with pair_permutation's exact tie
//   rule; then each warp sorts its pair slots' two tiles in registers as
//   the halves of packed int16x2 keys (one network for both, the odd last
//   tile against a zero half) and composes their interleaved adds, and
//   the warps' functions are composed in slot order. No sorted product
//   goes to memory.
// At decode (M = 4) over the six K = 1536 sites: `sorted` 0.84 ms (6.16
// before the register body), `sorted_tiled` 0.75 (1.64 before the packed
// pairs); `sorted` at a prefill cohort (M = 128) 23.9 (194) (chip_smoke.py
// phase 5 with --baseline-csrc, NVIDIA H100 80GB HBM3, 700.00 W). At
// w_out (M = 4, K = 8960, kp 16384) the radix body takes 0.32 ms on the
// served 8:16-pruned weight and 0.51 on an unpruned one, against 0.72 for
// the network, and 0.09 / 0.15 / 0.85 at kp 4096 / 8192 / 32768 (0.14 /
// 0.31 / 1.77; the same, with 8-bit stable passes matched by
// __match_any_sync, was 10-15% slower than with ballots).

#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace {

constexpr int kTiledWarps = 4;

template <int E, int W>
__global__ void __launch_bounds__(32 * W)
    sort_sorted_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w, int32_t* __restrict__ out,
                       int N, int K, int acc_bits, int rounds) {
  __shared__ pqs::Clamp scratch[2 * W];
  const int64_t o = blockIdx.x;
  const int64_t m = o / N, n = o % N;
  const pqs::DenseProducts p{x + m * K, w + n * K, K, 0};
  int r;
  if constexpr (pqs::radix_regime(E, W))
    r = pqs::radix_sorted_shared<W>(p, K, scratch, acc_bits, rounds);
  else
    r = pqs::sorted_dot<E, W>(p, pqs::dynamic_smem<uint32_t>(), scratch,
                              acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

template <int E, int LT>
__global__ void sort_tiled_kernel(const int8_t* __restrict__ x,
                                  const int8_t* __restrict__ w,
                                  int32_t* __restrict__ out, int N, int K,
                                  int kp, int acc_bits, int rounds) {
  constexpr int S = E * LT;
  __shared__ pqs::Clamp scratch[kTiledWarps];
  const int T = kp / S;
  int* sums = pqs::dynamic_smem<int>();
  const int64_t o = blockIdx.x;
  const int64_t m = o / N, n = o % N;
  const pqs::DenseProducts p{x + m * K, w + n * K, K, S};
  const int r = pqs::sorted_tiled_dot<E, LT, true>(p, sums, sums + T, T,
                                                   scratch, acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

struct SortedLaunch {
  const int8_t* x;
  const int8_t* w;
  int32_t* out;
  int64_t blocks;
  int N, K, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int W>
  void operator()() const {
    pqs::launch_smem(sort_sorted_kernel<E, W>, blocks, 32 * W,
                     pqs::sorted_smem_bytes(E, W, K), s, x, w, out, N, K,
                     acc_bits, rounds);
  }
};

struct TiledLaunch {
  const int8_t* x;
  const int8_t* w;
  int32_t* out;
  int M, N, K, kp, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    const int T = kp / (E * LT);
    pqs::launch_smem(sort_tiled_kernel<E, LT>, static_cast<int64_t>(M) * N,
                     pqs::paired_threads(T, E * LT, kTiledWarps),
                     2 * sizeof(int) * static_cast<size_t>(T), s, x, w, out,
                     N, K, kp, acc_bits, rounds);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. x (M, K), w (N, K) int8 and out
// (M, N) int32 are contiguous device buffers; kp >= K is the policy's
// padded K: policy 0 is sorted (kp a power of two), 1 sorted_tiled (kp a
// multiple of the power-of-two k_tile). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take (the Python wrappers check them first).
extern "C" int pqs_sort_matmul(const void* x, const void* w, void* out,
                               int M, int N, int K, int kp, int policy,
                               int acc_bits, int rounds, int k_tile,
                               void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || kp <= 0 || kp < K || acc_bits < 2 || acc_bits > 30 ||
      rounds < 0)
    return cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = static_cast<int64_t>(M) * N;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (policy == 0) {
    if (kp & (kp - 1)) return cudaErrorInvalidValue;
    return pqs::dispatch_sorted(
        kp, SortedLaunch{xp, wp, op, blocks, N, K, acc_bits, rounds, s});
  }
  if (policy != 1 || k_tile <= 0 || kp % k_tile) return cudaErrorInvalidValue;
  return pqs::dispatch_tile(
      k_tile, TiledLaunch{xp, wp, op, M, N, K, kp, acc_bits, rounds, s});
}
