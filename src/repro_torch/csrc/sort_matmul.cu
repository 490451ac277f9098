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
// ordered saturating adds, not device memory. `sorted` at kp = 2048 is 66
// bitonic stages of 1024 compare-exchanges per output (67,584), 2.4 times
// the 27,648 of sorting K = 1536 in six tiles of 256; both sit far above
// the bytes bound at decode, where the weights are about one byte per
// product.
//
// What the design does about it (pqs_accum.cuh holds the bodies, which
// read the products through a loader, DenseProducts here; the N:M gather
// twins in nm_sort_matmul.cu run the same bodies on kept products):
// - One block per output element. The TPU kernel kept a (bm, bn, K)
//   product cube in VMEM; here a block keeps only its own output's work.
// - sorted: kp / 8 threads (32 to 1024) sort the kp products as int16
//   keys in shared memory (4 KB at kp = 2048, 32 KB at 16384, 128 KB at
//   65536 of the 227 KB a block may use), pair them in place, and compose
//   the saturating adds of contiguous runs of the ordered stream, then
//   across the warps.
// - sorted_tiled: 4 warps. The tile sums are taken from the raw products
//   (sorting never changes a tile's sum) and ranked in shared memory with
//   pair_permutation's exact tie rule; then each warp sorts its pair slots'
//   two tiles in registers (the warp bitonic network of the K-streaming
//   kernels) and composes their interleaved adds, and the warps' functions
//   are composed in slot order. No sorted product goes to memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace {

constexpr int kTiledThreads = 128;

__global__ void sort_sorted_kernel(const int8_t* __restrict__ x,
                                   const int8_t* __restrict__ w,
                                   int32_t* __restrict__ out, int N, int K,
                                   int kp, int acc_bits, int rounds) {
  __shared__ pqs::Clamp scratch[32];
  const int64_t o = blockIdx.x;
  const int64_t m = o / N, n = o % N;
  const pqs::DenseProducts p{x + m * K, w + n * K, K, kp};
  const int r = pqs::sorted_dot(p, kp, pqs::dynamic_smem<int16_t>(), scratch,
                                acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

template <int E, int LT>
__global__ void sort_tiled_kernel(const int8_t* __restrict__ x,
                                  const int8_t* __restrict__ w,
                                  int32_t* __restrict__ out, int N, int K,
                                  int kp, int acc_bits, int rounds) {
  constexpr int S = E * LT;
  __shared__ pqs::Clamp scratch[kTiledThreads / 32];
  const int T = kp / S;
  int* sums = pqs::dynamic_smem<int>();
  const int64_t o = blockIdx.x;
  const int64_t m = o / N, n = o % N;
  const pqs::DenseProducts p{x + m * K, w + n * K, K, S};
  const int r = pqs::sorted_tiled_dot<E, LT>(p, sums, sums + T, T, scratch,
                                             acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

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
                     kTiledThreads, 2 * sizeof(int) * static_cast<size_t>(T),
                     s, x, w, out, N, K, kp, acc_bits, rounds);
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
    return pqs::launch_sorted(sort_sorted_kernel, blocks, kp, s, xp, wp, op,
                              N, K, kp, acc_bits, rounds);
  }
  if (policy != 1 || k_tile <= 0 || kp % k_tile) return cudaErrorInvalidValue;
  return pqs::dispatch_tile(
      k_tile, TiledLaunch{xp, wp, op, M, N, K, kp, acc_bits, rounds, s});
}
