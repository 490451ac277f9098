// seq_policy_matmul: PQS K-streaming accumulation-policy matmul for Hopper.
//
// Replaces: repro/kernels/sorted_matmul.py:seq_policy_matmul (the Pallas
// kernel with _seq_body, _stepwise and bitonic.sorted_order_bitonic).
//
// Computes out[m, n] = the dot product of x[m, :] and w[n, :] (int8 values,
// int32 products) accumulated into an acc_bits-bit register under one of
//   0 wide             exact int32 sum
//   1 clip             natural K order, saturating add after every product
//   2 wrap             natural K order, two's-complement wrap at acc_bits
//                      (a floor mod, not C's truncating %)
//   3 sorted_tiled_seq per k_tile tile: `rounds` split/sort/pair rounds,
//                      then saturating adds in the resulting order; tiles in
//                      natural K order (paper section 6)
//
// What bounds it on this card: integer ALU and register-shuffle traffic of
// the per-tile sort and of the serial saturating adds, not device memory.
// At decode (M = 4) the weight bytes are about 1 byte per 4 products, while
// the 256-element bitonic sort costs over a hundred integer instructions per
// product, so the kernel sits far above the memory roofline.
//
// What the design does about it:
// - One warp per output element (n) and per group of MR rows (m); the p-bit
//   register of each output lives in a register across the loop over K, so
//   no partial sum ever goes back to device memory (the TPU kernel revisited
//   its output block across a sequential K grid axis instead).
// - Each K chunk of 32*E products sits E to a lane, in registers, and goes
//   through the accumulation body shared with the N:M kernels
//   (pqs_accum.cuh: register bitonic sort with shuffles, ordered
//   clamp-composition reduction). The weight chunk is loaded once and
//   reused for the MR rows.
// - M, N and K edges are masked here: a zero product is neither positive
//   nor negative and adds nothing under any policy, so masked loads of 0
//   are the zero padding of the reference.

#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace {

using pqs::kRowsPerWarp;
using pqs::kWarpsPerBlock;

template <int E, int LT>
__global__ void seq_policy_kernel(const int8_t* __restrict__ x,
                                  const int8_t* __restrict__ w,
                                  int32_t* __restrict__ out, int M, int N,
                                  int K, int policy, int acc_bits,
                                  int rounds) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * kRowsPerWarp;
  if (n >= N) return;  // whole warp leaves together
  constexpr int C = 32 * E;  // products per warp per chunk

  int acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0;

  const int8_t* wrow = w + static_cast<int64_t>(n) * K;
  for (int k0 = 0; k0 < K; k0 += C) {
    int wv[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int k = k0 + lane * E + r;
      wv[r] = k < K ? static_cast<int>(wrow[k]) : 0;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int m = m0 + i;
      if (m >= M) break;  // uniform across the warp
      const int8_t* xrow = x + static_cast<int64_t>(m) * K;
      int v[E];
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int k = k0 + lane * E + r;
        v[r] = k < K ? static_cast<int>(xrow[k]) * wv[r] : 0;
      }
      acc[i] = pqs::accumulate_chunk<E, LT>(v, acc[i], policy, acc_bits,
                                            rounds, lane);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int m = m0 + i;
      if (m < M) out[static_cast<int64_t>(m) * N + n] = acc[i];
    }
  }
}

struct Launch {
  const int8_t* x;
  const int8_t* w;
  int32_t* out;
  int M, N, K, policy, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (M + kRowsPerWarp - 1) / kRowsPerWarp);
    seq_policy_kernel<E, LT><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        x, w, out, M, N, K, policy, acc_bits, rounds);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes. x (M, K), w (N, K) int8 and out
// (M, N) int32 are contiguous device buffers. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel does
// not take (the Python wrapper checks them first).
extern "C" int pqs_seq_policy_matmul(const void* x, const void* w, void* out,
                                     int M, int N, int K, int policy,
                                     int acc_bits, int rounds, int k_tile,
                                     void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (policy < 0 || policy > 3 || acc_bits < 2 || acc_bits > 30 || K < 0)
    return cudaErrorInvalidValue;
  const Launch launch{static_cast<const int8_t*>(x),
                      static_cast<const int8_t*>(w),
                      static_cast<int32_t*>(out),
                      M, N, K, policy, acc_bits, rounds,
                      static_cast<cudaStream_t>(stream)};
  // the sort tile is k_tile for sorted_tiled_seq; other policies stream
  // chunks of 256
  return pqs::dispatch_tile(policy == 3 ? k_tile : 256, launch);
}
