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
// wide is the int8 tensor-core mainloop of int8_mma.cuh with the (N, K)
// rows copied into its shared-memory ring by cp.async (mma_kernel<MT,
// DenseRows>): an int32 dot_general bit for bit, bound by the weight's
// bytes (quant_matmul.cu's header says why).
//
// The other policies, what bounds them on this card: integer ALU and
// register-shuffle traffic of the per-tile sort and of the serial
// saturating adds, not device memory. At decode (M = 4) the weight bytes
// are about 1 byte per 4 products, while a 256-key bitonic sort costs
// over a hundred integer instructions per key, so the kernel sits far
// above the memory roofline.
//
// What the design does about it:
// - One warp per output element (n) and per group of kRowsPerWarp = 4 rows
//   (m); the p-bit register of each output lives in a register across the
//   loop over K, so no partial sum ever goes back to device memory (the TPU
//   kernel revisited its output block across a sequential K grid axis
//   instead). The weight chunk is loaded once and reused for the 4 rows.
// - Each K chunk of 32*E products sits E to a lane, in registers.
// - sorted_tiled_seq (sorted_seq_kernel): rows m and m + 1 are one packed
//   stream, their products the low and high int16 halves of E registers a
//   lane (pqs_accum.cuh's packed body: every key of every round fits in 16
//   bits), so the 4 rows take 2 sorts of the tile and 2 pairings, each
//   compare-exchange a 16x2 max and min and each cross-lane stage one
//   shuffle for both rows. An odd M leaves the last partner half zero:
//   zero products are inert, and that row's register is never stored. Then
//   each half, unpacked to int32, composes its saturating adds (the
//   ordered clamp-composition reduction shared with the N:M kernels).
//   On sm_90a __vmaxs2 / __vmins2 compile to one VIMNMX.S16x2 each and
//   __vadd2 to one VIADD.16x2 (cuobjdump -sass; chip_smoke.py prints the
//   counts).
// - clip and wrap (policy_kernel) keep one int32 stream a row, through
//   the same reduction (wrap: one floor mod of the chunk's sum).
// - M, N and K edges are masked here: a zero product is neither positive
//   nor negative and adds nothing under any policy, so masked loads of 0
//   are the zero padding of the reference.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "pqs_accum.cuh"

namespace {

using pqs::kRowsPerWarp;
using pqs::kWarpsPerBlock;
static_assert(kRowsPerWarp % 2 == 0, "rows run in packed pairs");

// The weight chunk of lane `lane`: w[k0 + lane * E + r], zero past K.
template <int E>
__device__ __forceinline__ void load_chunk(int (&wv)[E], const int8_t* wrow,
                                           int k0, int K, int lane) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int k = k0 + lane * E + r;
    wv[r] = k < K ? static_cast<int>(wrow[k]) : 0;
  }
}

// clip (policy 1) and wrap (2), chunks of 256.
template <int E>
__global__ void policy_kernel(const int8_t* __restrict__ x,
                              const int8_t* __restrict__ w,
                              int32_t* __restrict__ out, int M, int N, int K,
                              int policy, int acc_bits) {
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
    load_chunk<E>(wv, wrow, k0, K, lane);
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
      acc[i] = policy == 2
                   ? pqs::wrap_add(acc[i], pqs::chunk_sum<E>(v), acc_bits)
                   : pqs::saturate_chunk<E>(v, acc[i], acc_bits, lane);
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

// sorted_tiled_seq (policy 3): sort tile S = E * LT (pqs::dispatch_tile),
// rows in packed pairs.
template <int E, int LT>
__global__ void sorted_seq_kernel(const int8_t* __restrict__ x,
                                  const int8_t* __restrict__ w,
                                  int32_t* __restrict__ out, int M, int N,
                                  int K, int acc_bits, int rounds) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (LT - 1);
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
    load_chunk<E>(wv, wrow, k0, K, lane);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; i += 2) {
      const int m = m0 + i;
      if (m >= M) break;  // uniform across the warp
      const bool pair = m + 1 < M;
      const int8_t* xa = x + static_cast<int64_t>(m) * K;
      const int8_t* xb = xa + K;
      uint32_t v[E];
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int k = k0 + lane * E + r;
        int a = 0, b = 0;
        if (k < K) {
          a = static_cast<int>(xa[k]) * wv[r];
          if (pair) b = static_cast<int>(xb[k]) * wv[r];
        }
        v[r] = pqs::pack2(a, b);
      }
      for (int rd = 0; rd < rounds; ++rd) pqs::pairwise_round2<E, LT>(v, l);
      int u[E];  // each half unpacked in turn
#pragma unroll
      for (int r = 0; r < E; ++r) u[r] = pqs::lo16(v[r]);
      acc[i] = pqs::saturate_chunk<E>(u, acc[i], acc_bits, lane);
#pragma unroll
      for (int r = 0; r < E; ++r) u[r] = pqs::hi16(v[r]);
      acc[i + 1] = pqs::saturate_chunk<E>(u, acc[i + 1], acc_bits, lane);
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

struct SortedLaunch {
  const int8_t* x;
  const int8_t* w;
  int32_t* out;
  int M, N, K, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (M + kRowsPerWarp - 1) / kRowsPerWarp);
    sorted_seq_kernel<E, LT><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
        x, w, out, M, N, K, acc_bits, rounds);
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
  const auto* x8 = static_cast<const int8_t*>(x);
  const auto* w8 = static_cast<const int8_t*>(w);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (policy == 0)
    return mma8::launch(x8, mma8::DenseRows{w8, N, K, mma8::copy_mode(w8, K)},
                        o, M, N, K, s);
  if (policy == 3)
    return pqs::dispatch_tile(
        k_tile, SortedLaunch{x8, w8, o, M, N, K, acc_bits, rounds, s});
  dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock,
            (M + kRowsPerWarp - 1) / kRowsPerWarp);
  policy_kernel<8><<<grid, 32 * kWarpsPerBlock, 0, s>>>(x8, w8, o, M, N, K,
                                                        policy, acc_bits);
  return cudaGetLastError();
}
