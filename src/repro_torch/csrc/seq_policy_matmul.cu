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
// - Each K chunk of 32*E products sits E to a lane, in registers. The sort
//   is a bitonic network over the chunk: exchanges inside a lane are
//   register swaps, exchanges between lanes are __shfl_xor_sync. No shared
//   memory. The weight chunk is loaded once and reused for the MR rows.
// - One descending sort per round does the split: positives come first in
//   descending order, negatives last with the most negative at the end, so
//   out[i] = max(s[i], 0) + min(s[T-1-i], 0) is exactly the reference's
//   pos_sorted[i] + neg_sorted[i]. The result depends only on the sorted
//   values, so any exact sort is valid.
// - The saturating adds are done as a parallel ordered reduction. A run of
//   saturating adds, x -> min(max(x + c, L), H), is closed under
//   composition, so each lane composes its E steps and the warp composes
//   the lanes' functions in order with shuffles. This is the stepwise
//   clamp of the reference exactly, not cumsum-then-clip. Wrap adds are a
//   ring homomorphism, so wrap(acc + chunk sum) equals the stepwise wraps.
// - M, N and K edges are masked here: a zero product is neither positive
//   nor negative and adds nothing under any policy, so masked loads of 0
//   are the zero padding of the reference.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerWarp = 4;  // MR

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
  const int l = lane & (LT - 1);
  const int qmax = (1 << (acc_bits - 1)) - 1;
  const int qmin = -qmax - 1;
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
      if (policy == 0 || policy == 2) {
        int s = 0;
#pragma unroll
        for (int r = 0; r < E; ++r) s += v[r];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(kFull, s, d);
        if (policy == 0) {
          acc[i] += s;
        } else {
          const int span = 1 << acc_bits;
          int t = (acc[i] + s - qmin) % span;  // floor mod: fix the sign
          if (t < 0) t += span;
          acc[i] = t + qmin;
        }
        continue;
      }
      if (policy == 3) {
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
      acc[i] = clamp_apply(f, acc[i]);  // meaningful in lane 0
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

template <int E, int LT>
void launch(const int8_t* x, const int8_t* w, int32_t* out, int M, int N,
            int K, int policy, int acc_bits, int rounds, cudaStream_t s) {
  dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock,
            (M + kRowsPerWarp - 1) / kRowsPerWarp);
  seq_policy_kernel<E, LT><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
      x, w, out, M, N, K, policy, acc_bits, rounds);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x (M, K), w (N, K) int8 and out
// (M, N) int32 are contiguous device buffers. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel does
// not take (the Python wrapper checks them first).
extern "C" int pqs_seq_policy_matmul(const void* x, const void* w, void* out,
                                     int M, int N, int K, int policy,
                                     int acc_bits, int rounds, int k_tile,
                                     void* stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (policy < 0 || policy > 3 || acc_bits < 2 || acc_bits > 30 || K < 0)
    return cudaErrorInvalidValue;
  if (policy != 3) {
    launch<8, 32>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s);
    return cudaGetLastError();
  }
  switch (k_tile) {
    case 1: launch<1, 1>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 2: launch<1, 2>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 4: launch<1, 4>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 8: launch<1, 8>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 16: launch<1, 16>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 32: launch<1, 32>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 64: launch<2, 32>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 128: launch<4, 32>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 256: launch<8, 32>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 512: launch<16, 32>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    case 1024: launch<32, 32>(xp, wp, op, M, N, K, policy, acc_bits, rounds, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
