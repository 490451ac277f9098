// sorted_stream.cu: the two-pass sorted_tiled pipeline for long K: pass 1
// (two bodies) and pass 2.
//
// Replaces:
//   pqs_tile_sums (mma8::mma_kernel with the TileSums epilogue, or
//   tile_sums_small_kernel) <- repro/kernels/sorted_stream.py:
//     tile_sums_matmul (pass 1 of sorted_tiled: the (M, N, kp/k_tile)
//     int32 sums of each output's k_tile tiles);
//   paired_accum_kernel <- repro/kernels/sorted_stream.py:paired_accum_matmul
//     (pass 2 of sorted_tiled, the Pallas _paired_kernel / _paired_body:
//     each output's tiles in the order its row of perm gives, paired,
//     sorted, interleaved and added with a saturating add per product).
// Between the passes, core/sorted_accum.py:pair_permutation ranks the tile
// sums in plain torch, as it runs outside any kernel in the JAX package.
// `sorted` at long K (sorted_stream.py:chunked_sort_matmul) runs the
// one-pass `sorted` kernel of sort_matmul.cu, which holds up to 65536 keys.
//
// Operands: x (M, K) and w (N, K) int8; kp >= K is K padded to whole
// k_tile tiles, the positions at or past K zero products masked in the
// kernels (the caller pads nothing); perm (M, N, kp/k_tile) int32.
//
// What bounds it on this card:
// - pass 1 is an exact int32 dot per tile: at decode (M = 4) one read of
//   the weight, 13.76 MB at w_out (N 1536, K 8960), device memory; at a
//   prefill cohort (M = 128) the (M, N, T) int32 output, 27.5 MB at
//   k_tile 256, outweighs the weight, and its words are T apart along N;
// - pass 2 is the integer work of the sorts and of the ordered saturating
//   adds, far above the bytes bound, as for the one-pass kernels
//   (sort_matmul.cu).
// The TPU's VMEM budgets (the bn-chunk of the product cube, CUBE_BUDGET,
// and the resident int8 slabs) do not carry over: one block holds one
// output's work only.
//
// What the design does about it:
// - pass 1 at k_tile >= 64 (a power-of-two multiple of the mainloop's
//   64-byte slab): the pipelined int8 tensor-core mainloop of
//   int8_mma.cuh with the dense (N, K) loader of row 1's `wide`, each
//   weight byte read once per block row (16 rows of x at decode, 32
//   above), and its TileSums epilogue: after a tile's slabs the block
//   keeps its accumulators in shared memory as that tile's sums, and
//   every 8 tiles writes them out along T; K splits on whole tiles, so no
//   atomics and no memset. At w_out it takes 0.0179 ms at M = 4 and 0.0957
//   at M = 128, against a float32 bmm of the same sums at 0.0344 / 0.0975
//   and the old body (one thread per output and tile, the weight read once
//   per row of x, dp4a on the integer pipe) at 0.1234 / 3.3988
//   (chip_smoke.py phase 5 with --baseline-csrc, NVIDIA H100 80GB HBM3,
//   700.00 W);
// - pass 1 at k_tile < 64 (tiles shorter than a slab; no qwen2-1.5b path
//   takes them): tile_sums_small_kernel, one thread per (m, n, tile),
//   __dp4a over 4 int8 pairs at a time when rows and tiles are 4-byte
//   aligned, a byte loop otherwise; consecutive threads take consecutive
//   tiles of one output, so the (M, N, T) output is written coalesced.
// - paired_accum_kernel: one block of up to 8 warps per output (one per
//   pair slot, pqs::paired_threads); warp w takes a contiguous run of pair
//   slots, sorts each slot's two tiles in registers as the halves of
//   packed int16x2 keys (one pass of the warp bitonic network of the
//   K-streaming kernels for both tiles), composes their interleaved
//   saturating adds, and the warps' functions are composed in slot order
//   (pqs_accum.cuh paired_dot). The odd last tile is the last slot, against
//   a zero half. The tiles are read straight from x and w; nothing sorted
//   goes back to memory. At w_out at decode it takes 0.29 ms, 0.60 with
//   two int32 networks a slot (chip_smoke.py phase 5 with --baseline-csrc,
//   NVIDIA H100 80GB HBM3, 700.00 W).

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "pqs_accum.cuh"

namespace {

constexpr int kSumThreads = 256;
constexpr int kPairWarps = 8;

// One thread per (m, n, tile) of the (M, N, T) output, grid-strided; rows
// of T tiles, so consecutive threads write consecutive words.
__global__ void tile_sums_small_kernel(const int8_t* __restrict__ x,
                                       const int8_t* __restrict__ w,
                                       int32_t* __restrict__ out, int M,
                                       int N, int K, int T, int k_tile,
                                       int words) {
  const int64_t total = static_cast<int64_t>(M) * N * T;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int t = static_cast<int>(i % T);
    const int64_t mn = i / T;
    const int8_t* xp = x + (mn / N) * K + static_cast<int64_t>(t) * k_tile;
    const int8_t* wp = w + (mn % N) * K + static_cast<int64_t>(t) * k_tile;
    // the tile's positions before K; the rest are zero products
    const int rem = K - t * k_tile;
    const int valid = rem < 0 ? 0 : rem < k_tile ? rem : k_tile;
    int s = 0;
    int q = 0;
    if (words) {
      const int* xi = reinterpret_cast<const int*>(xp);
      const int* wi = reinterpret_cast<const int*>(wp);
      for (; q + 4 <= valid; q += 4) s = __dp4a(xi[q >> 2], wi[q >> 2], s);
    }
    for (; q < valid; ++q)
      s += static_cast<int>(xp[q]) * static_cast<int>(wp[q]);
    out[i] = s;
  }
}

template <int E, int LT>
__global__ void paired_accum_kernel(const int8_t* __restrict__ x,
                                    const int8_t* __restrict__ w,
                                    const int32_t* __restrict__ perm,
                                    int32_t* __restrict__ out, int N, int K,
                                    int kp, int acc_bits, int rounds) {
  __shared__ pqs::Clamp scratch[kPairWarps];
  const int T = kp / (E * LT);
  const int64_t o = blockIdx.x;
  const int64_t m = o / N, n = o % N;
  const pqs::DenseProducts p{x + m * K, w + n * K, K, E * LT};
  const int r = pqs::paired_dot<E, LT, true>(p, perm + o * T, T, scratch,
                                             acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

struct PairedLaunch {
  const int8_t* x;
  const int8_t* w;
  const int32_t* perm;
  int32_t* out;
  int M, N, K, kp, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    paired_accum_kernel<E, LT>
        <<<static_cast<unsigned>(static_cast<int64_t>(M) * N),
           pqs::paired_threads(kp / (E * LT), E * LT, kPairWarps), 0, s>>>(
            x, w, perm, out, N, K, kp, acc_bits, rounds);
  }
};

bool valid_k(int K, int kp, int k_tile) {
  return K >= 0 && kp > 0 && kp >= K && k_tile > 0 && kp % k_tile == 0;
}

bool valid_blocks(int M, int N) {
  return static_cast<int64_t>(M) * N <= 0x7fffffff;
}

}  // namespace

// Plain C entry points, loaded with ctypes. x (M, K), w (N, K) int8, perm
// (M, N, kp/k_tile) int32 and the outputs ((M, N, kp/k_tile) sums, (M, N)
// registers, int32) are contiguous device buffers; kp >= K is a multiple
// of k_tile. Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments the kernel does not take (the
// Python wrappers check first).

// Pass 1 takes the mainloop where k_tile is a power-of-two multiple of
// its slab (mma8::kBK, 64) and K >= 1, else the small-tile body
// (sorted_stream.py tile_sums_body says the same).
extern "C" int pqs_tile_sums(const void* x, const void* w, void* out, int M,
                             int N, int K, int kp, int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (!valid_k(K, kp, k_tile)) return cudaErrorInvalidValue;
  const auto* x8 = static_cast<const int8_t*>(x);
  const auto* w8 = static_cast<const int8_t*>(w);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int slabs = k_tile / mma8::kBK;
  if (K >= 1 && k_tile % mma8::kBK == 0 && (slabs & (slabs - 1)) == 0)
    return mma8::launch_tile_sums(
        x8, mma8::DenseRows{w8, N, K, mma8::copy_mode(w8, K)}, o, M, N, K,
        k_tile, kp / k_tile, s);
  const auto addr = reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w);
  const int words = (k_tile % 4 == 0 && K % 4 == 0 && addr % 4 == 0);
  const int64_t total = static_cast<int64_t>(M) * N * (kp / k_tile);
  const int64_t want = (total + kSumThreads - 1) / kSumThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want
                                                                 : (1 << 20));
  tile_sums_small_kernel<<<blocks, kSumThreads, 0, s>>>(
      x8, w8, o, M, N, K, kp / k_tile, k_tile, words);
  return cudaGetLastError();
}

extern "C" int pqs_paired_accum(const void* x, const void* w,
                                const void* perm, void* out, int M, int N,
                                int K, int kp, int acc_bits, int rounds,
                                int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (!valid_k(K, kp, k_tile) || acc_bits < 2 || acc_bits > 30 ||
      rounds < 0 || !valid_blocks(M, N))
    return cudaErrorInvalidValue;
  return pqs::dispatch_tile(
      k_tile, PairedLaunch{static_cast<const int8_t*>(x),
                           static_cast<const int8_t*>(w),
                           static_cast<const int32_t*>(perm),
                           static_cast<int32_t*>(out), M, N, K, kp, acc_bits,
                           rounds, static_cast<cudaStream_t>(stream)});
}
