// nm_seq_policy_matmul.cu: the PQS K-streaming policies on N:M compressed
// weights, two kernels.
//
// Replaces:
//   nm_gather_kernel <- repro/kernels/nm_spmm.py:nm_gather_seq_policy_matmul
//     (the Pallas kernel _nm_gather_seq_kernel with gather_nm_products and
//     pad_last_pow2): only the kept products are formed and accumulated;
//   nm_expand_kernel <- repro/kernels/nm_spmm.py:nm_seq_policy_matmul (the
//     Pallas kernel _nm_seq_kernel with expand_nm_slab): each chunk of the
//     compressed row is expanded to its dense positions, then accumulated
//     exactly as the dense kernel does; the exactness oracle of the gather.
//
// Operands: x (M, K) int8; values (N, G, n_keep) int8 and indices
// (N, G, n_keep) int32 in canonical form (pruning.nm_compress: indices
// ascend in [0, m), padded slots carry value 0), K <= G * m. out (M, N)
// int32 holds the acc_bits register under wide / clip / wrap /
// sorted_tiled_seq (pqs_accum.cuh). The result equals the dense kernel on
// the decompressed weight bit for bit: the dense product stream is the
// kept-product stream with zeros at the pruned positions, zeros are inert
// under every policy, and a pairwise sort round maps a tile with extra
// zeros to the same ordered stream followed by zeros (the prefix
// property), for any number of rounds. So
// - wide, clip and wrap accumulate the kept products in ascending dense
//   position (the order in which canonical slabs store them);
// - sorted_tiled_seq takes the tile of k_tile dense positions, which is
//   bg = k_tile / m groups, as its bg * n_keep kept products zero-padded
//   to the next power of two (8:16 at k_tile 256: 128 products a tile).
//
// What bounds it on this card: as for the dense kernel, the integer work
// of the per-tile sort and the ordered saturating adds, far above the
// memory roofline at decode. The compressed slabs are 5 bytes per kept
// weight (int8 value, int32 index), 2.5 bytes per dense weight at 8:16, so
// the bytes bound is 2.5x the dense one; the gather sorts tiles of
// L = bg * n_keep products instead of k_tile, n_keep/m of the dense work.
//
// What the design does about it (the dense kernel's structure):
// - One warp per output element n and 4 rows of x, each register kept in
//   a register across the warp's loop over the tiles.
// - The compressed row's values and indices for a chunk are loaded once
//   (each lane its E consecutive slots) and reused for the 4 rows.
// - Gather: each lane reads its x entries at g * m + index directly from
//   device memory (the 4 rows, at most 4 * K bytes, stay in L1). A slot
//   whose position is not below K reads nothing and counts as a zero
//   product: x is never read past its K columns, whatever the slab holds.
// - Expand: each warp owns a shared-memory buffer of one chunk (32 * E
//   ints, 8 KB a block at k_tile 256). It zeroes it, scatters the chunk's
//   kept values into it by atomicAdd (a padded (value 0, index 0) slot
//   adds nothing and never overwrites a kept value at index 0), and after
//   __syncwarp runs the dense kernel's body on it.
// - Groups past G and positions past K are masked with zeros in-kernel,
//   so ragged G, M, N and K need no host padding.

#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace {

using pqs::kRowsPerWarp;
using pqs::kWarpsPerBlock;

// Stream of one output row: sort tiles of tile_len kept slots, each
// zero-padded to 2^log2_seg elements (for policies other than
// sorted_tiled_seq, tile_len = 2^log2_seg and the stream is the kept slots
// in order).
template <int E, int LT>
__global__ void nm_gather_kernel(const int8_t* __restrict__ x,
                                 const int8_t* __restrict__ vals,
                                 const int32_t* __restrict__ idx,
                                 int32_t* __restrict__ out, int M, int N,
                                 int K, int G, int n_keep, int m_group,
                                 int policy, int acc_bits, int rounds,
                                 int tile_len, int log2_seg) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * kRowsPerWarp;
  if (n >= N) return;  // whole warp leaves together
  constexpr int C = 32 * E;  // stream elements per warp per chunk
  const int seg = 1 << log2_seg;
  const int kept = G * n_keep;
  const int len = ((kept + tile_len - 1) / tile_len) << log2_seg;
  const int8_t* vrow = vals + static_cast<int64_t>(n) * kept;
  const int32_t* irow = idx + static_cast<int64_t>(n) * kept;

  int acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0;

  for (int e0 = 0; e0 < len; e0 += C) {
    int wv[E];
    int pos[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int e = e0 + lane * E + r;
      const int in_tile = e & (seg - 1);
      const int q = (e >> log2_seg) * tile_len + in_tile;  // kept slot
      int w = 0;
      int p = 0;
      if (in_tile < tile_len && q < kept) {
        w = vrow[q];
        p = (q / n_keep) * m_group + irow[q];
        if (static_cast<unsigned>(p) >= static_cast<unsigned>(K)) w = 0;
      }
      wv[r] = w;
      pos[r] = w ? p : 0;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int m = m0 + i;
      if (m >= M) break;  // uniform across the warp
      const int8_t* xrow = x + static_cast<int64_t>(m) * K;
      int v[E];
#pragma unroll
      for (int r = 0; r < E; ++r)
        v[r] = wv[r] ? static_cast<int>(xrow[pos[r]]) * wv[r] : 0;
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

template <int E, int LT>
__global__ void nm_expand_kernel(const int8_t* __restrict__ x,
                                 const int8_t* __restrict__ vals,
                                 const int32_t* __restrict__ idx,
                                 int32_t* __restrict__ out, int M, int N,
                                 int K, int G, int n_keep, int m_group,
                                 int policy, int acc_bits, int rounds) {
  constexpr int C = 32 * E;  // dense positions per warp per chunk
  __shared__ int buf[kWarpsPerBlock][C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  const int m0 = blockIdx.y * kRowsPerWarp;
  if (n >= N) return;  // whole warp leaves together; no block barrier used
  const int kept = G * n_keep;
  const int8_t* vrow = vals + static_cast<int64_t>(n) * kept;
  const int32_t* irow = idx + static_cast<int64_t>(n) * kept;
  int* wb = buf[warp];

  int acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += C) {
#pragma unroll
    for (int r = 0; r < E; ++r) wb[lane * E + r] = 0;
    __syncwarp();
    // the groups that reach into [k0, k0 + C)
    const int s_end = min(G, (k0 + C + m_group - 1) / m_group) * n_keep;
    for (int s = (k0 / m_group) * n_keep + lane; s < s_end; s += 32) {
      const int w = vrow[s];
      if (w) {
        const int p = (s / n_keep) * m_group + irow[s] - k0;
        if (static_cast<unsigned>(p) < static_cast<unsigned>(C))
          atomicAdd(&wb[p], w);
      }
    }
    __syncwarp();
    int wv[E];
#pragma unroll
    for (int r = 0; r < E; ++r) wv[r] = wb[lane * E + r];
    __syncwarp();  // every lane has read the chunk before it is zeroed
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

struct Args {
  const int8_t* x;
  const int8_t* vals;
  const int32_t* idx;
  int32_t* out;
  int M, N, K, G, n_keep, m_group, policy, acc_bits, rounds;
  cudaStream_t s;

  dim3 grid() const {
    return dim3((N + kWarpsPerBlock - 1) / kWarpsPerBlock,
                (M + kRowsPerWarp - 1) / kRowsPerWarp);
  }
};

struct GatherLaunch {
  Args a;
  int tile_len, log2_seg;

  template <int E, int LT>
  void operator()() const {
    nm_gather_kernel<E, LT><<<a.grid(), 32 * kWarpsPerBlock, 0, a.s>>>(
        a.x, a.vals, a.idx, a.out, a.M, a.N, a.K, a.G, a.n_keep, a.m_group,
        a.policy, a.acc_bits, a.rounds, tile_len, log2_seg);
  }
};

struct ExpandLaunch {
  Args a;

  template <int E, int LT>
  void operator()() const {
    nm_expand_kernel<E, LT><<<a.grid(), 32 * kWarpsPerBlock, 0, a.s>>>(
        a.x, a.vals, a.idx, a.out, a.M, a.N, a.K, a.G, a.n_keep, a.m_group,
        a.policy, a.acc_bits, a.rounds);
  }
};

// cudaErrorInvalidValue for arguments the kernels do not take (the Python
// wrappers check them first), else 0.
int check(int M, int N, int K, int G, int n_keep, int m_group, int policy,
          int acc_bits, int k_tile) {
  if (policy < 0 || policy > 3 || acc_bits < 2 || acc_bits > 30 || K < 0 ||
      G < 0 || m_group < 1 || n_keep < 1 || n_keep > m_group ||
      static_cast<int64_t>(G) * m_group < K ||
      2 * static_cast<int64_t>(G) * n_keep + 1024 > INT32_MAX)
    return cudaErrorInvalidValue;
  if (policy == 3 && (k_tile < m_group || k_tile % m_group != 0))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

Args args(const void* x, const void* vals, const void* idx, void* out, int M,
          int N, int K, int G, int n_keep, int m_group, int policy,
          int acc_bits, int rounds, void* stream) {
  return Args{static_cast<const int8_t*>(x),
              static_cast<const int8_t*>(vals),
              static_cast<const int32_t*>(idx),
              static_cast<int32_t*>(out),
              M, N, K, G, n_keep, m_group, policy, acc_bits, rounds,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C entry points, loaded with ctypes. x (M, K) int8, values and
// indices (N, G, n_keep) int8 / int32 and out (M, N) int32 are contiguous
// device buffers. Each returns cudaGetLastError() after its launch.
extern "C" int pqs_nm_gather_seq_policy_matmul(
    const void* x, const void* vals, const void* idx, void* out, int M,
    int N, int K, int G, int n_keep, int m_group, int policy, int acc_bits,
    int rounds, int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int bad = check(M, N, K, G, n_keep, m_group, policy, acc_bits,
                        k_tile);
  if (bad) return bad;
  const Args a = args(x, vals, idx, out, M, N, K, G, n_keep, m_group, policy,
                      acc_bits, rounds, stream);
  if (policy != 3) return pqs::dispatch_tile(256, GatherLaunch{a, 256, 8});
  // one sort tile: the bg = k_tile / m groups of a dense k_tile tile
  const int tile_len = (k_tile / m_group) * n_keep;
  int log2_seg = 0;
  while ((1 << log2_seg) < tile_len) ++log2_seg;
  return pqs::dispatch_tile(1 << log2_seg,
                            GatherLaunch{a, tile_len, log2_seg});
}

extern "C" int pqs_nm_seq_policy_matmul(
    const void* x, const void* vals, const void* idx, void* out, int M,
    int N, int K, int G, int n_keep, int m_group, int policy, int acc_bits,
    int rounds, int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int bad = check(M, N, K, G, n_keep, m_group, policy, acc_bits,
                        k_tile);
  if (bad) return bad;
  const Args a = args(x, vals, idx, out, M, N, K, G, n_keep, m_group, policy,
                      acc_bits, rounds, stream);
  return pqs::dispatch_tile(policy == 3 ? k_tile : 256, ExpandLaunch{a});
}
