// nm_expand_sort.cu: the PQS global-sort policies (`sorted`,
// `sorted_tiled`) on N:M compressed weights, each compressed row expanded
// to its dense positions in shared memory; the expand twins of
// nm_sort_matmul.cu's gather kernels but pass 2.
//
// Replaces:
//   nm_expand_sorted_kernel <- repro/kernels/nm_spmm.py:nm_sort_matmul
//     under `sorted` (the Pallas _nm_sort_kernel: expand_nm_slab, then
//     _sort_body over kp), and repro/kernels/sorted_stream.py:
//     nm_chunked_sort_matmul (`sorted` at long K, _nm_chunked_sort_kernel):
//     one block holds all kp keys of an output up to 65536, so the TPU's
//     VMEM split into two kernels does not carry over, as for the dense
//     sort_matmul.cu;
//   nm_expand_tiled_kernel  <- nm_sort_matmul under `sorted_tiled`;
//   nm_sums_few_rows_kernel<RG, P2, true>,
//   nm_sums_many_rows_kernel<P2, true> (nm_tile_sums.cuh) and, for tiles
//   above its kMaxTile = 1024 positions, nm_expand_tile_sums_kernel <-
//     repro/kernels/sorted_stream.py:nm_tile_sums_matmul (pass 1 of the
//     two-pass `sorted_tiled`, the Pallas _nm_tile_sums_kernel: each
//     (bn, bg, n_keep) slab expanded by expand_nm_slab in int32, then an
//     int32 dot_general a tile);
//   pass 2 (nm_paired_accum_matmul) is nm_expand_pass2.cu's.
//
// Operands: x (M, K) int8; values (N, G, n_keep) int8 and indices
// (N, G, n_keep) int32 (pruning.nm_compress); kp >= K and kp >= G * m is the
// padded K of the dense path (a power of two for `sorted`, whole k_tile
// tiles for `sorted_tiled`). The kernels read the slabs from device memory
// and rebuild the dense weight in shared memory by nm_decompress's
// scatter-add (pqs_accum.cuh expand_slots): a position's weight is the sum
// of the slots that name it, and a value-0 slot adds nothing, so a padded
// slot (value 0, index 0) never disturbs a kept value at position 0 of its
// group; a slot whose index leaves its group adds nothing, as the
// reference's one-hot expansion drops it. Positions at or past K, groups
// past G and the kp tail are zero products, masked in the kernel, so
// neither x nor the slabs are padded or copied on the host. The product
// stream is then the dense kernels' own, and so is the result, bit for
// bit, through the dense bodies of pqs_accum.cuh (sorted_dot,
// sorted_tiled_dot, paired_dot, warp_tile_sum).
//
// What bounds it on this card: as for the dense kernels (sort_matmul.cu,
// sorted_stream.cu), the integer work of sorting the dense stream and of
// the ordered saturating adds, far above the bytes bound at decode; the
// bytes are the gather twins' (5 bytes of slab a kept weight). Expanding
// sorts the whole dense stream, m / n_keep times the gather's work: twice
// at 8:16.
//
// The expansion target, and the shared memory it takes:
// - `sorted`: the keys x[pos] * value are written straight into int16
//   keys in shared memory (zeroed first; a value-0 slot writes nothing):
//   the kp keys of the dense kernel's register network (sorted_dot, the
//   SharedKeys loader; 2 kp bytes, 4 KB at kp = 2048, 128 KB at
//   MAX_STREAM_K = 65536, pqs::kSmemCap, which its cross-warp exchange
//   reuses) on one warp up to kp = 2048 and 16 at 65536; in between the
//   K keys of the radix body (radix_sorted_dot) beside its second buffer
//   and control block. On canonical slabs the keys are exact, products of
//   int8 carriers in [-16256, 16384]. Where slots name one position
//   several times (expand_slots reports an add onto a nonzero key) the
//   sum may leave int16: that block rebuilds the row's weights over the
//   keys and sorts int32 keys x w with the radix body in a slot of a
//   device-memory pool (expand_sorted_wide; nm_spmm.expand_scratch, a
//   slot a streaming multiprocessor, claimed by atomics), at every kp, as
//   the JAX kernel's int32 expansion adds them. The flag costs the int16
//   routes nothing (reduced through shared memory: __syncthreads_or cost
//   the one-warp kernel 6-12%).
// - `sorted_tiled` one-pass: the compressed row expanded into an int16 row
//   of K weights beside the T tile sums and the pairing (8 T + 2 K bytes:
//   3 KB at K = 1536; the wrapper refuses above 128 KB), then the dense
//   body on x and the row; up to 4 warps, one per pair slot. A row whose
//   weights are all int8 (canonical slabs always) sorts each pair slot as
//   packed int16x2 keys; a row where several slots name one position may
//   hold a weight past int8, whose products leave the int16 range, and
//   keeps two int32 networks a slot (pqs::int8_weights decides a block).
// At decode (M = 4, 8:16) over the six K = 1536 sites `sorted` takes 1.13
// ms and `sorted_tiled` 1.30 (6.38 and 2.04 before the register body and
// the packed pairs); at w_out `sorted` 0.84 (5.18) (chip_smoke.py phase 5
// with --baseline-csrc, NVIDIA H100 80GB HBM3, 700.00 W). Expanding costs
// 0.29 ms over the dense kernel's `sorted` and 0.55 over its
// `sorted_tiled` on the same dot. The radix body takes the w_out `sorted`
// (kp 16384) to 0.43 ms (0.84 on the network).
// - Pass 1: a sum of raw products in int32, with no clipping, so the
//   kept slots need not be expanded at all: for any slabs, canonical or
//   not, the sum over the slots of x[pos] * value is x times the int32
//   scatter-add of the slots. Up to k_tile 1024 it runs the gather twin's
//   pass-1 body (nm_tile_sums.cuh, one copy for both) with expand's rule
//   for a slot whose index lies outside its group: value zeroed, position
//   clamped into the tile, so its quad stays on the fast path where the
//   gather twin reads x where it points. The body reads each kept slot
//   once for all rows of x from a block's tile of x staged transposed in
//   shared memory (nm_tile_sums.cuh says what bounds it). Longer tiles
//   keep the first body: one warp per (n, tile) expands 256 dense
//   positions of the tile at a time into its own int16 buffer (512 bytes a
//   warp, 4 KB a block), then, for each row of x, its lanes take
//   consecutive positions (x read coalesced) and reduce by shuffles; it
//   expands the slabs once per tile and walks the rows of x one at a time.
//   At w_out (8:16, k_tile 256) the shared body takes 0.0268 ms at M = 4
//   and 0.2015 at M = 128, the one-warp body 0.0816 / 1.1528, a float32
//   bmm of the same sums on the decompressed weight 0.0343 / 0.0977
//   (chip_smoke.py phase 5 with --baseline-csrc, NVIDIA H100 80GB HBM3,
//   700.00 W).
// int16 weights hold the scatter-add of up to 258 int8 values exactly
// (canonical slabs: one).

#include <cstdint>
#include <cuda_runtime.h>

#include "nm_tile_sums.cuh"
#include "pqs_accum.cuh"

namespace {

using pqs::Slabs;
using pqs::slabs;
using pqs::valid_slabs;

constexpr int kTiledWarps = 4;
constexpr int kSumThreads = 256;
constexpr int kSumChunk = 256;  // dense positions a pass-1 warp expands

// The `sorted` kernel's shared memory: in the radix regime the radix
// control block and two buffers of K int16 keys; else the L = 64 W E
// int16 keys of the register network, whose cross-warp exchange at kp
// 65536 reuses them. The int32 route takes no more of it: its control
// block and buffers lie in its pool slot.
template <int E, int W>
__host__ __device__ constexpr size_t expand_sorted_smem(int K) {
  if constexpr (pqs::radix_regime(E, W))
    return sizeof(int) * pqs::radix_ctl_ints(W) +
           2 * pqs::radix_buffer_bytes(K, 2);
  return pqs::radix_buffer_bytes(64 * W * E, 2);
}

// A slot of the int32 route's pool: the radix control block of up to 16
// warps, then two buffers of K keys, rounded to 16 bytes
// (nm_spmm.expand_scratch sizes the pool to match).
constexpr int kPoolCtlInts = pqs::radix_ctl_ints(16);
static_assert(kPoolCtlInts % 4 == 0, "the control block is 16-byte aligned");

__host__ __device__ constexpr int64_t pool_slot_ints(int K) {
  return kPoolCtlInts + ((2 * static_cast<int64_t>(K) + 3) & ~int64_t{3});
}

// The `sorted` kernel's route for a row whose keys may leave int16 (two
// slots at one position): the row's weights (their sums, in int16) over
// the keys, then int32 keys in a slot of the device pool.
template <int W>
__device__ __forceinline__ int expand_sorted_wide(
    const int8_t* x, const int8_t* val, const int32_t* idx, int16_t* w,
    pqs::Clamp* scratch, int32_t* pool, int* busy, int slots, int* held,
    int64_t n, int K, int G, int n_keep, int m_group, int acc_bits,
    int rounds) {
  pqs::expand_row(w, val, idx, n, K, G, n_keep, m_group);
  const int s = pqs::claim_slot(busy, slots, held);
  int32_t* ctl = pool + pool_slot_ints(K) * s;
  int32_t* a = ctl + kPoolCtlInts;
  const int r = pqs::radix_sorted_dot<int32_t, W>(
      pqs::ExpandedProducts{x, w, K, 0}, K, a, a + K, ctl, scratch, acc_bits,
      rounds);
  pqs::release_slot(busy, s);
  return r;
}

template <int E, int W>
__global__ void __launch_bounds__(32 * W)
    nm_expand_sorted_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ val,
                            const int32_t* __restrict__ idx,
                            int32_t* __restrict__ pool, int* __restrict__ busy,
                            int32_t* __restrict__ out, int N, int K, int G,
                            int n_keep, int m_group, int acc_bits, int rounds,
                            int slots) {
  constexpr bool kRadix = pqs::radix_regime(E, W);
  __shared__ pqs::Clamp scratch[2 * W];
  __shared__ int held;
  unsigned char* smem = pqs::dynamic_smem<unsigned char>();
  int* ctl = reinterpret_cast<int*>(smem);
  auto* keys = reinterpret_cast<int16_t*>(
      kRadix ? smem + sizeof(int) * pqs::radix_ctl_ints(W) : smem);
  const int64_t o = blockIdx.x;
  const int64_t m = o / N, n = o % N;
  const int64_t kept = static_cast<int64_t>(G) * n_keep;
  const int len = kRadix ? K : 64 * W * E;
  // the keys x * value straight from the slots; an add onto a nonzero key
  // (two slots at one position) may leave int16
  const bool wide = pqs::expand_slots<false>(
      keys, len, 0, x + m * K, val + n * kept, idx + n * kept, 0,
      G * n_keep, K, n_keep, m_group, threadIdx.x, blockDim.x);
  int r;
  if (!wide) {
    if constexpr (kRadix)
      r = pqs::radix_sorted_dot<int16_t, W>(
          pqs::SharedKeys{keys}, K, keys,
          keys + pqs::radix_buffer_bytes(K, 2) / 2, ctl, scratch, acc_bits,
          rounds);
    else
      r = pqs::sorted_dot<E, W>(pqs::SharedKeys{keys},
                                reinterpret_cast<uint32_t*>(keys), scratch,
                                acc_bits, rounds);
  } else {
    r = expand_sorted_wide<W>(x + m * K, val, idx, keys, scratch, pool, busy,
                              slots, &held, n, K, G, n_keep, m_group,
                              acc_bits, rounds);
  }
  if (threadIdx.x == 0) out[o] = r;
}

template <int E, int LT>
__global__ void nm_expand_tiled_kernel(const int8_t* __restrict__ x,
                                       const int8_t* __restrict__ val,
                                       const int32_t* __restrict__ idx,
                                       int32_t* __restrict__ out, int N,
                                       int K, int G, int n_keep, int m_group,
                                       int T, int acc_bits, int rounds) {
  __shared__ pqs::Clamp scratch[kTiledWarps];
  int* sums = pqs::dynamic_smem<int>();
  int16_t* w = reinterpret_cast<int16_t*>(sums + 2 * T);
  const int64_t o = blockIdx.x;
  const int64_t m = o / N, n = o % N;
  pqs::expand_row(w, val, idx, n, K, G, n_keep, m_group);
  const pqs::ExpandedProducts p{x + m * K, w, K, E * LT};
  const int r =
      pqs::int8_weights(w, K)
          ? pqs::sorted_tiled_dot<E, LT, true>(p, sums, sums + T, T, scratch,
                                               acc_bits, rounds)
          : pqs::sorted_tiled_dot<E, LT, false>(p, sums, sums + T, T,
                                                scratch, acc_bits, rounds);
  if (threadIdx.x == 0) out[o] = r;
}

__global__ void nm_expand_tile_sums_kernel(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ val,
                                           const int32_t* __restrict__ idx,
                                           int32_t* __restrict__ out, int M,
                                           int N, int K, int G, int n_keep,
                                           int m_group, int T, int k_tile) {
  __shared__ int16_t buf[kSumThreads / 32][kSumChunk];
  const int lane = threadIdx.x & 31;
  const int64_t nt = static_cast<int64_t>(blockIdx.x) * (kSumThreads / 32) +
                     (threadIdx.x >> 5);
  if (nt >= static_cast<int64_t>(N) * T) return;  // whole warp leaves
  const int64_t n = nt / T;
  const int t = static_cast<int>(nt % T);
  const int64_t kept = static_cast<int64_t>(G) * n_keep;
  const int8_t* vrow = val + n * kept;
  const int32_t* irow = idx + n * kept;
  int16_t* w = buf[threadIdx.x >> 5];
  const int t0 = t * k_tile;
  const int end = min(t0 + k_tile, K);  // the tile's positions before K
  if (end <= t0) {
    if (lane == 0)
      for (int64_t m = 0; m < M; ++m) out[(m * N + n) * T + t] = 0;
    return;
  }
  const int len = min(k_tile, kSumChunk);
  for (int c0 = t0; c0 < end; c0 += len) {
    // the slots of the groups that reach into [c0, c0 + len)
    const int q0 = min(G, c0 / m_group) * n_keep;
    const int q1 = min(G, (c0 + len + m_group - 1) / m_group) * n_keep;
    pqs::expand_slots<true>(w, len, c0, nullptr, vrow, irow, q0, q1, K,
                            n_keep, m_group, lane, 32);
    for (int64_t m = 0; m < M; ++m) {
      const pqs::ExpandedProducts p{x + m * K + c0, w, end - c0, len};
      const int s = pqs::warp_tile_sum(p, 0);
      if (lane == 0) {
        int32_t* o = out + (m * N + n) * T + t;
        *o = (c0 == t0 ? 0 : *o) + s;
      }
    }
    __syncwarp();  // every lane has read the chunk before it is zeroed
  }
}

// Shared memory of the tiled kernels: 2 T ints (sums, perm) for the
// one-pass one, then the int16 row of K weights.
size_t tiled_smem(int T, int K) {
  return 2 * sizeof(int) * static_cast<size_t>(T) +
         sizeof(int16_t) * static_cast<size_t>(K);
}


struct SortedLaunch {
  Slabs a;
  int32_t* pool;
  int* busy;
  int32_t* out;
  int acc_bits, rounds, slots;
  cudaStream_t s;

  template <int E, int W>
  void operator()() const {
    pqs::launch_smem(nm_expand_sorted_kernel<E, W>,
                     static_cast<int64_t>(a.M) * a.N, 32 * W,
                     expand_sorted_smem<E, W>(a.K), s, a.x, a.val, a.idx,
                     pool, busy, out, a.N, a.K, a.G, a.n_keep, a.m_group,
                     acc_bits, rounds, slots);
  }
};

struct TiledLaunch {
  Slabs a;
  int32_t* out;
  int T, acc_bits, rounds;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    pqs::launch_smem(nm_expand_tiled_kernel<E, LT>,
                     static_cast<int64_t>(a.M) * a.N,
                     pqs::paired_threads(T, E * LT, kTiledWarps),
                     tiled_smem(T, a.K), s, a.x, a.val, a.idx, out, a.N, a.K,
                     a.G, a.n_keep, a.m_group, T, acc_bits, rounds);
  }
};

}  // namespace

// Plain C entry points, loaded with ctypes, with the arguments of
// nm_sort_matmul.cu's gather entry points. x (M, K) int8, values and
// indices (N, G, n_keep) int8 / int32, perm (M, N, kp/k_tile) int32 and the
// outputs ((M, N) registers, (M, N, kp/k_tile) sums, int32) are contiguous
// device buffers. Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments the kernel does not take, shared
// memory above pqs::kSmemCap included (the Python wrappers check first).

// policy 0: sorted (kp a power of two), 1: sorted_tiled (k_tile the sort
// tile, a power of two up to 1024).
// Under `sorted`, pool (slots * pool_slot_ints(K) int32) and busy
// (slots int32, zero between launches) are the int32 route's scratch;
// sorted_tiled reads neither.
extern "C" int pqs_nm_expand_sort_matmul(const void* x, const void* val,
                                         const void* idx, void* pool,
                                         void* busy, void* out, int M, int N,
                                         int K, int G, int n_keep,
                                         int m_group, int kp, int policy,
                                         int acc_bits, int rounds, int k_tile,
                                         int slots, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const Slabs a = slabs(x, val, idx, M, N, K, G, n_keep, m_group);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (acc_bits < 2 || acc_bits > 30 || rounds < 0 || kp <= 0)
    return cudaErrorInvalidValue;
  if (policy == 0) {
    if (!valid_slabs(a, kp, 0) || (kp & (kp - 1)) || slots < 1 || !pool ||
        !busy)
      return cudaErrorInvalidValue;
    return pqs::dispatch_sorted(
        kp, SortedLaunch{a, static_cast<int32_t*>(pool),
                         static_cast<int*>(busy), op, acc_bits, rounds,
                         slots, s});
  }
  if (policy != 1 || k_tile <= 0 || !valid_slabs(a, kp, k_tile) ||
      tiled_smem(kp / k_tile, K) > pqs::kSmemCap)
    return cudaErrorInvalidValue;
  return pqs::dispatch_tile(
      k_tile, TiledLaunch{a, op, kp / k_tile, acc_bits, rounds, s});
}

// Tiles up to nmsums::kMaxTile positions run nm_tile_sums.cuh's body with
// expand's drop rule, longer ones nm_expand_tile_sums_kernel
// (kernels/sorted_stream.py nm_expand_tile_sums_body names the same
// choice).
extern "C" int pqs_nm_expand_tile_sums(const void* x, const void* val,
                                       const void* idx, void* out, int M,
                                       int N, int K, int G, int n_keep,
                                       int m_group, int kp, int k_tile,
                                       void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const Slabs a = slabs(x, val, idx, M, N, K, G, n_keep, m_group);
  if (k_tile <= 0 || !valid_slabs(a, kp, k_tile))
    return cudaErrorInvalidValue;
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k_tile <= nmsums::kMaxTile)
    return nmsums::tile_sums<true>(a, o, kp, k_tile, s);
  const int T = kp / k_tile;
  const int64_t warps = static_cast<int64_t>(N) * T;
  const int64_t blocks = (warps + kSumThreads / 32 - 1) / (kSumThreads / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  nm_expand_tile_sums_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                               s>>>(a.x, a.val, a.idx, o, M, N, K, G, n_keep,
                                    m_group, T, k_tile);
  return cudaGetLastError();
}
