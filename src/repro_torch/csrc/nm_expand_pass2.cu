// nm_expand_pass2.cu: pass 2 of the two-pass `sorted_tiled` on N:M
// compressed weights, the expand twin (row 13), on nm_expand_sort.cu's
// rules for a compressed row: one kernel.
//
// Replaces:
//   nm_expand_paired_kernel<E, LT, kMerged> <- repro/kernels/
//     sorted_stream.py:nm_paired_accum_matmul (pass 2, fed the pairing
//     permutation; the Pallas _nm_paired_kernel: each slab expanded by
//     expand_nm_slab, then the dense tiles sorted, paired and added).
//
// Operands: x (M, K) int8; values (N, G, n_keep) int8 and indices
// (N, G, n_keep) int32 (pruning.nm_compress); perm (M, N, kp / k_tile)
// int32; kp >= K and kp >= G * m, whole k_tile tiles. A position's weight
// is the int32 scatter-add of the slots that name it (a value-0 slot and
// one whose index leaves its group add nothing), as expand_nm_slab's
// one-hot expansion builds it; positions at or past K, groups past G and
// the kp tail are zero products, masked in the kernel.
//
// What bounds it on this card: as for the gather twin (nm_sort_matmul.cu,
// row 14), the integer work of the pair sorts and the ordered saturating
// adds, far above the bytes bound at decode.
//
// What the design does about it:
// - A block (nm_expand_paired_kernel) takes one compressed row
//   and up to 4 rows of x (grid.y walks M in 4s), up to 16 / rows warps an
//   output, and builds what its rows share once. Before, a block per
//   output zeroed and scatter-added a 17.5 KB int16 row of K = 8960
//   weights and scanned it (int8_weights) 4 times a compressed row at
//   decode, then sorted dense tiles of 256 positions where the gather twin
//   sorts 128 kept keys. With at least one round the block builds the
//   row's merged slots instead (merge_slots: 4 bytes a kept slot, 17.5 KB
//   at w_out; a slot's position and, on the first slot of its group that
//   names it, the int16 sum of those slots' values; out-of-group slots and
//   the rest weight 0). Under expand's rules a group's expanded weights
//   are exactly its merged slots, so a k_tile tile has at most lc = (k_tile
//   / m) n_keep nonzero products, and with a round each sorted dense tile
//   is its merged products sorted, then zeros (the prefix property): the
//   gather twin's pass-2 body on the merged slots (tiles of next_pow2(lc),
//   128 at 8:16) gives the expanded row's register bit for bit. With no
//   round the dense interleave a0, b0, a1, b1 of two position-ordered
//   tiles is not the interleave of their merged products, so the block
//   expands the row once (2 K bytes) and its rows share it. Packed
//   int16x2 keys where every weight fits int8, else two int32 networks a
//   slot (a flag in shared memory).
// - This file is its own nvcc unit, so that its 44 pass-2 bodies (11 tile
//   sizes, two routes, packed and int32 networks) compile beside
//   nm_expand_sort.cu's in chip_smoke.py's parallel build.
// Pass 2 at w_out (M = 4, 8:16) takes 0.20 ms on the merged slots, 0.55
// with a row expanded per output, and the gather twin 0.18; merging the
// slots by the warp's shuffles instead of reading each slot's group from
// device memory took 0.21 to 0.20, and 2 rows of x a block (8 warps an
// output) 0.27 (chip_smoke.py phase 5 with --baseline-csrc and
// scripts/nm_sort_ab.py, NVIDIA H100 80GB HBM3, 700.00 W).

#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace {

using pqs::Slabs;
using pqs::slabs;
using pqs::valid_slabs;

constexpr int kRows = 4;          // rows of x a block serves
constexpr int kPassTwoWarps = 16;  // warps of a block

// Row n's merged slots (pass 2 with at least one round): ms[q] holds
// slot q's dense position in its low 16 bits and, in its high 16, the
// int16 sum of the values of the slots of its group that name that
// position, on the first of them; 0 (no product) on the others, on a slot
// of value 0, on one whose index leaves [0, m_group) and on one at or past
// K. So a group's expanded weights are its merged slots' (expand_slots'
// scatter-add, without the row). By the whole block, a lane a slot: where
// n_keep divides 32 a warp takes 32 slots, whole groups, and each lane
// reads its group's slots from its mates by shuffles; else it reads them
// from device memory. Returns, in every thread, whether a merged weight
// leaves int8 (never on canonical slabs). K <= 65536.
__device__ __forceinline__ bool merge_slots(uint32_t* ms,
                                            const int8_t* __restrict__ vr,
                                            const int32_t* __restrict__ ir,
                                            int kept, int K, int n_keep,
                                            int m_group) {
  __shared__ int any_wide;
  if (threadIdx.x == 0) any_wide = 0;
  bool wide = false;
  // slot q's word, given its group's slots by at(i) = (index, value), the
  // index -1 for a slot of value 0
  auto merged = [&](int q, int j, auto at) -> uint32_t {
    const int g = q / n_keep;
    const int pos = g * m_group + j;
    int sum = 0;
    bool first = true;
    for (int i = 0; i < n_keep; ++i) {
      const int2 s = at(i);
      if (s.x == j) {
        first &= g * n_keep + i >= q;
        sum += s.y;
      }
    }
    const bool live = static_cast<unsigned>(j) <
                          static_cast<unsigned>(m_group) && pos < K;
    if (!live || !first) return 0;
    wide |= sum != static_cast<int8_t>(sum);
    return static_cast<uint32_t>(pos) |
           (static_cast<uint32_t>(static_cast<uint16_t>(sum)) << 16);
  };
  if (32 % n_keep == 0) {
    const int lane = threadIdx.x & 31, lead = lane - lane % n_keep;
    for (int q0 = threadIdx.x & ~31; q0 < kept; q0 += blockDim.x) {
      const int q = q0 + lane;
      const int v = q < kept ? __ldg(vr + q) : 0;
      const int j = v ? __ldg(ir + q) : -1;
      const uint32_t word = merged(q, j, [&](int i) {
        return make_int2(__shfl_sync(pqs::kFull, j, lead + i),
                         __shfl_sync(pqs::kFull, v, lead + i));
      });
      if (q < kept) ms[q] = word;
    }
  } else {
    for (int q = threadIdx.x; q < kept; q += blockDim.x) {
      const int v = __ldg(vr + q);
      const int q0 = q - q % n_keep;
      ms[q] = merged(q, v ? __ldg(ir + q) : -1, [&](int i) {
        const int vi = __ldg(vr + q0 + i);
        return make_int2(vi ? __ldg(ir + q0 + i) : -1, vi);
      });
    }
  }
  // a flag in shared memory between plain barriers (expand_slots says why)
  __syncthreads();
  if (wide) any_wide = 1;
  __syncthreads();
  return any_wide != 0;
}

// The products of x's row m (x, K long) and a row's merged slots: tile
// t's slots [t * tile_len, + tile_len), zero past kept.
struct MergedProducts {
  const int8_t* x;
  const uint32_t* ms;
  int kept, tile_len;
  __device__ __forceinline__ int tile(int t, int j) const {
    const int q = t * tile_len + j;
    if (j >= tile_len || q >= kept) return 0;
    const uint32_t w = ms[q];
    return static_cast<int>(__ldg(x + (w & 0xffffu))) *
           static_cast<int>(static_cast<int16_t>(w >> 16));
  }
};

// Pass 2 (row 13): a block takes compressed row n and up to kRows rows of
// x (m0 = blockIdx.y * rows ..), wpo warps an output. kMerged (at least
// one round): the row's merged slots, sorted as tiles of S = E LT =
// next_pow2(lc); else the row expanded once into K int16 weights (dense
// tiles of S = k_tile: with no round the dense interleave is not the
// compacted one). Packed int16x2 keys where every weight fits int8, else
// int32 networks.
template <int E, int LT, bool kMerged>
__global__ void __launch_bounds__(32 * kPassTwoWarps)
    nm_expand_paired_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ val,
                            const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ perm,
                            int32_t* __restrict__ out, int M, int N, int K,
                            int G, int n_keep, int m_group, int T, int lc,
                            int acc_bits, int rounds, int rows_per_block,
                            int wpo) {
  __shared__ pqs::Clamp scratch[kPassTwoWarps];
  const int64_t n = blockIdx.x;
  const int m0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, M - m0);
  const int kept = G * n_keep;
  bool wide;
  uint32_t* ms = pqs::dynamic_smem<uint32_t>();
  int16_t* w = pqs::dynamic_smem<int16_t>();
  if constexpr (kMerged) {
    wide = merge_slots(ms, val + n * kept, idx + n * kept, kept, K, n_keep,
                       m_group);
  } else {
    pqs::expand_row(w, val, idx, n, K, G, n_keep, m_group);
    wide = !pqs::int8_weights(w, K);
  }
  const int warp = threadIdx.x >> 5, r = warp / wpo;
  if (r < rows) {
    const int64_t o = static_cast<int64_t>(m0 + r) * N + n;
    const int8_t* xr = x + static_cast<int64_t>(m0 + r) * K;
    const int* pr = perm + o * T;
    const int wi = warp - r * wpo;
    pqs::Clamp run;
    if constexpr (kMerged) {
      const MergedProducts p{xr, ms, kept, lc};
      run = wide ? pqs::paired_run<E, LT, false>(p, pr, T, wi, wpo, acc_bits,
                                                 rounds)
                 : pqs::paired_run<E, LT, true>(p, pr, T, wi, wpo, acc_bits,
                                                rounds);
    } else {
      const pqs::ExpandedProducts p{xr, w, K, E * LT};
      run = wide ? pqs::paired_run<E, LT, false>(p, pr, T, wi, wpo, acc_bits,
                                                 rounds)
                 : pqs::paired_run<E, LT, true>(p, pr, T, wi, wpo, acc_bits,
                                                rounds);
    }
    if ((threadIdx.x & 31) == 0) scratch[warp] = run;
  }
  __syncthreads();
  if (r < rows && warp == r * wpo && (threadIdx.x & 31) == 0) {
    pqs::Clamp f = scratch[warp];
    for (int i = 1; i < wpo; ++i) f = pqs::clamp_then(f, scratch[warp + i]);
    out[static_cast<int64_t>(m0 + r) * N + n] = pqs::clamp_apply(f, 0);
  }
}

size_t row_smem(int K) { return sizeof(int16_t) * static_cast<size_t>(K); }

// Shared memory of pass 2's merged slots: 4 bytes a kept slot.
size_t merged_smem(int kept) { return 4 * static_cast<size_t>(kept); }

struct PairedLaunch {
  Slabs a;
  const int32_t* perm;
  int32_t* out;
  int T, lc, acc_bits, rounds;
  bool merged;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    if (merged)
      launch<E, LT, true>(merged_smem(a.G * a.n_keep));
    else
      launch<E, LT, false>(row_smem(a.K));
  }

  template <int E, int LT, bool kMerged>
  void launch(size_t smem) const {
    const int rows = a.M < kRows ? a.M : kRows;
    const int wpo =
        pqs::paired_threads(T, E * LT, kPassTwoWarps / rows) / 32;
    auto* kernel = nm_expand_paired_kernel<E, LT, kMerged>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    kernel<<<dim3(a.N, (a.M + rows - 1) / rows), 32 * rows * wpo, smem, s>>>(
        a.x, a.val, a.idx, perm, out, a.M, a.N, a.K, a.G, a.n_keep,
        a.m_group, T, lc, acc_bits, rounds, rows, wpo);
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes, with the arguments of
// nm_sort_matmul.cu's pqs_nm_gather_paired_accum. x (M, K) int8, values
// and indices (N, G, n_keep) int8 / int32, perm (M, N, kp/k_tile) int32
// and out (M, N) int32 are contiguous device buffers. Returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments the kernel does not take, shared memory above pqs::kSmemCap
// included (the Python wrapper checks first).
extern "C" int pqs_nm_expand_paired_accum(const void* x, const void* val,
                                          const void* idx, const void* perm,
                                          void* out, int M, int N, int K,
                                          int G, int n_keep, int m_group,
                                          int kp, int acc_bits, int rounds,
                                          int k_tile, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const Slabs a = slabs(x, val, idx, M, N, K, G, n_keep, m_group);
  if (k_tile <= 0 || !valid_slabs(a, kp, k_tile) || acc_bits < 2 ||
      acc_bits > 30 || rounds < 0 || row_smem(K) > pqs::kSmemCap ||
      (M + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  // with a round, the merged slots where they fit (they hold positions in
  // 16 bits: K <= 65536, as row_smem's cap makes it)
  const int lc = (k_tile / m_group) * n_keep;
  const bool merged =
      rounds > 0 && merged_smem(G * n_keep) <= pqs::kSmemCap;
  const PairedLaunch launch{a, static_cast<const int32_t*>(perm),
                            static_cast<int32_t*>(out), kp / k_tile, lc,
                            acc_bits, rounds, merged,
                            static_cast<cudaStream_t>(stream)};
  return pqs::dispatch_tile(merged ? pqs::next_pow2(lc) : k_tile, launch);
}
