// sorted_stream.cu: the two-pass sorted_tiled pipeline for long K: pass 1
// (two bodies) and pass 2.
//
// Replaces:
//   pqs_tile_sums (mma8::mma_kernel with the TileSums epilogue, or
//   tile_sums_small_kernel) <- repro/kernels/sorted_stream.py:
//     tile_sums_matmul (pass 1 of sorted_tiled: the (M, N, kp/k_tile)
//     int32 sums of each output's k_tile tiles);
//   paired_rows_kernel <- repro/kernels/sorted_stream.py:paired_accum_matmul
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
//   (sort_matmul.cu): integer instructions, which an SM issues for 64
//   lanes a clock, half its rate for other instructions.
// The TPU's VMEM budgets (the bn-chunk of the product cube, CUBE_BUDGET,
// and the resident int8 slabs) do not carry over: a pass-2 block holds one
// weight row and up to 4 rows of x.
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
// - paired_rows_kernel (pass 2), on the block body of pass2.cuh: a block
//   takes weight row n and up to 4 rows of x (grid (N, ceil(M / 4))),
//   stages the weight row (16-byte loads) and the rows' perm in shared
//   memory once, and splits the rows' pair slots, two a warp step (a tile
//   on 16 lanes of 16 products, read as 16-byte words), over up to 8 warps
//   in contiguous runs. With a round each slot sorts only its nonzero
//   products: the warp counts them, and where no tile of the step holds
//   more than half its positions it compacts them through shared memory
//   onto the 64- or 128-key packed network instead of the 256-key one
//   (the served weight, 8:16-pruned and stored dense, always does). The
//   network holds an ascending lane's keys complemented, so no
//   compare-exchange inside a lane selects, and the saturating adds use
//   Hopper's add-then-max. Before it one block of up to 8 warps took one
//   output and read each product as two bytes, the weight row once a row
//   of x, and sorted every slot on the 256-key network.
//   At w_out at decode (M = 4) it takes 0.1775 ms on a random weight and
//   0.1238 on the weight as served, 0.285 for both before; at a prefill
//   cohort (M = 128) 5.25 and 3.49, 8.69 before. At decode a tile on 32
//   lanes took 0.1973 / 0.1388, on 8 lanes 0.2244 / 0.1528, 16 warps a
//   block 0.1836 / 0.1315, the directions as selects 0.2438 / 0.1535, the
//   adds without add-then-max 0.1816 / 0.1341, and every tile on the
//   256-key network 0.1686 / 0.1687: counting the nonzero products costs
//   a random weight 5% (chip_smoke.py phase 5 with --baseline-csrc and
//   scripts/pass2_ab.py, NVIDIA H100 80GB HBM3, 700.00 W).

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "pass2.cuh"
#include "pqs_accum.cuh"

namespace {

constexpr int kSumThreads = 256;
constexpr int kPairLanes = 16;  // lanes a pass-2 sort tile: 2 a warp
constexpr int kPairWarps = 8;   // warps a pass-2 block at most

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

// The arguments of paired_rows_kernel and its shared memory (byte
// offsets): the weight row staged (K bytes, where it fits), the block's
// rows of perm (where they fit), the warps' compaction buffers.
struct PairedArgs {
  const int8_t* x;
  const int8_t* w;
  const int32_t* perm;
  int32_t* out;
  int M, N, K, k_tile, T, acc_bits, rounds;
  int xa, wa;             // alignment of x's rows, of w's rows in memory
  int perm_at, buf_at;    // offsets; -1 for w or perm left in memory
  bool stage_w;
  int smem;
};

// Pass 2 (row 12): a block takes weight row n = blockIdx.x and up to
// kRows rows of x (m0 = blockIdx.y * kRows ..), stages the weight row and
// the rows' perm in shared memory and runs pass2::block_rows on the dense
// products, sorted on their nonzero products (kCompact).
// dst[0 .. len) = src[0 .. len) by the block (dst 16-byte aligned, src
// aligned to `align`), by the widest loads the alignment allows.
__device__ __forceinline__ void stage_bytes(unsigned char* dst,
                                            const int8_t* src, int len,
                                            int align) {
  int done = 0;
  if (align >= 16) {
    done = len & ~15;
    for (int i = threadIdx.x; i < (len >> 4); i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
  } else if (align >= 4) {
    done = len & ~3;
    for (int i = threadIdx.x; i < (len >> 2); i += blockDim.x)
      reinterpret_cast<uint32_t*>(dst)[i] =
          __ldg(reinterpret_cast<const uint32_t*>(src) + i);
  }
  for (int i = done + threadIdx.x; i < len; i += blockDim.x)
    dst[i] = static_cast<unsigned char>(src[i]);
}

template <int E, int LT>
__global__ void __launch_bounds__(32 * kPairWarps)
    paired_rows_kernel(PairedArgs a) {
  __shared__ pqs::Clamp acc[kPairWarps * pass2::kRows];
  unsigned char* smem = pqs::dynamic_smem<unsigned char>();
  const int64_t n = blockIdx.x;
  const int m0 = blockIdx.y * pass2::kRows;
  const int rows = min(pass2::kRows, a.M - m0);
  const int8_t* wr = a.w + n * a.K;
  if (a.stage_w) {
    stage_bytes(smem, wr, a.K, a.wa);
    wr = reinterpret_cast<const int8_t*>(smem);
  }
  const int32_t* pm = a.perm + (static_cast<int64_t>(m0) * a.N + n) * a.T;
  int64_t pstride = static_cast<int64_t>(a.N) * a.T;
  if (a.perm_at >= 0) {
    int* ps = reinterpret_cast<int*>(smem + a.perm_at);
    for (int k = threadIdx.x; k < rows * a.T; k += blockDim.x) {
      const int r = k / a.T;
      ps[k] = __ldg(pm + r * pstride + (k - r * a.T));
    }
    pm = ps;
    pstride = a.T;
  }
  __syncthreads();
  const pass2::DenseRows load{a.x + static_cast<int64_t>(m0) * a.K, wr, a.K,
                              a.k_tile, a.xa, a.stage_w ? 16 : a.wa};
  pass2::block_rows<E, LT, true>(
      load, pass2::PermRows{pm, pstride}, rows, a.T, acc,
      reinterpret_cast<uint32_t*>(smem + a.buf_at), a.acc_bits, a.rounds);
  if (threadIdx.x < rows)
    a.out[static_cast<int64_t>(m0 + threadIdx.x) * a.N + n] =
        pass2::rows_register(acc, threadIdx.x, blockDim.x >> 5);
}

// The alignment (1, 4, 8 or 16 bytes) of every row of a (rows, K) int8
// array at p.
int row_align(const void* p, int K) {
  const auto bits = reinterpret_cast<uintptr_t>(p) |
                    static_cast<uintptr_t>(K) | 16;
  const int a = static_cast<int>(bits & (~bits + 1));
  return a >= 4 ? a : 1;
}

struct PairedLaunch {
  PairedArgs a;
  cudaStream_t s;

  template <int E, int LT>
  void operator()() const {
    PairedArgs b = a;
    const int rows = b.M < pass2::kRows ? b.M : pass2::kRows;
    const int steps = ((b.T + 1) / 2 + 32 / LT - 1) / (32 / LT);
    const int warps = pass2::balanced_warps(rows * steps, kPairWarps);
    // the weight row and perm in shared memory where they fit, perm first
    // given up, then the weight row
    const int buf = 4 * warps * pass2::buffer_words(E * LT, LT);
    const int wbytes = pass2::round16(b.K);
    const int pbytes = pass2::round16(4 * static_cast<int64_t>(rows) * b.T);
    const int cap = static_cast<int>(pqs::kSmemCap);
    b.stage_w = wbytes + buf <= cap;
    const int at = b.stage_w ? wbytes : 0;
    b.perm_at = at + pbytes + buf <= cap ? at : -1;
    b.buf_at = at + (b.perm_at >= 0 ? pbytes : 0);
    b.smem = b.buf_at + buf;
    auto* kernel = paired_rows_kernel<E, LT>;
    if (b.smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           b.smem);
    kernel<<<dim3(b.N, (b.M + pass2::kRows - 1) / pass2::kRows), 32 * warps,
             b.smem, s>>>(b);
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
      rounds < 0 || !valid_blocks(M, N) ||
      (M + pass2::kRows - 1) / pass2::kRows > 65535)
    return cudaErrorInvalidValue;
  PairedArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const int32_t*>(perm), static_cast<int32_t*>(out),
               M, N, K, k_tile, kp / k_tile, acc_bits, rounds,
               row_align(x, K), row_align(w, K)};
  return pass2::dispatch<kPairLanes>(
      k_tile, PairedLaunch{a, static_cast<cudaStream_t>(stream)});
}
