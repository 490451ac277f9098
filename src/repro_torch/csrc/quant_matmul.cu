// quant_matmul.cu: the wide int8 matmuls for Hopper on the int8 tensor
// cores, quant_matmul (dense (K, N) weight) and nm_spmm (N:M compressed
// weight). quant_matmul runs a TMA-fed kernel of its own where TMA takes
// its operands and, elsewhere, a loader of the pipelined mainloop of
// int8_mma.cuh, as nm_spmm does (seq_policy_matmul.cu's policy wide runs
// that mainloop with a third loader, dense (N, K) rows).
//
// Replaces:
//   kn_tma_kernel<MN, kSplit> (N and K multiples of 16, both operands
//   16-byte aligned) and mma_kernel<MT, KnRows> (any other operands) <-
//     repro/kernels/quant_matmul.py:quant_matmul (the Pallas _kernel: an
//     int32 dot_general of each (bm, bk) x (bk, bn) block pair, the output
//     block revisited along the K grid axis); kernels/quant_matmul.py
//     quant_matmul_body names the body from the shapes and addresses;
//   mma_kernel<MT, NmChunks / NmBytes> <- repro/kernels/nm_spmm.py:nm_spmm
//     (the Pallas _kernel: each (bn, bg, n_keep) slab expanded by
//     expand_nm_slab, then the same dot).
//
// Both compute out[m, n] = sum_k x[m, k] * w[k, n] in int32 as an int32
// dot_general does (int8_mma.cuh says how the sum wraps). Operands: x
// (M, K) int8; quant_matmul's w (K, N) int8, in-by-out (the layout of
// QTensor.values, unlike the (N, K) weights of the policy kernels);
// nm_spmm's values / indices (N, G, n_keep) int8 / int32 with K <= G *
// m_group. Rows past M, columns past N and positions past K are masked in
// the kernel and groups past G do not exist, so nothing is padded on the
// host.
//
// nm_spmm's weight is the slabs' expanded sums, as the reference's one-hot
// expansion makes it: a slot whose index lies outside its group adds
// nothing, and slots that name one position add in int32. Its loaders
// (nm_chunks.cuh: NmChunks where m_group divides 16, else NmBytes) build
// each slab's bytes in shared memory from the values and indices; where
// two nonzero slots name one position (never on canonical slabs) the sum
// may leave int8, and that block's build flags it, so the block takes
// the exact int32 sums of its outputs from the slots instead of the
// tensor cores' (nm_chunks.cuh says how), where a byte of the tile would
// wrap the sum modulo 2^8.
//
// KnRows (quant_matmul), the loader of this file: the (K, N) slab as 4 x 4
// byte blocks (one 32-bit word of 4 columns from each of 4 rows of K),
// copied by cp.async into the ring two or three slabs ahead and transposed
// by byte permutes (prmt) into (N, K) rows over K (the mma's .col B
// operand), one slab ahead, by the thread that copied them: integer mma
// exists only as .row.col, and ldmatrix .trans moves only 16-bit elements
// on sm_90. Positions at or past K multiply x's zero fill, so no loader
// masks them.
//
// What bounds it on this card: device memory. At decode (M = 4) a weight
// byte feeds 8 operations, and at M = 128 256, both below the ~590 a byte
// at which the int8 tensor cores (1979 TOP/s over 3.35 TB/s) become the
// limit: the weight's bytes (5 a kept value when compressed) are the
// bound. The ring keeps two (decode) or three slabs' copies in flight
// while the tensor cores work on one; nm_spmm's build of the slab's bytes
// is integer work on top (a kept value sets a nibble of a byte-permute
// selector and a bit of a mask, then a chunk takes 4 permutes), paid once
// per block and slab whatever M. KnRows' 4-byte copies (1024 for a 4 KB
// slab), its separate transpose pass and its 3-4 stages of 4 KB a block
// left few bytes in flight: quant_matmul took 1.2-2x torch._int_mm.
//
// quant_matmul's TMA-fed kernel (kn namespace) answers that:
// - the Tensor Memory Accelerator: 2-D tensor maps over the (K, N) weight
//   and over x (encoded on the host through cuTensorMapEncodeTiled, which
//   the runtime hands out, so no -lcuda) give boxes of 128 K rows x 128
//   weight columns and of MN x rows x 128 K bytes, 128-byte swizzled,
//   zero past the edges. One producer lane keeps 4 stages (16 KB of
//   weight and MN x 128 bytes of x each) in flight on full / empty
//   mbarriers;
// - operands swapped: one consumer warpgroup computes the output's
//   transpose, w^T x^T. Integer tensor-core ops take s8 operands K-major
//   only and the (K, N) weight is not, so the weight is A, from registers:
//   each thread reads 4 x 4 byte blocks of the landed tile (word loads
//   that hit 32 banks under the swizzle) and transposes them with byte
//   permutes straight into its fragments; no second pass through shared
//   memory. x, K-major already, is B, read by wgmma from shared memory by
//   descriptor. The instruction's N is x's rows: 8 at decode (4 of 8
//   columns idle, where x as A idles 12 of 16 rows), 16 or 32, then
//   blocks of 128 rows;
// - wgmma.mma_async m64nMNk32 .s32.s8.s8 with A from registers, two 64-row
//   tiles a stage's k32 step; the next stage's fragments are built while
//   this stage's wgmmas run. mma.sync m16n8k32 with the same swapped
//   operands timed slower at M = 128 and no faster at decode (a same-call
//   A/B, PERF.md);
// - K split among as many blocks as fill one wave of the card, at most 8
//   (clusters of 16, the non-portable size, timed slower): the blocks of
//   one output tile form a cluster along z and add up each other's tiles
//   in distributed shared memory (kn_tma_kernel<MN, true>):
//   no zeroed output (a memset, a kernel of its own) and no atomics. One
//   split runs kn_tma_kernel<MN, false>, no cluster. Stores go through
//   the ring a row at a time, 512 contiguous bytes a warp.
// Over qwen2-1.5b's 7 projection sites it takes 0.0839 ms at decode and
// 0.1028 at M = 128, against 0.1076 / 0.2051 for KnRows and torch._int_mm
// on (N, K) weights at 0.0944 (M = 32) / 0.1017 (chip_smoke.py phase 5,
// NVIDIA H100 80GB HBM3, 700.00 W).

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_runtime.h>

#include <cooperative_groups.h>
#include <cstdint>

#include "int8_mma.cuh"
#include "nm_chunks.cuh"

namespace {

using mma8::cp_async;
using mma8::kBK;
using mma8::kBN;
using mma8::kRow;
using mma8::pack_bytes;
using mma8::store_word;

// quant_matmul's loader: the slab w[k0 .. k0 + kBK)[n0 .. n0 + kBN) of the
// (K, N) weight as 4 x 4 byte blocks (a 32-bit word of 4 columns from each
// of 4 rows of K), each copied by one thread into the raw bytes (rows of K
// over N, kRow bytes apart) and transposed by it into the tile with byte
// permutes. `mode`: 4 (w and N multiples of 4: cp.async of each word) or 1
// (byte loads).
struct KnRows {
  const int8_t* w;
  int N, K, mode;
  static constexpr int kLead = 1;
  static constexpr bool kExact = false;
  static constexpr int kBlocks = (kBN / 4) * (kBK / 4);
  __host__ __device__ __forceinline__ int raw_bytes() const {
    return kBK * kRow;
  }
  template <int NT>
  __device__ __forceinline__ void start(uint8_t*, uint8_t* raw, int n0,
                                        int k0) const {
    for (int b = threadIdx.x; b < kBlocks; b += NT) {
      const int nq = b % (kBN / 4), kq = b / (kBN / 4);
      const int n = n0 + 4 * nq, cols = min(max(N - n, 0), 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * kq + j;
        if (k < K && cols) {  // past K: x's zero fill; past N: not stored
          const int8_t* p = w + static_cast<int64_t>(k) * N + n;
          uint8_t* to = raw + (4 * kq + j) * kRow + 4 * nq;
          if (mode == 4)
            cp_async<4>(to, p, cols);
          else
            store_word(to, pack_bytes(p, cols));
        }
      }
    }
  }
  // Word c of block (kq, nq) after the permutes holds byte c of the
  // block's 4 row words q[0 .. 3]: column 4 nq + c over rows 4 kq .. + 3.
  template <int NT>
  __device__ __forceinline__ void build(uint8_t* tile, const uint8_t* raw,
                                        int, int, int*) const {
    for (int b = threadIdx.x; b < kBlocks; b += NT) {
      const int nq = b % (kBN / 4), kq = b / (kBN / 4);
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = *reinterpret_cast<const uint32_t*>(raw + (4 * kq + j) * kRow +
                                                  4 * nq);
      // t01 = (q0.0, q1.0, q0.1, q1.1), t23 = (q0.2, q1.2, q0.3, q1.3)
      const uint32_t t01 = __byte_perm(q[0], q[1], 0x5140);
      const uint32_t t23 = __byte_perm(q[0], q[1], 0x7362);
      const uint32_t u01 = __byte_perm(q[2], q[3], 0x5140);
      const uint32_t u23 = __byte_perm(q[2], q[3], 0x7362);
      uint8_t* dst = tile + 4 * nq * kRow + 4 * kq;
      store_word(dst, __byte_perm(t01, u01, 0x5410));
      store_word(dst + kRow, __byte_perm(t01, u01, 0x7632));
      store_word(dst + 2 * kRow, __byte_perm(t23, u23, 0x5410));
      store_word(dst + 3 * kRow, __byte_perm(t23, u23, 0x7632));
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// quant_matmul's TMA-fed body (aligned operands, quant_matmul_body "tma")
// ---------------------------------------------------------------------------

// Internal linkage, as the other kernels': the function-local statics
// below (the encoder, the attributes set once) then belong to this build,
// so two builds of this file loaded into one process each set up their own
// kernels.
namespace {
namespace kn {

namespace cg = cooperative_groups;

constexpr int kBK = 128;       // K rows of a stage: one 128-byte row of x
constexpr int kBN = 128;       // weight columns of a block: 2 x 64 mma rows
constexpr int kStages = 4;     // ring stages
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kWBytes = kBK * kBN;         // a stage's weight tile, 16 KB
// x rows of a block above 32 rows: 128, one block an SM (variant rows64
// times 64, two an SM and twice the blocks: slower at M = 128).
constexpr int kMaxRows = 128;
// Blocks of one output tile that split K, a cluster: 8, the portable
// cluster size.
constexpr int kMaxSplits = 8;

// x rows a block takes: M rounded up to a width the instruction takes.
template <int MN>
struct Tile {
  static constexpr int kXBytes = MN * kBK;
  static constexpr int kStage = kWBytes + kXBytes;  // a multiple of 1024
  static constexpr int kSmem = kStages * kStage + 1024;  // + alignment
};

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   mma8::smem_addr(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(mma8::smem_addr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   mma8::smem_addr(b))
               : "memory");
}

// Waits until the phase of parity `parity` of barrier b has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma8::smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (c0 inner, c1 outer) into shared dst, its bytes
// counted on barrier b; out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* b, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(mma8::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(mma8::smem_addr(b)),
      "r"(c0), "r"(c1)
      : "memory");
}

// Byte offset of (row r, byte c) of a tile of 128-byte rows under TMA's
// 128-byte swizzle: the 16-byte chunk index XOR the row's low 3 bits.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// The A fragments of both 64-row mma tiles for the k32 step at K row k0 of
// the landed (K, N) weight tile w: a thread (warp wi, g = lane / 4, t =
// lane % 4) owns the 4 columns 32 wi + 4 g .. + 3, mma rows (16 wi + g,
// 16 wi + g + 8) of tile 0 and then of tile 1, and K rows k0 + 4 t .. + 3
// (a[.][0], a[.][1]) and k0 + 16 + 4 t .. + 3 (a[.][2], a[.][3]). Each
// block of 4 rows x 4 columns is 4 word loads, transposed by byte
// permutes into one word per column (4 K bytes, the fragment's order).
// Threads t and t + 2 read the 4 rows in other orders, so that with the
// swizzle the 32 lanes of each load hit 32 banks.
__device__ __forceinline__ void build_a(uint32_t (&a)[2][4],
                                        const uint8_t* w, int k0, int col,
                                        int t) {
  const int sw = t & 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int base = k0 + 16 * h + 4 * t;
    uint32_t l[4], q[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      l[j] = *reinterpret_cast<const uint32_t*>(w +
                                                swz(base + (j ^ sw), col));
    q[0] = sw ? l[2] : l[0];
    q[1] = sw ? l[3] : l[1];
    q[2] = sw ? l[0] : l[2];
    q[3] = sw ? l[1] : l[3];
    mma8::transpose4(q, y);  // y[c]: column col + c over the 4 rows
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
      a[tile][2 * h] = y[2 * tile];
      a[tile][2 * h + 1] = y[2 * tile + 1];
    }
  }
}

// The wgmma descriptor of a K-major tile of 128-byte rows in 8-row groups
// of 1024 bytes under the 128-byte swizzle, from its k32 step's start.
__device__ __forceinline__ uint64_t x_desc(const uint8_t* p) {
  const uint64_t a = mma8::smem_addr(p);
  return ((a & 0x3ffff) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A B for a 64 x MN x 32 tile, A from registers, B by descriptor:
// wgmma.mma_async ... .s32.s8.s8, exact int32 (wrapping) adds.
template <int MN>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(int (&d)[1][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(int (&d)[2][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(int (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(int (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(int (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// A barrier of the consumer warpgroup alone (the producer warp is not in
// it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// out = x (M, K) times w (K, N), a block per (128 weight columns
// blockIdx.x, MN rows of x blockIdx.y, a run of `per` stages of K
// blockIdx.z): the producer warp's lane 0 keeps kStages TMA boxes of the
// weight (128 K rows x 128 columns) and of x (MN rows x 128 K bytes) in
// flight, each stage's full barrier counting its bytes; the consumer
// warpgroup computes the output's transpose, w^T x^T: A, the weight's
// fragments, built in registers from the landed tile (build_a), B, x's
// tile, read by descriptor, and frees the
// stage on its empty barrier. Then the consumers put the block's output
// tile in the ring, now free (every stage's boxes were waited on). With K
// split (gridDim.z > 1) the blocks of one output tile form a cluster
// along z, and each adds up a share of the tile's rows from all of their
// tiles in distributed shared memory (int32 adds, which wrap as the
// dot_general's): no atomics and no zeroed output. Stores go a row at a
// time, lanes over columns, so a warp's stores cover 512 contiguous bytes.
template <int MN, bool kSplit>
__global__ void __launch_bounds__(kThreads, MN <= 64 ? 2 : 1)
    kn_tma_kernel(__grid_constant__ const CUtensorMap wmap,
                  __grid_constant__ const CUtensorMap xmap,
                  int32_t* __restrict__ out, int M, int N, int K, int per) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  // the output tile: MN rows x kBN columns, kOutLd words a row (8 rows of
  // a store phase hit 32 banks)
  constexpr int kOutLd = kBN + 4;
  int32_t* held = reinterpret_cast<int32_t*>(ring);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * MN;
  const int total = (K + kBK - 1) / kBK;
  const int s_begin = blockIdx.z * per;
  const int slabs = min(total, s_begin + per) - s_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0)
      for (int i = 0; i < slabs; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], (i / kStages - 1) & 1);
        uint8_t* stage = ring + st * Tile<MN>::kStage;
        const int k0 = (s_begin + i) * kBK;
        mbar_expect_tx(&full[st], Tile<MN>::kStage);
        tma_load(stage, &wmap, &full[st], n0, k0);
        tma_load(stage + kWBytes, &xmap, &full[st], k0, m0);
      }
    if constexpr (!kSplit) return;  // else it joins the cluster barriers
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int col = 32 * warp + 4 * g;  // the thread's 4 weight columns
    int acc[2][MN / 8][4];  // acc[tile][j]: the 8 x rows of chunk j
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int j = 0; j < MN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tile][j][e] = 0;

    // stage i + 1's A fragments are built while stage i's wgmmas run,
    // into the other of two register sets
    uint32_t a[2][kBK / 32][2][4];
    auto fetch = [&](int i, uint32_t (&af)[kBK / 32][2][4]) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      const uint8_t* w = ring + st * Tile<MN>::kStage;
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s) build_a(af[s], w, 32 * s, col, t);
    };
    auto mmas = [&](int i, const uint32_t (&af)[kBK / 32][2][4]) {
      const uint8_t* xs = ring + (i % kStages) * Tile<MN>::kStage + kWBytes;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s)
#pragma unroll
        for (int tile = 0; tile < 2; ++tile)
          Wgmma<MN>::run(acc[tile], af[s][tile], x_desc(xs + 32 * s));
      wgmma_commit();
    };
    if (slabs > 0) fetch(0, a[0]);
    for (int i = 0; i < slabs; i += 2) {
      mmas(i, a[0]);
      if (i + 1 < slabs) fetch(i + 1, a[1]);
      wgmma_wait();
      mbar_arrive(&empty[i % kStages]);
      if (i + 1 == slabs) break;
      mmas(i + 1, a[1]);
      if (i + 2 < slabs) fetch(i + 2, a[0]);
      wgmma_wait();
      mbar_arrive(&empty[(i + 1) % kStages]);
    }

    // acc[tile][j][e]: mma row 16 warp + g + 8 (e / 2), i.e. weight
    // column col + 2 tile + e / 2; x row 8 j + 2 t + e % 2
    consumers_sync();  // every consumer is done with the ring
#pragma unroll
    for (int j = 0; j < MN / 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        *reinterpret_cast<int4*>(held + (8 * j + 2 * t + b) * kOutLd + col) =
            make_int4(acc[0][j][b], acc[0][j][2 + b], acc[1][j][b],
                      acc[1][j][2 + b]);
    if (!kSplit) consumers_sync();
  }

  const int rows = min(MN, M - m0), cols = min(kBN, N - n0);
  if constexpr (!kSplit) {  // the consumers store their tile
    for (int r = warp; r < rows; r += kConsumers / 32)
      if (4 * lane < cols)  // N a multiple of 16: whole quads
        *reinterpret_cast<int4*>(out + static_cast<int64_t>(m0 + r) * N +
                                 n0 + 4 * lane) =
            *reinterpret_cast<const int4*>(held + r * kOutLd + 4 * lane);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block of the cluster has its tile staged
    const int rank = static_cast<int>(cluster.block_rank());
    const int blocks = static_cast<int>(cluster.num_blocks());
    // rows rank, rank + blocks, ...: a row's 32 quads over 32 threads
    for (int i = threadIdx.x;
         i < ((rows - rank + blocks - 1) / blocks) * 32; i += kThreads) {
      const int r = rank + blocks * (i >> 5), q = 4 * (i & 31);
      if (q >= cols) continue;
      int4 v[kMaxSplits];  // every block's quad, the loads all in flight
#pragma unroll
      for (int p = 0; p < kMaxSplits; ++p)
        if (p < blocks)
          v[p] = *reinterpret_cast<const int4*>(
              cluster.map_shared_rank(held + r * kOutLd + q, p));
      int4 sum = v[0];
#pragma unroll
      for (int p = 1; p < kMaxSplits; ++p)
        if (p < blocks) {
          sum.x += v[p].x;
          sum.y += v[p].y;
          sum.z += v[p].z;
          sum.w += v[p].w;
        }
      *reinterpret_cast<int4*>(out + static_cast<int64_t>(m0 + r) * N + n0 +
                               q) = sum;
    }
    cluster.sync();  // no block leaves while the others read its tile
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (so the
// library needs no -lcuda), or null.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map over a row-major int8 matrix of `rows` x `cols` (cols bytes
// apart, a multiple of 16; base 16-byte aligned), boxes of box_rows rows x
// 128 bytes under the 128-byte swizzle, zeros out of bounds.
inline bool encode(CUtensorMap* map, const void* base, int rows, int cols,
                   int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether the body takes these operands: N and K multiples of 16 (TMA's
// row strides) and both bases 16-byte aligned.
inline bool takes(const void* x, const void* w, int N, int K) {
  return N % 16 == 0 && K % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <int MN>
int launch(const void* x, const void* w, int32_t* out, int M, int N, int K,
           cudaStream_t s) {
  CUtensorMap wmap, xmap;
  if (!encode(&wmap, w, K, N, kBK) || !encode(&xmap, x, M, K, MN))
    return cudaErrorNotSupported;
  constexpr int smem = Tile<MN>::kSmem;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaSuccess;
    for (auto kernel : {kn_tma_kernel<MN, false>, kn_tma_kernel<MN, true>})
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  static int resident = 0;
  if (resident == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &resident, kn_tma_kernel<MN, false>, kThreads, smem) !=
           cudaSuccess ||
       resident < 1))
    resident = 1;
  const int64_t tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + MN - 1) / MN;
  if (tiles_m > 65535 || tiles_n > 0x7fffffff) return cudaErrorInvalidValue;
  const int slabs = (K + kBK - 1) / kBK;
  // K split among as many blocks as the card holds at once (one wave), at
  // least a stage a block and at most kMaxSplits (a cluster)
  const int64_t wave = static_cast<int64_t>(resident) * mma8::sm_count();
  int splits = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(std::min(slabs, kMaxSplits),
                           wave / (tiles_n * tiles_m))));
  const int per = (slabs + splits - 1) / splits;
  splits = (slabs + per - 1) / per;
  const dim3 grid(static_cast<unsigned>(tiles_n),
                  static_cast<unsigned>(tiles_m), splits);
  if (splits == 1) {  // its own kernel, with no cluster code
    kn_tma_kernel<MN, false><<<grid, kThreads, smem, s>>>(wmap, xmap, out, M,
                                                          N, K, per);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kn_tma_kernel<MN, true>, wmap, xmap, out, M, N,
                         K, per);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// x rows a block takes at M rows: 8, 16, 32, then blocks of kMaxRows.
inline int launch_rows(const void* x, const void* w, int32_t* out, int M,
                       int N, int K, cudaStream_t s) {
  if (M <= 8) return launch<8>(x, w, out, M, N, K, s);
  if (M <= 16) return launch<16>(x, w, out, M, N, K, s);
  if (M <= 32) return launch<32>(x, w, out, M, N, K, s);
  return launch<kMaxRows>(x, w, out, M, N, K, s);
}

}  // namespace kn
}  // namespace

// Plain C entry points, loaded with ctypes; every buffer is a contiguous
// device buffer, out (M, N) int32. Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take (the Python wrappers check them first).

// x (M, K) int8, w (K, N) int8; body 0: KnRows on the int8 mainloop
// (any operands), 1: the TMA-fed body (kn::takes: N and K multiples of 16,
// both bases 16-byte aligned; kernels/quant_matmul.py quant_matmul_body
// names the body for the operands).
extern "C" int pqs_quant_matmul(const void* x, const void* w, void* out,
                                int M, int N, int K, int body,
                                void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(out);
  if (body == 1) {
    if (K == 0 || !kn::takes(x, w, N, K)) return cudaErrorInvalidValue;
    return kn::launch_rows(x, w, o, M, N, K, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
  const auto* w8 = static_cast<const int8_t*>(w);
  return mma8::launch(static_cast<const int8_t*>(x),
                      KnRows{w8, N, K, mma8::copy_mode(w8, N) == 1 ? 1 : 4},
                      o, M, N, K, s);
}

// x (M, K) int8, values (N, G, n_keep) int8, indices (N, G, n_keep) int32,
// K <= G * m_group.
extern "C" int pqs_nm_spmm(const void* x, const void* val, const void* idx,
                           void* out, int M, int N, int K, int G, int n_keep,
                           int m_group, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 0 || G < 0 || m_group < 1 || n_keep < 1 || n_keep > m_group ||
      static_cast<int64_t>(G) * m_group < K ||
      static_cast<int64_t>(G) * n_keep > 0x7fffffff)
    return cudaErrorInvalidValue;
  return nmload::launch_nm(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(val),
      static_cast<const int32_t*>(idx), static_cast<int32_t*>(out), M, N, K,
      G, n_keep, m_group, static_cast<cudaStream_t>(stream), mma8::WholeK{});
}
