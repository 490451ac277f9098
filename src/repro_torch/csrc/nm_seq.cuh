// nm_seq.cuh: what the two K-streaming kernels on N:M compressed weights
// share, the gather (nm_seq_policy_matmul.cu, row 6) and the expand
// (nm_expand_seq.cu, row 5): their launch arguments, the contract their C
// entry points check, and the warps that fill the card.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pqs_accum.cuh"

namespace {
namespace nmseq {

static_assert(pqs::kRowsPerWarp == 4, "a staged x word holds 4 rows");

// warps in flight that fill the card (132 SMs x 64): both kernels split an
// output's tiles over up to 8 warps until a launch has them
constexpr int kFillWarps = 132 * 64;

struct Args {
  const int8_t* x;
  const int8_t* vals;
  const int32_t* idx;
  int32_t* out;
  int M, N, K, G, n_keep, m_group, policy, acc_bits, rounds;
  cudaStream_t s;

  dim3 grid(int outputs_per_block) const {
    return dim3((N + outputs_per_block - 1) / outputs_per_block,
                (M + pqs::kRowsPerWarp - 1) / pqs::kRowsPerWarp);
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

}  // namespace nmseq
}  // namespace
