// The batched Keccak absorb-and-permute chain of the device Fiat-Shamir
// derivation, for Hopper (sm_90a), with a plain C launch interface loaded
// through ctypes by cpzk_tpu_torch/ops/keccak_kernels.py.
//
//   keccak_chain_kernel  replaces cpzk_tpu/ops/challenge.py::_absorb_permute_chain
//                        and cpzk_tpu/ops/keccak.py::keccak_f1600 (k = 1 with a
//                        zero mask)
//
// Layout: a state is 25 lanes as (hi, lo) int32 word arrays [25, n] (the
// reference's layout, lane i of row j at i * n + j), or [25, 1] shared by
// every row; the masks are [k, 25, n] the same way.  One thread owns one
// row: it reads its state and each mask once (a warp's loads of one lane
// are 32 consecutive words, so coalesced), keeps the 25 lanes in registers
// as uint64_t through all k permutations (keccak_u64.cuh), and writes the
// state once.
//
// What bounds it: a permutation needs about 4.3k int32 operations a row
// (ops/keccak_kernels.py counts them) against 200 bytes of mask read, so it
// is bound by operations; each row is one thread's dependent chain of
// 24 rounds, and the design keeps that chain short (funnel shifts for the
// rotations, three-input logic ops for chi and theta) rather than splitting
// a row over threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_u64.cuh"

namespace {

constexpr int kKeccakThreads = 128;

__global__ void __launch_bounds__(kKeccakThreads)
keccak_chain_kernel(const uint32_t* __restrict__ s_hi, const uint32_t* __restrict__ s_lo,
                    bool shared, const uint32_t* __restrict__ m_hi,
                    const uint32_t* __restrict__ m_lo, int k, int n,
                    uint32_t* __restrict__ o_hi, uint32_t* __restrict__ o_lo) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint64_t a[cpzk::KECCAK_LANES];
  cpzk::keccak_chain_lane(a, s_hi, s_lo, shared, m_hi, m_lo, k, n, j);
#pragma unroll
  for (int i = 0; i < cpzk::KECCAK_LANES; ++i) {
    o_hi[(long)i * n + j] = (uint32_t)(a[i] >> 32);
    o_lo[(long)i * n + j] = (uint32_t)a[i];
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() of the launch (0 = success).  shared != 0: the state
// is [25, 1], one for every row.
extern "C" int cpzk_keccak_chain(const void* s_hi, const void* s_lo, int shared,
                                 const void* m_hi, const void* m_lo, int k, int n,
                                 void* o_hi, void* o_lo, void* stream) {
  if (n < 1 || k < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kKeccakThreads - 1) / kKeccakThreads;
  keccak_chain_kernel<<<blocks, kKeccakThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)s_hi, (const uint32_t*)s_lo, shared != 0,
      (const uint32_t*)m_hi, (const uint32_t*)m_lo, k, n, (uint32_t*)o_hi,
      (uint32_t*)o_lo);
  return (int)cudaGetLastError();
}
