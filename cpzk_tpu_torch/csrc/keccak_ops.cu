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
// every row; the masks are [k, 25, n] the same way.  Two neighbouring
// threads of a warp own one row: thread part p (p = lane & 1) reads the lo
// (p = 0) or hi (p = 1) words of its state and of each mask once (half a
// warp's loads of one lane are 16 consecutive words), keeps its half of the
// 25 lanes in registers through all k permutations, exchanging with its
// pair only for the rotations (keccak_u64.cuh), and writes its half once.
//
// What bounds it: a permutation needs about 4.3k int32 operations a row
// (ops/keccak_kernels.py counts them) against 200 bytes of mask read, so it
// is bound by operations; at the path's widths each scheduler holds one to
// three warps, so what it takes is one row's dependent chain of 24 k
// rounds, times the warps a scheduler runs.  Two threads a row halve that
// chain (~90 operations and 29 shuffles a round a thread instead of ~180)
// and, at 20,480 rows, put at most 3 half-rows' warps on a scheduler where
// one thread a row put 2 whole rows'; the next mask is loaded while the
// current permutation runs, so the loads' latency hides behind it.
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
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  // a warp past the last row has nothing to do; a warp holding the last
  // row runs whole: its threads past n take row n - 1 (a pair's shuffles
  // need every lane of the warp) and store nothing
  if ((t & ~31L) >= 2L * n) return;
  const long j = t >> 1;
  const int part = (int)(t & 1);
  const long row = j < n ? j : n - 1;
  cpzk::KeccakHalf a[cpzk::KECCAK_LANES];
  cpzk::keccak_chain_row(a, s_hi, s_lo, shared, m_hi, m_lo, k, n, row, part);
  if (j < n) {
#pragma unroll
    for (int i = 0; i < cpzk::KECCAK_LANES; ++i)
      cpzk::keccak_store(o_hi, o_lo, (long)i * n + j, a[i], part);
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
  const long threads = 2L * n;
  const long blocks = (threads + kKeccakThreads - 1) / kKeccakThreads;
  keccak_chain_kernel<<<(unsigned)blocks, kKeccakThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)s_hi, (const uint32_t*)s_lo, shared != 0,
      (const uint32_t*)m_hi, (const uint32_t*)m_lo, k, n, (uint32_t*)o_hi,
      (uint32_t*)o_lo);
  return (int)cudaGetLastError();
}
