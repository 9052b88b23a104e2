// The two kernels of the batch prover, for Hopper (sm_90a), with a plain C
// launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/prove_kernels.py.
//
//   comb_tables_kernel  replaces cpzk_tpu/ops/prove.py::_comb_tables_kernel
//   commitments_kernel  replaces cpzk_tpu/ops/prove.py::_commitments_kernel
//                       (two ::_fixed_base_kernel walks and two
//                       cpzk_tpu/ops/curve.py::encode, fused)
//
// comb_tables_kernel builds one generator's table T_w[j] = j 16^w P (64
// windows x 16 entries, prove_w32.cuh's layout) once per BatchProver: one
// block, thread w builds window w (4 w doublings, then 14 adds).  It runs
// once, so it only has to be parallel enough not to matter (64 chains
// instead of one of 64 x 18 point operations).
//
// commitments_kernel: one thread per lane walks the G table over the lane's
// 64 digits (d_w in 0..15, [64, n] int32, LSB window first) and encodes
// the sum, then the same over the H table, so one accumulator is live at a
// time; it writes the two encodings as [32, n] bytes (byte i of lane j at
// i * n + j).  Each window of the current table (2 KiB) is staged in
// shared memory by the block, and a thread selects its entry by reading all
// 16 and keeping one by a mask (prove_w32.cuh comb_select): the digits are
// nibbles of secret scalars, so no address depends on them.
//
// What bounds it: per lane 128 point additions and two encodes (about 265
// field squarings and multiplies each) against 256 bytes of digits and 64
// bytes out, so it is bound by operations (ops/prove_kernels.py counts
// them).  As in the point kernels, each lane is one thread's long chain of
// dependent multiplies; the design keeps everything in registers between
// the staged window loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519_w32.cuh"
#include "prove_w32.cuh"
#include "ristretto_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::NL;
using cpzk::NW;

constexpr int kCombThreads = cpzk::COMB_WINDOWS;
constexpr int kCommitThreads = 64;

__device__ __forceinline__ void load_fe1(Fe& out, const int32_t* __restrict__ src) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = src[i];
  cpzk::fe_from_limbs(out, l);
}

// p: four [20, 1] limb arrays; out: the 64-window table (32,768 words).
__global__ void __launch_bounds__(kCombThreads)
comb_tables_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pz, const int32_t* __restrict__ pt,
                   uint32_t* __restrict__ out) {
  const int w = threadIdx.x;
  if (w >= cpzk::COMB_WINDOWS) return;
  Fe p[4];
  load_fe1(p[0], px);
  load_fe1(p[1], py);
  load_fe1(p[2], pz);
  load_fe1(p[3], pt);
  cpzk::comb_window(out + (long)w * cpzk::COMB_WINDOW_WORDS, p, w);
}

__global__ void __launch_bounds__(kCommitThreads)
commitments_kernel(const uint32_t* __restrict__ tg, const uint32_t* __restrict__ th,
                   const int32_t* __restrict__ digits, uint8_t* __restrict__ r1,
                   uint8_t* __restrict__ r2, int n) {
  __shared__ uint32_t window[cpzk::COMB_WINDOW_WORDS];
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < n;  // every thread takes part in the staging
  for (int g = 0; g < 2; ++g) {
    const uint32_t* table = g == 0 ? tg : th;
    Fe acc[4];
    cpzk::pt_set_identity(acc);
    for (int w = 0; w < cpzk::COMB_WINDOWS; ++w) {
      __syncthreads();
      for (int k = threadIdx.x; k < cpzk::COMB_WINDOW_WORDS; k += blockDim.x) {
        window[k] = table[(long)w * cpzk::COMB_WINDOW_WORDS + k];
      }
      __syncthreads();
      const uint32_t d = live ? (uint32_t)digits[(long)w * n + j] : 0u;
      cpzk::comb_step(acc, window, d);
    }
    uint8_t bytes[32];
    cpzk::ristretto_encode(bytes, acc);
    if (live) {
      uint8_t* out = g == 0 ? r1 : r2;
#pragma unroll
      for (int i = 0; i < 32; ++i) out[(long)i * n + j] = bytes[i];
    }
  }
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int cpzk_comb_tables(const void* px, const void* py, const void* pz,
                                const void* pt, void* out, void* stream) {
  comb_tables_kernel<<<1, kCombThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)pt,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int cpzk_commitments(const void* tg, const void* th, const void* digits,
                                void* r1, void* r2, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kCommitThreads - 1) / kCommitThreads;
  commitments_kernel<<<blocks, kCommitThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tg, (const uint32_t*)th, (const int32_t*)digits, (uint8_t*)r1,
      (uint8_t*)r2, n);
  return (int)cudaGetLastError();
}
