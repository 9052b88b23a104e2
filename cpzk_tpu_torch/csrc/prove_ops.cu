// The two kernels of the batch prover, for Hopper (sm_90a), with a plain C
// launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/prove_kernels.py.
//
//   comb_tables_kernel  replaces cpzk_tpu/ops/prove.py::_comb_tables_kernel
//   commitments_kernel  replaces cpzk_tpu/ops/prove.py::_commitments_kernel
//                       (two ::_fixed_base_kernel walks and two
//                       cpzk_tpu/ops/curve.py::encode, fused)
//
// comb_tables_kernel builds one generator's table (prove_w32.cuh's layout:
// 64 windows of entries j 16^w P, j = 0 .. 8, affine, as (y - x, y + x,
// 2d x y)) once per BatchProver, in one block and three phases between
// barriers: one quad of threads runs the chain of 252 doublings from P and
// stores each window's base 16^w P every 4 rounds (comb_bases); then each
// entry j >= 2 of every window on its own thread, in levels (j = 2; 3, 4;
// 5 .. 8) by one doubling or one add of entries already made (comb_entry);
// then thread w brings window w to affine form with one inversion
// (comb_normalise).  The extended entries live in dynamic shared memory
// (73,728 bytes).  What bounds it is the chain: 252 dependent doublings on
// one quad (~0.26 ms at 1.048 us a quad round on an H100), then one window's
// inversion (~270 dependent squarings and multiplies); its operations
// (ops/prove_kernels.py comb_tables_work) would take 0.1 us on the card.
//
// commitments_kernel runs a thread per point: thread (lane j, generator g)
// (blockIdx.y = g) walks g's table over lane j's 64 digits ([64, n] int32
// nibbles, LSB window first, packed into 8 words at the start and recoded
// to signed digits e_w in [-8, 8] as it walks, the top window split over
// two steps so that any nibble is taken), adding the selected entry to its
// accumulator by the mixed add (7 multiplies), 65 a point, then encodes it and
// writes its 32 bytes to row g's [32, n] output (byte i of lane j at
// i * n + j).  A block of 128 threads copies each window (864 bytes) into
// shared memory between two barriers, a step at a time; every thread of a
// block walks the same table, so a warp's reads of an entry are
// broadcasts.  What bounds it: per point 64 mixed adds (the least; the
// kernel makes 65) and one ENCODE against 256 bytes of digits and 32 bytes
// out, so operations (ops/prove_kernels.py commitments_work); a point's chain is ~745
// dependent multiplies and squarings, and a thread a point gives 1,024
// warps at the main path's 16,384 lanes, under 8 an SM, so the time is
// ~1.5x one point's chain (its chain floor, one lane).
//
// Constant time: the digits are nibbles of secret scalars; the recode is
// arithmetic, the select reads all 9 entries of the window and keeps one by
// a mask, the sign is applied by masks (prove_w32.cuh).  No address and no
// branch depends on a digit, a carry or a sign.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519_w32.cuh"
#include "msm_w32.cuh"
#include "prove_w32.cuh"
#include "ristretto_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::NL;
using cpzk::NW;

constexpr int kCombThreads = 256;
// commitments_kernel's blocks, under a register cap of 65,536 / (128 x 4)
// = 128: what the A/B kept (PERF.md section 6)
constexpr int kCommitThreads = 128;
constexpr int kCommitMinBlocks = 4;
constexpr int kCombSmem = cpzk::COMB_EXT_WORDS * 4;

constexpr int kWindowVecs = cpzk::COMB_WINDOW_WORDS / 4;

__device__ __forceinline__ void load_fe1(Fe& out, const int32_t* __restrict__ src) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = src[i];
  cpzk::fe_from_limbs(out, l);
}

// p: four [20, 1] limb arrays; out: the table (COMB_TABLE_WORDS words).
__global__ void __launch_bounds__(kCombThreads, 1)
comb_tables_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                   const int32_t* __restrict__ pz, const int32_t* __restrict__ pt,
                   uint32_t* __restrict__ out) {
  extern __shared__ uint4 comb_smem[];
  uint32_t* ext = reinterpret_cast<uint32_t*>(comb_smem);
  const int t = threadIdx.x;
  if (t < 4) {
    Fe p[4];
    load_fe1(p[0], px);
    load_fe1(p[1], py);
    load_fe1(p[2], pz);
    load_fe1(p[3], pt);
    cpzk::comb_bases(ext, p, cpzk::quad_of_thread(t));
  }
  __syncthreads();
  for (int l = 1; l <= cpzk::COMB_LEVELS; ++l) {
    const int lo = cpzk::comb_level_lo(l), count = cpzk::comb_level_hi(l) - lo + 1;
    for (int k = t; k < cpzk::COMB_WINDOWS * count; k += blockDim.x)
      cpzk::comb_entry(ext, k / count, lo + k % count);
    __syncthreads();
  }
  if (t < cpzk::COMB_WINDOWS)
    cpzk::comb_normalise(out + t * cpzk::COMB_WINDOW_WORDS,
                         ext + t * cpzk::COMB_ENTRIES * cpzk::PT_WORDS);
}

__global__ void __launch_bounds__(kCommitThreads, kCommitMinBlocks)
commitments_kernel(const uint32_t* __restrict__ tg, const uint32_t* __restrict__ th,
                   const int32_t* __restrict__ digits, uint8_t* __restrict__ r1,
                   uint8_t* __restrict__ r2, int n) {
  const int g = blockIdx.y;
  const uint4* __restrict__ table = reinterpret_cast<const uint4*>(g == 0 ? tg : th);
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = j < n;  // every thread takes part in the staging
  __shared__ uint4 window[kWindowVecs];
  cpzk::CombDigits d;
  cpzk::comb_digits_load(d, digits, n, j, live);
  Fe acc[4];
  cpzk::pt_identity(acc);
  for (int s = 0; s < cpzk::COMB_STEPS; ++s) {
    if (s < cpzk::COMB_WINDOWS) {  // the last step re-reads window 63
      __syncthreads();  // every thread is done with the last window
      for (int k = threadIdx.x; k < kWindowVecs; k += kCommitThreads)
        window[k] = table[s * kWindowVecs + k];
      __syncthreads();
    }
    cpzk::comb_step(acc, d, reinterpret_cast<const uint32_t*>(window), s);
  }
  if (!live) return;
  uint8_t bytes[32];
  cpzk::ristretto_encode(bytes, acc);
  uint8_t* out = g == 0 ? r1 : r2;
#pragma unroll
  for (int i = 0; i < 32; ++i) out[(long)i * n + j] = bytes[i];
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns the first CUDA error of setting the kernel's
// shared memory size or of the launch (0 = success).
extern "C" int cpzk_comb_tables(const void* px, const void* py, const void* pz,
                                const void* pt, void* out, void* stream) {
  cudaError_t rc = cudaFuncSetAttribute(comb_tables_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kCombSmem);
  if (rc != cudaSuccess) return (int)rc;
  comb_tables_kernel<<<1, kCombThreads, kCombSmem, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, (const int32_t*)pt,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int cpzk_commitments(const void* tg, const void* th, const void* digits,
                                void* r1, void* r2, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kCommitThreads - 1) / kCommitThreads, 2);
  commitments_kernel<<<grid, kCommitThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tg, (const uint32_t*)th, (const int32_t*)digits, (uint8_t*)r1,
      (uint8_t*)r2, n);
  return (int)cudaGetLastError();
}
