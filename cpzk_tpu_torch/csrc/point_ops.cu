// The two point kernels of the batch-verification ladder, for Hopper
// (sm_90a), with a plain C launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/point_kernels.py.
//
//   point_add_kernel       replaces cpzk_tpu/ops/pallas_kernels.py::_add_kernel
//   point_double_k_kernel  replaces cpzk_tpu/ops/pallas_kernels.py::_double_k_kernel
//
// Layout: every coordinate is a limb-major [20, n] int32 array, limb i of
// lane j at i * n + j.  One thread owns one lane: it loads its coordinates
// (a warp's loads of one limb are 32 consecutive words, so coalesced),
// turns each into 8 words of fe25519_w32.cuh, keeps the point in registers
// through the whole operation (all k rounds of double_k, with no stores
// between rounds), and stores limbs in [0, 2^13) once.  Threads past n
// return at once, so any n >= 1 works.
//
// What bounds them: per lane an add moves 960 bytes and needs ~1.6k int32
// operations, so at a full lane chunk it is bound by bytes; double_k(4)
// moves 560 bytes and needs ~4.6k operations, so it is bound by operations
// (ops/point_kernels.py counts both).  Each lane is one thread running a few
// thousand dependent integer instructions (about 4 for each word product:
// IMAD.WIDE.U32 and the carry adds), and the main path's launches are only
// a few thousand lanes wide, so each warp is about alone on its scheduler
// and a launch costs that warp's issue time.  So:
// * the block size follows n (block_threads): one-warp blocks until every
//   scheduler of every SM has a warp, larger blocks beyond that;
// * __launch_bounds__(256, 1) lets ptxas use as many registers as it likes
//   (with the default it held the add to 80 and spilled), so it can keep
//   the independent multiplies of a formula in flight together;
// * fe25519_w32.cuh interleaves those multiplies (mul_n, sq_n).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::NL;

constexpr int kMaxThreads = 256;
constexpr int kSchedulersPerSm = 4;

__device__ __forceinline__ void load_fe(Fe& out, const int32_t* __restrict__ src,
                                        int n, int j) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = src[(size_t)i * n + j];
  cpzk::fe_from_limbs(out, l);
}

__device__ __forceinline__ void store_fe(int32_t* __restrict__ dst, const Fe& v,
                                         int n, int j) {
  int32_t l[NL];
  cpzk::fe_to_limbs(l, v);
#pragma unroll
  for (int i = 0; i < NL; ++i) dst[(size_t)i * n + j] = l[i];
}

__global__ void __launch_bounds__(kMaxThreads, 1)
point_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                 const int32_t* __restrict__ z1, const int32_t* __restrict__ t1,
                 const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
                 const int32_t* __restrict__ z2, const int32_t* __restrict__ t2,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                 int32_t* __restrict__ oz, int32_t* __restrict__ ot, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe p[4], q[4], r[4];
  load_fe(p[0], x1, n, j);
  load_fe(p[1], y1, n, j);
  load_fe(p[2], z1, n, j);
  load_fe(p[3], t1, n, j);
  load_fe(q[0], x2, n, j);
  load_fe(q[1], y2, n, j);
  load_fe(q[2], z2, n, j);
  load_fe(q[3], t2, n, j);
  cpzk::point_add(r, p, q);
  store_fe(ox, r[0], n, j);
  store_fe(oy, r[1], n, j);
  store_fe(oz, r[2], n, j);
  store_fe(ot, r[3], n, j);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
point_double_k_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                      const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                      int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                      int32_t* __restrict__ ot, int n, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Fe p[4];
  load_fe(p[0], x, n, j);
  load_fe(p[1], y, n, j);
  load_fe(p[2], z, n, j);
  cpzk::point_double_k(p, k);
  store_fe(ox, p[0], n, j);
  store_fe(oy, p[1], n, j);
  store_fe(oz, p[2], n, j);
  store_fe(ot, p[3], n, j);
}

// SMs of the current device, read once per device.
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    counts[dev] = c;
  }
  return counts[dev];
}

int threads_for(int n, int sms) {
  const int warps = (n + 31) / 32;
  int per_block = warps / (kSchedulersPerSm * (sms > 0 ? sms : 1));
  if (per_block < 1) per_block = 1;
  if (per_block > kMaxThreads / 32) per_block = kMaxThreads / 32;
  return 32 * per_block;
}

}  // namespace

// Threads per block for an n-lane launch on the current device: one-warp
// blocks (so n >= 32 * SMs puts a block on every SM) until each SM has a
// warp for every scheduler, then blocks of up to 256 threads.
extern "C" int cpzk_block_threads(int n) { return threads_for(n, sm_count()); }

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int cpzk_point_add(const void* x1, const void* y1, const void* z1,
                              const void* t1, const void* x2, const void* y2,
                              const void* z2, const void* t2, void* ox,
                              void* oy, void* oz, void* ot, int n,
                              void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = cpzk_block_threads(n);
  point_add_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x1, (const int32_t*)y1, (const int32_t*)z1,
      (const int32_t*)t1, (const int32_t*)x2, (const int32_t*)y2,
      (const int32_t*)z2, (const int32_t*)t2, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, (int32_t*)ot, n);
  return (int)cudaGetLastError();
}

extern "C" int cpzk_point_double_k(const void* x, const void* y, const void* z,
                                   void* ox, void* oy, void* oz, void* ot,
                                   int n, int k, void* stream) {
  if (n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int threads = cpzk_block_threads(n);
  point_double_k_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oz, (int32_t*)ot, n, k);
  return (int)cudaGetLastError();
}
