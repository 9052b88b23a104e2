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
// keeps the point in registers through every field multiplication of the
// operation (all k rounds of double_k, with no stores between rounds) and
// stores the result once.  Threads past n return at once, so any n >= 1
// works.  The field arithmetic is fe25519.cuh, shared with the host build
// the tests run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace {

using cpzk::NL;

constexpr int kThreads = 64;

__device__ __forceinline__ void load_fe(int32_t out[NL],
                                        const int32_t* __restrict__ src,
                                        int n, int j) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = src[(size_t)i * n + j];
}

__device__ __forceinline__ void store_fe(int32_t* __restrict__ dst,
                                         const int32_t v[NL], int n, int j) {
#pragma unroll
  for (int i = 0; i < NL; ++i) dst[(size_t)i * n + j] = v[i];
}

__global__ void __launch_bounds__(kThreads)
point_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                 const int32_t* __restrict__ z1, const int32_t* __restrict__ t1,
                 const int32_t* __restrict__ x2, const int32_t* __restrict__ y2,
                 const int32_t* __restrict__ z2, const int32_t* __restrict__ t2,
                 int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                 int32_t* __restrict__ oz, int32_t* __restrict__ ot, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int32_t X1[NL], Y1[NL], Z1[NL], T1[NL], X2[NL], Y2[NL], Z2[NL], T2[NL];
  load_fe(X1, x1, n, j);
  load_fe(Y1, y1, n, j);
  load_fe(Z1, z1, n, j);
  load_fe(T1, t1, n, j);
  load_fe(X2, x2, n, j);
  load_fe(Y2, y2, n, j);
  load_fe(Z2, z2, n, j);
  load_fe(T2, t2, n, j);
  int32_t X3[NL], Y3[NL], Z3[NL], T3[NL];
  cpzk::point_add(X3, Y3, Z3, T3, X1, Y1, Z1, T1, X2, Y2, Z2, T2);
  store_fe(ox, X3, n, j);
  store_fe(oy, Y3, n, j);
  store_fe(oz, Z3, n, j);
  store_fe(ot, T3, n, j);
}

__global__ void __launch_bounds__(kThreads)
point_double_k_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                      const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                      int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                      int32_t* __restrict__ ot, int n, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int32_t X[NL], Y[NL], Z[NL], T[NL];
  load_fe(X, x, n, j);
  load_fe(Y, y, n, j);
  load_fe(Z, z, n, j);
  cpzk::point_double_k(X, Y, Z, T, k);
  store_fe(ox, X, n, j);
  store_fe(oy, Y, n, j);
  store_fe(oz, Z, n, j);
  store_fe(ot, T, n, j);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int cpzk_point_add(const void* x1, const void* y1, const void* z1,
                              const void* t1, const void* x2, const void* y2,
                              const void* z2, const void* t2, void* ox,
                              void* oy, void* oz, void* ot, int n,
                              void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  point_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
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
  point_double_k_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (int32_t*)ox,
      (int32_t*)oy, (int32_t*)oz, (int32_t*)ot, n, k);
  return (int)cudaGetLastError();
}
