// Ristretto255 DECODE of a batch of 32-byte wires, for Hopper (sm_90a), with
// a plain C launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/decode_kernels.py.
//
//   ristretto_decode_kernel  replaces cpzk_tpu/ops/curve.py::decode (an XLA
//                            program in the JAX package, no Pallas kernel)
//
// Layout: the wires are [n, 32] bytes, lane j's encoding at 32 j (each
// thread reads its own 32 bytes as two 16-byte loads); the point comes out
// as [4, 8, n] 32-bit words, word i of coordinate c (X, Y, Z, T) of lane j
// at (8 c + i) n + j (a warp's stores of one word are 32 consecutive words,
// so coalesced), each the canonical value below p; valid is one byte a
// lane (1: a point, 0: not an encoding, and the identity in the words).
// One thread owns one lane and runs ristretto_w32.cuh's ristretto_decode
// in registers.
//
// What bounds it: a lane reads 32 bytes and writes 129, and needs about
// 257 squarings and 27 multiplies (ops/decode_kernels.py counts them),
// some 70k int32 operations, so it is bound by operations by far.  Each
// lane is one thread's dependent chain through the a^((p-5)/8) power, so
// the design keeps one lane a thread and relies on enough lanes (a block
// of 128 threads, one per lane) to fill the schedulers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ristretto_w32.cuh"

namespace {

constexpr int kDecodeThreads = 128;

__global__ void __launch_bounds__(kDecodeThreads)
ristretto_decode_kernel(const uint8_t* __restrict__ wire, int n,
                        uint32_t* __restrict__ words, uint8_t* __restrict__ valid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const uint4* src = reinterpret_cast<const uint4*>(wire + (size_t)j * 32);
  const uint4 lo = src[0], hi = src[1];
  const uint32_t raw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint8_t in[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) in[i] = (uint8_t)(raw[i >> 2] >> (8 * (i & 3)));
  cpzk::Fe p[4];
  const uint32_t ok = cpzk::ristretto_decode(p, in);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cpzk::Fe v;
    cpzk::fe_canonical(v, p[c]);
#pragma unroll
    for (int i = 0; i < cpzk::NW; ++i) words[(size_t)(8 * c + i) * n + j] = v.w[i];
  }
  valid[j] = (uint8_t)ok;
}

}  // namespace

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() of the launch (0 = success).  `wire` must be 16-byte
// aligned (the wrapper checks).
extern "C" int cpzk_ristretto_decode(const void* wire, int n, void* words, void* valid,
                                     void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kDecodeThreads - 1) / kDecodeThreads;
  ristretto_decode_kernel<<<blocks, kDecodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, n, (uint32_t*)words, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
