// Ristretto255 DECODE of a batch of 32-byte wires, for Hopper (sm_90a), with
// a plain C launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/decode_kernels.py.
//
//   ristretto_decode_kernel  replaces cpzk_tpu/ops/curve.py::decode (an XLA
//                            program in the JAX package, no Pallas kernel)
//
// Layout: the wires are [n, 32] bytes, lane j's encoding at 32 j (each
// thread reads its lane's 32 bytes as two 16-byte loads); the point comes
// out as [4, 8, n] 32-bit words, word i of coordinate c (X, Y, Z, T) of
// lane j at (8 c + i) n + j (a warp's stores of one word are 32 consecutive
// words, so coalesced), each the canonical value below p; valid is one byte
// a lane (1: a point, 0: not an encoding, and the identity in the words).
// One thread owns one lane.
//
// What bounds it: a lane reads 32 bytes and writes 129, and needs 257
// squarings and 27 multiplies (ops/decode_kernels.py counts them), some 70k
// int32 operations, so it is bound by operations by far.  But a lane is one
// dependent chain of those 284 products, and up to 16,384 lanes (one warp a
// scheduler) the kernel takes that chain's time, at 4,096 lanes as at
// 16,384.  The design (decode_w32.cuh) shortens the chain itself: the 262
// products of its power in radix 2^25.5, ten 64-bit column sums of one
// multiply-add a limb product and a short carry, 174 instructions a
// squaring against 218 on words.  One thread a lane: splitting a lane's
// products over two or four threads, with a barrier and a shared-memory
// exchange a product, was slower at every width (PERF.md); blocks of 64
// threads; the runs of squarings are rolled loops (unrolled, such code
// missed the instruction cache: PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_w32.cuh"

namespace {

constexpr int kDecodeThreads = 64;

using cpzk::Fe;
using cpzk::NW;

__global__ void __launch_bounds__(kDecodeThreads)
ristretto_decode_kernel(const uint8_t* __restrict__ wire, int n,
                        uint32_t* __restrict__ words, uint8_t* __restrict__ valid) {
  const long j = (long)blockIdx.x * kDecodeThreads + threadIdx.x;
  if (j >= n) return;
  const uint4* src = reinterpret_cast<const uint4*>(wire + j * 32);
  const uint4 lo = src[0], hi = src[1];
  const uint32_t in[NW] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  Fe p[4];
  const uint32_t ok = cpzk::dec_ristretto(p, in);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    Fe v;
    cpzk::fe_canonical(v, p[c]);
#pragma unroll
    for (int i = 0; i < NW; ++i) words[(long)(8 * c + i) * n + j] = v.w[i];
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
