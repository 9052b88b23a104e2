// Keccak-f[1600] on 25 native 64-bit lanes for one thread, written for an
// H100 thread.  Host and device code: keccak_ops.cu runs it per thread, and
// the tests compile this header with a host C++ compiler (through
// host_shim.cpp) to hold it against the plain PyTorch version in
// cpzk_tpu_torch/ops/keccak.py.
//
// It is the permutation of the kernel that replaces
// cpzk_tpu/ops/keccak.py::keccak_f1600 (and the absorb chain of
// cpzk_tpu/ops/challenge.py::_absorb_permute_chain).  The TPU has no 64-bit
// integer lanes, so the reference keeps each Keccak lane as an (hi, lo)
// int32 pair and rotates with cross-word shifts; an H100 thread has 64-bit
// registers (pairs of 32-bit ones) and a funnel shift, so here a lane is a
// uint64_t, a rotation is two funnel shifts, and chi's a ^ (~b & c) is one
// three-input logic op per 32-bit half.  The 24 rounds are unrolled, so
// every lane index and rotation is a constant and the state stays in
// registers.  Lane index x + 5 y, as in the reference.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define KECCAK_FN __host__ __device__ __forceinline__
#else
#define KECCAK_FN static inline
#endif

namespace cpzk {

constexpr int KECCAK_LANES = 25;
constexpr int KECCAK_ROUNDS = 24;

#define CPZK_KECCAK_RC                                                          \
  {0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,         \
   0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,         \
   0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,         \
   0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,         \
   0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,         \
   0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,         \
   0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,         \
   0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull}

// rotation offsets r[x + 5 y] of rho
#define CPZK_KECCAK_RHO                                                         \
  {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,                       \
   41, 45, 15, 21, 8, 18, 2, 61, 56, 14}

KECCAK_FN uint64_t rotl64(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

// One Keccak-f[1600] permutation of a[25] in place.
KECCAK_FN void keccak_f1600(uint64_t a[KECCAK_LANES]) {
  const uint64_t rc[KECCAK_ROUNDS] = CPZK_KECCAK_RC;
  const int rho[KECCAK_LANES] = CPZK_KECCAK_RHO;
#pragma unroll
  for (int r = 0; r < KECCAK_ROUNDS; ++r) {
    // theta
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    // rho and pi
    uint64_t b[KECCAK_LANES];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
#pragma unroll
      for (int y = 0; y < 5; ++y) {
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], rho[x + 5 * y]);
      }
    }
    // chi
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
      }
    }
    // iota
    a[0] ^= rc[r];
  }
}

// The absorb chain of row j of n: the state (hi, lo words of lane i at
// i * n + j, or at i when `shared`: one state for every row), then for
// t < k: state ^= mask t (words at (t * 25 + i) * n + j) and permute.
KECCAK_FN void keccak_chain_lane(uint64_t a[KECCAK_LANES], const uint32_t* s_hi,
                                 const uint32_t* s_lo, bool shared,
                                 const uint32_t* m_hi, const uint32_t* m_lo, int k,
                                 long n, long j) {
  const long s_stride = shared ? 1 : n, s_col = shared ? 0 : j;
#pragma unroll
  for (int i = 0; i < KECCAK_LANES; ++i) {
    a[i] = ((uint64_t)s_hi[i * s_stride + s_col] << 32) | s_lo[i * s_stride + s_col];
  }
  for (int t = 0; t < k; ++t) {
#pragma unroll
    for (int i = 0; i < KECCAK_LANES; ++i) {
      const long at = ((long)t * KECCAK_LANES + i) * n + j;
      a[i] ^= ((uint64_t)m_hi[at] << 32) | m_lo[at];
    }
    keccak_f1600(a);
  }
}

}  // namespace cpzk
