// Keccak-f[1600] and the absorb chain of one row on the two 32-bit halves
// of its 25 lanes, written for a pair of H100 threads.  Host and device
// code: keccak_ops.cu runs a row on two threads of a warp, and the tests
// compile this header with a host C++ compiler (through host_shim.cpp) to
// hold it against the plain PyTorch version in cpzk_tpu_torch/ops/keccak.py.
//
// It is the permutation of the kernel that replaces
// cpzk_tpu/ops/keccak.py::keccak_f1600 (and the absorb chain of
// cpzk_tpu/ops/challenge.py::_absorb_permute_chain).  The reference keeps
// each lane as an (hi, lo) int32 pair; so does this code.  On the card a
// row's two threads (neighbouring lanes of a warp, part = lane & 1) each
// hold one half of all 25 lanes: part 0 the lo words, part 1 the hi words.
// Theta's column parities, chi and the mask XORs are bitwise, so each
// thread does them on its half alone; a 64-bit rotation needs the other
// half, which one __shfl_xor_sync(.., 1) fetches, then one funnel shift
// gives this half of the result (the same instruction on both threads, so
// nothing diverges).  A round is ~90 int32 operations and 29 shuffles a
// thread, against ~180 operations for one thread holding the whole row:
// a row's dependent chain is about halved, for the same work a row.
//
// On the host one call runs both threads of a pair (KeccakPair holds both
// halves; its rotation reads the other half directly), so the host tests
// run the formulas the card runs.  Within a round every lane index and
// rotation is a constant, so the state stays in registers.  Lane index
// x + 5 y, as in the reference.
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

// The upper word of (hi:lo) << s, 0 <= s < 32.
KECCAK_FN uint32_t keccak_funnel(uint32_t lo, uint32_t hi, int s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(lo, hi, s);
#else
  return s == 0 ? hi : (hi << s) | (lo >> (32 - s));
#endif
}

// This half of a lane rotated left by 0 < r < 64, from this half and the
// other: the same formula for the hi and the lo half.
KECCAK_FN uint32_t keccak_rot_half(uint32_t mine, uint32_t other, int r) {
  return r < 32 ? keccak_funnel(other, mine, r) : keccak_funnel(mine, other, r - 32);
}

// Both halves of a lane: w[0] lo, w[1] hi (one call is both threads of a
// pair: the host's form).
struct KeccakPair {
  uint32_t w[2];
};

KECCAK_FN KeccakPair keccak_xor(KeccakPair a, KeccakPair b) {
  return {{a.w[0] ^ b.w[0], a.w[1] ^ b.w[1]}};
}

KECCAK_FN KeccakPair keccak_chi(KeccakPair a, KeccakPair b, KeccakPair c) {
  return {{a.w[0] ^ (~b.w[0] & c.w[0]), a.w[1] ^ (~b.w[1] & c.w[1])}};
}

KECCAK_FN KeccakPair keccak_rotl(KeccakPair x, int r) {
  return {{keccak_rot_half(x.w[0], x.w[1], r), keccak_rot_half(x.w[1], x.w[0], r)}};
}

KECCAK_FN void keccak_iota(KeccakPair& a, uint64_t rc, int) {
  a.w[0] ^= (uint32_t)rc;
  a.w[1] ^= (uint32_t)(rc >> 32);
}

// Word at of a row's (hi, lo) arrays into a lane.
KECCAK_FN void keccak_load(KeccakPair& a, const uint32_t* hi, const uint32_t* lo, long at,
                           int) {
  a.w[0] = lo[at];
  a.w[1] = hi[at];
}

KECCAK_FN void keccak_store(uint32_t* hi, uint32_t* lo, long at, KeccakPair a, int) {
  lo[at] = a.w[0];
  hi[at] = a.w[1];
}

#if defined(__CUDACC__)
// This thread's half of a lane (part 0 lo, part 1 hi); its pair is the
// neighbouring lane of the warp, and every lane of the warp takes part in
// each rotation's shuffle.  Card code only: the host runs a pair's two
// threads at once as a KeccakPair.
struct KeccakHalf {
  uint32_t w;
};

KECCAK_FN KeccakHalf keccak_xor(KeccakHalf a, KeccakHalf b) { return {a.w ^ b.w}; }

KECCAK_FN KeccakHalf keccak_chi(KeccakHalf a, KeccakHalf b, KeccakHalf c) {
  return {a.w ^ (~b.w & c.w)};
}

KECCAK_FN KeccakHalf keccak_rotl(KeccakHalf x, int r) {
#if defined(__CUDA_ARCH__)
  return {keccak_rot_half(x.w, __shfl_xor_sync(0xffffffffu, x.w, 1), r)};
#else
  return {keccak_rot_half(x.w, x.w, r)};  // not reached: no host code holds a KeccakHalf
#endif
}

KECCAK_FN void keccak_iota(KeccakHalf& a, uint64_t rc, int part) {
  a.w ^= part ? (uint32_t)(rc >> 32) : (uint32_t)rc;
}

KECCAK_FN void keccak_load(KeccakHalf& a, const uint32_t* hi, const uint32_t* lo, long at,
                           int part) {
  a.w = (part ? hi : lo)[at];
}

KECCAK_FN void keccak_store(uint32_t* hi, uint32_t* lo, long at, KeccakHalf a, int part) {
  (part ? hi : lo)[at] = a.w;
}
#endif

#if defined(__CUDACC__)
// the round constants of the card's rolled round loop
__constant__ uint64_t kKeccakRc[KECCAK_ROUNDS] = CPZK_KECCAK_RC;
#endif

// One round of a[25] in place with round constant rc (W: a KeccakPair, or
// on the card the KeccakHalf of thread `part`).
template <class W>
KECCAK_FN void keccak_round(W a[KECCAK_LANES], uint64_t rc, int part) {
  const int rho[KECCAK_LANES] = CPZK_KECCAK_RHO;
  // theta
  W c[5];
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    c[x] = keccak_xor(keccak_xor(keccak_xor(a[x], a[x + 5]), keccak_xor(a[x + 10], a[x + 15])),
                      a[x + 20]);
  }
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    const W d = keccak_xor(c[(x + 4) % 5], keccak_rotl(c[(x + 1) % 5], 1));
#pragma unroll
    for (int y = 0; y < 5; ++y) a[x + 5 * y] = keccak_xor(a[x + 5 * y], d);
  }
  // rho and pi
  W b[KECCAK_LANES];
  b[0] = a[0];
#pragma unroll
  for (int i = 1; i < KECCAK_LANES; ++i) {
    const int x = i % 5, y = i / 5;
    b[y + 5 * ((2 * x + 3 * y) % 5)] = keccak_rotl(a[i], rho[i]);
  }
  // chi
#pragma unroll
  for (int y = 0; y < 5; ++y) {
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      a[x + 5 * y] = keccak_chi(b[x + 5 * y], b[(x + 1) % 5 + 5 * y], b[(x + 2) % 5 + 5 * y]);
    }
  }
  // iota
  keccak_iota(a[0], rc, part);
}

// One Keccak-f[1600] permutation of a[25] in place.  On the card the rounds
// are a loop of two iterations of twelve rounds (~1,950 instructions in
// all), the fastest of the unrollings timed on the H100: all 24 rounds,
// ~3,400 instructions, missed the instruction cache (1.08-1.21x the time
// of a one-round loop at 4096 to 20,480 rows), one round an iteration
// spent ~27 more logic ops a round at the back edge (1-6% slower than
// twelve), and 2 or 3 rounds an iteration ran 1.1-1.6x slower.
template <class W>
KECCAK_FN void keccak_f1600(W a[KECCAK_LANES], int part) {
#if defined(__CUDA_ARCH__)
#pragma unroll 12
  for (int r = 0; r < KECCAK_ROUNDS; ++r) keccak_round(a, kKeccakRc[r], part);
#else
  const uint64_t rc[KECCAK_ROUNDS] = CPZK_KECCAK_RC;
#pragma unroll
  for (int r = 0; r < KECCAK_ROUNDS; ++r) keccak_round(a, rc[r], part);
#endif
}

// The absorb chain of row j of n: the state (hi, lo words of lane i at
// i * n + j, or at i when `shared`: one state for every row), then for
// t < k: state ^= mask t (words at (t * 25 + i) * n + j) and permute.
// Mask t + 1 is loaded before permutation t starts, so its loads are in
// flight while the permutation runs.
template <class W>
KECCAK_FN void keccak_chain_row(W a[KECCAK_LANES], const uint32_t* s_hi, const uint32_t* s_lo,
                                bool shared, const uint32_t* m_hi, const uint32_t* m_lo, int k,
                                long n, long j, int part) {
  const long s_stride = shared ? 1 : n, s_col = shared ? 0 : j;
#pragma unroll
  for (int i = 0; i < KECCAK_LANES; ++i) keccak_load(a[i], s_hi, s_lo, i * s_stride + s_col, part);
  if (k < 1) return;
  W m[KECCAK_LANES];
#pragma unroll
  for (int i = 0; i < KECCAK_LANES; ++i) keccak_load(m[i], m_hi, m_lo, (long)i * n + j, part);
  for (int t = 0; t < k; ++t) {
#pragma unroll
    for (int i = 0; i < KECCAK_LANES; ++i) a[i] = keccak_xor(a[i], m[i]);
    // the next mask (the last one again after the last step: no branch)
    const long next = (long)(t + 1 < k ? t + 1 : t) * KECCAK_LANES * n + j;
#pragma unroll
    for (int i = 0; i < KECCAK_LANES; ++i) keccak_load(m[i], m_hi, m_lo, next + i * n, part);
    keccak_f1600(a, part);
  }
}

}  // namespace cpzk
