// GF(2^255 - 19) and edwards25519 point arithmetic for one lane, in 32-bit
// words, written for an H100 thread.  Host and device code: the kernels in
// point_ops.cu call these functions per thread, and the tests compile this
// header with a host C++ compiler (through host_shim.cpp) to hold it against
// the plain PyTorch versions in cpzk_tpu_torch/ops/point_kernels.py.
//
// It is the field arithmetic of the kernels that replace
// cpzk_tpu/ops/pallas_kernels.py::_add_kernel and ::_double_k_kernel.  Those
// TPU kernels run a 20 x 13-bit signed-limb schedule because a TPU's int32
// vector units have no widening multiply.  Copied onto an H100 that schedule
// costs about 1.2k instructions a field multiply (400 products and seven
// carry rounds), and a launch took the latency of one lane's long dependent
// instruction stream.  An H100 thread has a 32 x 32 -> 64-bit multiply-add
// (IMAD.WIDE.U32), so here:
//
// * a field element is 8 unsigned 32-bit words, value = sum(w[i] 2^(32 i)),
//   kept below 2^256 but not below p (lazy reduction);
// * a multiply is 64 word products, the high 256 bits folded into the low
//   ones times 38 (2^256 = 38 mod p), and one short carry chain; a square
//   is 36 products (28 cross products, doubled, and 8 squares);
// * add, sub and x2 run one carry (or borrow) chain and fold what leaves
//   word 7 back in times 38, which for sub adds 2^256 - 38 = 2p;
// * the kernels' [20, n] loose 13-bit limbs become words once on entry
//   (fe_from_limbs) and limbs in [0, 2^13) once on exit (fe_to_limbs);
// * independent multiplies and squares of a point formula run as one
//   batch (mul_n, sq_n) whose steps are interleaved, so the thread keeps
//   several dependency chains in flight: at the main path's widths each
//   warp is about alone on its scheduler, and only its own instruction-level
//   parallelism hides the latency of each chain.
//
// Overflow: a word product plus two words is at most (2^32 - 1)^2 +
// 2 (2^32 - 1) = 2^64 - 1, so every uint64_t accumulator below is exact.
// Portable C++ only (no __int128, no inline PTX), so the host build runs
// the very code the card runs.  Right shifts of negative int64_t are
// arithmetic on every compiler this is built with (nvcc, g++).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FE_FN __host__ __device__ __forceinline__
#else
#define FE_FN static inline
#endif

namespace cpzk {

constexpr int NL = 20;  // limbs of the kernels' [20, n] interface
constexpr int LIMB_BITS = 13;
constexpr int32_t LIMB_MASK = (1 << LIMB_BITS) - 1;
constexpr int NW = 8;  // words of a field element

struct Fe {
  uint32_t w[NW];
};

// 2d mod p, little-endian words
#define CPZK_D2_WORDS                                                   \
  {0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,                  \
   0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}

// a b + x + y, exact in 64 bits: the step of every product chain below.
FE_FN uint64_t mac(uint32_t a, uint32_t b, uint32_t x, uint32_t y) {
  return (uint64_t)a * b + x + y;
}

// x[m] += 38 c[m] for carries c[m] <= 38 out of word 7.
template <int N>
FE_FN void fold_carry_n(Fe x[N], const uint32_t c[N]) {
  uint64_t t[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    t[m] = (uint64_t)x[m].w[0] + c[m] * 38u;
    x[m].w[0] = (uint32_t)t[m];
  }
#pragma unroll
  for (int i = 1; i < NW; ++i) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      t[m] = (uint64_t)x[m].w[i] + (t[m] >> 32);
      x[m].w[i] = (uint32_t)t[m];
    }
  }
  // a second carry leaves x < 38 c, so this add cannot carry
#pragma unroll
  for (int m = 0; m < N; ++m) x[m].w[0] += (uint32_t)(t[m] >> 32) * 38u;
}

// Loose limbs (value sum(l[i] 2^(13 i)), |l[i]| < 2^24, possibly negative
// or above 2^256) -> words of a congruent value in [0, 2^256).  The limbs
// are summed into an int64_t window that emits a word whenever 32 bits are
// complete; what remains above bit 256 is a small signed t, folded in as
// 38 t with a signed carry chain.
FE_FN void fe_from_limbs(Fe& out, const int32_t l[NL]) {
  uint32_t* w = out.w;
  int64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int bit = LIMB_BITS * i;
    acc += (int64_t)l[i] * ((int64_t)1 << (bit & 31));
    if ((bit + LIMB_BITS) >> 5 != bit >> 5) {
      w[bit >> 5] = (uint32_t)acc;
      acc >>= 32;
    }
  }
  int64_t s = (int64_t)w[0] + 38 * acc;
  w[0] = (uint32_t)s;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    s = (int64_t)w[i] + (s >> 32);
    w[i] = (uint32_t)s;
  }
  // the chain's carry c is -1, 0 or 1; adding 38 c again cannot carry or
  // borrow out of word 0 (the words hold less than 38 |t| when c = 1, at
  // least 2^256 - 38 |t| when c = -1)
  w[0] += (uint32_t)(38 * (s >> 32));
}

// Words -> 20 limbs in [0, 2^13), the same value (it is below 2^256).
FE_FN void fe_to_limbs(int32_t l[NL], const Fe& in) {
  const uint32_t* w = in.w;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int bit = LIMB_BITS * i, wd = bit >> 5, sh = bit & 31;
    uint32_t v = w[wd] >> sh;
    if (sh > 32 - LIMB_BITS && wd + 1 < NW) v |= w[wd + 1] << (32 - sh);
    l[i] = (int32_t)(v & LIMB_MASK);
  }
}

// 512-bit r[m] -> out[m] = r[m] mod 2^256 + 38 (r[m] >> 256), below 2^256.
template <int N>
FE_FN void reduce_wide_n(Fe out[N], const uint32_t r[N][2 * NW]) {
  uint64_t t[N];
#pragma unroll
  for (int m = 0; m < N; ++m) t[m] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      t[m] = mac(r[m][NW + i], 38u, r[m][i], (uint32_t)(t[m] >> 32));
      out[m].w[i] = (uint32_t)t[m];
    }
  }
  uint32_t c[N];
#pragma unroll
  for (int m = 0; m < N; ++m) c[m] = (uint32_t)(t[m] >> 32);
  fold_carry_n<N>(out, c);
}

// out[m] = a[m] b[m] for N independent pairs, by operand scanning: row i
// adds a[m] b[m].w[i] at word i.  Outputs may alias inputs.
template <int N>
FE_FN void mul_n(Fe out[N], const Fe a[N], const Fe b[N]) {
  uint32_t r[N][2 * NW];
  uint64_t t[N];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int m = 0; m < N; ++m) t[m] = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
      for (int m = 0; m < N; ++m) {
        t[m] = mac(a[m].w[j], b[m].w[i], i ? r[m][i + j] : 0u, (uint32_t)(t[m] >> 32));
        r[m][i + j] = (uint32_t)t[m];
      }
    }
#pragma unroll
    for (int m = 0; m < N; ++m) r[m][i + NW] = (uint32_t)(t[m] >> 32);
  }
  reduce_wide_n<N>(out, r);
}

// out[m] = a[m]^2 for N independent inputs: the 28 cross products, doubled,
// plus the 8 squares.  Outputs may alias inputs.
template <int N>
FE_FN void sq_n(Fe out[N], const Fe a[N]) {
  uint32_t r[N][2 * NW];
  uint64_t t[N];
  // cross products a[i] a[j], i < j, into r[1..14]
#pragma unroll
  for (int m = 0; m < N; ++m) {
    r[m][0] = 0;
    r[m][2 * NW - 1] = 0;
  }
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
#pragma unroll
    for (int m = 0; m < N; ++m) t[m] = 0;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
#pragma unroll
      for (int m = 0; m < N; ++m) {
        t[m] = mac(a[m].w[i], a[m].w[j], i ? r[m][i + j] : 0u, (uint32_t)(t[m] >> 32));
        r[m][i + j] = (uint32_t)t[m];
      }
    }
#pragma unroll
    for (int m = 0; m < N; ++m) r[m][i + NW] = (uint32_t)(t[m] >> 32);
  }
  // double them (the cross sum is below 2^480, so r[15] was 0)
#pragma unroll
  for (int k = 2 * NW - 1; k > 0; --k) {
#pragma unroll
    for (int m = 0; m < N; ++m) r[m][k] = (r[m][k] << 1) | (r[m][k - 1] >> 31);
  }
  // add the squares a[i]^2 at words 2i, 2i + 1
#pragma unroll
  for (int m = 0; m < N; ++m) t[m] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      t[m] = mac(a[m].w[i], a[m].w[i], r[m][2 * i], (uint32_t)(t[m] >> 32));
      r[m][2 * i] = (uint32_t)t[m];
      t[m] = (uint64_t)r[m][2 * i + 1] + (t[m] >> 32);
      r[m][2 * i + 1] = (uint32_t)t[m];
    }
  }
  reduce_wide_n<N>(out, r);
}

FE_FN void fe_mul(Fe& out, const Fe& a, const Fe& b) { mul_n<1>(&out, &a, &b); }

FE_FN void fe_sq(Fe& out, const Fe& a) { sq_n<1>(&out, &a); }

FE_FN void fe_add(Fe& out, const Fe& a, const Fe& b) {
  uint64_t t = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    t = (uint64_t)a.w[i] + b.w[i] + (t >> 32);
    out.w[i] = (uint32_t)t;
  }
  const uint32_t c = (uint32_t)(t >> 32);
  fold_carry_n<1>(&out, &c);
}

// a - b.  A borrow out of word 7 means the words wrapped by +2^256;
// subtracting 38 then makes the net change +2^256 - 38 = 2p, so the result
// stays non-negative and congruent.
FE_FN void fe_sub(Fe& out, const Fe& a, const Fe& b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    out.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  uint64_t t = (uint64_t)out.w[0] - borrow * 38u;
  out.w[0] = (uint32_t)t;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    t = (uint64_t)out.w[i] - (t >> 63);
    out.w[i] = (uint32_t)t;
  }
  // a second borrow leaves out >= 2^256 - 38, so this cannot borrow
  out.w[0] -= (uint32_t)(t >> 63) * 38u;
}

// 2 a (the plain versions' mul_small(a, 2)).
FE_FN void fe_mul2(Fe& out, const Fe& a) {
  const uint32_t c = a.w[NW - 1] >> 31;
#pragma unroll
  for (int i = NW - 1; i > 0; --i) out.w[i] = (a.w[i] << 1) | (a.w[i - 1] >> 31);
  out.w[0] = a.w[0] << 1;
  fold_carry_n<1>(&out, &c);
}

// Unified a=-1 extended addition (add-2008-hwcd-3), the formulas of
// cpzk_tpu/ops/pallas_kernels.py::_add_kernel, as two batches of four
// independent multiplies around one more (C = T1 T2 2d).  p, q and out are
// (X, Y, Z, T); out may not alias p or q.
FE_FN void point_add(Fe out[4], const Fe p[4], const Fe q[4]) {
  const Fe d2 = {CPZK_D2_WORDS};
  Fe u[4], v[4], w[4];
  fe_sub(u[0], p[1], p[0]);
  fe_sub(v[0], q[1], q[0]);
  fe_add(u[1], p[1], p[0]);
  fe_add(v[1], q[1], q[0]);
  u[2] = p[3];
  v[2] = q[3];
  u[3] = p[2];
  v[3] = q[2];
  mul_n<4>(w, u, v);  // A, B, T1 T2, Z1 Z2
  const Fe &A = w[0], &B = w[1];
  Fe C, Dv, E, F, G, H;
  fe_mul(C, w[2], d2);
  fe_mul2(Dv, w[3]);
  fe_sub(E, B, A);
  fe_sub(F, Dv, C);
  fe_add(G, Dv, C);
  fe_add(H, B, A);
  u[0] = E;
  v[0] = F;
  u[1] = G;
  v[1] = H;
  u[2] = F;
  v[2] = G;
  u[3] = E;
  v[3] = H;
  mul_n<4>(out, u, v);
}

// One a=-1 doubling round (dbl-2008-hwcd) of p's X, Y, Z in place, a batch
// of four squares and a batch of three multiplies; E and H are kept for
// the T = E H of the last round.
FE_FN void point_double_round(Fe p[4], Fe& E, Fe& H) {
  Fe s[4];
  s[0] = p[0];
  s[1] = p[1];
  s[2] = p[2];
  fe_add(s[3], p[0], p[1]);
  sq_n<4>(s, s);  // A = X^2, B = Y^2, Z^2, (X + Y)^2
  Fe C, F, G;
  fe_mul2(C, s[2]);
  fe_add(H, s[0], s[1]);
  fe_sub(E, H, s[3]);
  fe_sub(G, s[0], s[1]);
  fe_add(F, C, G);
  const Fe a[3] = {E, G, F}, b[3] = {F, H, G};
  mul_n<3>(p, a, b);
}

// k >= 1 fused a=-1 doublings (dbl-2008-hwcd) of p in place, the formulas
// of cpzk_tpu/ops/pallas_kernels.py::_double_k_kernel: only X, Y, Z pass
// between rounds; T comes from the last round.
FE_FN void point_double_k(Fe p[4], int k) {
  Fe E, H;
  for (int r = 0; r < k; ++r) point_double_round(p, E, H);
  fe_mul(p[3], E, H);
}

}  // namespace cpzk
