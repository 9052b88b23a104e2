// Ristretto255 DECODE (RFC 9496 section 4.3.1) of one lane, written for an
// H100 thread: the long power of its square root in radix 2^25.5 (ten
// unsigned limbs, 64-bit column sums), everything else on the 8 x 32-bit
// words of fe25519_w32.cuh and ristretto_w32.cuh.  Host and device code:
// decode_ops.cu runs a lane a thread on the card, and the tests compile this
// header with a host C++ compiler (through host_shim.cpp) to hold it
// against the plain PyTorch version (ops/curve.py decode), the JAX
// package's and the host core's.
//
// It is the body of the kernel that replaces cpzk_tpu/ops/curve.py::decode.
// A lane's DECODE is one dependent chain of 257 squarings and 27 multiplies,
// 262 of them the a^((p - 5) / 8) power of SQRT_RATIO_M1, and up to one warp
// a scheduler that chain is the kernel's time.  A squaring on 8 x 32-bit
// words is 218 instructions on the H100 (operand scanning: each word
// product's high half feeds the next add, a third of the rest moves and
// constants for the 64-bit addends, then the fold by 38 and its carry).
// Here the power runs on ten limbs, limb i of weight 2^ceil(25.5 i) (26 bits
// for even i, 25 for odd), each below 2^bits + 2^14:
//
// * a product's output limb k is one 64-bit sum of its ten (a square's five
//   or six) limb products, the factors 2 (two odd limbs) and 19 (2^255 = 19
//   mod p) folded into a 32-bit operand beforehand, each product one
//   multiply-add into the sum (ten_mad: PTX mad.wide.u32, so the operands
//   stay 32-bit; written in C, nvcc carried the limbs as 64-bit values
//   across the squaring loop and multiplied their zero high halves);
// * the sums are carried in ref10's order, two chains interleaved;
// * a squaring is 174 instructions, 56 of them IMAD.WIDE.U32; the power
//   converts from words once and back once.
//
// The other 22 products stay on words: converting their operands to limbs
// and back cost more than the limbs saved (PERF.md, as do a lane split
// over two or four threads, signed limbs and C-written products, all
// slower on the H100).  Runs of squarings are rolled loops, so the
// kernel's code stays small.  Constant time: no branch or address depends
// on a value.
#pragma once

#include <stdint.h>

#include "ristretto_w32.cuh"

namespace cpzk {

constexpr int NT = 10;  // limbs of a radix-2^25.5 element

// Ten unsigned limbs, value sum f[i] 2^ten_exp(i), limb i below
// 2^ten_bits(i) + 2^14.
struct Fe10 {
  uint32_t v[NT];
};

// Limb i's weight exponent ceil(25.5 i) (0, 26, 51, 77, ... 230) and bits.
FE_FN constexpr int ten_exp(int i) { return 25 * i + (i + 1) / 2; }
FE_FN constexpr int ten_bits(int i) { return i % 2 ? 25 : 26; }

// acc + x y, the product's operands held to 32 bits: on the card one
// mad.wide.u32 (left to itself, nvcc carried the limbs across the
// squaring loop as 64-bit values and multiplied their zero high halves).
FE_FN uint64_t ten_mad(uint32_t x, uint32_t y, uint64_t acc) {
#if defined(__CUDA_ARCH__)
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(x), "r"(y), "l"(acc));
  return d;
#else
  return (uint64_t)x * y + acc;
#endif
}

// 64-bit limb sums (each below 2^61) -> limbs within the bound: ref10's
// carry order, two chains (from limbs 0 and 4) interleaved, limb 9's carry
// into limb 0 times 19, limb 0's once more into limb 1.
FE_FN void fe10_carry(Fe10& h, uint64_t a[NT]) {
  constexpr int kOrder[12] = {0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0};
#pragma unroll
  for (int s = 0; s < 12; ++s) {
    const int i = kOrder[s], b = ten_bits(i);
    const uint64_t c = a[i] >> b;
    a[i] &= ((uint64_t)1 << b) - 1;
    if (i == NT - 1) a[0] += 19 * c;
    else a[i + 1] += c;
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) h.v[i] = (uint32_t)a[i];
}

// h = f g.  Limb products f_i g_j land in limb (i + j) mod 10 with factor 2
// when i and j are both odd (their weights' half bits) and 19 when i + j
// >= 10 (2^255 = 19); the 2 goes on f, the 19 on g, so every operand fits
// 32 bits and every limb sum 2^61.  h may alias f or g.
FE_FN void fe10_mul(Fe10& h, const Fe10& f, const Fe10& g) {
  uint32_t f2[NT], g19[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    f2[i] = 2u * f.v[i];
    g19[i] = 19u * g.v[i];
  }
  uint64_t a[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) a[k] = 0;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t x = (i & j & 1) ? f2[i] : f.v[i];
      const uint32_t y = i + j >= NT ? g19[j] : g.v[j];
      a[(i + j) % NT] = ten_mad(x, y, a[(i + j) % NT]);
    }
  }
  fe10_carry(h, a);
}

// h = f^2: the pairs i <= j once, a cross pair's factor 2 and the odd
// pair's 2 as 2 f_i and 2 f_j (or 38 f_j past the wrap).
FE_FN void fe10_sq(Fe10& h, const Fe10& f) {
  uint32_t f2[NT], f19[NT], f38[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    f2[i] = 2u * f.v[i];
    f19[i] = 19u * f.v[i];
    f38[i] = 38u * f.v[i];
  }
  uint64_t a[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) a[k] = 0;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int j = i; j < NT; ++j) {
      const int twos = (i & j & 1) + (i < j);
      const uint32_t x = twos ? f2[i] : f.v[i];
      const uint32_t y = i + j >= NT ? (twos == 2 ? f38[j] : f19[j])
                                     : (twos == 2 ? f2[j] : f.v[j]);
      a[(i + j) % NT] = ten_mad(x, y, a[(i + j) % NT]);
    }
  }
  fe10_carry(h, a);
}

// Words (a value below 2^256) -> limbs of a congruent value: the bits of
// each limb, bit 255 folded into limb 0 times 19.
FE_FN void fe10_from_words(Fe10& h, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int e = ten_exp(i), wd = e >> 5, sh = e & 31;
    uint32_t x = a.w[wd] >> sh;
    if (sh + ten_bits(i) > 32) x |= a.w[wd + 1] << (32 - sh);
    h.v[i] = x & ((1u << ten_bits(i)) - 1u);
  }
  h.v[0] += 19u * (a.w[NW - 1] >> 31);
}

// Limbs (within the bound: a value below 2^256) -> the same value in words:
// the limbs summed into a 64-bit window that emits a word whenever 32 bits
// are complete, and word 7 after the last limb.
FE_FN void fe10_to_words(Fe& out, const Fe10& h) {
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int e = ten_exp(i);
    acc += (uint64_t)h.v[i] << (e & 31);
    if ((e + ten_bits(i)) >> 5 != e >> 5) {
      out.w[e >> 5] = (uint32_t)acc;
      acc >>= 32;
    }
  }
  out.w[NW - 1] = (uint32_t)acc;
}

// a^(2^k), k >= 1 squarings, as a rolled loop.
FE_FN void fe10_pow2k(Fe10& out, const Fe10& a, int k) {
  fe10_sq(out, a);
#pragma unroll 1
  for (int i = 1; i < k; ++i) fe10_sq(out, out);
}

// a^((p - 5) / 8) = a^(2^252 - 3), the addition chain of
// ristretto_w32.cuh's fe_pow_p58, in limbs throughout.
FE_FN void fe10_pow_p58(Fe10& out, const Fe10& a) {
  Fe10 t0, t1, t2, t3, t5, t6, t9, t10, u;
  fe10_sq(t0, a);              // a^2
  fe10_pow2k(t1, t0, 2);       // a^8
  fe10_mul(t2, a, t1);         // a^9
  fe10_mul(t3, t0, t2);        // a^11
  fe10_sq(u, t3);              // a^22
  fe10_mul(t5, t2, u);         // a^(2^5 - 1)
  fe10_pow2k(u, t5, 5);
  fe10_mul(t6, u, t5);         // a^(2^10 - 1)
  fe10_pow2k(u, t6, 10);
  fe10_mul(t1, u, t6);         // a^(2^20 - 1)
  fe10_pow2k(u, t1, 20);
  fe10_mul(t1, u, t1);         // a^(2^40 - 1)
  fe10_pow2k(u, t1, 10);
  fe10_mul(t9, u, t6);         // a^(2^50 - 1)
  fe10_pow2k(u, t9, 50);
  fe10_mul(t10, u, t9);        // a^(2^100 - 1)
  fe10_pow2k(u, t10, 100);
  fe10_mul(t1, u, t10);        // a^(2^200 - 1)
  fe10_pow2k(u, t1, 50);
  fe10_mul(t1, u, t9);         // a^(2^250 - 1)
  fe10_pow2k(u, t1, 2);
  fe10_mul(out, u, a);         // a^(2^252 - 3)
}

// The power on words, through limbs: DECODE's other 22 products stay on
// words (converting their operands to limbs and back cost more than the
// limbs saved: PERF.md).
FE_FN void dec_pow_p58(Fe& out, const Fe& a) {
  Fe10 x;
  fe10_from_words(x, a);
  fe10_pow_p58(x, x);
  fe10_to_words(out, x);
}

// SQRT_RATIO_M1(u, v), the steps of ristretto_w32.cuh's fe_sqrt_ratio_m1.
FE_FN uint32_t dec_sqrt_ratio_m1(Fe& r, const Fe& u, const Fe& v) {
  const Fe sqrt_m1 = {CPZK_SQRT_M1_WORDS};
  Fe v3, v7, t, check, neg_u, neg_u_i, r_i;
  fe_sq(t, v);
  fe_mul(v3, t, v);         // v^3
  fe_sq(t, v3);
  fe_mul(v7, t, v);         // v^7
  fe_mul(t, u, v7);
  dec_pow_p58(t, t);         // (u v^7)^((p - 5) / 8)
  fe_mul(r, u, v3);
  fe_mul(r, r, t);          // r = u v^3 (u v^7)^((p - 5) / 8)
  fe_sq(t, r);
  fe_mul(check, v, t);      // v r^2
  fe_neg(neg_u, u);
  fe_mul(neg_u_i, neg_u, sqrt_m1);
  const uint32_t correct = fe_eq(check, u);
  const uint32_t flipped = fe_eq(check, neg_u);
  const uint32_t flipped_i = fe_eq(check, neg_u_i);
  fe_mul(r_i, r, sqrt_m1);
  fe_select(r, flipped | flipped_i, r_i, r);
  fe_abs(r, r);
  return correct | flipped;
}

// RFC 9496 DECODE of the 32 bytes held as 8 little-endian words, the
// steps of ops/curve.py::decode.  Returns 1 when they are the canonical
// encoding of a point, which p then holds as (x, y, 1, x y); else 0, and
// p is the identity (0, 1, 1, 0).  The checks, all taken together by
// masks: s < p (the bytes are s's own canonical encoding, bit 255 clear),
// s even, the square root exists, t = x y non-negative, y not zero.
FE_FN uint32_t dec_ristretto(Fe p[4], const uint32_t in[NW]) {
  const Fe d = {CPZK_D_WORDS};
  Fe s, c, one, zero;
#pragma unroll
  for (int i = 0; i < NW; ++i) s.w[i] = in[i];
  fe_canonical(c, s);
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) diff |= c.w[i] ^ s.w[i];
  const uint32_t canonical_ok = (uint32_t)(((uint64_t)diff - 1u) >> 63);
  const uint32_t even_ok = 1u - (in[0] & 1u);
  fe_set_small(one, 1);
  fe_set_small(zero, 0);
  Fe ss, u1, u2, u2_sqr, v, t;
  fe_sq(ss, s);
  fe_sub(u1, one, ss);       // 1 - s^2
  fe_add(u2, one, ss);       // 1 + s^2
  fe_sq(u2_sqr, u2);
  fe_sq(t, u1);
  fe_mul(t, d, t);
  fe_neg(t, t);
  fe_sub(v, t, u2_sqr);      // -(d u1^2) - u2^2
  fe_mul(t, v, u2_sqr);
  Fe invsqrt, den_x, den_y, x, y;
  const uint32_t was_square = dec_sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den_x, invsqrt, u2);
  fe_mul(den_y, invsqrt, den_x);
  fe_mul(den_y, den_y, v);
  fe_mul2(x, s);
  fe_mul(x, x, den_x);
  fe_abs(x, x);              // |2 s den_x|
  fe_mul(y, u1, den_y);
  fe_mul(t, x, y);
  const uint32_t valid = canonical_ok & even_ok & was_square &
                         (1u - fe_is_negative(t)) & (1u - fe_eq(y, zero));
  fe_select(p[0], valid, x, zero);
  fe_select(p[1], valid, y, one);
  p[2] = one;
  fe_select(p[3], valid, t, zero);
  return valid;
}

}  // namespace cpzk
