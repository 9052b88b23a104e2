// Ristretto255 ENCODE (RFC 9496 section 4.3.2) and the field functions it
// and DECODE need, for one lane, on the 8 x 32-bit words of
// fe25519_w32.cuh, written for an H100 thread.  Host and device code:
// prove_ops.cu calls these per thread, decode_w32.cuh builds DECODE on
// them, and the tests compile this header with a host C++ compiler
// (through host_shim.cpp) to hold it against the plain PyTorch versions in
// cpzk_tpu_torch/ops/curve.py (encode) and ops/limbs.py (canonical,
// _pow_p58, sqrt_ratio_m1, is_negative).
//
// It replaces cpzk_tpu/ops/curve.py::encode (with ops/limbs.py::_pow_p58,
// ::inv and ::sqrt_ratio_m1) inside the commitments kernel.  A field value
// here is any 8-word value below 2^256 (fe25519_w32.cuh's lazy form); only
// fe_canonical brings it below p, and every test of a value (sign, zero,
// equality) goes through it.  Everything is constant time: no branch and
// no memory address depends on a value (selects are masks), because the
// commitments encode secret multiples of the generators.
#pragma once

#include <stdint.h>

#include "fe25519_w32.cuh"

namespace cpzk {

// sqrt(-1) mod p and 1 / sqrt(a - d), little-endian words
#define CPZK_SQRT_M1_WORDS                                              \
  {0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u,                  \
   0x3dfbd7a7u, 0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u}
#define CPZK_INVSQRT_A_MINUS_D_WORDS                                    \
  {0x805d40eau, 0x99c8fdaau, 0x5a4172beu, 0x9d2f1617u,                  \
   0xfe01d840u, 0x16c27b91u, 0xcfaffca2u, 0x786c8905u}
// the curve constant d mod p
#define CPZK_D_WORDS                                                    \
  {0x135978a3u, 0x75eb4dcau, 0x4141d8abu, 0x00700a4du,                  \
   0x7779e898u, 0x8cc74079u, 0x2b6ffe73u, 0x52036ceeu}

FE_FN void fe_set_small(Fe& out, uint32_t v) {
  out.w[0] = v;
#pragma unroll
  for (int i = 1; i < NW; ++i) out.w[i] = 0;
}

// The unique representative below p of a value below 2^256.  Fold bit 255
// (2^255 = 19 mod p): the value is then below 2^255 + 19 < 2p, so one
// subtraction of p finishes; x >= p exactly when x + 19 reaches 2^255, and
// then x - p = x + 19 - 2^255.
FE_FN void fe_canonical(Fe& out, const Fe& a) {
  uint64_t t = (uint64_t)a.w[0] + 19u * (a.w[NW - 1] >> 31);
  out.w[0] = (uint32_t)t;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    t = (uint64_t)(i == NW - 1 ? a.w[i] & 0x7fffffffu : a.w[i]) + (t >> 32);
    out.w[i] = (uint32_t)t;
  }
  uint32_t y[NW];
  t = (uint64_t)out.w[0] + 19u;
  y[0] = (uint32_t)t;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    t = (uint64_t)out.w[i] + (t >> 32);
    y[i] = (uint32_t)t;
  }
  const uint32_t m = 0u - (y[NW - 1] >> 31);
  y[NW - 1] &= 0x7fffffffu;
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = (y[i] & m) | (out.w[i] & ~m);
}

// RFC 9496 sign: the parity of the canonical representative (0 or 1).
FE_FN uint32_t fe_is_negative(const Fe& a) {
  Fe c;
  fe_canonical(c, a);
  return c.w[0] & 1u;
}

// 1 when a = b mod p, else 0.
FE_FN uint32_t fe_eq(const Fe& a, const Fe& b) {
  Fe x, y;
  fe_canonical(x, a);
  fe_canonical(y, b);
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) diff |= x.w[i] ^ y.w[i];
  return (uint32_t)(((uint64_t)diff - 1u) >> 63);
}

// out = bit ? a : b, for bit in {0, 1}, by masks.
FE_FN void fe_select(Fe& out, uint32_t bit, const Fe& a, const Fe& b) {
  const uint32_t m = 0u - bit;
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = (a.w[i] & m) | (b.w[i] & ~m);
}

FE_FN void fe_neg(Fe& out, const Fe& a) {
  Fe zero;
  fe_set_small(zero, 0);
  fe_sub(out, zero, a);
}

// out = bit ? -a : a
FE_FN void fe_cneg(Fe& out, uint32_t bit, const Fe& a) {
  Fe n;
  fe_neg(n, a);
  fe_select(out, bit, n, a);
}

// |a|: the representative with an even canonical form.
FE_FN void fe_abs(Fe& out, const Fe& a) { fe_cneg(out, fe_is_negative(a), a); }

// a^(2^k), k >= 1 squarings.
FE_FN void fe_pow2k(Fe& out, const Fe& a, int k) {
  fe_sq(out, a);
  for (int i = 1; i < k; ++i) fe_sq(out, out);
}

// a^((p - 5) / 8) = a^(2^252 - 3), the addition chain of ops/limbs.py::_pow_p58.
FE_FN void fe_pow_p58(Fe& out, const Fe& a) {
  Fe t0, t1, t2, t3, t5, t6, t7, t8, t9, t10, t11, t12, u;
  fe_sq(t0, a);          // a^2
  fe_pow2k(t1, t0, 2);   // a^8
  fe_mul(t2, a, t1);     // a^9
  fe_mul(t3, t0, t2);    // a^11
  fe_sq(u, t3);          // a^22
  fe_mul(t5, t2, u);     // a^(2^5 - 1)
  fe_pow2k(u, t5, 5);
  fe_mul(t6, u, t5);     // a^(2^10 - 1)
  fe_pow2k(u, t6, 10);
  fe_mul(t7, u, t6);     // a^(2^20 - 1)
  fe_pow2k(u, t7, 20);
  fe_mul(t8, u, t7);     // a^(2^40 - 1)
  fe_pow2k(u, t8, 10);
  fe_mul(t9, u, t6);     // a^(2^50 - 1)
  fe_pow2k(u, t9, 50);
  fe_mul(t10, u, t9);    // a^(2^100 - 1)
  fe_pow2k(u, t10, 100);
  fe_mul(t11, u, t10);   // a^(2^200 - 1)
  fe_pow2k(u, t11, 50);
  fe_mul(t12, u, t9);    // a^(2^250 - 1)
  fe_pow2k(u, t12, 2);
  fe_mul(out, u, a);     // a^(2^252 - 3)
}

// SQRT_RATIO_M1 (RFC 9496 section 3.1), the steps of
// ops/limbs.py::sqrt_ratio_m1: r = |sqrt(u / v)| or |sqrt(i u / v)|; returns
// was_square (1 or 0).  v = 0 gives r = 0 and was_square = (u = 0).
FE_FN uint32_t fe_sqrt_ratio_m1(Fe& r, const Fe& u, const Fe& v) {
  const Fe sqrt_m1 = {CPZK_SQRT_M1_WORDS};
  Fe v3, v7, t, check, neg_u, neg_u_i, r_i;
  fe_sq(t, v);
  fe_mul(v3, t, v);        // v^3
  fe_sq(t, v3);
  fe_mul(v7, t, v);        // v^7
  fe_mul(t, u, v7);
  fe_pow_p58(t, t);        // (u v^7)^((p - 5) / 8)
  fe_mul(r, u, v3);
  fe_mul(r, r, t);         // r = u v^3 (u v^7)^((p - 5) / 8)
  fe_sq(t, r);
  fe_mul(check, v, t);     // v r^2
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

// The 32 little-endian bytes of the canonical representative.
FE_FN void fe_to_bytes(uint8_t out[32], const Fe& a) {
  Fe c;
  fe_canonical(c, a);
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] = (uint8_t)(c.w[i >> 2] >> (8 * (i & 3)));
}

// RFC 9496 ENCODE of the extended point p = (X, Y, Z, T), the steps of
// ops/curve.py::encode.  The identity encodes to 32 zero bytes.
FE_FN void ristretto_encode(uint8_t out[32], const Fe p[4]) {
  const Fe sqrt_m1 = {CPZK_SQRT_M1_WORDS};
  const Fe invsqrt_a_minus_d = {CPZK_INVSQRT_A_MINUS_D_WORDS};
  const Fe &X0 = p[0], &Y0 = p[1], &Z0 = p[2], &T0 = p[3];
  Fe u1, u2, t, one, invsqrt, den1, den2, z_inv;
  fe_add(t, Z0, Y0);
  fe_sub(u1, Z0, Y0);
  fe_mul(u1, t, u1);       // (Z0 + Y0)(Z0 - Y0)
  fe_mul(u2, X0, Y0);
  fe_sq(t, u2);
  fe_mul(t, u1, t);        // u1 u2^2
  fe_set_small(one, 1);
  fe_sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den1, invsqrt, u1);
  fe_mul(den2, invsqrt, u2);
  fe_mul(z_inv, den1, den2);
  fe_mul(z_inv, z_inv, T0);
  Fe ix0, iy0, enchanted;
  fe_mul(ix0, X0, sqrt_m1);
  fe_mul(iy0, Y0, sqrt_m1);
  fe_mul(enchanted, den1, invsqrt_a_minus_d);
  fe_mul(t, T0, z_inv);
  const uint32_t rotate = fe_is_negative(t);
  Fe x, y, den_inv;
  fe_select(x, rotate, iy0, X0);
  fe_select(y, rotate, ix0, Y0);
  fe_select(den_inv, rotate, enchanted, den2);
  fe_mul(t, x, z_inv);
  fe_cneg(y, fe_is_negative(t), y);
  Fe s;
  fe_sub(t, Z0, y);
  fe_mul(s, den_inv, t);
  fe_abs(s, s);
  fe_to_bytes(out, s);
}

}  // namespace cpzk
