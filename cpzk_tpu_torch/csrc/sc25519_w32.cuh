// Arithmetic mod l (the ristretto255 group order) for one lane, in 32-bit
// words, written for an H100 thread.  Host and device code: the kernels in
// scalar_ops.cu call these functions per thread, and the tests compile this
// header with a host C++ compiler (through host_shim.cpp) to hold it against
// the plain PyTorch versions in cpzk_tpu_torch/ops/sclimbs.py.
//
// It is the scalar arithmetic of the kernels that replace the reference's
// device scalar plane (cpzk_tpu/ops/sclimbs.py under
// cpzk_tpu/ops/backend.py::_rlc_products, _rlc_scalar_groups and
// _signed_digits_jit).  The TPU version runs 20 x 13-bit limbs with a
// Barrett reduction at base 2^13, because a TPU's int32 vector units have no
// widening multiply.  An H100 thread has a 32 x 32 -> 64-bit multiply-add, so
// here:
//
// * a scalar is 8 unsigned 32-bit words, value = sum(w[i] 2^(32 i)); every
//   function takes and returns canonical values (below l), as the plain
//   versions do;
// * a product is 64 word products into 16 words, reduced by Barrett
//   (HAC 14.42) at base b = 2^32, k = 8: l = 2^252 + d has a 125-bit d, so
//   there is no cheap fold as for p; mu = floor(b^16 / l) has 9 words, the
//   quotient estimate is at most 2 below the true one, and two conditional
//   subtractions of l finish;
// * the kernels' [20, n] canonical 13-bit limbs become words on entry
//   (sc_from_limbs) and limbs once on exit (sc_to_limbs);
// * the 4-bit window recode (MSB window first) and the signed c-bit recode
//   (LSB window first, digits in [-2^(c-1), 2^(c-1)], a carry chain) read
//   the words directly.
//
// Portable C++ only (no __int128, no inline PTX), so the host build runs the
// very code the card runs.
#pragma once

#include <stdint.h>

#include "fe25519_w32.cuh"

namespace cpzk {

struct Sc {
  uint32_t w[NW];
};

// l, little-endian words
#define CPZK_L_WORDS                                                    \
  {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,                  \
   0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u}
// mu = floor(2^512 / l), 9 words (it is below 2^260)
#define CPZK_MU_WORDS                                                   \
  {0x0a2c131bu, 0xed9ce5a3u, 0x086329a7u, 0x2106215du, 0xffffffebu,     \
   0xffffffffu, 0xffffffffu, 0xffffffffu, 0x0000000fu}

// Canonical limbs (digits in [0, 2^13), value below 2^256) -> words.
FE_FN void sc_from_limbs(Sc& out, const int32_t l[NL]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int bit = LIMB_BITS * i, wd = bit >> 5, sh = bit & 31;
    const uint32_t v = (uint32_t)l[i];
    if (wd < NW) out.w[wd] |= v << sh;
    if (sh > 32 - LIMB_BITS && wd + 1 < NW) out.w[wd + 1] |= v >> (32 - sh);
  }
}

// Words -> 20 limbs in [0, 2^13), the same value.
FE_FN void sc_to_limbs(int32_t l[NL], const Sc& in) {
  Fe f;
#pragma unroll
  for (int i = 0; i < NW; ++i) f.w[i] = in.w[i];
  fe_to_limbs(l, f);
}

// x >= l for a 9-word x.
FE_FN bool sc_geq_l9(const uint32_t x[NW + 1]) {
  const uint32_t l[NW] = CPZK_L_WORDS;
  if (x[NW]) return true;
#pragma unroll
  for (int i = NW - 1; i >= 0; --i) {
    if (x[i] != l[i]) return x[i] > l[i];
  }
  return true;
}

// x -= l for a 9-word x >= l.
FE_FN void sc_sub_l9(uint32_t x[NW + 1]) {
  const uint32_t l[NW] = CPZK_L_WORDS;
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)x[i] - l[i] - borrow;
    x[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  x[NW] -= borrow;
}

// 16-word x (below 2^512) -> x mod l (Barrett, HAC 14.42, b = 2^32, k = 8).
FE_FN void sc_reduce_wide(Sc& out, const uint32_t x[2 * NW]) {
  const uint32_t mu[NW + 1] = CPZK_MU_WORDS;
  const uint32_t l[NW] = CPZK_L_WORDS;
  // q1 = floor(x / b^7) (9 words); q2 = q1 mu (18 words); q3 = floor(q2 / b^9)
  uint32_t q2[2 * NW + 2];
#pragma unroll
  for (int i = 0; i < 2 * NW + 2; ++i) q2[i] = 0;
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) {
    uint64_t t = 0;
#pragma unroll
    for (int j = 0; j < NW + 1; ++j) {
      t = mac(x[NW - 1 + i], mu[j], q2[i + j], (uint32_t)(t >> 32));
      q2[i + j] = (uint32_t)t;
    }
    q2[i + NW + 1] = (uint32_t)(t >> 32);
  }
  const uint32_t* q3 = q2 + NW + 1;  // 9 words
  // r2 = (q3 l) mod b^9
  uint32_t r2[NW + 1];
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) r2[i] = 0;
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) {
    uint64_t t = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (i + j < NW + 1) {
        t = mac(q3[i], l[j], r2[i + j], (uint32_t)(t >> 32));
        r2[i + j] = (uint32_t)t;
      }
    }
    if (i + NW < NW + 1) r2[i + NW] += (uint32_t)(t >> 32);
  }
  // r = (x mod b^9) - r2, modulo b^9 (which adds b^9 when it is negative)
  uint32_t r[NW + 1];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) {
    const uint64_t t = (uint64_t)x[i] - r2[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  // r < 3l: at most two subtractions
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (sc_geq_l9(r)) sc_sub_l9(r);
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = r[i];
}

// Canonical 13-bit limbs l[0 .. 40) of a value below 2^512 (the layout of
// cpzk_tpu/ops/sclimbs.py::bytes_wide_to_limbs; unused high limbs 0) -> 16
// words, the input of sc_reduce_wide.
FE_FN void sc_wide_from_limbs(uint32_t x[2 * NW], const int32_t l[2 * NL]) {
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) x[i] = 0;
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) {
    const int bit = LIMB_BITS * i, wd = bit >> 5, sh = bit & 31;
    const uint32_t v = (uint32_t)l[i];
    if (wd < 2 * NW) x[wd] |= v << sh;
    if (sh > 32 - LIMB_BITS && wd + 1 < 2 * NW) x[wd + 1] |= v >> (32 - sh);
  }
}

// out = a b mod l.  out may alias a or b.
FE_FN void sc_mul(Sc& out, const Sc& a, const Sc& b) {
  uint32_t r[2 * NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      t = mac(a.w[j], b.w[i], i ? r[i + j] : 0u, (uint32_t)(t >> 32));
      r[i + j] = (uint32_t)t;
    }
    r[i + NW] = (uint32_t)(t >> 32);
  }
  sc_reduce_wide(out, r);
}

// out = a + b mod l (the sum is below 2l < 2^254).
FE_FN void sc_add(Sc& out, const Sc& a, const Sc& b) {
  uint32_t r[NW + 1];
  uint64_t t = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    t = (uint64_t)a.w[i] + b.w[i] + (t >> 32);
    r[i] = (uint32_t)t;
  }
  r[NW] = (uint32_t)(t >> 32);
  if (sc_geq_l9(r)) sc_sub_l9(r);
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = r[i];
}

// out = l - a, with 0 -> 0.
FE_FN void sc_neg(Sc& out, const Sc& a) {
  const uint32_t l[NW] = CPZK_L_WORDS;
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) any |= a.w[i];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)l[i] - a.w[i] - borrow;
    out.w[i] = any ? (uint32_t)t : 0u;
    borrow = (uint32_t)(t >> 63);
  }
}

FE_FN void sc_zero(Sc& out) {
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = 0;
}

// The 64 4-bit windows of a (below 2^256), most significant first:
// out[k * stride] is the window of bits 4 (63 - k) .. 4 (63 - k) + 3, the
// layout of cpzk_tpu/ops/curve.py::scalars_to_windows.
FE_FN void sc_windows4(int32_t* out, long stride, const Sc& a) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    out[(long)(63 - i) * stride] = (int32_t)((a.w[i >> 3] >> (4 * (i & 7))) & 15u);
  }
}

// The nwin signed c-bit digits of a (below 2^253), least significant window
// first: out[k * stride] for k < nwin, digit k of weight 2^(c k), in
// [-2^(c-1), 2^(c-1)]: the unsigned window plus the carry, less 2^c (and a
// carry of 1 into the next) when that reaches 2^(c-1).  4 <= c <= 16, and
// nwin c >= 256, so the last carry is 0 for a < 2^(c nwin - 1).
FE_FN void sc_signed_digits(int32_t* out, long stride, const Sc& a, int c, int nwin) {
  const int half = 1 << (c - 1);
  int carry = 0;
  for (int k = 0; k < nwin; ++k) {
    const int bit = c * k, wd = bit >> 5, sh = bit & 31;
    uint64_t v = 0;
    if (wd < NW) v = a.w[wd];
    if (wd + 1 < NW) v |= (uint64_t)a.w[wd + 1] << 32;
    const int t = (int)((v >> sh) & ((1u << c) - 1u)) + carry;
    carry = t >= half;
    out[(long)k * stride] = t - (carry << c);
  }
}

}  // namespace cpzk
