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

// ---------------------------------------------------------------------------
// rlc_scalars (scalar_ops.cu): the bodies its threads run
// ---------------------------------------------------------------------------

// The sum of a s over the rows is kept as a plain integer in 9 words, with
// carries and no reduction mod l (the rows' a s mod l are below 2^253, so
// up to 2^27 rows sum below 2^280), and reduced once, at the end: exact
// in any order, so the result is that of the sum mod l.
constexpr int RLC_SUM_WORDS = NW + 1;
// threads a block (two a row: rlc_row)
constexpr int RLC_THREADS = 128;

// The operands of one call: [20, n] canonical limbs a, c, s in and a c,
// b a, b a c out, limb i of row j at i n + j.
struct RlcRows {
  const int32_t* a;
  const int32_t* c;
  const int32_t* s;
  int32_t* ac;
  int32_t* ba;
  int32_t* bac;
  long n;
};

// Limbs of row j (limb i at i stride + j) <-> a scalar.
FE_FN void sc_load(Sc& out, const int32_t* src, long stride, long j) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = src[(long)i * stride + j];
  sc_from_limbs(out, l);
}

FE_FN void sc_store(int32_t* dst, const Sc& v, long stride, long j) {
  int32_t l[NL];
  sc_to_limbs(l, v);
#pragma unroll
  for (int i = 0; i < NL; ++i) dst[(long)i * stride + j] = l[i];
}

FE_FN void sc9_zero(uint32_t x[RLC_SUM_WORDS]) {
#pragma unroll
  for (int i = 0; i < RLC_SUM_WORDS; ++i) x[i] = 0;
}

// x += y, carries only (the sums stay far below 2^288).
FE_FN void sc9_add(uint32_t x[RLC_SUM_WORDS], const uint32_t y[RLC_SUM_WORDS]) {
  uint64_t t = 0;
#pragma unroll
  for (int i = 0; i < RLC_SUM_WORDS; ++i) {
    t = (uint64_t)x[i] + y[i] + (t >> 32);
    x[i] = (uint32_t)t;
  }
}

// Row j < rows.n as thread `part` (0 or 1) of its two: part 0 a c (into
// rows.ac) and b (a c) (into rows.bac), part 1 a s (into as, its term of
// the sum) and b a (into rows.ba), so a row's chain is two products.  Both
// parts run the same two products on operands picked by the part, so the
// two threads of a row do not diverge; as is 0 for part 0.
FE_FN void rlc_row(uint32_t as[RLC_SUM_WORDS], const RlcRows& rows, const Sc& b, long j,
                   int part) {
  Sc a, y, t, v, u;
  sc_load(a, rows.a, rows.n, j);
  sc_load(y, part ? rows.s : rows.c, rows.n, j);
  sc_mul(t, a, y);
#pragma unroll
  for (int i = 0; i < NW; ++i) v.w[i] = part ? a.w[i] : t.w[i];
  sc_mul(u, b, v);
  sc_store(part ? rows.ba : rows.bac, u, rows.n, j);
  sc9_zero(as);
  if (part) {
#pragma unroll
    for (int i = 0; i < NW; ++i) as[i] = t.w[i];
  } else {
    sc_store(rows.ac, t, rows.n, j);
  }
}

// The last step: S = total mod l (the 9-word sum of every row's a s), then
// corr0 = -S and corr1 = -b S into [20, 1] limbs.
FE_FN void rlc_finish(int32_t* corr0, int32_t* corr1, const uint32_t total[RLC_SUM_WORDS],
                      const Sc& b) {
  uint32_t w[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) w[i] = i < RLC_SUM_WORDS ? total[i] : 0u;
  Sc sum, r;
  sc_reduce_wide(sum, w);
  sc_neg(r, sum);
  sc_store(corr0, r, 1, 0);
  sc_mul(r, b, sum);
  sc_neg(r, r);
  sc_store(corr1, r, 1, 0);
}

}  // namespace cpzk
