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
// * a product is 64 word products into 16 words, reduced by folding at
//   bit 252 (l = 2^252 + c with a 125-bit c, so 2^252 = -c mod l): three
//   folds by c (60 word products, where Barrett at base 2^32 takes 125)
//   and one conditional subtraction of l (sc_reduce_wide);
// * the kernels' [20, n] canonical 13-bit limbs become words on entry
//   (sc_from_limbs) and limbs once on exit (sc_to_limbs); the recodes
//   read the words directly (recode_w32.cuh).
//
// Portable C++ only (no __int128; one inline-PTX load, sc_load_early, on the
// card only), so the host build runs the very arithmetic the card runs.
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

// 16-word x (below 2^512) -> x mod l, by folding at bit 252: l = 2^252 + c
// with c < 2^125 (four words), so 2^252 = -c (mod l) and x = x_lo + 2^252
// x_hi = x_lo - c x_hi.  Three folds, each adding l to stay positive:
//   t = c x_hi      (x_hi < 2^260: 4 x 9 word products, t < 2^385)
//   u = c t_hi      (t_hi < 2^133: 4 x 5, u < 2^258)
//   v = x_lo + l - t_lo + u           (0 < v < 2^259)
//   w = v_lo + l - c v_hi             (v_hi < 2^7; l - 2^132 < w < 2l)
// and one conditional subtraction of l: 60 word products in all, where a
// Barrett reduction at base 2^32 (q1 mu and q3 l) takes 125.
FE_FN void sc_reduce_wide(Sc& out, const uint32_t x[2 * NW]) {
  const uint32_t c[4] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu};
  const uint32_t l[NW] = CPZK_L_WORDS;
  constexpr uint32_t LO28 = 0x0fffffffu;  // word 7's bits below 2^252
  // x_hi = x >> 252 (9 words, the top one 4 bits)
  uint32_t h[NW + 1];
#pragma unroll
  for (int i = 0; i < NW; ++i) h[i] = (x[NW - 1 + i] >> 28) | (x[NW + i] << 4);
  h[NW] = x[2 * NW - 1] >> 28;
  // t = c h (13 words), a row a word of h
  uint32_t t[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = mac(c[j], h[i], t[i + j], (uint32_t)(acc >> 32));
      t[i + j] = (uint32_t)acc;
    }
    t[i + 4] = (uint32_t)(acc >> 32);
  }
  // u = c (t >> 252) (9 words; t >> 252 has 5, the top one 5 bits)
  uint32_t th[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) th[i] = (t[NW - 1 + i] >> 28) | (t[NW + i] << 4);
  uint32_t u[NW + 1];
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) u[i] = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = mac(c[j], th[i], u[i + j], (uint32_t)(acc >> 32));
      u[i + j] = (uint32_t)acc;
    }
    u[i + 4] = (uint32_t)(acc >> 32);
  }
  // v = x_lo + l - t_lo + u (9 words, below 2^259), a signed carry chain
  uint32_t v[NW + 1];
  int64_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) {
    const uint32_t xi = i < NW - 1 ? x[i] : i == NW - 1 ? x[i] & LO28 : 0u;
    const uint32_t ti = i < NW - 1 ? t[i] : i == NW - 1 ? t[i] & LO28 : 0u;
    const uint32_t li = i < NW ? l[i] : 0u;
    const int64_t s = (int64_t)xi + li + u[i] - ti + carry;
    v[i] = (uint32_t)s;
    carry = s >> 32;
  }
  // w = v_lo + l - c q, q = v >> 252 (below 2^7); l - 2^132 < w < 2l
  const uint32_t q = (v[NW - 1] >> 28) | (v[NW] << 4);
  uint32_t cq[5];
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = mac(c[j], q, 0u, (uint32_t)(acc >> 32));
    cq[j] = (uint32_t)acc;
  }
  cq[4] = (uint32_t)(acc >> 32);
  uint32_t w[NW + 1];
  carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t vi = i < NW - 1 ? v[i] : v[i] & LO28;
    const int64_t s = (int64_t)vi + l[i] - (i < 5 ? cq[i] : 0u) + carry;
    w[i] = (uint32_t)s;
    carry = s >> 32;
  }
  w[NW] = (uint32_t)carry;
  if (sc_geq_l9(w)) sc_sub_l9(w);
#pragma unroll
  for (int i = 0; i < NW; ++i) out.w[i] = w[i];
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

// p[at] if `load`, else 0, loaded where it stands: on the card by a
// predicated inline-PTX load, which the compiler neither moves towards the
// value's first use nor guards by a branch (on the H100 plain loads left a
// lane's Barrett reduction 0.1-0.5 us slower than these, and the fold
// slower than Barrett); on the host a plain load.
FE_FN int32_t sc_load_early(const int32_t* p, long at, bool load) {
#if defined(__CUDA_ARCH__)
  int32_t v;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\tmov.b32 %0, 0;\n\t"
      "@q ld.global.nc.b32 %0, [%1];\n\t}"
      : "=r"(v)
      : "l"(__cvta_generic_to_global(p + at)), "r"((unsigned)load)
      : "memory");
  return v;
#else
  return load ? p[at] : 0;
#endif
}

// reduce_wide_kernel's lane body (scalar_ops.cu): lane j < n of the
// rows <= 40 canonical 13-bit limbs of x (limb i at i n + j, a value below
// 2^512; the limbs past `rows` are 0) reduced mod l into out's 20 limbs.
FE_FN void reduce_wide_lane(const int32_t* x, int rows, int32_t* out, long n, long j) {
  int32_t l[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) l[i] = sc_load_early(x, (long)i * n + j, i < rows);
  uint32_t w[2 * NW];
  sc_wide_from_limbs(w, l);
  Sc r;
  sc_reduce_wide(r, w);
  sc_store(out, r, n, j);
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
