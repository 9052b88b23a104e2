// The thread bodies of the batch prover's two kernels (prove_ops.cu) on the
// words of fe25519_w32.cuh: the comb table's build (a doubling chain on a
// quad, the entries by doublings and adds, one inversion a window) and the
// walk (a signed digit a window, a constant-time select, a mixed add).
// Host and device code: the tests compile this header with a host C++
// compiler (through host_shim.cpp), whose entry points run every thread of every
// phase in the kernels' order, to hold the bodies against the plain PyTorch
// versions in cpzk_tpu_torch/ops/prove_kernels.py.
//
// Table layout (the kernels' own): window w, entry j, coordinate c, word i
// at ((w * COMB_ENTRIES + j) * 3 + c) * 8 + i, as canonical uint32 words
// (below p).  Entry j of window w is the point j 16^w P in affine form
// (x, y), stored as (y - x, y + x, 2d x y): pt_cached's form with Z = 1, so
// that the walk's add needs no Z2 product (a mixed add, 7 multiplies).  A
// window holds entries 0 .. 8 (9 x 24 words, 864 bytes; entry 0 is the
// identity, (1, 1, 0)), a table 64 windows (55,296 bytes).
//
// Digits.  The kernel takes a scalar's 64 unsigned nibbles d_w (LSB window
// first) and recodes them as it walks, in 65 steps: below the top window,
// v = d_w + carry, carry = (v >= 8), e_w = v - 16 carry in [-8, 7]; the top
// window's v = d_63 + carry (0 .. 16, unrecoded, as dalek's to_radix_16)
// is split over two steps on window 63's entries, min(v, 8) and the rest
// (0 .. 8, zero for any scalar below 2^255), so every nibble is accepted.
// sum_w e_w 16^w is the scalar, and e_w P is entry |e_w|, negated when
// e_w < 0 by swapping y - x and y + x and negating 2d x y.
//
// Constant time.  The nibbles are those of secret scalars (nonces k,
// witnesses x).  The recode is arithmetic (shifts and masks), the select
// reads every entry of the window and keeps one by a mask, the negation
// is a masked swap and a masked negation, the add and ENCODE have no
// branch on a value: no address and no branch depends on a digit, a carry
// or a sign.  The table build works on the public generator only.
#pragma once

#include <stdint.h>

#include "fe25519_w32.cuh"
#include "msm_w32.cuh"
#include "ristretto_w32.cuh"

namespace cpzk {

constexpr int COMB_WINDOWS = 64;
constexpr int COMB_ENTRIES = 9;
// the walk's steps: one a window, and a second on the top window
constexpr int COMB_STEPS = COMB_WINDOWS + 1;
constexpr int COMB_ENTRY_WORDS = 3 * NW;
constexpr int COMB_WINDOW_WORDS = COMB_ENTRIES * COMB_ENTRY_WORDS;
constexpr int COMB_TABLE_WORDS = COMB_WINDOWS * COMB_WINDOW_WORDS;
// the build's scratch: every entry in extended form (X, Y, Z, T)
constexpr int COMB_EXT_WORDS = COMB_WINDOWS * COMB_ENTRIES * PT_WORDS;
// the build's levels: level l makes the entries j in (2^(l-1), 2^l]
constexpr int COMB_LEVELS = 3;

FE_FN uint32_t* comb_ext(uint32_t* ext, int w, int j) {
  return ext + (w * COMB_ENTRIES + j) * PT_WORDS;
}

// Coordinate c of a point's 32 words.
FE_FN void comb_load_coord(Fe& v, const uint32_t* src, int c) {
#pragma unroll
  for (int i = 0; i < NW; ++i) v.w[i] = src[c * NW + i];
}

// a^(p - 2) = 1 / a (a != 0): a^(2^252 - 3), three squarings, times a^3.
FE_FN void fe_invert(Fe& out, const Fe& a) {
  Fe t, a3;
  fe_pow_p58(t, a);
  fe_pow2k(t, t, 3);
  fe_sq(a3, a);
  fe_mul(a3, a3, a);
  fe_mul(out, t, a3);
}

// ---------------------------------------------------------------------------
// comb_tables (one block): the bases, the entries, then the affine form
// ---------------------------------------------------------------------------

// Phase 1, one quad: the window bases 16^w P as entry 1 of each window, by
// one chain of 252 doublings on the quad (quad_double_round: a square, a
// gather, a product, a gather), each base stored every 4 rounds.  On the
// card lane r of the quad stores coordinate r; on the host one call is the
// whole quad.
FE_FN void comb_store_base(uint32_t* dst, const Fe p[4], Quad qd) {
#if defined(__CUDA_ARCH__)
  Fe v;
  fe_pick(v, p[0], p[1], p[2], p[3], qd.r);
#pragma unroll
  for (int i = 0; i < NW; ++i) dst[qd.r * NW + i] = v.w[i];
#else
  (void)qd;
  pt_store_words(dst, p);
#endif
}

MSM_FN void comb_bases(uint32_t* ext, Fe p[4], Quad qd) {
  comb_store_base(comb_ext(ext, 0, 1), p, qd);
  for (int w = 1; w < COMB_WINDOWS; ++w) {
    quad_double_k(p, 4, qd);
    comb_store_base(comb_ext(ext, w, 1), p, qd);
  }
}

// The entries of level l (1 .. COMB_LEVELS): j from comb_level_lo(l) to
// comb_level_hi(l).
FE_FN int comb_level_lo(int l) { return (1 << (l - 1)) + 1; }
FE_FN int comb_level_hi(int l) {
  return (1 << l) < COMB_ENTRIES - 1 ? (1 << l) : COMB_ENTRIES - 1;
}

// Phase 2, one thread an entry: entry j >= 2 of window w from the entries
// of the levels below, 2 (j / 2) by a doubling for even j, (j + 1) / 2 +
// (j - 1) / 2 by an add for odd j.
MSM_FN void comb_entry(uint32_t* ext, int w, int j) {
  Fe a[4], out[4];
  pt_load_words(a, comb_ext(ext, w, (j + 1) >> 1));
  if (j & 1) {
    Fe b[4];
    pt_load_words(b, comb_ext(ext, w, j >> 1));
    point_add(out, a, b);
  } else {
    point_double_k(a, 1);
    pt_copy(out, a);
  }
  pt_store_words(comb_ext(ext, w, j), out);
}

// An affine point (x, y) as a table entry: (y - x, y + x, 2d x y), canonical.
FE_FN void comb_store_entry(uint32_t* dst, const Fe& x, const Fe& y) {
  const Fe d2 = {CPZK_D2_WORDS};
  Fe v[3], t;
  fe_sub(v[0], y, x);
  fe_add(v[1], y, x);
  fe_mul(t, x, y);
  fe_mul(v[2], t, d2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fe_canonical(t, v[c]);
#pragma unroll
    for (int i = 0; i < NW; ++i) dst[c * NW + i] = t.w[i];
  }
}

// Phase 3, thread w: window w's entries in the table's form.  One inversion
// for the window (Montgomery's trick): the products Z_1 .. Z_j, the inverse
// of the last, then back down, each step giving 1 / Z_j.
MSM_FN void comb_normalise(uint32_t* out, const uint32_t* ext_w) {
  Fe pre[COMB_ENTRIES], z, inv, zi, x, y;
  fe_set_small(pre[0], 1);
  for (int j = 1; j < COMB_ENTRIES; ++j) {
    comb_load_coord(z, ext_w + j * PT_WORDS, 2);
    fe_mul(pre[j], pre[j - 1], z);
  }
  fe_invert(inv, pre[COMB_ENTRIES - 1]);
  for (int j = COMB_ENTRIES - 1; j >= 1; --j) {
    const uint32_t* e = ext_w + j * PT_WORDS;
    fe_mul(zi, inv, pre[j - 1]);
    comb_load_coord(z, e, 2);
    fe_mul(inv, inv, z);
    comb_load_coord(x, e, 0);
    comb_load_coord(y, e, 1);
    fe_mul(x, x, zi);
    fe_mul(y, y, zi);
    comb_store_entry(out + j * COMB_ENTRY_WORDS, x, y);
  }
  fe_set_small(x, 0);
  fe_set_small(y, 1);
  comb_store_entry(out, x, y);
}

// ---------------------------------------------------------------------------
// commitments (a thread a point): the digits, the select, the mixed add
// ---------------------------------------------------------------------------

// A lane's 64 nibbles packed 8 a word (window w at bits 4 (w mod 8) of word
// w / 8), consumed from the bottom, and the recode's carry.
struct CombDigits {
  uint32_t p[8];
  uint32_t carry;
};

// Lane j's nibbles of [64, n] int32 digits (LSB window first); a lane past
// the batch's end (live false) walks zero digits.
FE_FN void comb_digits_load(CombDigits& d, const int32_t* digits, long n, long j, bool live) {
#pragma unroll
  for (int k = 0; k < 8; ++k) d.p[k] = 0;
  d.carry = 0;
  if (!live) return;
#pragma unroll
  for (int w = 0; w < COMB_WINDOWS; ++w)
    d.p[w >> 3] |= ((uint32_t)digits[(long)w * n + j] & 15u) << (4 * (w & 7));
}

// Step s's digit as a magnitude (an entry index, 0 .. 8) and a sign bit (1
// for negative).  Below the top window (s < 63) the signed recode; at the
// top (s = 63, 64: public) v = nibble + carry, unrecoded, split as min(v, 8)
// and the rest, which step 64 (its nibble 0) takes as v.
FE_FN void comb_next_digit(CombDigits& d, int s, uint32_t& mag, uint32_t& neg) {
  const uint32_t top = s >= COMB_WINDOWS - 1 ? 1u : 0u;
  const uint32_t nib = d.p[0] & 15u;
#pragma unroll
  for (int k = 0; k < 7; ++k) d.p[k] = (d.p[k] >> 4) | (d.p[k + 1] << 28);
  d.p[7] >>= 4;
  const uint32_t v = nib + d.carry;                        // 0 .. 16
  const uint32_t c = ((v + 8u) >> 4) & (top ^ 1u);         // v >= 8, below the top
  const uint32_t over = ((8u - v) >> 31) & top;            // v > 8, at the top
  const uint32_t rest = (v - 8u) & (0u - over);            // to step 64
  const int32_t e = (int32_t)v - (int32_t)(c << 4);        // -8 .. 16
  d.carry = c | rest;
  neg = (uint32_t)e >> 31;
  mag = (((uint32_t)e ^ (0u - neg)) + neg) - rest;
}

// q = the window's entry mag, negated when neg is 1, in constant time:
// every entry is read and the one whose index equals mag kept by a mask;
// the negation swaps y - x and y + x and negates 2d x y by masks.
FE_FN void comb_select(Fe q[3], const uint32_t* window, uint32_t mag, uint32_t neg) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int i = 0; i < NW; ++i) q[c].w[i] = 0;
  }
#pragma unroll
  for (int j = 0; j < COMB_ENTRIES; ++j) {
    const uint32_t m = 0u - (uint32_t)(((uint64_t)((uint32_t)j ^ mag) - 1u) >> 63);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int i = 0; i < NW; ++i) q[c].w[i] |= window[(j * 3 + c) * NW + i] & m;
    }
  }
  const Fe a = q[0], b = q[1];
  fe_select(q[0], neg, b, a);
  fe_select(q[1], neg, a, b);
  fe_cneg(q[2], neg, q[2]);
}

// acc += Q, Q an affine entry (y - x, y + x, 2d x y): add-2008-hwcd-3 with
// Z2 = 1, so D = 2 Z1 by a doubling, not a product; A, B, C in one batch
// of three multiplies, X3, Y3, Z3, T3 in one of four.
FE_FN void pt_add_affine_into(Fe acc[4], const Fe q[3]) {
  Fe u[3], w[3], D;
  fe_sub(u[0], acc[1], acc[0]);
  fe_add(u[1], acc[1], acc[0]);
  u[2] = acc[3];
  mul_n<3>(w, u, q);  // A, B, C
  fe_mul2(D, acc[2]);
  Fe E, F, G, H;
  fe_sub(E, w[1], w[0]);
  fe_sub(F, D, w[2]);
  fe_add(G, D, w[2]);
  fe_add(H, w[1], w[0]);
  const Fe a[4] = {E, G, F, E}, b[4] = {F, H, G, H};
  mul_n<4>(acc, a, b);
}

// Step s of the walk (0 .. 64): acc += e_s 16^w P from window w's entries,
// w = min(s, 63).
FE_FN void comb_step(Fe acc[4], CombDigits& d, const uint32_t* window, int s) {
  uint32_t mag, neg;
  comb_next_digit(d, s, mag, neg);
  Fe q[3];
  comb_select(q, window, mag, neg);
  pt_add_affine_into(acc, q);
}

}  // namespace cpzk
