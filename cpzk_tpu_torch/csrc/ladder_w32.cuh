// The thread bodies of the per-row ladder kernels (ladder_ops.cu) on the
// point arithmetic of fe25519_w32.cuh and msm_w32.cuh.  Host and device
// code: the kernels call them per thread, phase by phase between barriers,
// and the tests compile this header with a host C++ compiler (through
// host_shim.cpp, whose host_ladder_* functions run every thread of every
// phase in the kernels' order) to hold them against the plain PyTorch
// versions in cpzk_tpu_torch/ops/verify.py.
//
// A lane's ladder is cpzk_tpu/ops/verify.py::_msm_rows for one batch column:
// per term t a 16-entry table [0..15] P_t (curve.build_table: 14 adds), then
// 64 steps of four doublings and one table add per term (the windows are
// public 4-bit values, most significant first), so the lane ends with
// sum_t scalar_t P_t.  The table entries are stored in the adds' cached form
// (Y - X, Y + X, 2d T, 2 Z; msm_w32.cuh's pt_cached), so a ladder add costs
// 8 multiplies.  The cached add runs point_add's formulas on the same values
// mod p, so every entry and every lane's ladder equals the plain version's
// coordinates exactly after canonicalization.
//
// The tables do not fit in registers (2 KB a table) and the index differs
// in every lane, so they live in a global scratch the wrapper allocates:
// lane j's tables are contiguous, an entry 32 words (128 bytes, one cache
// line), read as eight 16-byte loads, so a lane's load of an entry touches
// one line.
#pragma once

#include <stdint.h>

#include "fe25519_w32.cuh"
#include "msm_w32.cuh"
#include "ristretto_w32.cuh"

// Bodies with loops of adds or doublings: the compiler may keep them out of
// line.
#if defined(__CUDACC__)
#define LADDER_FN inline __host__ __device__
#else
#define LADDER_FN static inline
#endif

namespace cpzk {

constexpr int LADDER_ENTRIES = 16;  // a 4-bit window's table
constexpr int LADDER_BITS = 4;      // doublings a step
constexpr int LADDER_STEPS = 64;    // windows of a scalar below 2^256
constexpr int LADDER_TABLE_WORDS = LADDER_ENTRIES * PT_WORDS;
// table words a lane: the combined check's four terms, a per-row check's
// two (one equation at a time)
constexpr int LADDER_COMBINED_WORDS = 4 * LADDER_TABLE_WORDS;
constexpr int LADDER_EACH_WORDS = 2 * LADDER_TABLE_WORDS;

// A point operand: the four coordinates as [20, *] int32 limbs (loose,
// possibly negative), each with its row stride in elements, and the column
// step: 1 for a point per lane ([20, n]), 0 for one point every lane shares
// ([20, 1]).
struct LadderPt {
  const int32_t* c[4];
  long ld[4];
  long step;
};

// A [64, *] int32 window operand (most significant window first) and its
// row stride.
struct LadderWin {
  const int32_t* w;
  long ld;
};

// The operand's point of lane j, in words.
FE_FN void ladder_load(Fe p[4], const LadderPt& pt, long j) {
  const long col = j * pt.step;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int32_t l[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) l[q] = pt.c[k][(long)q * pt.ld[k] + col];
    fe_from_limbs(p[k], l);
  }
}

// -P: (-X, Y, Z, -T).
FE_FN void pt_negate(Fe p[4]) {
  fe_neg(p[0], p[0]);
  fe_neg(p[3], p[3]);
}

// The table of p: entry k = k p in cached form at tab[32 k], k = 0 .. 15
// (entry 0 the identity's cached form (1, 1, 0, 2)); 14 cached adds, the
// plain curve.build_table's acc = acc + p.
LADDER_FN void ladder_table(uint32_t* tab, const Fe p[4]) {
  Fe c[4], acc[4], e[4];
  pt_identity(acc);
  pt_cached(e, acc);
  pt_store_words(tab, e);
  pt_cached(c, p);
  pt_store_words(tab + PT_WORDS, c);
  pt_copy(acc, p);
  for (int k = 2; k < LADDER_ENTRIES; ++k) {
    pt_add_cached_into(acc, c);
    pt_cached(e, acc);
    pt_store_words(tab + (long)k * PT_WORDS, e);
  }
}

// One ladder step: acc = 2^4 acc + sum_t tab_t[w_t] (a window's low four
// bits index its table, as the plain version's select tree does).  The
// rounds and the terms stay loops on the card: unrolled, the combined
// kernel was 38,453 SASS instructions of 16 bytes (18,874 rolled) and one
// lane's chain took 2.90 ms (1.55 rolled) on an H100, a warp about alone
// on its scheduler waiting on instruction fetches (PERF.md, section 6).
template <int NT>
LADDER_FN void ladder_step(Fe acc[4], const uint32_t* const tabs[NT], const int32_t w[NT]) {
  Fe E, H;
#pragma unroll 1
  for (int r = 0; r < LADDER_BITS; ++r) point_double_round(acc, E, H);
  fe_mul(acc[3], E, H);
#pragma unroll 1
  for (int t = 0; t < NT; ++t) {
    Fe e[4];
    pt_load_words(e, tabs[t] + (long)(w[t] & (LADDER_ENTRIES - 1)) * PT_WORDS);
    pt_add_cached_into(acc, e);
  }
}

// Lane j's whole ladder over NT terms: acc = sum_t scalar_t P_t, tab_t the
// table of P_t, win[t] the windows of scalar_t.
template <int NT>
LADDER_FN void ladder_run(Fe acc[4], const uint32_t* const tabs[NT], const LadderWin win[NT],
                          long j) {
  pt_identity(acc);
  for (int s = 0; s < LADDER_STEPS; ++s) {
    int32_t w[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) w[t] = win[t].w[(long)s * win[t].ld + j];
    ladder_step<NT>(acc, tabs, w);
  }
}

// The combined check's lane j: the tables of r1, y1, r2, y2 (pts, in that
// order) into tabs (this lane's LADDER_COMBINED_WORDS), then
// a r1 + (a c) y1 + (b a) r2 + (b a c) y2 with the windows win.
LADDER_FN void ladder_combined_lane(Fe acc[4], const LadderPt pts[4], const LadderWin win[4],
                                    uint32_t* tabs, long j) {
  const uint32_t* t[4];
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    Fe p[4];
    ladder_load(p, pts[k], j);
    ladder_table(tabs + (long)k * LADDER_TABLE_WORDS, p);
    t[k] = tabs + (long)k * LADDER_TABLE_WORDS;
  }
  ladder_run<4>(acc, t, win, j);
}

// 1 when a = 0 mod p (the canonical value, not the words: those need not
// be reduced).
FE_FN uint32_t fe_is_zero(const Fe& a) {
  Fe c;
  fe_canonical(c, a);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) any |= c.w[i];
  return any == 0u;
}

// The identity test in the quotient group (curve.is_identity): X = 0 or
// Y = 0 mod p.
FE_FN uint32_t ladder_is_identity(const Fe p[4]) { return fe_is_zero(p[0]) | fe_is_zero(p[1]); }

// The per-row check's lane j: s G - c Y1 - R1 = O and s H - c Y2 - R2 = O,
// pts = g, h, y1, y2, r1, r2 (g and h may be shared), win = the windows of
// s and c; each equation's two tables (G and -Y1, then H and -Y2) into tabs
// (this lane's LADDER_EACH_WORDS) in turn.  1 when both hold.
LADDER_FN uint32_t ladder_each_lane(const LadderPt pts[6], const LadderWin win[2],
                                    uint32_t* tabs, long j) {
  const uint32_t* t[2] = {tabs, tabs + LADDER_TABLE_WORDS};
  uint32_t ok = 1;
#pragma unroll 1
  for (int e = 0; e < 2; ++e) {
    Fe p[4], d[4], c[4];
    ladder_load(p, pts[e], j);
    ladder_table(tabs, p);
    ladder_load(p, pts[2 + e], j);
    pt_negate(p);
    ladder_table(tabs + LADDER_TABLE_WORDS, p);
    ladder_run<2>(d, t, win, j);
    ladder_load(p, pts[4 + e], j);
    pt_negate(p);
    pt_cached(c, p);
    pt_add_cached_into(d, c);
    ok &= ladder_is_identity(d);
  }
  return ok;
}

// One level (half h) of a block's tree sum of n points in s (32 words
// each), thread i: x += s[i + h] for i < h and i + h < n, into s[i] (x
// holds s[i]).
FE_FN void ladder_tree_level(Fe x[4], uint32_t* s, int i, int h, int n) {
  if (i >= h || i + h >= n) return;
  Fe q[4];
  pt_load_words(q, s + (long)(i + h) * PT_WORDS);
  pt_add_into(x, q);
  pt_store_words(s + (long)i * PT_WORDS, x);
}

// Thread t of nt: the sum of the k block partials t, t + nt, ... (32 words
// each at parts) into x.
LADDER_FN void ladder_parts_sum(Fe x[4], const uint32_t* parts, int k, int t, int nt) {
  pt_identity(x);
  for (int i = t; i < k; i += nt) {
    Fe q[4];
    pt_load_words(q, parts + (long)i * PT_WORDS);
    pt_add_into(x, q);
  }
}

// Thread t of nt: the sum of the points at columns t, t + nt, ... of the k
// columns of pt ([20, k] limbs) into x.
LADDER_FN void ladder_limbs_sum(Fe x[4], const LadderPt& pt, int k, int t, int nt) {
  pt_identity(x);
  for (int i = t; i < k; i += nt) {
    Fe q[4];
    ladder_load(q, pt, i);
    pt_add_into(x, q);
  }
}

// The chunk's total: its limbs into out (column 0 of [20, *] with row
// stride ld) and its identity test into *ok.
FE_FN void ladder_finish(int32_t* const out[4], long ld, uint8_t* ok, const Fe x[4]) {
  store_point(out, ld, 0, x);
  *ok = (uint8_t)ladder_is_identity(x);
}

}  // namespace cpzk
