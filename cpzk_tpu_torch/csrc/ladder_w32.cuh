// The thread bodies of the per-row ladder kernels (ladder_ops.cu) on the
// point arithmetic of fe25519_w32.cuh and msm_w32.cuh.  Host and device
// code: the kernels call them per thread, phase by phase between barriers,
// and the tests compile this header with a host C++ compiler (through
// host_shim.cpp, whose host_ladder_* functions run every quad of every
// phase in the kernels' order) to hold them against the plain PyTorch
// versions in cpzk_tpu_torch/ops/verify.py.
//
// A lane's ladder is cpzk_tpu/ops/verify.py::_msm_rows for one batch column:
// per term t a 16-entry table [0..15] P_t (curve.build_table: 14 adds), then
// 64 steps of four doublings and one table add per term (the windows are
// public 4-bit values, most significant first), so the lane ends with
// sum_t scalar_t P_t.  The table entries are stored in the adds' cached form
// (Y - X, Y + X, 2d T, 2 Z; msm_w32.cuh's pt_cached).  The cached add runs
// point_add's formulas on the same values mod p, so every entry and every
// lane's ladder equals the plain version's coordinates exactly after
// canonicalization.
//
// A lane's ladder runs on a quad: four consecutive threads of a warp
// (msm_w32.cuh's Quad), each holding the accumulator.  A doubling round is
// quad_double_round (one square and one product a thread), a table add
// quad_add_cached_into (one product, a gather, one product, a gather), so a
// step's chain is about half as long as one thread's.  Thread r of a quad
// needs only coordinate r of a cached entry (32 bytes; the quad's four loads
// make one 128-byte line), so a step's entries fit in registers: the quad
// loads the next step's entries, and the windows of the step after, when a
// step begins, and they arrive while its four doubling rounds run.
//
// The tables do not fit in registers (2 KB a table) and the index differs
// in every lane, so they live in a global scratch the wrapper allocates
// (lane j's contiguous, an entry 32 words) or, for generators every lane
// shares, in the block's shared memory.  One thread builds a table (14
// cached adds); a quad's threads build theirs side by side.
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
// table words a lane in the scratch: the combined check's four terms; a
// per-row check's four (each equation's -Y and generator) or, with the
// generators shared (their tables in the block's shared memory), two
constexpr int LADDER_COMBINED_WORDS = 4 * LADDER_TABLE_WORDS;
constexpr int LADDER_EACH_WORDS = 4 * LADDER_TABLE_WORDS;
constexpr int LADDER_EACH_SHARED_WORDS = 2 * LADDER_TABLE_WORDS;

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
// plain curve.build_table's acc = acc + p.  One thread.
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

// Lane j's window of step s.  On the card an inline-PTX load through the
// read-only path, issued where it stands (a step ahead of its use).
FE_FN int32_t ladder_window(const LadderWin& win, int s, long j) {
  const int32_t* p = win.w + (long)s * win.ld + j;
#if defined(__CUDA_ARCH__)
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}

template <int NT>
FE_FN void ladder_quad_windows(int32_t w[NT], const LadderWin win[NT], int s, long j) {
#pragma unroll
  for (int t = 0; t < NT; ++t) w[t] = ladder_window(win[t], s, j);
}

// The quad's parts of entry w_t of each table (a window's low four bits
// index its table, as the plain version's select tree does).
template <int NT>
FE_FN void ladder_quad_entries(QuadCached e[NT], const uint32_t* const tabs[NT],
                               const int32_t w[NT], Quad qd) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
    quad_load_cached(e[t], tabs[t] + (long)(w[t] & (LADDER_ENTRIES - 1)) * PT_WORDS, qd);
}

// One ladder step on a quad: acc = 2^4 acc + sum_t e_t (e is consumed).
// The rounds and the terms stay loops on the card (a term's entry is
// shifted into e[0], so the loop indexes no register array): unrolled, a
// step's code outgrows the instruction cache and a lone warp waits on
// instruction fetches (PERF.md, section 6).
template <int NT>
FE_FN void ladder_quad_step(Fe acc[4], QuadCached e[NT], Quad qd) {
#pragma unroll 1
  for (int r = 0; r < LADDER_BITS; ++r) quad_double_round(acc, qd);
#pragma unroll 1
  for (int t = 0; t < NT; ++t) {
    quad_add_cached_into(acc, e[0], qd);
#pragma unroll
    for (int u = 0; u + 1 < NT; ++u) e[u] = e[u + 1];
  }
}

// Lane j's whole ladder over NT terms on its quad: acc = sum_t scalar_t P_t,
// tabs[t] the table of P_t, win[t] the windows of scalar_t.  Each step
// first loads the next step's entries (the last step its own again) and
// the windows of the step after.
template <int NT>
FE_FN void ladder_quad_run(Fe acc[4], const uint32_t* const tabs[NT], const LadderWin win[NT],
                           long j, Quad qd) {
  int32_t w[NT];
  QuadCached cur[NT], nxt[NT];
  ladder_quad_windows<NT>(w, win, 0, j);
  ladder_quad_entries<NT>(cur, tabs, w, qd);
  ladder_quad_windows<NT>(w, win, 1, j);
  pt_identity(acc);
#pragma unroll 1
  for (int s = 0; s < LADDER_STEPS; ++s) {
    ladder_quad_entries<NT>(nxt, tabs, w, qd);
    ladder_quad_windows<NT>(w, win, s + 2 < LADDER_STEPS ? s + 2 : LADDER_STEPS - 1, j);
    ladder_quad_step<NT>(acc, cur, qd);
#pragma unroll
    for (int t = 0; t < NT; ++t) cur[t] = nxt[t];
  }
}

// The combined check, phase 1, thread r of lane j's quad: the table of
// pts[r] (pts = r1, y1, r2, y2) into tabs + r LADDER_TABLE_WORDS (tabs: the
// lane's LADDER_COMBINED_WORDS), so the four tables build side by side; the
// host runs the four threads in turn.
LADDER_FN void ladder_combined_table(uint32_t* tabs, const LadderPt pts[4], long j, int r) {
  Fe p[4];
  ladder_load(p, pts[r], j);
  ladder_table(tabs + (long)r * LADDER_TABLE_WORDS, p);
}

LADDER_FN void ladder_combined_tables(uint32_t* tabs, const LadderPt pts[4], long j, Quad qd) {
#if defined(__CUDA_ARCH__)
  ladder_combined_table(tabs, pts, j, qd.r);
#else
  (void)qd;
  for (int r = 0; r < 4; ++r) ladder_combined_table(tabs, pts, j, r);
#endif
}

// The combined check, phase 2 (after the quad's barrier), lane j's quad:
// a r1 + (a c) y1 + (b a) r2 + (b a c) y2 with the windows win.
LADDER_FN void ladder_combined_quad(Fe acc[4], const uint32_t* tabs, const LadderWin win[4],
                                    long j, Quad qd) {
  const uint32_t* const t[4] = {tabs, tabs + LADDER_TABLE_WORDS, tabs + 2 * LADDER_TABLE_WORDS,
                                tabs + 3 * LADDER_TABLE_WORDS};
  ladder_quad_run<4>(acc, t, win, j, qd);
}

// The per-row check, phase 1, thread r of quad e (equation e: s P_e - c Y_e
// - R_e, P = G, H) of lane j, the block's lane l; pts = g, h, y1, y2, r1,
// r2.  Thread 0 builds -Y_e's table; thread 1 P_e's.  With the generators
// shared (`shared`), -Y_e's goes to tabs + e LADDER_TABLE_WORDS (tabs: the
// lane's LADDER_EACH_SHARED_WORDS) and P_e's, built only in the block's
// lane 0 while the other lanes build their -Y tables, to gh + e
// LADDER_TABLE_WORDS (the block's shared memory); else -Y_e's to tabs + 2 e
// LADDER_TABLE_WORDS and P_e's to the table after it (LADDER_EACH_WORDS).
// Threads 2 and 3 build nothing.
LADDER_FN void ladder_each_table(uint32_t* tabs, uint32_t* gh, const LadderPt pts[6], long j,
                                 int l, int e, bool shared, int r) {
  if (r > 1 || (r == 1 && shared && l != 0)) return;
  uint32_t* dst = r == 0   ? tabs + (long)(shared ? e : 2 * e) * LADDER_TABLE_WORDS
                  : shared ? gh + (long)e * LADDER_TABLE_WORDS
                           : tabs + (long)(2 * e + 1) * LADDER_TABLE_WORDS;
  Fe p[4];
  ladder_load(p, pts[r == 0 ? 2 + e : e], j);
  if (r == 0) pt_negate(p);
  ladder_table(dst, p);
}

LADDER_FN void ladder_each_tables(uint32_t* tabs, uint32_t* gh, const LadderPt pts[6], long j,
                                  int l, int e, bool shared, Quad qd) {
#if defined(__CUDA_ARCH__)
  ladder_each_table(tabs, gh, pts, j, l, e, shared, qd.r);
#else
  (void)qd;
  for (int r = 0; r < 2; ++r) ladder_each_table(tabs, gh, pts, j, l, e, shared, r);
#endif
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

// The per-row check, phase 2 (after the tables' barrier), quad e of lane j
// (tables as phase 1 left them, win = the windows of s and c): 1 when
// s P_e - c Y_e - R_e is the identity.  The lane's bit is the AND of its
// two quads'.
LADDER_FN uint32_t ladder_each_quad(const uint32_t* tabs, const uint32_t* gh,
                                    const LadderPt pts[6], const LadderWin win[2], long j,
                                    int e, bool shared, Quad qd) {
  const uint32_t* const t[2] = {
      shared ? gh + (long)e * LADDER_TABLE_WORDS : tabs + (long)(2 * e + 1) * LADDER_TABLE_WORDS,
      tabs + (long)(shared ? e : 2 * e) * LADDER_TABLE_WORDS};
  Fe acc[4], p[4], c[4];
  ladder_quad_run<2>(acc, t, win, j, qd);
  ladder_load(p, pts[4 + e], j);
  pt_negate(p);
  pt_cached(c, p);
  QuadCached q;
  quad_cached_pick(q, c, qd);
  quad_add_cached_into(acc, q, qd);
  return ladder_is_identity(acc);
}

// The combined check's lane sum.  A block sums its quads' points by a tree
// in shared memory (msm_tree_level); then the blocks' sums are summed in
// groups of nq (the quads a block): each block stores its sum as a partial
// of level 0 and takes a ticket of its group, and the last block of a group
// to arrive sums the group's partials (a quad each, the same tree) into a
// partial of the next level, until one is left: the chunk's total.

// Points and tickets of the partials of every level for `blocks` blocks of
// nq >= 2 quads (a level's partials follow the last level's; tickets, one
// a group, likewise).
FE_FN long ladder_reduce_points(long blocks, int nq, long* tickets) {
  long points = 0, groups = 0;
  for (long count = blocks; count > 1; count = (count + nq - 1) / nq) {
    points += count;
    groups += (count + nq - 1) / nq;
  }
  *tickets = groups;
  return points;
}

// Quad q of the block that sums group `base / nq` of a level: partial
// base + q of `level`, or the identity past the group's size.  Other blocks
// wrote them, so the card reads them past the L1.
FE_FN void ladder_group_load(Fe x[4], const uint32_t* level, long base, int size, int q) {
  if (q >= size) {
    pt_identity(x);
    return;
  }
  const uint32_t* src = level + (base + q) * PT_WORDS;
#if defined(__CUDA_ARCH__)
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint4 v = __ldcg(s + u);
    uint32_t* f = x[u >> 1].w + (u & 1) * 4;
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
#else
  pt_load_words(x, src);
#endif
}

// ladder_partials_identity: the sum of k chunk totals ([20, k] limbs) on
// quads of threads, nq = min(k, LADDER_PARTIALS_QUADS) of them.  Quad q
// starts from column q as it is loaded (no add with the identity) and adds
// columns q + nq, q + 2 nq, ... in turn; then a tree over the nq quads'
// points runs only the ceil(log2 nq) levels nq needs, levels whose partner
// lies in another warp through the block's shared memory (msm_tree_level),
// the last three (partners within warp 0) by warp shuffles with no
// barrier.  k = 1 is the identity test alone, k = 2 one quad add.
constexpr int LADDER_PARTIALS_QUADS = 32;
constexpr int LADDER_WARP_QUADS = 8;

// The quads that hold a point for k totals, and the block's threads (whole
// warps).
FE_FN int ladder_partials_quads(int k) {
  return k < LADDER_PARTIALS_QUADS ? k : LADDER_PARTIALS_QUADS;
}

FE_FN int ladder_partials_threads(int k) { return (4 * ladder_partials_quads(k) + 31) / 32 * 32; }

// Quad q of nq: columns q, q + nq, ... of the k columns of pt summed into
// x, the first as loaded, each next column loaded while the add before it
// runs; the identity for an idle quad (q >= nq: the rest of the block's
// last warp).
LADDER_FN void ladder_partials_load(Fe x[4], const LadderPt& pt, int k, int q, int nq,
                                    Quad qd) {
  if (q >= nq) {
    pt_identity(x);
    return;
  }
  ladder_load(x, pt, q);
  if (q + nq >= k) return;
  Fe y[4];
  ladder_load(y, pt, q + nq);
  for (int i = q + 2 * nq;; i += nq) {
    Fe z[4];
    const bool more = i < k;
    if (more) ladder_load(z, pt, i);
    quad_add_into(x, y, qd);
    if (!more) break;
    pt_copy(y, z);
  }
}

// A level (half h < LADDER_WARP_QUADS) of the tree within warp 0: quad i
// adds y, quad i + h's point (a shuffle of the lane 4 h above), for i < h
// and i + h < nq.
MSM_FN void ladder_partials_level(Fe x[4], const Fe y[4], int i, int h, int nq, Quad qd) {
  if (i < h && i + h < nq) quad_add_into(x, y, qd);
}

// The chunk's total: its limbs into out (column 0 of [20, *] with row
// stride ld) and its identity test into *ok.
FE_FN void ladder_finish(int32_t* const out[4], long ld, uint8_t* ok, const Fe x[4]) {
  store_point(out, ld, 0, x);
  *ok = (uint8_t)ladder_is_identity(x);
}

}  // namespace cpzk
