// The thread bodies of the Pippenger kernels (msm_ops.cu) on the point
// arithmetic of fe25519_w32.cuh.  Host and device code: the kernels call
// them per thread, phase by phase between barriers, and the tests compile
// this header with a host C++ compiler (through host_shim.cpp), whose
// drivers run every thread of every phase in the kernels' order, to hold
// them against the plain PyTorch version in cpzk_tpu_torch/ops/msm.py.
//
// Digits are signed c-bit digits d in [-2^(c-1), 2^(c-1)], so a window has
// the buckets j = 1 .. 2^(c-1) (the top one included: n_buckets = 2^(c-1) + 1
// with bucket 0, which is skipped).  A point enters bucket |d|, negated
// where d < 0.
//
// msm_bucket in four steps (the bodies below, in the order they run):
//   1. the chunk's points once from [20, m] limbs to the adds' cached form,
//      32 consecutive words a point (msm_point_words);
//   2. a counting sort of each window's digits by bucket: a histogram, an
//      exclusive scan of it into bucket offsets, the empty buckets stored as
//      the identity, and a scatter of the signed term entries ±(i + 1) into
//      bucket order (msm_sort_*);
//   3. the window's sorted entries split evenly over runs, one run a thread:
//      a thread adds its entries in order and flushes its sum at every bucket
//      change (msm_run); a bucket whose entries all lie in the run is stored,
//      a piece of a bucket that continues past either end of the run is
//      kept;
//   4. the pieces joined by a segmented suffix reduction of log depth
//      (msm_seg_join, msm_seg_level), first over a block's threads, then
//      over the blocks of a window (msm_place_head decides where a joined
//      piece goes).
// msm_window_reduce in two: the window totals sum_j j B_j by segments, a
// suffix scan and a tree sum (msm_totals_*, msm_tree_level), then each
// window total times 2^(c w) and their tree sum (msm_scale_horner,
// msm_tree_level); four lanes of a warp share each add and doubling of
// both (Quad, quad_*).  The kernels only sequence these bodies between
// barriers, so the host drivers run the code the card runs.
#pragma once

#include <stdint.h>

#include "fe25519_w32.cuh"

// Bodies with loops of adds or doublings: the compiler may keep them out of
// line.
#if defined(__CUDACC__)
#define MSM_FN inline __host__ __device__
#else
#define MSM_FN static inline
#endif

namespace cpzk {

// words of a point in the kernels' form (X, Y, Z, T, 8 words each)
constexpr int PT_WORDS = 4 * NW;
// threads of the sort's block (a multiple of 32)
constexpr int MSM_SORT_THREADS = 1024;

FE_FN void pt_identity(Fe p[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < NW; ++i) p[k].w[i] = 0;
  }
  p[1].w[0] = 1;
  p[2].w[0] = 1;
}

FE_FN void pt_copy(Fe out[4], const Fe p[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = p[k];
}

// acc += p (acc and p distinct).
FE_FN void pt_add_into(Fe acc[4], const Fe p[4]) {
  Fe r[4];
  point_add(r, acc, p);
  pt_copy(acc, r);
}

// Term i of [20, m] limb-major coordinates (loose signed limbs) -> words.
FE_FN void load_point(Fe p[4], const int32_t* const coords[4], long m, long i) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int32_t l[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) l[q] = coords[k][(long)q * m + i];
    fe_from_limbs(p[k], l);
  }
}

FE_FN void store_point(int32_t* const out[4], long stride, long j, const Fe p[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int32_t l[NL];
    fe_to_limbs(l, p[k]);
#pragma unroll
    for (int q = 0; q < NL; ++q) out[k][(long)q * stride + j] = l[q];
  }
}

// A point in the kernels' form: 32 words at src (16-byte aligned), read and
// written as 16-byte vectors on the card.
FE_FN void pt_load_words(Fe p[4], const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 v = s[q];
    uint32_t* f = p[q >> 1].w + (q & 1) * 4;
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
#else
  for (int k = 0; k < 4; ++k) {
    for (int i = 0; i < NW; ++i) p[k].w[i] = src[k * NW + i];
  }
#endif
}

FE_FN void pt_store_words(uint32_t* dst, const Fe p[4]) {
#if defined(__CUDA_ARCH__)
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t* f = p[q >> 1].w + (q & 1) * 4;
    d[q] = make_uint4(f[0], f[1], f[2], f[3]);
  }
#else
  for (int k = 0; k < 4; ++k) {
    for (int i = 0; i < NW; ++i) dst[k * NW + i] = p[k].w[i];
  }
#endif
}

// ---------------------------------------------------------------------------
// msm_bucket, step 1: the points in the adds' cached form
// ---------------------------------------------------------------------------

// A point's cached form (Y - X, Y + X, 2d T, 2 Z): the factors that
// point_add derives from its second operand, so that adding it costs 8
// multiplies, not 9, and two dependent levels, not three.
FE_FN void pt_cached(Fe c[4], const Fe p[4]) {
  const Fe d2 = {CPZK_D2_WORDS};
  fe_sub(c[0], p[1], p[0]);
  fe_add(c[1], p[1], p[0]);
  fe_mul(c[2], p[3], d2);
  fe_mul2(c[3], p[2]);
}

// The cached form of -P from that of P, in place: (Y + X, Y - X, -2d T, 2 Z).
FE_FN void pt_cached_negate(Fe c[4]) {
  const Fe zero = {{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
  const Fe t = c[0];
  c[0] = c[1];
  c[1] = t;
  fe_sub(c[2], zero, c[2]);
}

// acc += Q, Q in cached form: add-2008-hwcd-3 (point_add's formulas) with
// A = (Y1 - X1) Q0, B = (Y1 + X1) Q1, C = T1 Q2, D = Z1 Q3 in one batch.
FE_FN void pt_add_cached_into(Fe acc[4], const Fe q[4]) {
  Fe u[4], w[4];
  fe_sub(u[0], acc[1], acc[0]);
  fe_add(u[1], acc[1], acc[0]);
  u[2] = acc[3];
  u[3] = acc[2];
  mul_n<4>(w, u, q);  // A, B, C, D
  Fe E, F, G, H;
  fe_sub(E, w[1], w[0]);
  fe_sub(F, w[3], w[2]);
  fe_add(G, w[3], w[2]);
  fe_add(H, w[1], w[0]);
  const Fe a[4] = {E, G, F, E}, b[4] = {F, H, G, H};
  mul_n<4>(acc, a, b);
}

// Term i of [20, m] limbs into pw[32 i .. 32 i + 32), cached.
FE_FN void msm_point_words(uint32_t* pw, const int32_t* const coords[4], long m, long i) {
  Fe p[4], c[4];
  load_point(p, coords, m, i);
  pt_cached(c, p);
  pt_store_words(pw + i * PT_WORDS, c);
}

// ---------------------------------------------------------------------------
// msm_bucket, step 2: the counting sort of one window (a block of nt threads
// on the card; every phase runs for every thread t before the next starts)
// ---------------------------------------------------------------------------

FE_FN int msm_bucket_of(int32_t d) { return d < 0 ? -d : d; }

// The entry of term i with digit d: i + 1, negated for a negative digit.
FE_FN int32_t msm_entry(int32_t d, long i) {
  return d < 0 ? -(int32_t)(i + 1) : (int32_t)(i + 1);
}

// Claims the next slot of the counter *ctr and returns it: a shared-memory
// atomic add on the card (grouping a warp's lanes by counter with
// __match_any_sync first costs four times as much on random digits on the
// H100), a plain one on the host, which runs the threads one after
// another.
FE_FN uint32_t msm_claim(uint32_t* ctr) {
#if defined(__CUDA_ARCH__)
  return atomicAdd(ctr, 1u);
#else
  return (*ctr)++;
#endif
}

// Phase 1, thread t of nt: the histogram of |digit| over the row's m digits
// into counts[0 .. nb] (zeroed before; bucket 0 counts the zero digits).
FE_FN void msm_sort_count(uint32_t* counts, const int32_t* row, long m, int t, int nt) {
  for (long i = t; i < m; i += nt) msm_claim(&counts[msm_bucket_of(row[i])]);
}

// Buckets 1 .. nb in nt chunks of ch = ceil(nb / nt): thread t's chunk.
FE_FN int msm_chunk_lo(int nb, int t, int nt) {
  const int ch = (nb + nt - 1) / nt;
  const int lo = 1 + t * ch;
  return lo < nb + 1 ? lo : nb + 1;
}

// Phase 2, thread t: the sum of its chunk of counts into part[t].
FE_FN void msm_sort_chunk_sum(uint32_t* part, const uint32_t* counts, int nb, int t, int nt) {
  const int hi = msm_chunk_lo(nb, t + 1, nt);
  uint32_t s = 0;
  for (int b = msm_chunk_lo(nb, t, nt); b < hi; ++b) s += counts[b];
  part[t] = s;
}

// Phase 3, thread g < 32: the exclusive scan of its group of nt / 32 chunk
// sums in place, the group's total into grp[g].
FE_FN void msm_sort_scan_group(uint32_t* part, uint32_t* grp, int nt, int g) {
  const int gs = nt / 32;
  uint32_t acc = 0;
  for (int u = g * gs; u < (g + 1) * gs; ++u) {
    const uint32_t x = part[u];
    part[u] = acc;
    acc += x;
  }
  grp[g] = acc;
}

// Phase 4, one thread: the exclusive scan of the 32 group totals in place;
// returns the total, the window's count of non-zero digits.
FE_FN uint32_t msm_sort_scan_groups(uint32_t* grp) {
  uint32_t acc = 0;
  for (int g = 0; g < 32; ++g) {
    const uint32_t x = grp[g];
    grp[g] = acc;
    acc += x;
  }
  return acc;
}

// Phase 5, thread t: the empty buckets among 1 + t, 1 + t + nt, ...
// (coalesced stores) stored as the identity, in limbs at lane base + b - 1
// of stride lanes.
FE_FN void msm_sort_empties(const uint32_t* counts, int nb, int t, int nt,
                            int32_t* const out[4], long stride, long base) {
  Fe id[4];
  pt_identity(id);
  for (int b = 1 + t; b <= nb; b += nt) {
    if (counts[b] == 0) store_point(out, stride, base + b - 1, id);
  }
}

// Phase 6, thread t: its chunk's counts turned into the offsets where each
// bucket's entries start (the cursors of the scatter).
FE_FN void msm_sort_cursors(uint32_t* counts, const uint32_t* part, const uint32_t* grp,
                            int nb, int t, int nt) {
  const int hi = msm_chunk_lo(nb, t + 1, nt);
  uint32_t acc = part[t] + grp[t / (nt / 32)];
  for (int b = msm_chunk_lo(nb, t, nt); b < hi; ++b) {
    const uint32_t x = counts[b];
    counts[b] = acc;
    acc += x;
  }
}

// Phase 7, thread t: the scatter of the non-zero digits' entries into
// bucket order (cursor[b] is the next free position of bucket b): keys[e]
// the bucket, ents[e] the signed entry.
FE_FN void msm_sort_scatter(int32_t* keys, int32_t* ents, uint32_t* cursor, const int32_t* row,
                            long m, int t, int nt) {
  for (long i = t; i < m; i += nt) {
    const int32_t d = row[i];
    if (d != 0) {
      const int b = msm_bucket_of(d);
      const uint32_t e = msm_claim(&cursor[b]);
      keys[e] = b;
      ents[e] = msm_entry(d, i);
    }
  }
}

// ---------------------------------------------------------------------------
// msm_bucket, step 3: one thread's run of sorted entries
// ---------------------------------------------------------------------------
//
// A window's n sorted entries are split into ranges (a block's, then a
// thread's run).  A range keeps at most two pieces of buckets that cross
// its ends: its first piece, of a bucket that continues before it, and its
// last, of one that continues after it (a range inside one bucket keeps
// its piece as the first).  key[] is a piece's bucket, has[] whether it
// holds a sum; a range without a first piece takes the key of a bucket
// that crosses its start (has 0) or -1, so that the slots of one bucket
// are contiguous (msm_seg_join).

// The bucket that continues across position x (0 <= x <= n) of the sorted
// keys, or -1.
FE_FN int msm_gap_key(const int32_t* keys, long n, long x) {
  return x > 0 && x < n && keys[x - 1] == keys[x] ? keys[x] : -1;
}

// Where bucket b's entries within [lo, hi) go: 0 the whole bucket lies in
// the range, 1 it continues before lo, 2 it continues after hi (only).
FE_FN int msm_piece_kind(const int32_t* keys, long n, long lo, long hi, int b) {
  if (lo > 0 && keys[lo - 1] == b) return 1;
  if (hi < n && keys[hi] == b) return 2;
  return 0;
}

// One run: entries lo .. hi - 1 of a window's n sorted entries, added bucket
// by bucket (every entry is one add, so the lanes of a warp stay together)
// from the cached points pw; a sum is flushed where the bucket changes: a whole
// bucket to out (limbs, lane base + b - 1 of stride lanes), a first piece
// to (fslot, fkey, fhas)[r], a last piece to (lslot, lkey, lhas)[r].
FE_FN void msm_run(uint32_t* fslot, int* fkey, int* fhas, uint32_t* lslot, int* lkey,
                   int* lhas, int r, const int32_t* keys, const int32_t* ents, long n, long lo,
                   long hi, const uint32_t* pw, int32_t* const out[4], long stride, long base) {
  fhas[r] = lhas[r] = 0;
  fkey[r] = msm_gap_key(keys, n, lo);
  lkey[r] = -1;
  if (lo >= hi) return;
  Fe acc[4];
  pt_identity(acc);
  int b = keys[lo];
  for (long e = lo; e <= hi; ++e) {
    // the flush holds no exit, so a warp's lanes meet again at the add
    if (e == hi || keys[e] != b) {
      const int kind = msm_piece_kind(keys, n, lo, hi, b);
      if (kind == 0) {
        store_point(out, stride, base + b - 1, acc);
      } else if (kind == 1) {
        pt_store_words(fslot + (long)r * PT_WORDS, acc);
        fhas[r] = 1;
      } else {
        pt_store_words(lslot + (long)r * PT_WORDS, acc);
        lkey[r] = b;
        lhas[r] = 1;
      }
      pt_identity(acc);
      if (e < hi) b = keys[e];
    }
    if (e < hi) {
      const int32_t en = ents[e];
      Fe q[4];
      pt_load_words(q, pw + (long)((en < 0 ? -en : en) - 1) * PT_WORDS);
      if (en < 0) pt_cached_negate(q);
      pt_add_cached_into(acc, q);
    }
  }
}

// ---------------------------------------------------------------------------
// msm_bucket, step 4: the segmented reduction of the pieces
// ---------------------------------------------------------------------------
//
// The pieces of nr ranges become nr + 1 slots: slot i is range i's first
// piece joined with range i - 1's last (its bucket continues into range i),
// slot nr range nr - 1's last.  A bucket's slots are then contiguous and
// one a range, and a segmented reduction of log depth sums them.

// Slot i (0 <= i <= nr) of the join, in place over the first pieces.
FE_FN void msm_seg_join(uint32_t* slot, int* key, int* has, const uint32_t* lslot,
                        const int* lkey, const int* lhas, int nr, int i) {
  if (i == nr) {
    key[i] = lkey[i - 1];
    has[i] = 0;
  }
  if (i == 0 || !lhas[i - 1]) return;
  Fe v[4], q[4];
  pt_load_words(q, lslot + (long)(i - 1) * PT_WORDS);
  if (has[i]) {
    pt_load_words(v, slot + (long)i * PT_WORDS);
    pt_add_into(v, q);
  } else {
    pt_copy(v, q);
  }
  pt_store_words(slot + (long)i * PT_WORDS, v);
  key[i] = lkey[i - 1];
  has[i] = 1;
}

// One level (distance d) of the segmented suffix reduction over ns slots at
// slot i: dst[i] = src[i], plus src[i + d] where that slot holds a piece of
// the same bucket.  After the levels d = 1, 2, 4, ... the first slot of
// each bucket holds the sum of all its slots.  Returns whether slot i took
// a piece: when no slot takes one at some level, no later level would.
FE_FN bool msm_seg_level(uint32_t* dst, int* dhas, const uint32_t* src, const int* shas,
                         const int* key, int ns, int i, int d) {
  Fe v[4];
  pt_load_words(v, src + (long)i * PT_WORDS);
  int h = shas[i];
  const int j = i + d;
  const bool take = j < ns && key[i] >= 0 && key[j] == key[i] && shas[j];
  if (take) {
    Fe q[4];
    pt_load_words(q, src + (long)j * PT_WORDS);
    if (h) {
      pt_add_into(v, q);
    } else {
      pt_copy(v, q);
    }
    h = 1;
  }
  pt_store_words(dst + (long)i * PT_WORDS, v);
  dhas[i] = h;
  return take;
}

// Slot i's point (words at v), the identity where it holds none.
FE_FN void msm_slot_point(Fe pt[4], const uint32_t* v, const int* has, int i) {
  if (has[i]) {
    pt_load_words(pt, v + (long)i * PT_WORDS);
  } else {
    pt_identity(pt);
  }
}

// Whether slot i starts its bucket's slots (and so holds their sum).
FE_FN bool msm_seg_head(const int* key, int i) {
  return key[i] >= 0 && (i == 0 || key[i - 1] != key[i]);
}

// A block's joined piece of bucket b (slot value v) over its entries
// [lo, hi) of the window's n: the whole bucket to out, else into the
// block's first or last piece at part (its two pieces' words).
FE_FN void msm_place_head(const Fe v[4], int b, const int32_t* keys, long n, long lo, long hi,
                          int32_t* const out[4], long stride, long base, uint32_t* part) {
  const int kind = msm_piece_kind(keys, n, lo, hi, b);
  if (kind == 0) {
    store_point(out, stride, base + b - 1, v);
  } else {
    pt_store_words(part + (kind - 1) * PT_WORDS, v);
  }
}

// The keys and has flags of a block's first and last pieces for its
// entries [lo, hi) of the window's n (the words come from msm_place_head).
FE_FN void msm_block_pieces(int* key, int* has, const int32_t* keys, long n, long lo, long hi) {
  const int first = msm_gap_key(keys, n, lo);
  const int last = msm_gap_key(keys, n, hi);
  key[0] = first;
  has[0] = lo < hi && first >= 0;
  // a block inside one bucket keeps its piece as the first
  key[1] = last;
  has[1] = lo < hi && last >= 0 && last != first;
}

// The even split of a count into parts: the start of part p of np.
FE_FN long msm_split(long n, long p, long np) { return n * p / np; }

// Thread r of nr in a block's entries [lo, hi): its run (msm_run) over its
// even share of them.
FE_FN void msm_thread_run(uint32_t* fslot, int* fkey, int* fhas, uint32_t* lslot, int* lkey,
                          int* lhas, int r, int nr, const int32_t* keys, const int32_t* ents,
                          long n, long lo, long hi, const uint32_t* pw, int32_t* const out[4],
                          long stride, long base) {
  const long len = hi - lo;
  msm_run(fslot, fkey, fhas, lslot, lkey, lhas, r, keys, ents, n, lo + msm_split(len, r, nr),
          lo + msm_split(len, r + 1, nr), pw, out, stride, base);
}

// The segmented reduction over ns slots, double-buffered (a, ha) -> (b, hb)
// level by level (msm_seg_level), thread t of nt taking slots t, t + nt, ...
// of each level: on the card a block's threads with a barrier between
// levels, on the host one thread (t = 0, nt = 1) taking every slot.
// Returns the buffer holding the result, its has flags in *has_out.
MSM_FN uint32_t* msm_seg_reduce(uint32_t* a, int* ha, uint32_t* b, int* hb, const int* key,
                                int ns, int t, int nt, int** has_out) {
  for (int d = 1; d < ns; d <<= 1) {
    bool took = false;
    for (int i = t; i < ns; i += nt) took |= msm_seg_level(b, hb, a, ha, key, ns, i, d);
#if defined(__CUDA_ARCH__)
    took = __syncthreads_or(took);
#endif
    uint32_t* tw = a;
    a = b;
    b = tw;
    int* th = ha;
    ha = hb;
    hb = th;
    if (!took) break;
  }
  *has_out = ha;
  return a;
}

// Slot i after a block's reduction (words v, flags has): where it starts
// its bucket's slots, its sum placed as msm_place_head places it.
FE_FN void msm_place_slot(const uint32_t* v, const int* has, const int* key, int i,
                          const int32_t* keys, long n, long lo, long hi, int32_t* const out[4],
                          long stride, long base, uint32_t* part) {
  if (!msm_seg_head(key, i)) return;
  Fe pt[4];
  msm_slot_point(pt, v, has, i);
  msm_place_head(pt, key[i], keys, n, lo, hi, out, stride, base, part);
}

// Slot i after the window's join of its blocks' pieces: where it starts its
// bucket's slots, its sum is the whole bucket.
FE_FN void msm_store_slot(const uint32_t* v, const int* has, const int* key, int i,
                          int32_t* const out[4], long stride, long base) {
  if (!msm_seg_head(key, i)) return;
  Fe pt[4];
  msm_slot_point(pt, v, has, i);
  store_point(out, stride, base + key[i] - 1, pt);
}

// The window's last block, for block q of the window: its first and last
// pieces (words at pieces + 2 q PT_WORDS, keys and has flags at 2 q) into
// the join's slot q and last piece q.  Other blocks wrote them, so the card
// reads them past the L1.
FE_FN void msm_load_pieces(uint32_t* fbuf, int* fkey, int* fhas, uint32_t* lbuf, int* lkey,
                           int* lhas, const uint32_t* pieces, const int32_t* pkey,
                           const int32_t* phas, int q) {
  const uint32_t* src = pieces + 2L * q * PT_WORDS;
#if defined(__CUDA_ARCH__)
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* fd = reinterpret_cast<uint4*>(fbuf + (long)q * PT_WORDS);
  uint4* ld = reinterpret_cast<uint4*>(lbuf + (long)q * PT_WORDS);
#pragma unroll
  for (int u = 0; u < PT_WORDS / 4; ++u) {
    fd[u] = __ldcg(s + u);
    ld[u] = __ldcg(s + PT_WORDS / 4 + u);
  }
  fkey[q] = __ldcg(pkey + 2 * q);
  fhas[q] = __ldcg(phas + 2 * q);
  lkey[q] = __ldcg(pkey + 2 * q + 1);
  lhas[q] = __ldcg(phas + 2 * q + 1);
#else
  for (int u = 0; u < PT_WORDS; ++u) {
    fbuf[(long)q * PT_WORDS + u] = src[u];
    lbuf[(long)q * PT_WORDS + u] = src[PT_WORDS + u];
  }
  fkey[q] = pkey[2 * q];
  fhas[q] = phas[2 * q];
  lkey[q] = pkey[2 * q + 1];
  lhas[q] = phas[2 * q + 1];
#endif
}


// ---------------------------------------------------------------------------
// msm_window_reduce: four lanes share each doubling and each add
// ---------------------------------------------------------------------------
//
// A quad (four consecutive lanes r = 0..3 of a warp) holds one point, every
// lane all four coordinates.  A doubling (dbl-2008-hwcd, the formulas of
// point_double_k) squares one value per lane, gathers the four squares, and
// multiplies one product per lane (X' = EF, Y' = GH, Z' = FG, T' = EH); an
// add (add-2008-hwcd-3, those of point_add) multiplies one product per lane
// (A, B, T1 T2, Z1 Z2), gathers them, runs C = T1 T2 2d in every lane, and
// multiplies one product per lane.  So a doubling costs the latency of two
// field operations and an add three, where one thread runs seven and nine
// (in batches).  The gathers are warp shuffles on the card; on the host one
// call runs the four lanes one after another.  The results equal
// point_double_k's and point_add's word for word.  The per-row ladders
// (ladder_w32.cuh) run on the same doubling and on quad_add_cached_into.

// This lane's place r in its quad and the mask of the quad's lanes (on the
// host r is 0 and unused: a call there is the whole quad).
struct Quad {
  int r;
  unsigned mask;
};

FE_FN Quad quad_of_thread(int tid) { return Quad{tid & 3, 0xFu << (tid & 28)}; }

// Lane r's pick of four values, word by word (a lane-indexed array would
// live in local memory on the card).
FE_FN void fe_pick(Fe& out, const Fe& a, const Fe& b, const Fe& c, const Fe& d, int r) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
    out.w[i] = r == 0 ? a.w[i] : r == 1 ? b.w[i] : r == 2 ? c.w[i] : d.w[i];
}

// Doubling, lane r's square: X^2, Y^2, Z^2, (X + Y)^2.
FE_FN void quad_dbl_square(Fe& s, const Fe p[4], int r) {
  Fe sum, in;
  fe_add(sum, p[0], p[1]);
  fe_pick(in, p[0], p[1], p[2], sum, r);
  fe_sq(s, in);
}

// Doubling, every lane: (E, F, G, H) from the four squares.
FE_FN void quad_dbl_efgh(Fe efgh[4], const Fe s[4]) {
  Fe C;
  fe_mul2(C, s[2]);
  fe_add(efgh[3], s[0], s[1]);       // H = A + B
  fe_sub(efgh[0], efgh[3], s[3]);    // E = H - (X + Y)^2
  fe_sub(efgh[2], s[0], s[1]);       // G = A - B
  fe_add(efgh[1], C, efgh[2]);       // F = C + G
}

// Doubling and add, lane r's product: EF, GH, FG, EH.
FE_FN void quad_product(Fe& out, const Fe efgh[4], int r) {
  Fe a, b;
  fe_pick(a, efgh[0], efgh[2], efgh[1], efgh[0], r);   // E, G, F, E
  fe_pick(b, efgh[1], efgh[3], efgh[2], efgh[3], r);   // F, H, G, H
  fe_mul(out, a, b);
}

// Add p + q, lane r's first product: (Y1 - X1)(Y2 - X2), (Y1 + X1)(Y2 + X2),
// T1 T2, Z1 Z2.
FE_FN void quad_add_first(Fe& out, const Fe p[4], const Fe q[4], int r) {
  Fe pd, ps, qd, qs, u, v;
  fe_sub(pd, p[1], p[0]);
  fe_add(ps, p[1], p[0]);
  fe_sub(qd, q[1], q[0]);
  fe_add(qs, q[1], q[0]);
  fe_pick(u, pd, ps, p[3], p[2], r);
  fe_pick(v, qd, qs, q[3], q[2], r);
  fe_mul(out, u, v);
}

// Add, every lane: (E, F, G, H) from the four first products.
FE_FN void quad_add_efgh(Fe efgh[4], const Fe w[4]) {
  const Fe d2 = {CPZK_D2_WORDS};
  Fe C, Dv;
  fe_mul(C, w[2], d2);
  fe_mul2(Dv, w[3]);
  fe_sub(efgh[0], w[1], w[0]);   // E = B - A
  fe_sub(efgh[1], Dv, C);        // F = D - C
  fe_add(efgh[2], Dv, C);        // G = D + C
  fe_add(efgh[3], w[1], w[0]);   // H = B + A
}

#if defined(__CUDA_ARCH__)
// The four values of a quad, one from each lane (lane r of the quad gives
// out[r]).
__device__ __forceinline__ void quad_gather(Fe out[4], const Fe& v, unsigned mask) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < NW; ++i) out[r].w[i] = __shfl_sync(mask, v.w[i], r, 4);
  }
}
#endif

// One doubling of p (every lane of the quad holds it).
FE_FN void quad_double_round(Fe p[4], Quad qd) {
#if defined(__CUDA_ARCH__)
  Fe sq, s[4], efgh[4], prod;
  quad_dbl_square(sq, p, qd.r);
  quad_gather(s, sq, qd.mask);
  quad_dbl_efgh(efgh, s);
  quad_product(prod, efgh, qd.r);
  quad_gather(p, prod, qd.mask);
#else
  (void)qd;
  Fe s[4], efgh[4], prod[4];
  for (int r = 0; r < 4; ++r) quad_dbl_square(s[r], p, r);
  quad_dbl_efgh(efgh, s);
  for (int r = 0; r < 4; ++r) quad_product(prod[r], efgh, r);
  pt_copy(p, prod);
#endif
}

// k >= 0 doublings of p (every lane of the quad holds it).
MSM_FN void quad_double_k(Fe p[4], int k, Quad qd) {
  for (int round = 0; round < k; ++round) quad_double_round(p, qd);
}

// acc += q (every lane of the quad holds both).
MSM_FN void quad_add_into(Fe acc[4], const Fe q[4], Quad qd) {
#if defined(__CUDA_ARCH__)
  Fe w1, w[4], efgh[4], prod;
  quad_add_first(w1, acc, q, qd.r);
  quad_gather(w, w1, qd.mask);
  quad_add_efgh(efgh, w);
  quad_product(prod, efgh, qd.r);
  quad_gather(acc, prod, qd.mask);
#else
  (void)qd;
  Fe w[4], efgh[4], prod[4];
  for (int r = 0; r < 4; ++r) quad_add_first(w[r], acc, q, r);
  quad_add_efgh(efgh, w);
  for (int r = 0; r < 4; ++r) quad_product(prod[r], efgh, r);
  pt_copy(acc, prod);
#endif
}

// A point in the adds' cached form (pt_cached) as a quad holds it for
// quad_add_cached_into: on the card lane r holds coordinate r only (8
// words; the quad's four 32-byte loads of an entry make one 128-byte
// line); on the host, where one call is the whole quad, all four.
struct QuadCached {
#if defined(__CUDA_ARCH__)
  Fe c;
#else
  Fe c[4];
#endif
};

// This lane's part of the cached point at src (32 words, 16-byte aligned;
// global or shared memory).  On the card the load is an inline-PTX
// generic load, so the compiler issues it where it stands and does not
// sink it towards its first use: the ladder loads a step's entries one
// step ahead.
FE_FN void quad_load_cached(QuadCached& q, const uint32_t* src, Quad qd) {
#if defined(__CUDA_ARCH__)
  const uint32_t* s = src + qd.r * NW;
  uint32_t* w = q.c.w;
  asm volatile("ld.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(s) : "memory");
  asm volatile("ld.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w[4]), "=r"(w[5]), "=r"(w[6]), "=r"(w[7]) : "l"(s + 4) : "memory");
#else
  (void)qd;
  for (int k = 0; k < 4; ++k) {
    for (int i = 0; i < NW; ++i) q.c[k].w[i] = src[k * NW + i];
  }
#endif
}

// This lane's part of the cached point c (every lane holds all of it).
FE_FN void quad_cached_pick(QuadCached& q, const Fe c[4], Quad qd) {
#if defined(__CUDA_ARCH__)
  fe_pick(q.c, c[0], c[1], c[2], c[3], qd.r);
#else
  (void)qd;
  for (int k = 0; k < 4; ++k) q.c[k] = c[k];
#endif
}

// Cached add, lane r's first product: (Y1 - X1) Q0, (Y1 + X1) Q1, T1 Q2,
// Z1 Q3 (A, B, C, D of pt_add_cached_into), qr the entry's coordinate r.
FE_FN void quad_add_cached_first(Fe& out, const Fe p[4], const Fe& qr, int r) {
  Fe pd, ps, u;
  fe_sub(pd, p[1], p[0]);
  fe_add(ps, p[1], p[0]);
  fe_pick(u, pd, ps, p[3], p[2], r);
  fe_mul(out, u, qr);
}

// Cached add, every lane: (E, F, G, H) from A, B, C, D with adds alone (the
// entry carries 2d T).
FE_FN void quad_cached_efgh(Fe efgh[4], const Fe w[4]) {
  fe_sub(efgh[0], w[1], w[0]);   // E = B - A
  fe_sub(efgh[1], w[3], w[2]);   // F = D - C
  fe_add(efgh[2], w[3], w[2]);   // G = D + C
  fe_add(efgh[3], w[1], w[0]);   // H = B + A
}

// acc += Q, Q cached (every lane of the quad holds acc, each its part of
// Q): pt_add_cached_into's formulas, one product a lane, a gather, E F G H
// in every lane, one product a lane, a gather.  Equal to
// pt_add_cached_into word for word.
FE_FN void quad_add_cached_into(Fe acc[4], const QuadCached& q, Quad qd) {
#if defined(__CUDA_ARCH__)
  Fe w1, w[4], efgh[4], prod;
  quad_add_cached_first(w1, acc, q.c, qd.r);
  quad_gather(w, w1, qd.mask);
  quad_cached_efgh(efgh, w);
  quad_product(prod, efgh, qd.r);
  quad_gather(acc, prod, qd.mask);
#else
  (void)qd;
  Fe w[4], efgh[4], prod[4];
  for (int r = 0; r < 4; ++r) quad_add_cached_first(w[r], acc, q.c[r], r);
  quad_cached_efgh(efgh, w);
  for (int r = 0; r < 4; ++r) quad_product(prod[r], efgh, r);
  pt_copy(acc, prod);
#endif
}

// ---------------------------------------------------------------------------
// msm_window_reduce, step 1: the window totals (a block a window, a quad a
// segment of g = 2^log_g buckets; every step runs for every quad before
// the next starts)
// ---------------------------------------------------------------------------
//
// Segment s holds buckets s g + 1 .. s g + g; walked from the top it gives
// run_s (the sum of its buckets) and tot_s (sum over it of (j - s g) B_j),
// so it contributes tot_s + s g run_s to sum_j j B_j.  Over all segments
// that is sum_s x_s with x_s = tot_s + g later_s, where later_s is the sum
// of the runs after s: a suffix scan of the runs, then the tree sum of the
// x_s.

// quads (segments) a window at most, and the buckets a window stages in
// shared memory at most (c <= 11: 128 KB)
constexpr int MSM_TOTALS_QUADS = 64;
constexpr int MSM_TOTALS_STAGED_BUCKETS = 1024;

// Segments a window for window size c (a power of two dividing 2^(c-1)).
FE_FN int msm_totals_segments(int c) {
  const int nb = 1 << (c - 1);
  return nb < MSM_TOTALS_QUADS ? nb : MSM_TOTALS_QUADS;
}

// log2 of the buckets a segment of nseg segments holds for window size c.
FE_FN int msm_totals_log_g(int c, int nseg) {
  int log_g = 0;
  while ((nseg << log_g) < (1 << (c - 1))) ++log_g;
  return log_g;
}

// Step 0, thread t of nt: the window's nb buckets (limbs at lanes base ..
// base + nb - 1 of [20, lanes]) into sb in the kernels' form, read once
// with coalesced loads.
FE_FN void msm_totals_stage(uint32_t* sb, const int32_t* const coords[4], long lanes, long base,
                            int nb, int t, int nt) {
  for (int q = t; q < nb; q += nt) {
    Fe b[4];
    load_point(b, coords, lanes, base + q);
    pt_store_words(sb + (long)q * PT_WORDS, b);
  }
}

// Step 1, quad sg: its segment's walk from the top bucket (staged in sb,
// or the limbs where sb is null), run and tot into sr[sg] and sx[sg].
MSM_FN void msm_totals_segment(Fe run[4], uint32_t* sr, uint32_t* sx, const uint32_t* sb,
                               const int32_t* const coords[4], long lanes, long base, int sg,
                               int log_g, Quad qd) {
  Fe tot[4];
  pt_identity(run);
  pt_identity(tot);
  for (int q = ((sg + 1) << log_g) - 1; q >= sg << log_g; --q) {
    Fe b[4];
    if (sb) {
      pt_load_words(b, sb + (long)q * PT_WORDS);
    } else {
      load_point(b, coords, lanes, base + q);
    }
    quad_add_into(run, b, qd);
    quad_add_into(tot, run, qd);
  }
  if (qd.r == 0) {
    pt_store_words(sx + (long)sg * PT_WORDS, tot);
    pt_store_words(sr + (long)sg * PT_WORDS, run);
  }
}

// Step 2, one level (distance d) of the inclusive suffix scan of the nseg
// runs, quad sg: run += src[sg + d] where that exists; run into dst[sg].
MSM_FN void msm_totals_scan_level(Fe run[4], uint32_t* dst, const uint32_t* src, int sg,
                                  int nseg, int d, Quad qd) {
  if (sg + d < nseg) {
    Fe q[4];
    pt_load_words(q, src + (long)(sg + d) * PT_WORDS);
    quad_add_into(run, q, qd);
  }
  if (qd.r == 0) pt_store_words(dst + (long)sg * PT_WORDS, run);
}

// Step 3, quad sg: x = 2^log_g later_sg + tot_sg (sr the scanned runs, sx
// the tots), into sx[sg].
MSM_FN void msm_totals_weight(Fe x[4], uint32_t* sx, const uint32_t* sr, int sg, int nseg,
                              int log_g, Quad qd) {
  if (sg + 1 < nseg) {
    pt_load_words(x, sr + (long)(sg + 1) * PT_WORDS);
  } else {
    pt_identity(x);
  }
  Fe tot[4];
  pt_load_words(tot, sx + (long)sg * PT_WORDS);
  quad_double_k(x, log_g, qd);
  quad_add_into(x, tot, qd);
  if (qd.r == 0) pt_store_words(sx + (long)sg * PT_WORDS, x);
}

// Steps 4 (the x_s) and the scale kernel's sum: one level (half h) of the
// tree sum of n points in s, quad i: x += s[i + h] for i < h and
// i + h < n, into s[i] (x holds s[i]).
MSM_FN void msm_tree_level(Fe x[4], uint32_t* s, int i, int h, int n, Quad qd) {
  if (i >= h || i + h >= n) return;
  Fe q[4];
  pt_load_words(q, s + (long)(i + h) * PT_WORDS);
  quad_add_into(x, q, qd);
  if (qd.r == 0) pt_store_words(s + (long)i * PT_WORDS, x);
}

// The least power of two >= n: the tree sum's first level is half of it.
FE_FN int msm_tree_top(int n) {
  int top = 1;
  while (top < n) top <<= 1;
  return top;
}

// ---------------------------------------------------------------------------
// msm_window_reduce, step 2: each window total times 2^(c w), summed (one
// block, a quad for each of nq strides of windows)
// ---------------------------------------------------------------------------

// quads of the scale step for k windows
FE_FN int msm_scale_quads(int k) { return k < MSM_TOTALS_QUADS ? k : MSM_TOTALS_QUADS; }

// Quad q of nq: Horner over windows q, q + nq, ... (totals, 32 words each)
// from the top with stride nq, then times 2^(c q), into sq[q]; a quad's
// chain is at most c (k - 1) doublings.
MSM_FN void msm_scale_horner(Fe acc[4], uint32_t* sq, const uint32_t* totals, int k, int c,
                             int q, int nq, Quad qd) {
  int w = q + (k - 1 - q) / nq * nq;
  pt_load_words(acc, totals + (long)w * PT_WORDS);
  for (w -= nq; w >= 0; w -= nq) {
    quad_double_k(acc, c * nq, qd);
    Fe t[4];
    pt_load_words(t, totals + (long)w * PT_WORDS);
    quad_add_into(acc, t, qd);
  }
  quad_double_k(acc, c * q, qd);
  if (qd.r == 0) pt_store_words(sq + (long)q * PT_WORDS, acc);
}

}  // namespace cpzk
