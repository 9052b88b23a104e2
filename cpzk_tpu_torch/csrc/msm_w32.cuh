// The thread bodies of the Pippenger kernels (msm_ops.cu) on the point
// arithmetic of fe25519_w32.cuh.  Host and device code: the kernels call
// them per thread, and the tests compile this header with a host C++
// compiler (through host_shim.cpp) and run them over every (window, bucket)
// to hold them against the plain PyTorch version in
// cpzk_tpu_torch/ops/msm.py.
//
// Digits are signed c-bit digits d in [-2^(c-1), 2^(c-1)], so a window has
// the buckets j = 1 .. 2^(c-1) (the top one included: n_buckets = 2^(c-1) + 1
// with bucket 0, which is skipped).  A point enters bucket |d|, negated
// where d < 0.
#pragma once

#include <stdint.h>

#include "fe25519_w32.cuh"

namespace cpzk {

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

// -P = (-X, Y, Z, -T) in place.
FE_FN void pt_negate(Fe p[4]) {
  const Fe zero = {{0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
  fe_sub(p[0], zero, p[0]);
  fe_sub(p[3], zero, p[3]);
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

// Add the terms of one pending list into acc: each entry is i + 1 for a
// positive digit of term i and -(i + 1) for a negative one.
FE_FN void msm_flush(Fe acc[4], const int32_t* pend, int pstride, int cnt,
                     const int32_t* const coords[4], long m) {
  for (int q = 0; q < cnt; ++q) {
    const int32_t e = pend[q * pstride];
    Fe p[4];
    load_point(p, coords, m, (e < 0 ? -e : e) - 1);
    if (e < 0) pt_negate(p);
    pt_add_into(acc, p);
  }
}

// One thread's work of msm_bucket_kernel on one tile of window w's digits:
// of the count terms base .. base + count - 1 (digits tile[0 .. count)),
// those whose digit has magnitude j are added into acc (bucket j's running
// sum), negated where the digit is negative.  Matches are first listed in
// pend (cap entries at stride pstride) and added after the scan, so the
// threads of a warp, which scan the same tile for different j, run their
// adds together instead of one at a time; a full list is emptied early.
FE_FN void msm_bucket_tile(Fe acc[4], const int32_t* tile, int count, long base, int j,
                           const int32_t* const coords[4], long m, int32_t* pend,
                           int pstride, int cap) {
  int cnt = 0;
  for (int t = 0; t < count; ++t) {
    const int32_t d = tile[t];
    if (d == j || d == -j) {
      if (cnt == cap) {
        msm_flush(acc, pend, pstride, cnt, coords, m);
        cnt = 0;
      }
      const int32_t e = (int32_t)(base + t + 1);
      pend[cnt * pstride] = d < 0 ? -e : e;
      ++cnt;
    }
  }
  msm_flush(acc, pend, pstride, cnt, coords, m);
}

// One thread's segment of msm_window_reduce_kernel: the buckets at
// positions lo .. hi - 1 of one window (position q holds bucket q + 1, at
// lane base + q of [20, lanes] limb-major coordinates), walked from the
// top: run = sum of the segment's buckets, tot = sum over the segment of
// (q - lo + 1) bucket_(q+1).
FE_FN void msm_segment(Fe run[4], Fe tot[4], int lo, int hi,
                       const int32_t* const buckets[4], long lanes, long base) {
  pt_identity(run);
  pt_identity(tot);
  for (int q = hi - 1; q >= lo; --q) {
    Fe b[4];
    load_point(b, buckets, lanes, base + q);
    pt_add_into(run, b);
    pt_add_into(tot, run);
  }
}

// Join the g segments of S = 2^log_s buckets each (segment s covers
// positions s S .. s S + S - 1) into the window total sum_j j bucket_j =
// sum_s tot_s + S sum_s s run_s, the last sum by running sums from the top
// segment down (so a small-scalar multiple costs adds, not a ladder).
FE_FN void msm_join(Fe total[4], const Fe (*run)[4], const Fe (*tot)[4], int g, int log_s) {
  Fe rr[4], acc[4];
  pt_identity(rr);
  pt_identity(acc);
  pt_identity(total);
  for (int s = g - 1; s >= 0; --s) {
    pt_add_into(total, tot[s]);
    if (s > 0) {
      pt_add_into(rr, run[s]);
      pt_add_into(acc, rr);
    }
  }
  if (log_s > 0) point_double_k(acc, log_s);
  pt_add_into(total, acc);
}

// Horner over the k window totals, most significant first:
// acc = 2^c acc + total_w.  Window w's total is the four 8-word
// coordinates at totals[32 w ..], read as volatile: on the card another
// block wrote them (and fenced) before this one read its ticket.
FE_FN void msm_horner(Fe acc[4], int k, int c, const volatile uint32_t* totals) {
  pt_identity(acc);
  for (int w = k - 1; w >= 0; --w) {
    point_double_k(acc, c);
    Fe t[4];
    for (int q = 0; q < 4; ++q) {
      for (int i = 0; i < NW; ++i) t[q].w[i] = totals[(long)(w * 4 + q) * NW + i];
    }
    pt_add_into(acc, t);
  }
}

// A point's four coordinates as 8-word totals at out[0 .. 32).
FE_FN void store_total(uint32_t* out, const Fe p[4]) {
  for (int q = 0; q < 4; ++q) {
    for (int i = 0; i < NW; ++i) out[q * NW + i] = p[q].w[i];
  }
}

}  // namespace cpzk
