// Test-only host build of fe25519_w32.cuh, sc25519_w32.cuh, msm_w32.cuh,
// ristretto_w32.cuh, decode_w32.cuh, recode_w32.cuh, prove_w32.cuh,
// keccak_u64.cuh and ladder_w32.cuh:
// a C interface over limb-major [20, n] int32 arrays, looping over lanes on
// the CPU, so the tests can hold the kernels' field, point and scalar
// arithmetic, the Pippenger thread bodies, ristretto encode and decode, the prover's
// comb and walk bodies, the Keccak chain, the per-row ladders' bodies and
// rlc_scalars' against the plain PyTorch versions with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC host_shim.cpp -o libfe25519_host.so
//
// Every entry converts its inputs from limbs to words and its outputs back,
// as the kernels do.  Nothing outside tests/test_torch_kernel_host.py loads
// this library.
#include <stdint.h>

#include <algorithm>
#include <array>
#include <utility>
#include <vector>

#include "decode_w32.cuh"
#include "fe25519_w32.cuh"
#include "keccak_u64.cuh"
#include "ladder_w32.cuh"
#include "msm_w32.cuh"
#include "prove_w32.cuh"
#include "recode_w32.cuh"
#include "ristretto_w32.cuh"
#include "sc25519_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::NL;
using cpzk::NW;
using cpzk::PT_WORDS;
using cpzk::Sc;

void load_fe(Fe& out, const int32_t* src, int n, int j) {
  int32_t l[NL];
  for (int i = 0; i < NL; ++i) l[i] = src[(long)i * n + j];
  cpzk::fe_from_limbs(out, l);
}

void store_fe(int32_t* dst, const Fe& v, int n, int j) {
  int32_t l[NL];
  cpzk::fe_to_limbs(l, v);
  for (int i = 0; i < NL; ++i) dst[(long)i * n + j] = l[i];
}

void load_sc(Sc& out, const int32_t* src, int n, int j) {
  int32_t l[NL];
  for (int i = 0; i < NL; ++i) l[i] = src[(long)i * n + j];
  cpzk::sc_from_limbs(out, l);
}

void store_sc(int32_t* dst, const Sc& v, int n, int j) {
  int32_t l[NL];
  cpzk::sc_to_limbs(l, v);
  for (int i = 0; i < NL; ++i) dst[(long)i * n + j] = l[i];
}

// The whole quad in one call (msm_w32.cuh's Quad on the host).
constexpr cpzk::Quad kQuad = {0, 0xFu};

// Point operand `k` of a flat list of [20, n] coordinate pointers (4 a
// point), per lane or shared (step 0: a [20, 1] array).
cpzk::LadderPt ladder_pt(const int32_t* const* c, int k, int n, int step) {
  cpzk::LadderPt p;
  for (int i = 0; i < 4; ++i) {
    p.c[i] = c[4 * k + i];
    p.ld[i] = step ? n : 1;
  }
  p.step = step;
  return p;
}

// A 9-word sum of rlc_scalars (sc25519_w32.cuh's RLC_SUM_WORDS).
using Sum9 = std::array<uint32_t, cpzk::RLC_SUM_WORDS>;

// A warp's shuffle levels of half from / 2 .. 1 as __shfl_down_sync gives
// them to rlc_scalars_kernel's warp_sum9 (lane i reads lane i + off, its
// own value past the warp), each lane's sc9_add.
void warp_sum9(Sum9* x, int from) {
  for (int off = from / 2; off >= 1; off >>= 1) {
    Sum9 y[32];
    for (int i = 0; i < 32; ++i) y[i] = x[i + off < 32 ? i + off : i];
    for (int i = 0; i < 32; ++i) cpzk::sc9_add(x[i].data(), y[i].data());
  }
}

// rlc_scalars_kernel's block_sum9 over a block's `threads` values (whole
// warps): thread 0's sum.
Sum9 block_sum9(std::vector<Sum9>& x, int threads) {
  const int warps = threads / 32;
  for (int w = 0; w < warps; ++w) warp_sum9(&x[32L * w], 32);
  if (warps == 1) return x[0];
  Sum9 lanes[32];
  for (int l = 0; l < 32; ++l) {
    if (l < warps) {
      lanes[l] = x[32L * l];
    } else {
      lanes[l].fill(0);
    }
  }
  warp_sum9(lanes, warps);
  return lanes[0];
}

// Window operand t of [nt, 64, n] windows.
cpzk::LadderWin ladder_win(const int32_t* w, int t, int n) {
  return cpzk::LadderWin{w + (long)t * cpzk::LADDER_STEPS * n, n};
}

}  // namespace

extern "C" {

// 2d as 20 limbs
void host_d2(int32_t* out) {
  const Fe d2 = {CPZK_D2_WORDS};
  store_fe(out, d2, 1, 0);
}

// [20, n] limbs -> [8, n] words (fe_from_limbs alone)
void host_to_words(const int32_t* a, uint32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Fe w;
    load_fe(w, a, n, j);
    for (int i = 0; i < NW; ++i) out[(long)i * n + j] = w.w[i];
  }
}

// op: 0 mul, 1 add, 2 sub, 3 mul2 (b unused), 4 square (b unused),
// 5 the conversion round trip, 6 canonical, 7 pow_p58, 8 neg, 9 abs
// (b unused from 3 on)
void host_fe_op(int op, const int32_t* a, const int32_t* b, int32_t* out,
                int n) {
  for (int j = 0; j < n; ++j) {
    Fe x, y, z;
    load_fe(x, a, n, j);
    if (op < 3) load_fe(y, b, n, j);
    switch (op) {
      case 0: cpzk::fe_mul(z, x, y); break;
      case 1: cpzk::fe_add(z, x, y); break;
      case 2: cpzk::fe_sub(z, x, y); break;
      case 3: cpzk::fe_mul2(z, x); break;
      case 4: cpzk::fe_sq(z, x); break;
      case 6: cpzk::fe_canonical(z, x); break;
      case 7: cpzk::fe_pow_p58(z, x); break;
      case 8: cpzk::fe_neg(z, x); break;
      case 9: cpzk::fe_abs(z, x); break;
      default: z = x; break;
    }
    store_fe(out, z, n, j);
  }
}

void host_point_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                    const int32_t* t1, const int32_t* x2, const int32_t* y2,
                    const int32_t* z2, const int32_t* t2, int32_t* ox,
                    int32_t* oy, int32_t* oz, int32_t* ot, int n) {
  for (int j = 0; j < n; ++j) {
    Fe p[4], q[4], r[4];
    load_fe(p[0], x1, n, j);
    load_fe(p[1], y1, n, j);
    load_fe(p[2], z1, n, j);
    load_fe(p[3], t1, n, j);
    load_fe(q[0], x2, n, j);
    load_fe(q[1], y2, n, j);
    load_fe(q[2], z2, n, j);
    load_fe(q[3], t2, n, j);
    cpzk::point_add(r, p, q);
    store_fe(ox, r[0], n, j);
    store_fe(oy, r[1], n, j);
    store_fe(oz, r[2], n, j);
    store_fe(ot, r[3], n, j);
  }
}

void host_point_double_k(const int32_t* x, const int32_t* y, const int32_t* z,
                         int32_t* ox, int32_t* oy, int32_t* oz, int32_t* ot,
                         int n, int k) {
  for (int j = 0; j < n; ++j) {
    Fe p[4];
    load_fe(p[0], x, n, j);
    load_fe(p[1], y, n, j);
    load_fe(p[2], z, n, j);
    cpzk::point_double_k(p, k);
    store_fe(ox, p[0], n, j);
    store_fe(oy, p[1], n, j);
    store_fe(oz, p[2], n, j);
    store_fe(ot, p[3], n, j);
  }
}

// [20, n] limbs -> is_negative per lane (0 or 1)
void host_fe_is_negative(const int32_t* a, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Fe x;
    load_fe(x, a, n, j);
    out[j] = (int32_t)cpzk::fe_is_negative(x);
  }
}

// sqrt_ratio_m1(u, v) per lane: the root [20, n] and was_square [n]
void host_fe_sqrt_ratio_m1(const int32_t* u, const int32_t* v, int32_t* r,
                           int32_t* was_square, int n) {
  for (int j = 0; j < n; ++j) {
    Fe x, y, z;
    load_fe(x, u, n, j);
    load_fe(y, v, n, j);
    was_square[j] = (int32_t)cpzk::fe_sqrt_ratio_m1(z, x, y);
    store_fe(r, z, n, j);
  }
}

// ristretto ENCODE of [20, n] x 4 points -> [32, n] bytes
void host_ristretto_encode(const int32_t* x, const int32_t* y, const int32_t* z,
                           const int32_t* t, uint8_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Fe p[4];
    load_fe(p[0], x, n, j);
    load_fe(p[1], y, n, j);
    load_fe(p[2], z, n, j);
    load_fe(p[3], t, n, j);
    uint8_t b[32];
    cpzk::ristretto_encode(b, p);
    for (int i = 0; i < 32; ++i) out[(long)i * n + j] = b[i];
  }
}

// ristretto_decode_kernel's thread body (decode_w32.cuh) for every lane
// j < n: [n, 32] byte rows -> [4, 8, n] canonical words and [n] validity
// bytes
void host_ristretto_decode(const uint8_t* wire, uint32_t* words, uint8_t* valid, int n) {
  for (int j = 0; j < n; ++j) {
    uint32_t in[NW];
    for (int i = 0; i < NW; ++i) {
      const uint8_t* b = wire + (long)j * 32 + 4 * i;
      in[i] = (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
              ((uint32_t)b[3] << 24);
    }
    Fe p[4];
    const uint32_t ok = cpzk::dec_ristretto(p, in);
    for (int c = 0; c < 4; ++c) {
      Fe v;
      cpzk::fe_canonical(v, p[c]);
      for (int i = 0; i < NW; ++i) words[(long)(8 * c + i) * n + j] = v.w[i];
    }
    valid[j] = (uint8_t)ok;
  }
}

// decode_w32.cuh's radix-2^25.5 ops on [20, n] limbs, through its word
// conversions: op 0 a b, 1 a^2, 2 a^((p - 5) / 8), 3 the conversion round
// trip, 4 a b with the product's limbs checked against the carry's bound
// (out is all 0 where one exceeds h_i < 2^b_i + 2^14)
void host_fe10_op(int op, const int32_t* a, const int32_t* b, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Fe x, y, z;
    load_fe(x, a, n, j);
    load_fe(y, b, n, j);
    cpzk::Fe10 f, g;
    cpzk::fe10_from_words(f, x);
    cpzk::fe10_from_words(g, y);
    switch (op) {
      case 0: cpzk::fe10_mul(f, f, g); break;
      case 1: cpzk::fe10_sq(f, f); break;
      case 2: cpzk::fe10_pow_p58(f, f); break;
      case 4: {
        cpzk::fe10_mul(f, f, g);
        bool ok = true;
        for (int i = 0; i < cpzk::NT; ++i)
          ok = ok && f.v[i] < (1u << cpzk::ten_bits(i)) + (1u << 14);
        if (!ok) f = cpzk::Fe10{};
        break;
      }
      default: break;
    }
    cpzk::fe10_to_words(z, f);
    store_fe(out, z, n, j);
  }
}

// comb_tables_kernel's phases for the [20, 1] point p, every thread of
// each in the kernel's order: the bases on one quad, the entries level by
// level, then each window's affine form, into out (COMB_TABLE_WORDS words)
void host_comb_tables(const int32_t* x, const int32_t* y, const int32_t* z,
                      const int32_t* t, uint32_t* out) {
  Fe p[4];
  load_fe(p[0], x, 1, 0);
  load_fe(p[1], y, 1, 0);
  load_fe(p[2], z, 1, 0);
  load_fe(p[3], t, 1, 0);
  std::vector<uint32_t> ext(cpzk::COMB_EXT_WORDS, 0u);
  cpzk::comb_bases(ext.data(), p, cpzk::Quad{0, 0u});
  for (int l = 1; l <= cpzk::COMB_LEVELS; ++l) {
    const int lo = cpzk::comb_level_lo(l), count = cpzk::comb_level_hi(l) - lo + 1;
    for (int k = 0; k < cpzk::COMB_WINDOWS * count; ++k)
      cpzk::comb_entry(ext.data(), k / count, lo + k % count);
  }
  for (int w = 0; w < cpzk::COMB_WINDOWS; ++w)
    cpzk::comb_normalise(out + w * cpzk::COMB_WINDOW_WORDS,
                         ext.data() + w * cpzk::COMB_ENTRIES * PT_WORDS);
}

// commitments_kernel's thread body for every thread (lane j < n, generator
// g), reading the tables in place: [64, n] digits -> two [32, n] encodings
void host_commitments(const uint32_t* tg, const uint32_t* th, const int32_t* digits,
                      uint8_t* r1, uint8_t* r2, int n) {
  for (int g = 0; g < 2; ++g) {
    const uint32_t* table = g == 0 ? tg : th;
    for (int j = 0; j < n; ++j) {
      cpzk::CombDigits d;
      cpzk::comb_digits_load(d, digits, n, j, true);
      Fe acc[4];
      cpzk::pt_identity(acc);
      for (int s = 0; s < cpzk::COMB_STEPS; ++s) {
        const int w = s < cpzk::COMB_WINDOWS ? s : cpzk::COMB_WINDOWS - 1;
        cpzk::comb_step(acc, d, table + w * cpzk::COMB_WINDOW_WORDS, s);
      }
      uint8_t b[32];
      cpzk::ristretto_encode(b, acc);
      uint8_t* out = g == 0 ? r1 : r2;
      for (int i = 0; i < 32; ++i) out[(long)i * n + j] = b[i];
    }
  }
}

// The walk's digits of every lane j < n: [64, n] nibbles -> [65, n] digits
// e_s, one a step (comb_next_digit's magnitude with its sign)
void host_comb_recode(const int32_t* digits, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    cpzk::CombDigits d;
    cpzk::comb_digits_load(d, digits, n, j, true);
    for (int s = 0; s < cpzk::COMB_STEPS; ++s) {
      uint32_t mag, neg;
      cpzk::comb_next_digit(d, s, mag, neg);
      out[(long)s * n + j] = neg ? -(int32_t)mag : (int32_t)mag;
    }
  }
}

// keccak_chain_kernel's row body for every row j < n, both threads of a
// row's pair at once
void host_keccak_chain(const uint32_t* s_hi, const uint32_t* s_lo, int shared,
                       const uint32_t* m_hi, const uint32_t* m_lo, int k, int n,
                       uint32_t* o_hi, uint32_t* o_lo) {
  for (int j = 0; j < n; ++j) {
    cpzk::KeccakPair a[cpzk::KECCAK_LANES];
    cpzk::keccak_chain_row(a, s_hi, s_lo, shared != 0, m_hi, m_lo, k, n, j, 0);
    for (int i = 0; i < cpzk::KECCAK_LANES; ++i)
      cpzk::keccak_store(o_hi, o_lo, (long)i * n + j, a[i], 0);
  }
}

// Scalars mod l.  op: 0 mul, 1 add, 2 neg (b unused), 3 the conversion
// round trip (b unused).
void host_sc_op(int op, const int32_t* a, const int32_t* b, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Sc x, y, z;
    load_sc(x, a, n, j);
    if (op < 2) load_sc(y, b, n, j);
    switch (op) {
      case 0: cpzk::sc_mul(z, x, y); break;
      case 1: cpzk::sc_add(z, x, y); break;
      case 2: cpzk::sc_neg(z, x); break;
      default: z = x; break;
    }
    store_sc(out, z, n, j);
  }
}

// reduce_wide_kernel's lane body for every lane j < n: [rows <= 40, n]
// canonical limbs of values below 2^512 -> [20, n] limbs mod l.
void host_reduce_wide(const int32_t* x, int rows, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) cpzk::reduce_wide_lane(x, rows, out, n, j);
}


// [20, n] scalars -> [64, n] 4-bit windows (MSB first), recode_w32.cuh's
// lane body for every lane.
void host_sc_windows(const int32_t* a, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Sc x;
    cpzk::recode_load(x, a + j, n);
    cpzk::recode_windows(out + j, n, x);
  }
}

// [20, n] scalars -> [nwin, n] signed c-bit digits (LSB first), the same way.
void host_sc_signed_digits(const int32_t* a, int c, int nwin, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Sc x;
    uint32_t w[NW];
    cpzk::recode_load(x, a + j, n);
    cpzk::recode_digits(out + j, n, c, nwin, x, w, 1);
  }
}

// scalar_recode_kernel's body (recode_w32.cuh's recode_thread) for every
// thread of a call, with the kernel's arguments: mode 0 -> [4, 64, pad]
// windows (lane n spliced), mode 1 -> [nwin, m] digits.
void host_scalar_recode(const int32_t* g0, const int32_t* g1, const int32_t* g2,
                        const int32_t* g3, const int32_t* corr0, const int32_t* corr1, int n,
                        int pad, int mode, int c, int nwin, int m, int32_t* out) {
  const cpzk::RecodeArgs args{g0, g1, g2, g3, corr0, corr1, n, pad, m, mode, c, nwin, out};
  const int threads = cpzk::recode_threads(args);
  uint32_t w[NW];
  for (int t = 0; t < threads; ++t) cpzk::recode_thread(args, t, w, 1);
}

// rlc_scalars_kernel over every block of `threads` threads (whole warps;
// 0: the kernel's RLC_THREADS), two a row, then its last block, in its
// order: [20, n] a, c, s and [20, 1] beta -> [20, n] a c, b a, b a c and
// [20, 1] -S, -b S (S = sum a s mod l).
void host_rlc_scalars(const int32_t* a, const int32_t* c, const int32_t* s, const int32_t* bl,
                      int32_t* ac, int32_t* ba, int32_t* bac, int32_t* corr0, int32_t* corr1,
                      int n, int threads) {
  if (threads == 0) threads = cpzk::RLC_THREADS;
  const cpzk::RlcRows rows{a, c, s, ac, ba, bac, n};
  Sc b;
  cpzk::sc_load(b, bl, 1, 0);
  const long blocks = (2L * n + threads - 1) / threads;
  std::vector<Sum9> partials(blocks), x(threads);
  for (long blk = 0; blk < blocks; ++blk) {
    for (int tid = 0; tid < threads; ++tid) {
      const long t = blk * threads + tid, j = t >> 1;
      if (j < n) {
        cpzk::rlc_row(x[tid].data(), rows, b, j, (int)(t & 1));
      } else {
        x[tid].fill(0);
      }
    }
    partials[blk] = block_sum9(x, threads);
  }
  Sum9 total = partials[0];
  if (blocks > 1) {
    for (int tid = 0; tid < threads; ++tid) {
      x[tid].fill(0);
      for (long k = tid; k < blocks; k += threads) cpzk::sc9_add(x[tid].data(), partials[k].data());
    }
    total = block_sum9(x, threads);
  }
  cpzk::rlc_finish(corr0, corr1, total.data(), b);
}

// msm_bucket's two kernels over every block, thread and phase, in their
// order: points [20, m] x 4, digits [k, m] -> buckets [20, k 2^(c-1)] x 4,
// bucket j of window w at lane w 2^(c-1) + j - 1; `threads` runs a block and
// `parts` blocks a window (the card's are 128 and a count set by m).
void host_msm_bucket(const int32_t* x, const int32_t* y, const int32_t* z,
                     const int32_t* t, const int32_t* digits, int32_t* ox, int32_t* oy,
                     int32_t* oz, int32_t* ot, int m, int k, int c, int threads, int parts) {
  const int nb = 1 << (c - 1);
  const int nt = cpzk::MSM_SORT_THREADS;
  const int32_t* const coords[4] = {x, y, z, t};
  int32_t* const out[4] = {ox, oy, oz, ot};
  const long stride = (long)k * nb;
  std::vector<uint32_t> pw((long)m * PT_WORDS), counts(nb + 1), part(nt), grp(32);
  std::vector<int32_t> keys((long)m), ents((long)m);
  for (long i = 0; i < m; ++i) cpzk::msm_point_words(pw.data(), coords, m, i);
  // a block's slots (its threads' or, in the join, the window's blocks')
  const int slots = std::max(threads, parts) + 1;
  std::vector<uint32_t> buf0((long)slots * PT_WORDS), buf1(buf0.size()), lbuf(buf0.size());
  std::vector<int> key(slots), has0(slots), has1(slots), lkey(slots), lhas(slots);
  std::vector<uint32_t> pieces((long)2 * parts * PT_WORDS);
  std::vector<int32_t> pkey(2 * parts), phas(2 * parts);
  for (int w = 0; w < k; ++w) {
    const int32_t* row = digits + (long)w * m;
    const long base = (long)w * nb;
    // msm_bucket_sort_kernel's block w
    std::fill(counts.begin(), counts.end(), 0u);
    for (int tid = 0; tid < nt; ++tid) cpzk::msm_sort_count(counts.data(), row, m, tid, nt);
    for (int tid = 0; tid < nt; ++tid)
      cpzk::msm_sort_chunk_sum(part.data(), counts.data(), nb, tid, nt);
    for (int g = 0; g < 32; ++g) cpzk::msm_sort_scan_group(part.data(), grp.data(), nt, g);
    const long n = cpzk::msm_sort_scan_groups(grp.data());
    for (int tid = 0; tid < nt; ++tid)
      cpzk::msm_sort_empties(counts.data(), nb, tid, nt, out, stride, base);
    for (int tid = 0; tid < nt; ++tid)
      cpzk::msm_sort_cursors(counts.data(), part.data(), grp.data(), nb, tid, nt);
    for (int tid = 0; tid < nt; ++tid)
      cpzk::msm_sort_scatter(keys.data(), ents.data(), counts.data(), row, m, tid, nt);
    // msm_bucket_add_kernel's blocks (p, w)
    for (int p = 0; p < parts; ++p) {
      const long lo = cpzk::msm_split(n, p, parts), hi = cpzk::msm_split(n, p + 1, parts);
      uint32_t* mine = pieces.data() + (long)2 * p * PT_WORDS;
      if (lo < hi) {
        for (int r = 0; r < threads; ++r)
          cpzk::msm_thread_run(buf0.data(), key.data(), has0.data(), lbuf.data(), lkey.data(),
                               lhas.data(), r, threads, keys.data(), ents.data(), n, lo, hi,
                               pw.data(), out, stride, base);
        for (int i = 0; i <= threads; ++i)
          cpzk::msm_seg_join(buf0.data(), key.data(), has0.data(), lbuf.data(), lkey.data(),
                             lhas.data(), threads, i);
        int* has;
        const uint32_t* v = cpzk::msm_seg_reduce(buf0.data(), has0.data(), buf1.data(),
                                                 has1.data(), key.data(), threads + 1, 0, 1,
                                                 &has);
        for (int i = 0; i <= threads; ++i)
          cpzk::msm_place_slot(v, has, key.data(), i, keys.data(), n, lo, hi, out, stride, base,
                               mine);
      }
      cpzk::msm_block_pieces(pkey.data() + 2 * p, phas.data() + 2 * p, keys.data(), n, lo, hi);
    }
    // the window's last block joins the blocks' pieces
    for (int q = 0; q < parts; ++q)
      cpzk::msm_load_pieces(buf0.data(), key.data(), has0.data(), lbuf.data(), lkey.data(),
                            lhas.data(), pieces.data(), pkey.data(), phas.data(), q);
    for (int i = 0; i <= parts; ++i)
      cpzk::msm_seg_join(buf0.data(), key.data(), has0.data(), lbuf.data(), lkey.data(),
                         lhas.data(), parts, i);
    int* has;
    const uint32_t* v = cpzk::msm_seg_reduce(buf0.data(), has0.data(), buf1.data(),
                                             has1.data(), key.data(), parts + 1, 0, 1, &has);
    for (int i = 0; i <= parts; ++i) cpzk::msm_store_slot(v, has, key.data(), i, out, stride, base);
  }
}

// msm_window_reduce's two kernels over every quad and step, in their order:
// buckets [20, k 2^(c-1)] x 4 -> the [20, 1] result, with `segments`
// segments a window (a power of two dividing 2^(c-1); the card's:
// msm_totals_segments(c)) and `quads` quads for the scaled windows (at
// most k; the card's: msm_scale_quads(k)).
void host_msm_window_reduce(const int32_t* bx, const int32_t* by, const int32_t* bz,
                            const int32_t* bt, int32_t* ox, int32_t* oy, int32_t* oz,
                            int32_t* ot, int k, int c, int segments, int quads) {
  const int nb = 1 << (c - 1);
  const int log_g = cpzk::msm_totals_log_g(c, segments);
  const int32_t* const coords[4] = {bx, by, bz, bt};
  const long lanes = (long)k * nb;
  const bool staged = nb <= cpzk::MSM_TOTALS_STAGED_BUCKETS;
  std::vector<uint32_t> totals((long)k * PT_WORDS), sb(staged ? (long)nb * PT_WORDS : 0);
  std::vector<uint32_t> sr0((long)segments * PT_WORDS), sr1(sr0.size()), sx(sr0.size());
  std::vector<Fe> run((long)segments * 4), x((long)segments * 4);
  // msm_window_reduce_totals_kernel's block w
  for (int w = 0; w < k; ++w) {
    const long base = (long)w * nb;
    if (staged) cpzk::msm_totals_stage(sb.data(), coords, lanes, base, nb, 0, 1);
    uint32_t* ra = sr0.data();
    uint32_t* rb = sr1.data();
    for (int sg = 0; sg < segments; ++sg)
      cpzk::msm_totals_segment(&run[(long)sg * 4], ra, sx.data(), staged ? sb.data() : nullptr,
                               coords, lanes, base, sg, log_g, kQuad);
    for (int d = 1; d < segments; d <<= 1) {
      for (int sg = 0; sg < segments; ++sg)
        cpzk::msm_totals_scan_level(&run[(long)sg * 4], rb, ra, sg, segments, d, kQuad);
      std::swap(ra, rb);
    }
    for (int sg = 0; sg < segments; ++sg)
      cpzk::msm_totals_weight(&x[(long)sg * 4], sx.data(), ra, sg, segments, log_g, kQuad);
    for (int h = segments >> 1; h >= 1; h >>= 1) {
      for (int sg = 0; sg < segments; ++sg)
        cpzk::msm_tree_level(&x[(long)sg * 4], sx.data(), sg, h, segments, kQuad);
    }
    cpzk::pt_store_words(&totals[(long)w * PT_WORDS], &x[0]);
  }
  // msm_window_reduce_scale_kernel's quads
  std::vector<uint32_t> sq((long)quads * PT_WORDS);
  std::vector<Fe> acc((long)quads * 4);
  for (int q = 0; q < quads; ++q)
    cpzk::msm_scale_horner(&acc[(long)q * 4], sq.data(), totals.data(), k, c, q, quads, kQuad);
  for (int h = cpzk::msm_tree_top(quads) >> 1; h >= 1; h >>= 1) {
    for (int q = 0; q < quads; ++q)
      cpzk::msm_tree_level(&acc[(long)q * 4], sq.data(), q, h, quads, kQuad);
  }
  int32_t* const out[4] = {ox, oy, oz, ot};
  cpzk::store_point(out, 1, 0, &acc[0]);
}

// msm_w32.cuh's quad doubling and add per lane:
// k doublings of [20, n] x 3, and p + q of [20, n] x 4 each.
void host_quad_double_k(const int32_t* x, const int32_t* y, const int32_t* z, int32_t* ox,
                        int32_t* oy, int32_t* oz, int32_t* ot, int n, int k) {
  for (int j = 0; j < n; ++j) {
    Fe p[4];
    load_fe(p[0], x, n, j);
    load_fe(p[1], y, n, j);
    load_fe(p[2], z, n, j);
    p[3] = p[0];  // not read: a doubling takes X, Y, Z
    cpzk::quad_double_k(p, k, kQuad);
    store_fe(ox, p[0], n, j);
    store_fe(oy, p[1], n, j);
    store_fe(oz, p[2], n, j);
    store_fe(ot, p[3], n, j);
  }
}

void host_quad_add(const int32_t* x1, const int32_t* y1, const int32_t* z1, const int32_t* t1,
                   const int32_t* x2, const int32_t* y2, const int32_t* z2, const int32_t* t2,
                   int32_t* ox, int32_t* oy, int32_t* oz, int32_t* ot, int n) {
  for (int j = 0; j < n; ++j) {
    Fe p[4], q[4];
    load_fe(p[0], x1, n, j);
    load_fe(p[1], y1, n, j);
    load_fe(p[2], z1, n, j);
    load_fe(p[3], t1, n, j);
    load_fe(q[0], x2, n, j);
    load_fe(q[1], y2, n, j);
    load_fe(q[2], z2, n, j);
    load_fe(q[3], t2, n, j);
    cpzk::quad_add_into(p, q, kQuad);
    store_fe(ox, p[0], n, j);
    store_fe(oy, p[1], n, j);
    store_fe(oz, p[2], n, j);
    store_fe(ot, p[3], n, j);
  }
}

// ladder_w32.cuh's table body per lane: [20, n] x 4 -> the 16 cached
// entries as limbs, [16, 4, 20, n] (entry e, coordinate c at (4 e + c) 20 n).
void host_ladder_table(const int32_t* const* pts, int32_t* out, int n) {
  std::vector<uint32_t> tab(cpzk::LADDER_TABLE_WORDS);
  for (int j = 0; j < n; ++j) {
    Fe p[4];
    cpzk::ladder_load(p, ladder_pt(pts, 0, n, 1), j);
    cpzk::ladder_table(tab.data(), p);
    for (int e = 0; e < cpzk::LADDER_ENTRIES; ++e) {
      Fe c[4];
      cpzk::pt_load_words(c, tab.data() + (long)e * PT_WORDS);
      for (int k = 0; k < 4; ++k) store_fe(out + (long)(4 * e + k) * NL * n, c[k], n, j);
    }
  }
}

// msm_w32.cuh's cached add per lane, one thread's and the quad's: p + q of
// [20, n] x 4 each (q turned into the cached form) -> the words of both,
// [4, 8, n] uint32 each.
void host_quad_add_cached(const int32_t* const* p, const int32_t* const* q, uint32_t* out_pt,
                          uint32_t* out_quad, int n) {
  for (int j = 0; j < n; ++j) {
    Fe a[4], b[4], c[4], x[4], y[4];
    cpzk::ladder_load(a, ladder_pt(p, 0, n, 1), j);
    cpzk::ladder_load(b, ladder_pt(q, 0, n, 1), j);
    cpzk::pt_cached(c, b);
    cpzk::pt_copy(x, a);
    cpzk::pt_add_cached_into(x, c);
    cpzk::QuadCached qc;
    cpzk::quad_cached_pick(qc, c, kQuad);
    cpzk::pt_copy(y, a);
    cpzk::quad_add_cached_into(y, qc, kQuad);
    for (int k = 0; k < 4; ++k) {
      for (int i = 0; i < NW; ++i) {
        out_pt[((long)k * NW + i) * n + j] = x[k].w[i];
        out_quad[((long)k * NW + i) * n + j] = y[k].w[i];
      }
    }
  }
}

// nt (2 or 4) terms per lane on its quad: pts holds nt points ([20, n] x 4
// each; four terms' tables built by the combined check's four threads, two
// one after the other), w [nt, 64, n] windows.  s < 0: the whole ladder
// (ladder_quad_run) into out; s >= 0: one ladder_quad_step with the entries
// of step s on the point acc ([20, n] x 4), into out.
void host_ladder_steps(const int32_t* const* pts, const int32_t* w, const int32_t* const* acc,
                       int nt, int s, int32_t* const* out, int n) {
  std::vector<uint32_t> tabs((long)nt * cpzk::LADDER_TABLE_WORDS);
  for (int j = 0; j < n; ++j) {
    const uint32_t* t[4];
    cpzk::LadderPt pt[4];
    cpzk::LadderWin win[4];
    for (int k = 0; k < nt; ++k) {
      pt[k] = ladder_pt(pts, k, n, 1);
      t[k] = tabs.data() + (long)k * cpzk::LADDER_TABLE_WORDS;
      win[k] = ladder_win(w, k, n);
    }
    if (nt == 4) {
      cpzk::ladder_combined_tables(tabs.data(), pt, j, kQuad);
    } else {
      for (int k = 0; k < nt; ++k) {
        Fe p[4];
        cpzk::ladder_load(p, pt[k], j);
        cpzk::ladder_table(tabs.data() + (long)k * cpzk::LADDER_TABLE_WORDS, p);
      }
    }
    Fe x[4];
    if (s < 0) {
      if (nt == 2) cpzk::ladder_quad_run<2>(x, t, win, j, kQuad);
      else cpzk::ladder_quad_run<4>(x, t, win, j, kQuad);
    } else {
      cpzk::ladder_load(x, ladder_pt(acc, 0, n, 1), j);
      int32_t ws[4];
      cpzk::QuadCached e[4];
      for (int k = 0; k < nt; ++k) ws[k] = cpzk::ladder_window(win[k], s, j);
      if (nt == 2) {
        cpzk::ladder_quad_entries<2>(e, t, ws, kQuad);
        cpzk::ladder_quad_step<2>(x, e, kQuad);
      } else {
        cpzk::ladder_quad_entries<4>(e, t, ws, kQuad);
        cpzk::ladder_quad_step<4>(x, e, kQuad);
      }
    }
    cpzk::store_point(out, n, j, x);
  }
}

// ladder_is_identity per lane of [20, n] x 4 points (0 or 1).
void host_ladder_is_identity(const int32_t* const* pts, int32_t* out, int n) {
  for (int j = 0; j < n; ++j) {
    Fe p[4];
    cpzk::ladder_load(p, ladder_pt(pts, 0, n, 1), j);
    out[j] = (int32_t)cpzk::ladder_is_identity(p);
  }
}

// ladder_combined_kernel over every block of `threads` threads (a multiple
// of 4, at least 8: four a lane) and every phase, in its order, blocks
// finishing in index order: r1, y1, r2, y2 ([20, n] x 4 each, in pts),
// windows [4, 64, n] -> the chunk's total ([20, 1] x 4) and its identity
// test.
void host_ladder_combined(const int32_t* const* pts, const int32_t* w, int32_t* const* out,
                          uint8_t* ok, int n, int threads) {
  const int nq = threads / 4;
  const long blocks = (4L * n + threads - 1) / threads;
  long ntickets;
  const long points = cpzk::ladder_reduce_points(blocks, nq, &ntickets);
  std::vector<uint32_t> tables((long)n * cpzk::LADDER_COMBINED_WORDS);
  std::vector<uint32_t> s((long)nq * PT_WORDS), parts((points + 1) * PT_WORDS);
  std::vector<unsigned> tickets(ntickets + 1, 0u);
  std::vector<Fe> acc((long)nq * 4);
  cpzk::LadderPt pt[4];
  cpzk::LadderWin win[4];
  for (int k = 0; k < 4; ++k) {
    pt[k] = ladder_pt(pts, k, n, 1);
    win[k] = ladder_win(w, k, n);
  }
  for (long b = 0; b < blocks; ++b) {
    for (int q = 0; q < nq; ++q) {
      const long j = b * nq + q;
      if (j < n)
        cpzk::ladder_combined_tables(tables.data() + j * cpzk::LADDER_COMBINED_WORDS, pt, j,
                                     kQuad);
    }
    for (int q = 0; q < nq; ++q) {
      const long j = b * nq + q;
      Fe* x = &acc[(long)q * 4];
      if (j < n) {
        cpzk::ladder_combined_quad(x, tables.data() + j * cpzk::LADDER_COMBINED_WORDS, win, j,
                                   kQuad);
      } else {
        cpzk::pt_identity(x);
      }
      cpzk::pt_store_words(s.data() + (long)q * PT_WORDS, x);
    }
    for (int h = cpzk::msm_tree_top(nq) >> 1; h >= 1; h >>= 1) {
      for (int q = 0; q < nq; ++q)
        cpzk::msm_tree_level(&acc[(long)q * 4], s.data(), q, h, nq, kQuad);
    }
    // the groups of partials: this block goes on while it is its group's last
    uint32_t* level = parts.data();
    unsigned* tk = tickets.data();
    long idx = b;
    bool total = true;
    for (long count = blocks; count > 1;) {
      cpzk::pt_store_words(level + idx * PT_WORDS, &acc[0]);
      const long group = idx / nq, groups = (count + nq - 1) / nq;
      const int size = (int)std::min<long>(nq, count - group * nq);
      if (tk[group]++ != (unsigned)(size - 1)) {
        total = false;
        break;
      }
      for (int q = 0; q < nq; ++q) {
        cpzk::ladder_group_load(&acc[(long)q * 4], level, group * nq, size, q);
        cpzk::pt_store_words(s.data() + (long)q * PT_WORDS, &acc[(long)q * 4]);
      }
      for (int h = cpzk::msm_tree_top(size) >> 1; h >= 1; h >>= 1) {
        for (int q = 0; q < nq; ++q)
          cpzk::msm_tree_level(&acc[(long)q * 4], s.data(), q, h, size, kQuad);
      }
      level += count * PT_WORDS;
      tk += groups;
      idx = group;
      count = groups;
    }
    if (total) cpzk::ladder_finish(out, 1, ok, &acc[0]);
  }
}

// ladder_partials_identity_kernel's block over k totals ([20, k] x 4 in
// pts) -> ok: every quad's columns, the levels across warps in shared
// memory, then warp 0's levels with each quad's partner as the shuffle
// gives it (its own point past the warp), in the kernel's order.
void host_ladder_partials_identity(const int32_t* const* pts, uint8_t* ok, int k) {
  const int nq = cpzk::ladder_partials_quads(k);
  const int quads = cpzk::ladder_partials_threads(k) / 4, warp = cpzk::LADDER_WARP_QUADS;
  std::vector<uint32_t> s((long)quads * PT_WORDS);
  std::vector<Fe> acc((long)quads * 4);
  const cpzk::LadderPt pt = ladder_pt(pts, 0, k, 1);
  for (int q = 0; q < quads; ++q)
    cpzk::ladder_partials_load(&acc[(long)q * 4], pt, k, q, nq, kQuad);
  int h = cpzk::msm_tree_top(nq) >> 1;
  if (h >= warp) {
    for (int q = 0; q < quads; ++q)
      cpzk::pt_store_words(s.data() + (long)q * PT_WORDS, &acc[(long)q * 4]);
    for (; h >= warp; h >>= 1) {
      for (int q = 0; q < quads; ++q)
        cpzk::msm_tree_level(&acc[(long)q * 4], s.data(), q, h, nq, kQuad);
    }
  }
  for (; h >= 1; h >>= 1) {
    for (int q = 0; q < warp; ++q) {
      Fe y[4];
      cpzk::pt_copy(y, &acc[(long)(q + h < warp ? q + h : q) * 4]);
      cpzk::ladder_partials_level(&acc[(long)q * 4], y, q, h, nq, kQuad);
    }
  }
  *ok = (uint8_t)cpzk::ladder_is_identity(&acc[0]);
}

// ladder_each_kernel over every block of `threads` threads (a multiple of
// 8: two quads a lane) and both phases, in its order: g, h, y1, y2, r1, r2
// in pts (steps[k] 0: a shared [20, 1] point; g and h both shared: their
// tables once a block), windows [2, 64, n] (s, c) -> one byte a lane.
void host_ladder_each(const int32_t* const* pts, const int32_t* steps, const int32_t* w,
                      uint8_t* out, int n, int threads) {
  const bool shared = steps[0] == 0 && steps[1] == 0;
  const long words = shared ? cpzk::LADDER_EACH_SHARED_WORDS : cpzk::LADDER_EACH_WORDS;
  const int lanes = threads / 8;
  const long blocks = (8L * n + threads - 1) / threads;
  std::vector<uint32_t> tables((long)n * words), gh(2L * cpzk::LADDER_TABLE_WORDS);
  cpzk::LadderPt pt[6];
  for (int k = 0; k < 6; ++k) pt[k] = ladder_pt(pts, k, n, steps[k]);
  const cpzk::LadderWin win[2] = {ladder_win(w, 0, n), ladder_win(w, 1, n)};
  for (long b = 0; b < blocks; ++b) {
    for (int l = 0; l < lanes; ++l) {
      const long j = b * lanes + l;
      if (j >= n) continue;
      for (int e = 0; e < 2; ++e)
        cpzk::ladder_each_tables(tables.data() + j * words, gh.data(), pt, j, l, e, shared,
                                 kQuad);
    }
    for (int l = 0; l < lanes; ++l) {
      const long j = b * lanes + l;
      if (j >= n) continue;
      uint32_t bit = 1;
      for (int e = 0; e < 2; ++e)
        bit &= cpzk::ladder_each_quad(tables.data() + j * words, gh.data(), pt, win, j, e,
                                      shared, kQuad);
      out[j] = (uint8_t)bit;
    }
  }
}

}  // extern "C"
