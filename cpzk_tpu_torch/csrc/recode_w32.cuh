// The scalar recode of the combined check's device scalar plane: a thread's
// whole body, written for an H100 thread.  Host and device code:
// scalar_ops.cu's scalar_recode_kernel runs recode_thread per thread, and
// the tests compile this header with a host C++ compiler (through
// host_shim.cpp), which runs it for every thread of a call, to hold it
// against the plain PyTorch versions (rlc_windows_plain, rlc_digits_plain in
// ops/scalar_kernels.py).
//
// It replaces the splice (or the term concatenation) and the recode of
// cpzk_tpu/ops/backend.py::_rlc_products (sclimbs.to_windows) and
// ::_pippenger_digits_device / ::_signed_digits_jit
// (sclimbs.to_signed_digits).  The layouts are the reference's: scalars
// [20, pad] canonical 13-bit limbs (limb i of lane j at i pad + j),
// windows [4, 64, pad] (MSB window first), digits [nwin, m] (LSB first).
// The recode moves ~80 bytes in and 256 (windows) or 4 nwin (digits) out a
// lane for a few shifts a word: bound by bytes, and at the paths' widths
// (some 18k to 74k lanes) within a few microseconds of its launch.  What a
// call takes past the launch is one thread's chain (its loads' round trip,
// its conversion, its windows or its digit carries) and the stores' drain,
// so the design keeps that chain short:
//
// * one lane a thread (four or two neighbouring lanes a thread, every load
//   and store a 16- or 8-byte access, made each thread's chain longer and
//   were slower at every shape on the H100: PERF.md);
// * a thread finds its scalar's place with one 32-bit division (the
//   earlier kernel took a 64-bit division and a modulo, and picked the
//   group from a stack array) and its source by selects: a group's lane,
//   a correction, or zero;
// * the windows are 64 shifts and stores, unrolled; the signed digits a
//   loop over the windows at the run-time window size, a window's two words
//   read from a per-thread copy of the scalar in shared memory, the loop
//   left to the compiler's unrolling so the reads of later windows overlap
//   the carry chain (streamed through registers in a rolled loop the chain
//   was slower; a version unrolled for each window size, 35k instructions,
//   was 1.8x slower: each thread runs the body once, so its instructions
//   are fetched cold).
#pragma once

#include <stdint.h>

#include "sc25519_w32.cuh"

namespace cpzk {

// One call's operands: the four [20, pad] groups (a, a c, b a, b a c), the
// [20, 1] corrections, and the output: mode 0 windows [4, 64, pad] with
// lane n of groups 0, 1 replaced by corr0, corr1 and of groups 2, 3 by 0;
// mode 1 digits [nwin, m] of the terms g0[0, n) | g1 | g2 | g3 | corr0 |
// corr1 | 0 ... (c-bit signed digits).
struct RecodeArgs {
  const int32_t* g0;
  const int32_t* g1;
  const int32_t* g2;
  const int32_t* g3;
  const int32_t* corr0;
  const int32_t* corr1;
  int n, pad, m;
  int mode, c, nwin;
  int32_t* out;
};

// Threads of a call: one a window lane (4 pad) or a term (m).
FE_FN int recode_threads(const RecodeArgs& a) { return a.mode == 0 ? 4 * a.pad : a.m; }

// Group g's pointer, by selects.
FE_FN const int32_t* recode_group(const RecodeArgs& a, int g) {
  return g == 0 ? a.g0 : g == 1 ? a.g1 : g == 2 ? a.g2 : a.g3;
}

// The scalar whose limb i is src[i stride] (0 for a null src), as words;
// on the card read through the non-coherent cache.
FE_FN void recode_load(Sc& out, const int32_t* src, long stride) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#if defined(__CUDA_ARCH__)
    l[i] = src ? __ldg(src + i * stride) : 0;
#else
    l[i] = src ? src[i * stride] : 0;
#endif
  }
  sc_from_limbs(out, l);
}

// The 64 4-bit windows of a, most significant first: window 63 - i (bits
// 4 i .. 4 i + 3) into out[(63 - i) stride].
FE_FN void recode_windows(int32_t* out, long stride, const Sc& a) {
#pragma unroll
  for (int i = 0; i < 64; ++i)
    out[(long)(63 - i) * stride] = (int32_t)((a.w[i >> 3] >> (4 * (i & 7))) & 15u);
}

// The signed c-bit digits (4 <= c <= 16) of a (below 2^256), least
// significant window first, into out[k stride] for k < nwin: the window
// plus the carry, less 2^c (and a carry of 1 into the next) when that
// reaches 2^(c-1); windows past bit 256 are the last carry, then 0.  A
// window's two words are read at a run-time index from the thread's copy
// of the words, w[i ws] (on the card a column of the block's shared
// memory: kept in registers, even declared volatile, nvcc picked each word
// by a chain of selects, 2.5x the parent's loop).
FE_FN void recode_digits(int32_t* out, long stride, int c, int nwin, const Sc& a,
                         uint32_t* w, int ws) {
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i * ws] = a.w[i];
  const int half = 1 << (c - 1);
  int carry = 0;
  for (int k = 0; k < nwin; ++k) {
    const int bit = c * k, wd = bit >> 5, sh = bit & 31;
    uint64_t v = 0;
    if (wd < NW) v = w[wd * ws];
    if (wd + 1 < NW) v |= (uint64_t)w[(wd + 1) * ws] << 32;
    const int t = (int)((v >> sh) & ((1u << c) - 1u)) + carry;
    carry = t >= half;
    out[(long)k * stride] = t - (carry << c);
  }
}

// Thread t's whole body.  Mode 0: group g = t / pad, lane j, lane n the
// correction (groups 0, 1) or 0 (groups 2, 3).  Mode 1: term t, lane
// t mod n of group t / n for t < 4 n, then corr0, corr1, zeros; w, ws the
// thread's scratch for the digits' words (recode_digits).
FE_FN void recode_thread(const RecodeArgs& a, int t, uint32_t* w, int ws) {
  Sc v;
  if (a.mode == 0) {
    const int g = t / a.pad, j = t - g * a.pad;
    const bool splice = j == a.n;
    const int32_t* src = !splice ? recode_group(a, g) + j
                         : g == 0 ? a.corr0
                         : g == 1 ? a.corr1
                                  : nullptr;
    recode_load(v, src, splice ? 1 : a.pad);
    recode_windows(a.out + (long)g * 64 * a.pad + j, a.pad, v);
    return;
  }
  const int g = t / a.n;
  const int32_t* src = g < 4 ? recode_group(a, g) + (t - g * a.n)
                       : t == 4 * a.n ? a.corr0
                       : t == 4 * a.n + 1 ? a.corr1
                                          : nullptr;
  recode_load(v, src, g < 4 ? a.pad : 1);
  recode_digits(a.out + t, a.m, a.c, a.nwin, v, w, ws);
}

}  // namespace cpzk
