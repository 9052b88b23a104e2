// The thread bodies of the batch prover's two kernels (prove_ops.cu) on the
// words of fe25519_w32.cuh: building one window of a fixed-base comb table,
// and one window step of the fixed-base walk.  Host and device code: the
// tests compile this header with a host C++ compiler (through
// host_shim.cpp) to hold the bodies against the plain PyTorch versions in
// cpzk_tpu_torch/ops/prove_kernels.py.
//
// Table layout (the kernels' own): window w, entry j, coordinate c
// (X, Y, Z, T), word i at ((w * 16 + j) * 4 + c) * 8 + i, as uint32 words of
// a value below 2^256 (not reduced below p).  Entry j of window w is
// j 16^w P; entry 0 is the identity.  One window is 512 words (2 KiB), one
// table 64 windows (128 KiB).
#pragma once

#include <stdint.h>

#include "fe25519_w32.cuh"

namespace cpzk {

constexpr int COMB_WINDOWS = 64;
constexpr int COMB_ENTRIES = 16;
constexpr int COMB_ENTRY_WORDS = 4 * NW;
constexpr int COMB_WINDOW_WORDS = COMB_ENTRIES * COMB_ENTRY_WORDS;

FE_FN void pt_set_identity(Fe p[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < NW; ++i) p[c].w[i] = 0;
  }
  p[1].w[0] = 1;
  p[2].w[0] = 1;
}

FE_FN void comb_store_entry(uint32_t* window, int j, const Fe e[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < NW; ++i) window[(j * 4 + c) * NW + i] = e[c].w[i];
  }
}

// Window w of P's table: base = 16^w P by 4 w doublings (point_double_k,
// T from the last round, as the reference's four doublings a window give
// it), then entry j = entry j - 1 + base, in the order of
// cpzk_tpu/ops/curve.py::build_table.
FE_FN void comb_window(uint32_t* window, const Fe p[4], int w) {
  Fe base[4], e[4], next[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) base[c] = p[c];
  if (w > 0) point_double_k(base, 4 * w);
  pt_set_identity(e);
  comb_store_entry(window, 0, e);
  comb_store_entry(window, 1, base);
#pragma unroll
  for (int c = 0; c < 4; ++c) e[c] = base[c];
  for (int j = 2; j < COMB_ENTRIES; ++j) {
    point_add(next, e, base);
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = next[c];
    comb_store_entry(window, j, e);
  }
}

// out = window[digit] in constant time: every entry is read, and the one
// whose index equals the digit is kept by a mask (no address depends on
// the digit, which is a secret nibble of k or x).
FE_FN void comb_select(Fe out[4], const uint32_t* window, uint32_t digit) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < NW; ++i) out[c].w[i] = 0;
  }
  for (int j = 0; j < COMB_ENTRIES; ++j) {
    const uint32_t m = 0u - (uint32_t)(((uint64_t)((uint32_t)j ^ digit) - 1u) >> 63);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int i = 0; i < NW; ++i) out[c].w[i] |= window[(j * 4 + c) * NW + i] & m;
    }
  }
}

// acc += window[digit], the step of cpzk_tpu/ops/prove.py::_fixed_base_kernel.
FE_FN void comb_step(Fe acc[4], const uint32_t* window, uint32_t digit) {
  Fe e[4], sum[4];
  comb_select(e, window, digit);
  point_add(sum, acc, e);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = sum[c];
}

}  // namespace cpzk
