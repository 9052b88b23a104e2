// GF(2^255 - 19) and edwards25519 point arithmetic for one lane, in
// registers.  Host and device code: the CUDA kernels in point_ops.cu call
// these functions per thread, and the tests compile this header with a
// host C++ compiler (through host_shim.cpp) to hold it against the plain
// PyTorch version in cpzk_tpu_torch/ops/limbs.py.
//
// Representation and carry schedule are exactly those of ops/limbs.py:
// 20 signed int32 limbs in radix 2^13, value = sum(limb[i] * 2^(13 i)),
// the carry out of limb 19 (weight 2^260) re-entering limb 0 times
// 608 = 2^260 mod p.  Every function returns limbs in the loose bound
// |limb| <= 9500 given inputs in that bound, so outputs are bit-identical
// to the plain version's.
//
// Overflow: with |limb| <= 9500 a schoolbook product limb is a sum of at
// most 20 terms of magnitude <= 9500^2, i.e. <= 1.81e9 < 2^31, so every
// accumulator fits int32 (signed overflow would be undefined behaviour;
// the bound keeps it from occurring).  Right shifts of negative limbs are
// arithmetic on every compiler this is built with (nvcc, g++); no left
// shift of a negative value appears.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FE_FN __host__ __device__ __forceinline__
#else
#define FE_FN static inline
#endif

namespace cpzk {

constexpr int NL = 20;
constexpr int LIMB_BITS = 13;
constexpr int32_t LIMB_MASK = (1 << LIMB_BITS) - 1;
constexpr int32_t TOP_FOLD = 608;  // 2^260 mod p = 19 * 2^5

// 2d mod p in the same limbs as ops/limbs.py's D2 constant
#define CPZK_D2_LIMBS                                                  \
  {4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20,   7,            \
   5196, 7655, 3886, 1856, 7270, 8092, 5855, 3810, 438,  72}

// One carry-save round with modular wrap (limbs._wrap_round), in place.
FE_FN void wrap_round(int32_t x[NL]) {
  int32_t hi[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    hi[i] = x[i] >> LIMB_BITS;
    x[i] &= LIMB_MASK;
  }
  x[0] += hi[NL - 1] * TOP_FOLD;
#pragma unroll
  for (int i = 1; i < NL; ++i) x[i] += hi[i - 1];
}

// limbs.carry20: four wrap rounds.
FE_FN void carry20(int32_t x[NL]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) wrap_round(x);
}

// limbs.carry_product: reduce a 39-limb schoolbook product to loose form.
FE_FN void carry_product(int32_t out[NL], const int32_t prod[2 * NL - 1]) {
  int32_t x[42];
#pragma unroll
  for (int i = 0; i < 2 * NL - 1; ++i) x[i] = prod[i];
  x[39] = 0;
  x[40] = 0;
  x[41] = 0;
  // three widening rounds, truncated to 42 limbs (limbs._round_widen)
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int32_t carry = 0;
#pragma unroll
    for (int i = 0; i < 42; ++i) {
      const int32_t h = x[i] >> LIMB_BITS;
      x[i] = (x[i] & LIMB_MASK) + carry;
      carry = h;
    }
  }
  // fold the 42 limbs as c0 + 608 * (c1 + 608 * c2)
  int32_t t[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = x[NL + i];
  t[0] += x[40] * TOP_FOLD;
  t[1] += x[41] * TOP_FOLD;
  wrap_round(t);
  wrap_round(t);
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = x[i] + t[i] * TOP_FOLD;
  carry20(out);
}

FE_FN void fe_mul(int32_t out[NL], const int32_t a[NL], const int32_t b[NL]) {
  int32_t prod[2 * NL - 1];
#pragma unroll
  for (int k = 0; k < 2 * NL - 1; ++k) prod[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) prod[i + j] += a[i] * b[j];
  }
  carry_product(out, prod);
}

FE_FN void fe_sq(int32_t out[NL], const int32_t a[NL]) { fe_mul(out, a, a); }

FE_FN void fe_add(int32_t out[NL], const int32_t a[NL], const int32_t b[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i] + b[i];
  wrap_round(out);
}

FE_FN void fe_sub(int32_t out[NL], const int32_t a[NL], const int32_t b[NL]) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i] - b[i];
  wrap_round(out);
}

// limbs.mul_small for |k| <= 400.
FE_FN void fe_mul_small(int32_t out[NL], const int32_t a[NL], int32_t k) {
#pragma unroll
  for (int i = 0; i < NL; ++i) out[i] = a[i] * k;
  carry20(out);
}

// Unified a=-1 extended addition (add-2008-hwcd-3), the arithmetic of
// cpzk_tpu/ops/pallas_kernels.py::_add_kernel operation for operation.
// Outputs may not alias inputs.
FE_FN void point_add(int32_t X3[NL], int32_t Y3[NL], int32_t Z3[NL],
                     int32_t T3[NL], const int32_t X1[NL],
                     const int32_t Y1[NL], const int32_t Z1[NL],
                     const int32_t T1[NL], const int32_t X2[NL],
                     const int32_t Y2[NL], const int32_t Z2[NL],
                     const int32_t T2[NL]) {
  const int32_t d2[NL] = CPZK_D2_LIMBS;
  int32_t u[NL], v[NL], A[NL], B[NL], C[NL], Dv[NL];
  fe_sub(u, Y1, X1);
  fe_sub(v, Y2, X2);
  fe_mul(A, u, v);
  fe_add(u, Y1, X1);
  fe_add(v, Y2, X2);
  fe_mul(B, u, v);
  fe_mul(u, T1, d2);
  fe_mul(C, u, T2);
  fe_mul(u, Z1, Z2);
  fe_mul_small(Dv, u, 2);
  int32_t E[NL], F[NL], G[NL], H[NL];
  fe_sub(E, B, A);
  fe_sub(F, Dv, C);
  fe_add(G, Dv, C);
  fe_add(H, B, A);
  fe_mul(X3, E, F);
  fe_mul(Y3, G, H);
  fe_mul(Z3, F, G);
  fe_mul(T3, E, H);
}

// k >= 1 fused a=-1 doublings (dbl-2008-hwcd) in place, the arithmetic of
// cpzk_tpu/ops/pallas_kernels.py::_double_k_kernel: only X, Y, Z pass
// between rounds; T comes from the last round.
FE_FN void point_double_k(int32_t X[NL], int32_t Y[NL], int32_t Z[NL],
                          int32_t T[NL], int k) {
  int32_t A[NL], B[NL], C[NL], E[NL], F[NL], G[NL], H[NL], t[NL];
  for (int r = 0; r < k; ++r) {
    fe_sq(A, X);
    fe_sq(B, Y);
    fe_sq(t, Z);
    fe_mul_small(C, t, 2);
    fe_add(H, A, B);
    fe_add(t, X, Y);
    fe_sq(t, t);
    fe_sub(E, H, t);
    fe_sub(G, A, B);
    fe_add(F, C, G);
    fe_mul(X, E, F);
    fe_mul(Y, G, H);
    fe_mul(Z, F, G);
  }
  fe_mul(T, E, H);
}

}  // namespace cpzk
