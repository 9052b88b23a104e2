// Test-only host build of fe25519.cuh: a C interface over limb-major
// [20, n] int32 arrays, looping over lanes on the CPU, so the tests can hold
// the kernels' field and point arithmetic against the plain PyTorch version
// with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC host_shim.cpp -o libfe25519_host.so
//
// Nothing outside tests/test_torch_kernel_host.py loads this library.
#include <stdint.h>

#include "fe25519.cuh"

namespace {

using cpzk::NL;

void load_fe(int32_t out[NL], const int32_t* src, int n, int j) {
  for (int i = 0; i < NL; ++i) out[i] = src[(long)i * n + j];
}

void store_fe(int32_t* dst, const int32_t v[NL], int n, int j) {
  for (int i = 0; i < NL; ++i) dst[(long)i * n + j] = v[i];
}

}  // namespace

extern "C" {

void host_d2(int32_t* out) {
  const int32_t d2[NL] = CPZK_D2_LIMBS;
  for (int i = 0; i < NL; ++i) out[i] = d2[i];
}

// op: 0 mul, 1 add, 2 sub, 3 mul_small(a, k) (b unused)
void host_fe_op(int op, const int32_t* a, const int32_t* b, int32_t* out,
                int n, int k) {
  for (int j = 0; j < n; ++j) {
    int32_t x[NL], y[NL], z[NL];
    load_fe(x, a, n, j);
    if (op != 3) load_fe(y, b, n, j);
    switch (op) {
      case 0: cpzk::fe_mul(z, x, y); break;
      case 1: cpzk::fe_add(z, x, y); break;
      case 2: cpzk::fe_sub(z, x, y); break;
      default: cpzk::fe_mul_small(z, x, k); break;
    }
    store_fe(out, z, n, j);
  }
}

void host_point_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                    const int32_t* t1, const int32_t* x2, const int32_t* y2,
                    const int32_t* z2, const int32_t* t2, int32_t* ox,
                    int32_t* oy, int32_t* oz, int32_t* ot, int n) {
  for (int j = 0; j < n; ++j) {
    int32_t X1[NL], Y1[NL], Z1[NL], T1[NL], X2[NL], Y2[NL], Z2[NL], T2[NL];
    load_fe(X1, x1, n, j);
    load_fe(Y1, y1, n, j);
    load_fe(Z1, z1, n, j);
    load_fe(T1, t1, n, j);
    load_fe(X2, x2, n, j);
    load_fe(Y2, y2, n, j);
    load_fe(Z2, z2, n, j);
    load_fe(T2, t2, n, j);
    int32_t X3[NL], Y3[NL], Z3[NL], T3[NL];
    cpzk::point_add(X3, Y3, Z3, T3, X1, Y1, Z1, T1, X2, Y2, Z2, T2);
    store_fe(ox, X3, n, j);
    store_fe(oy, Y3, n, j);
    store_fe(oz, Z3, n, j);
    store_fe(ot, T3, n, j);
  }
}

void host_point_double_k(const int32_t* x, const int32_t* y, const int32_t* z,
                         int32_t* ox, int32_t* oy, int32_t* oz, int32_t* ot,
                         int n, int k) {
  for (int j = 0; j < n; ++j) {
    int32_t X[NL], Y[NL], Z[NL], T[NL];
    load_fe(X, x, n, j);
    load_fe(Y, y, n, j);
    load_fe(Z, z, n, j);
    cpzk::point_double_k(X, Y, Z, T, k);
    store_fe(ox, X, n, j);
    store_fe(oy, Y, n, j);
    store_fe(oz, Z, n, j);
    store_fe(ot, T, n, j);
  }
}

}  // extern "C"
