// Test-only host build of fe25519_w32.cuh: a C interface over limb-major
// [20, n] int32 arrays, looping over lanes on the CPU, so the tests can hold
// the kernels' field and point arithmetic against the plain PyTorch version
// with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC host_shim.cpp -o libfe25519_host.so
//
// Every entry converts its inputs from limbs to words and its outputs back,
// as the kernels do.  Nothing outside tests/test_torch_kernel_host.py loads
// this library.
#include <stdint.h>

#include "fe25519_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::NL;
using cpzk::NW;

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
// 5 the conversion round trip (b unused)
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

}  // extern "C"
