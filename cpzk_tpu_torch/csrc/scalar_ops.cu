// The scalar kernels of the combined check's device scalar plane and of the
// device challenge reduction, for Hopper (sm_90a), with a plain C launch
// interface loaded through ctypes by cpzk_tpu_torch/ops/scalar_kernels.py.
//
//   rlc_scalars_kernel    replaces the products and the corrections of
//                         cpzk_tpu/ops/backend.py::_rlc_products and
//                         ::_rlc_scalar_groups (on cpzk_tpu/ops/sclimbs.py
//                         mul, sum_mod_l and neg)
//   scalar_recode_kernel  replaces the splice or the term concatenation and
//                         the recode of ::_rlc_products (sclimbs.to_windows)
//                         and ::_pippenger_digits_device / _signed_digits_jit
//                         (sclimbs.to_signed_digits)
//   reduce_wide_kernel    replaces cpzk_tpu/ops/sclimbs.py::reduce_wide on
//                         the 64-byte challenges (40 limbs in, 20 out)
//
// Layout: scalars are limb-major [20, pad] int32 arrays of canonical 13-bit
// limbs, limb i of lane j at i * pad + j; windows are [64, pad] (MSB first),
// digits [nwin, m] (LSB first).  One thread owns one lane, so a warp's load
// of one limb is 32 consecutive words; the arithmetic is sc25519_w32.cuh.
//
// What bounds them: rlc_scalars moves 6 x 80 bytes a row (three scalars in,
// three products out) and needs about 1.9k int32 operations a row (four
// products mod l; ops/scalar_kernels.py counts them), so it is bound by
// operations at the main path's widths, and in practice by the latency of
// one thread's four dependent Barrett products.  The sum of a s over all
// rows is exact in any order (addition mod l), so it is reduced per block in
// shared memory and then by the last block to finish (an atomic ticket), in
// one launch.  reduce_wide moves 160 + 80 bytes a lane and needs about 300
// int32 operations (one Barrett reduction), so it is bound by bytes.
// scalar_recode moves 80 bytes in and 256 (windows) or 4 nwin
// (digits) out a lane and does a few shifts per output word: bound by bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sc25519_w32.cuh"

namespace {

using cpzk::NL;
using cpzk::NW;
using cpzk::Sc;

constexpr int kRlcThreads = 128;
constexpr int kRecodeThreads = 256;
constexpr int kReduceThreads = 128;

__device__ __forceinline__ void load_sc(Sc& out, const int32_t* __restrict__ src,
                                        long stride, long j) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = src[(long)i * stride + j];
  cpzk::sc_from_limbs(out, l);
}

__device__ __forceinline__ void store_sc(int32_t* __restrict__ dst, const Sc& v,
                                         long stride, long j) {
  int32_t l[NL];
  cpzk::sc_to_limbs(l, v);
#pragma unroll
  for (int i = 0; i < NL; ++i) dst[(long)i * stride + j] = l[i];
}

// Sum mod l of the block's sh[0 .. blockDim.x) into sh[0].
__device__ void block_sum(Sc* sh) {
  for (int span = blockDim.x / 2; span > 0; span >>= 1) {
    __syncthreads();
    if ((int)threadIdx.x < span) cpzk::sc_add(sh[threadIdx.x], sh[threadIdx.x], sh[threadIdx.x + span]);
  }
  __syncthreads();
}

// Per lane j < n: ac = a c, ba = b a, bac = b a c (mod l); and over all
// lanes S = sum a s, then corr0 = -S and corr1 = -b S.  partials holds one
// 8-word sum per block, ticket starts at 0.
__global__ void __launch_bounds__(kRlcThreads)
rlc_scalars_kernel(const int32_t* __restrict__ al, const int32_t* __restrict__ cl,
                   const int32_t* __restrict__ sl, const int32_t* __restrict__ bl,
                   int32_t* __restrict__ ac, int32_t* __restrict__ ba,
                   int32_t* __restrict__ bac, uint32_t* partials,
                   unsigned int* ticket, int32_t* __restrict__ corr0,
                   int32_t* __restrict__ corr1, int n) {
  __shared__ Sc sh[kRlcThreads];
  __shared__ bool last;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  Sc b;
  load_sc(b, bl, 1, 0);
  Sc as;
  if (j < n) {
    Sc a, c, s, t;
    load_sc(a, al, n, j);
    load_sc(c, cl, n, j);
    load_sc(s, sl, n, j);
    cpzk::sc_mul(t, a, c);
    store_sc(ac, t, n, j);
    cpzk::sc_mul(t, b, t);
    store_sc(bac, t, n, j);
    cpzk::sc_mul(t, b, a);
    store_sc(ba, t, n, j);
    cpzk::sc_mul(as, a, s);
  } else {
    cpzk::sc_zero(as);
  }
  sh[threadIdx.x] = as;
  block_sum(sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) partials[(long)blockIdx.x * NW + i] = sh[0].w[i];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's partial is visible (each fenced before
  // its ticket); read them past L1
  Sc acc;
  cpzk::sc_zero(acc);
  for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) {
    Sc p;
#pragma unroll
    for (int i = 0; i < NW; ++i) p.w[i] = __ldcg(&partials[(long)k * NW + i]);
    cpzk::sc_add(acc, acc, p);
  }
  sh[threadIdx.x] = acc;
  block_sum(sh);
  if (threadIdx.x == 0) {
    Sc s = sh[0], r;
    cpzk::sc_neg(r, s);
    store_sc(corr0, r, 1, 0);
    cpzk::sc_mul(r, b, s);
    cpzk::sc_neg(r, r);
    store_sc(corr1, r, 1, 0);
  }
}

// mode 0 (windows): thread t = g pad + j of 4 pad writes the 64 windows of
// group g's lane j into out[g][64][pad], where lane n holds corr0 (g = 0),
// corr1 (g = 1) or 0 (g = 2, 3) instead of the group's own scalar.
// mode 1 (digits): thread t < m writes the nwin digits of term t into
// out[nwin][m], terms ordered g0[0..n) | g1 | g2 | g3 | corr0 | corr1 | 0.
__global__ void __launch_bounds__(kRecodeThreads)
scalar_recode_kernel(const int32_t* __restrict__ g0, const int32_t* __restrict__ g1,
                     const int32_t* __restrict__ g2, const int32_t* __restrict__ g3,
                     const int32_t* __restrict__ corr0, const int32_t* __restrict__ corr1,
                     int n, int pad, int mode, int c, int nwin, int m,
                     int32_t* __restrict__ out) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t* groups[4] = {g0, g1, g2, g3};
  Sc v;
  if (mode == 0) {
    if (t >= 4L * pad) return;
    const int g = (int)(t / pad), j = (int)(t % pad);
    if (j != n) {
      load_sc(v, groups[g], pad, j);
    } else if (g < 2) {
      load_sc(v, g == 0 ? corr0 : corr1, 1, 0);
    } else {
      cpzk::sc_zero(v);
    }
    cpzk::sc_windows4(out + (long)g * 64 * pad + j, pad, v);
    return;
  }
  if (t >= m) return;
  if (t < 4L * n) {
    load_sc(v, groups[t / n], pad, t % n);
  } else if (t == 4L * n) {
    load_sc(v, corr0, 1, 0);
  } else if (t == 4L * n + 1) {
    load_sc(v, corr1, 1, 0);
  } else {
    cpzk::sc_zero(v);
  }
  cpzk::sc_signed_digits(out + t, m, v, c, nwin);
}

// Lane j < n: the W <= 40 canonical 13-bit limbs of x (limb i at i n + j,
// a value below 2^512) reduced mod l into out's 20 limbs.
__global__ void __launch_bounds__(kReduceThreads)
reduce_wide_kernel(const int32_t* __restrict__ x, int rows, int32_t* __restrict__ out,
                   int n) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int32_t l[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) l[i] = i < rows ? x[(long)i * n + j] : 0;
  uint32_t w[2 * NW];
  cpzk::sc_wide_from_limbs(w, l);
  Sc r;
  cpzk::sc_reduce_wide(r, w);
  store_sc(out, r, n, j);
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
// partials: ceil(n / 128) x 8 words of scratch; ticket: one zeroed word.
extern "C" int cpzk_rlc_scalars(const void* al, const void* cl, const void* sl,
                                const void* bl, void* ac, void* ba, void* bac,
                                void* partials, void* ticket, void* corr0,
                                void* corr1, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kRlcThreads - 1) / kRlcThreads;
  rlc_scalars_kernel<<<blocks, kRlcThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)al, (const int32_t*)cl, (const int32_t*)sl,
      (const int32_t*)bl, (int32_t*)ac, (int32_t*)ba, (int32_t*)bac,
      (uint32_t*)partials, (unsigned int*)ticket, (int32_t*)corr0,
      (int32_t*)corr1, n);
  return (int)cudaGetLastError();
}

extern "C" int cpzk_rlc_scalars_blocks(int n) {
  return (n + kRlcThreads - 1) / kRlcThreads;
}

extern "C" int cpzk_scalar_recode(const void* g0, const void* g1, const void* g2,
                                  const void* g3, const void* corr0,
                                  const void* corr1, int n, int pad, int mode,
                                  int c, int nwin, int m, void* out, void* stream) {
  if (mode < 0 || mode > 1 || (mode == 0 && (n < 0 || pad <= n)) ||
      (mode == 1 && (n < 1 || pad < n || m < 4L * n + 2 || c < 4 || c > 16 ||
                     nwin * c < 256)))
    return (int)cudaErrorInvalidValue;
  const long threads = mode == 0 ? 4L * pad : (long)m;
  const long blocks = (threads + kRecodeThreads - 1) / kRecodeThreads;
  scalar_recode_kernel<<<(unsigned)blocks, kRecodeThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)g0, (const int32_t*)g1, (const int32_t*)g2, (const int32_t*)g3,
      (const int32_t*)corr0, (const int32_t*)corr1, n, pad, mode, c, nwin, m,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int cpzk_reduce_wide(const void* x, int rows, void* out, int n, void* stream) {
  if (n < 1 || rows < 1 || rows > 2 * NL) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kReduceThreads - 1) / kReduceThreads;
  reduce_wide_kernel<<<blocks, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, rows, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
