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
// digits [nwin, m] (LSB first).  One thread owns one lane (two a row in
// rlc_scalars), so a warp's load of one limb is consecutive words; the
// arithmetic is sc25519_w32.cuh (a product reduced mod l by three folds
// at bit 252).
//
// What bounds them: rlc_scalars moves 6 x 80 bytes a row (three scalars in,
// three products out) and needs about 1.5k int32 operations a row (four
// products mod l and a 9-word add; ops/scalar_kernels.py counts them), so
// it is bound by bytes, under a microsecond at the main path's widths; what
// it takes is the launch and a chain: a row's products, the sum over the
// rows, one last block's reduction and two more products.  Its design
// shortens that chain: two threads a row, each two products on operands
// picked by its part (no divergence); the sum of a s as plain 9-word
// integers (exact, reduced once at the end by sc_reduce_wide, sc25519_w32.cuh),
// by five warp shuffles and one pass over the block's warps in shared
// memory; each block's partial fenced before an atomic ticket, and the
// last block to take one sums the partials the same way, resets the ticket
// (so the wrapper zeroes it once a stream, not once a call) and finishes
// in the same launch.  reduce_wide moves 160 + 80 bytes a lane and needs
// about 230 int32 operations (three folds at bit 252), so it is bound by
// bytes; what it takes is the launch, one round trip to memory for a
// lane's 40 limbs (all loaded before any arithmetic) and one lane's chain
// of 60 word products.
// scalar_recode moves 80 bytes in and 256 (windows) or 4 nwin (digits) out
// a lane and does a few shifts per output word: bound by bytes, and at the
// paths' widths within microseconds of its launch's cost; what it takes
// past that is one thread's chain and the stores' drain.  Its design
// (recode_w32.cuh): one lane a thread with a short chain (one 32-bit
// division for its place where a 64-bit division and modulo were, its
// source by selects where a stack array was, the digit loop's word reads
// overlapping its carry chain), and blocks sized so that every SM gets one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "recode_w32.cuh"
#include "sc25519_w32.cuh"

extern "C" int cpzk_sm_count();  // point_ops.cu

namespace {

using cpzk::NL;
using cpzk::Sc;

constexpr int kRlcThreads = cpzk::RLC_THREADS;
constexpr int kRlcWarps = kRlcThreads / 32;
constexpr int kRecodeThreads = 256;
constexpr int kReduceThreads = 128;

using cpzk::RLC_SUM_WORDS;

__device__ __forceinline__ void load_sc(Sc& out, const int32_t* __restrict__ src,
                                        long stride, long j) {
  int32_t l[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) l[i] = src[(long)i * stride + j];
  cpzk::sc_from_limbs(out, l);
}

// x summed over the lanes from lane `from` down, by shuffle levels of half
// from / 2 .. 1, into lane 0 (the lanes' 9-word sums; cpzk::sc9_add).
__device__ __forceinline__ void warp_sum9(uint32_t x[RLC_SUM_WORDS], int from) {
#pragma unroll
  for (int off = from / 2; off >= 1; off >>= 1) {
    uint32_t y[RLC_SUM_WORDS];
#pragma unroll
    for (int i = 0; i < RLC_SUM_WORDS; ++i) y[i] = __shfl_down_sync(~0u, x[i], off);
    cpzk::sc9_add(x, y);
  }
}

// The block's sum of every thread's x into thread 0's: each warp's by five
// shuffle levels, then warp 0 over the warps' sums through shared memory
// (one barrier).
__device__ __forceinline__ void block_sum9(uint32_t x[RLC_SUM_WORDS],
                                           uint32_t (*sh)[RLC_SUM_WORDS]) {
  warp_sum9(x, 32);
  if (kRlcWarps == 1) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RLC_SUM_WORDS; ++i) sh[warp][i] = x[i];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < RLC_SUM_WORDS; ++i) x[i] = lane < kRlcWarps ? sh[lane][i] : 0u;
  warp_sum9(x, kRlcWarps);
}

// Per row j < rows.n: a c, b a, b a c (mod l), two threads a row; and
// over all rows S = sum a s, then corr0 = -S and corr1 = -b S.
// partials holds one 9-word sum a block, ticket starts at 0.
__global__ void __launch_bounds__(kRlcThreads)
rlc_scalars_kernel(cpzk::RlcRows rows, const int32_t* __restrict__ bl, uint32_t* partials,
                   unsigned int* ticket, int32_t* __restrict__ corr0,
                   int32_t* __restrict__ corr1) {
  __shared__ uint32_t sh[kRlcWarps][RLC_SUM_WORDS];
  __shared__ bool last;
  const long t = (long)blockIdx.x * kRlcThreads + threadIdx.x;
  const long j = t >> 1;
  Sc b;
  load_sc(b, bl, 1, 0);
  uint32_t x[RLC_SUM_WORDS];
  if (j < rows.n) {
    cpzk::rlc_row(x, rows, b, j, (int)(t & 1));
  } else {
    cpzk::sc9_zero(x);
  }
  block_sum9(x, sh);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) cpzk::rlc_finish(corr0, corr1, x, b);
    return;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < RLC_SUM_WORDS; ++i) {
      partials[(long)blockIdx.x * RLC_SUM_WORDS + i] = x[i];
    }
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's partial is visible (each fenced before
  // its ticket); read them past L1
  __threadfence();
  cpzk::sc9_zero(x);
#pragma unroll 4
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kRlcThreads) {
    uint32_t p[RLC_SUM_WORDS];
#pragma unroll
    for (int i = 0; i < RLC_SUM_WORDS; ++i) {
      p[i] = __ldcg(&partials[(long)k * RLC_SUM_WORDS + i]);
    }
    cpzk::sc9_add(x, p);
  }
  // every block has taken its ticket: leave it zeroed for the next call
  if (threadIdx.x == 0) *ticket = 0;
  block_sum9(x, sh);
  if (threadIdx.x == 0) cpzk::rlc_finish(corr0, corr1, x, b);
}

// An empty kernel: the launch floor the small kernels' times are read
// against (chip_smoke.py, bench_kernels.py); no wrapper, no counter.
__global__ void launch_floor_kernel() {}

// rlc_scalars' blocks for n rows.
long rlc_blocks(int n) { return (2L * n + kRlcThreads - 1) / kRlcThreads; }

// One thread a lane (or term), its whole body recode_w32.cuh's
// recode_thread: mode 0 the windows of group g's lanes with lane n
// spliced, mode 1 the digits of the terms.
__global__ void __launch_bounds__(kRecodeThreads)
scalar_recode_kernel(cpzk::RecodeArgs args, int threads) {
  __shared__ uint32_t words[cpzk::NW][kRecodeThreads];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  cpzk::recode_thread(args, t, &words[0][threadIdx.x], kRecodeThreads);
}

// Lane j < n: the W <= 40 canonical 13-bit limbs of x (limb i at i n + j,
// a value below 2^512) reduced mod l into out's 20 limbs
// (cpzk::reduce_wide_lane: the fold of sc_reduce_wide).
__global__ void __launch_bounds__(kReduceThreads)
reduce_wide_kernel(const int32_t* __restrict__ x, int rows, int32_t* __restrict__ out,
                   int n) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  cpzk::reduce_wide_lane(x, rows, out, n, j);
}

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
// partials: cpzk_rlc_scalars_blocks(n) x 9 words of scratch; ticket: one
// zeroed word, which the call leaves zeroed (its last block resets it), so
// a caller keeps one a stream and zeroes it once.
extern "C" int cpzk_rlc_scalars(const void* al, const void* cl, const void* sl,
                                const void* bl, void* ac, void* ba, void* bac,
                                void* partials, void* ticket, void* corr0,
                                void* corr1, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const cpzk::RlcRows rows{(const int32_t*)al, (const int32_t*)cl, (const int32_t*)sl,
                           (int32_t*)ac,       (int32_t*)ba,       (int32_t*)bac,
                           (long)n};
  rlc_scalars_kernel<<<(unsigned)rlc_blocks(n), kRlcThreads, 0, (cudaStream_t)stream>>>(
      rows, (const int32_t*)bl, (uint32_t*)partials, (unsigned int*)ticket,
      (int32_t*)corr0, (int32_t*)corr1);
  return (int)cudaGetLastError();
}

// Blocks of an n-row call: the partials' rows.
extern "C" int cpzk_rlc_scalars_blocks(int n) { return (int)rlc_blocks(n); }

extern "C" int cpzk_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int cpzk_scalar_recode(const void* g0, const void* g1, const void* g2,
                                  const void* g3, const void* corr0,
                                  const void* corr1, int n, int pad, int mode,
                                  int c, int nwin, int m, void* out, void* stream) {
  if (mode < 0 || mode > 1 || (mode == 0 && (n < 0 || pad <= n)) ||
      (mode == 1 && (n < 1 || pad < n || m < 4L * n + 2 || c < 4 || c > 16 ||
                     nwin * c < 256)))
    return (int)cudaErrorInvalidValue;
  const cpzk::RecodeArgs args{(const int32_t*)g0, (const int32_t*)g1, (const int32_t*)g2,
                              (const int32_t*)g3, (const int32_t*)corr0,
                              (const int32_t*)corr1, n, pad, m, mode, c, nwin,
                              (int32_t*)out};
  const int threads = cpzk::recode_threads(args);
  // blocks of 256 threads, halved down to one warp while that leaves an
  // SM without a block
  const int sms = cpzk_sm_count();
  int block = kRecodeThreads;
  while (block > 32 && (threads + block - 1) / block < sms) block /= 2;
  scalar_recode_kernel<<<(unsigned)((threads + block - 1) / block), block, 0,
                         (cudaStream_t)stream>>>(args, threads);
  return (int)cudaGetLastError();
}

extern "C" int cpzk_reduce_wide(const void* x, int rows, void* out, int n, void* stream) {
  if (n < 1 || rows < 1 || rows > 2 * NL) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kReduceThreads - 1) / kReduceThreads;
  reduce_wide_kernel<<<blocks, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, rows, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
