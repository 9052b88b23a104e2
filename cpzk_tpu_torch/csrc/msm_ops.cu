// The two kernels of the signed-digit Pippenger MSM, for Hopper (sm_90a),
// with a plain C launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/msm_kernels.py.  Both run on the point arithmetic of
// fe25519_w32.cuh, through the thread bodies of msm_w32.cuh.
//
//   msm_bucket_kernel         replaces the bucket sums of
//                             cpzk_tpu/ops/msm.py::_window_sum (sort, prefix
//                             scan, boundary differences) for every window
//                             of msm_kernel
//   msm_window_reduce_kernel  replaces the suffix scan and tree sum of
//                             ::_window_sum and the Horner step of
//                             ::msm_kernel (double_k(acc, c) + W_w)
//
// Layout: points are [20, m] limb-major int32 coordinates, digits [k, m]
// signed c-bit digits (LSB window first), buckets [20, k B] with bucket j of
// window w at lane w B + j - 1 (B = 2^(c-1)), the result [20, 1].
//
// msm_bucket_kernel: one thread per (window, bucket).  A block holds
// consecutive buckets of one window; it stages tiles of that window's
// digits in shared memory, every thread scans the tile (the reads are
// broadcasts) and lists the terms whose digit has its bucket's magnitude,
// then adds the listed points (loaded from L2; the m points of a chunk are
// 5 MB at m = 16,384) into its running sum, negated for a negative digit.
// Listing first lets a warp's threads run their adds together: at c = 11 a
// thread matches about one term in a thousand, and adding at the match
// would run each thread's add alone.  The grouping is this scan, not a sort.
// What bounds it: one point add per non-zero digit (about 1.6k int32
// operations each), so operations; the scan costs m reads per thread more.
//
// msm_window_reduce_kernel: one block of G threads per window.  Thread s
// walks its segment of S = B / G buckets from the top with two running sums
// (msm_segment), thread 0 joins the segments with small-scalar multiples as
// running sums (msm_join) into W_w, and the last block to finish (an atomic
// ticket) runs Horner over the windows.  One dependent chain of about
// 2 S + 3 G adds per window and k (c doublings + 1 add) for Horner: bound by
// that chain's latency, far above its operation bound (2 k B adds).
#include <cuda_runtime.h>
#include <stdint.h>

#include "msm_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::NW;

constexpr int kBucketThreads = 128;
constexpr int kTile = 2048;
constexpr int kPendCap = 8;
constexpr int kMaxSegments = 32;

__global__ void __launch_bounds__(kBucketThreads)
msm_bucket_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ z, const int32_t* __restrict__ t,
                  const int32_t* __restrict__ digits, int32_t* __restrict__ ox,
                  int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                  int32_t* __restrict__ ot, int m, int k, int c) {
  __shared__ int32_t tile[kTile];
  __shared__ int32_t pend[kPendCap * kBucketThreads];
  const int nb = 1 << (c - 1);
  const int w = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const bool active = j <= nb;
  const int32_t* const coords[4] = {x, y, z, t};
  const int32_t* row = digits + (long)w * m;
  Fe acc[4];
  cpzk::pt_identity(acc);
  for (long base = 0; base < m; base += kTile) {
    const int count = (int)(m - base < kTile ? m - base : kTile);
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = row[base + i];
    __syncthreads();
    if (active)
      cpzk::msm_bucket_tile(acc, tile, count, base, j, coords, m, pend + threadIdx.x,
                            blockDim.x, kPendCap);
  }
  if (active) {
    int32_t* const out[4] = {ox, oy, oz, ot};
    cpzk::store_point(out, (long)k * nb, (long)w * nb + j - 1, acc);
  }
}

__global__ void __launch_bounds__(kMaxSegments)
msm_window_reduce_kernel(const int32_t* __restrict__ bx, const int32_t* __restrict__ by,
                         const int32_t* __restrict__ bz, const int32_t* __restrict__ bt,
                         uint32_t* totals, unsigned int* ticket,
                         int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz, int32_t* __restrict__ ot,
                         int k, int c, int log_s) {
  __shared__ Fe run_sh[kMaxSegments][4];
  __shared__ Fe tot_sh[kMaxSegments][4];
  __shared__ bool last;
  const int nb = 1 << (c - 1);
  const int seg = 1 << log_s;
  const int w = blockIdx.x, s = threadIdx.x;
  const int32_t* const coords[4] = {bx, by, bz, bt};
  const long lanes = (long)k * nb;
  {
    Fe run[4], tot[4];
    cpzk::msm_segment(run, tot, s * seg, s * seg + seg, coords, lanes, (long)w * nb);
    cpzk::pt_copy(run_sh[s], run);
    cpzk::pt_copy(tot_sh[s], tot);
  }
  __syncthreads();
  if (s == 0) {
    Fe total[4];
    cpzk::msm_join(total, run_sh, tot_sh, blockDim.x, log_s);
    cpzk::store_total(totals + (long)w * 4 * NW, total);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || s != 0) return;
  // every window's total is visible (each fenced before its ticket)
  Fe acc[4];
  cpzk::msm_horner(acc, k, c, totals);
  int32_t* const out[4] = {ox, oy, oz, ot};
  cpzk::store_point(out, 1, 0, acc);
}

int bucket_threads(int nb) {
  int t = nb < kBucketThreads ? nb : kBucketThreads;
  return (t + 31) / 32 * 32;
}

}  // namespace

// Segments per window of msm_window_reduce (a power of two, at most 32)
// for window size c; log2 of the buckets per segment is c - 1 - log2 of it.
extern "C" int cpzk_msm_segments(int c) {
  const int nb = 1 << (c - 1);
  return nb < kMaxSegments ? nb : kMaxSegments;
}

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int cpzk_msm_bucket(const void* x, const void* y, const void* z,
                               const void* t, const void* digits, void* ox, void* oy,
                               void* oz, void* ot, int m, int k, int c, void* stream) {
  if (m < 1 || k < 1 || c < 2 || c > 16) return (int)cudaErrorInvalidValue;
  const int nb = 1 << (c - 1);
  const int threads = bucket_threads(nb);
  const dim3 grid((nb + threads - 1) / threads, k);
  msm_bucket_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t,
      (const int32_t*)digits, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot,
      m, k, c);
  return (int)cudaGetLastError();
}

// scratch: k x 32 words of window totals, then one zeroed ticket word.
extern "C" int cpzk_msm_window_reduce(const void* bx, const void* by, const void* bz,
                                      const void* bt, void* scratch, void* ox, void* oy,
                                      void* oz, void* ot, int k, int c, void* stream) {
  if (k < 1 || c < 2 || c > 16) return (int)cudaErrorInvalidValue;
  const int segments = cpzk_msm_segments(c);
  int log_s = 0;
  while ((segments << log_s) < (1 << (c - 1))) ++log_s;
  uint32_t* totals = (uint32_t*)scratch;
  msm_window_reduce_kernel<<<k, segments, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bx, (const int32_t*)by, (const int32_t*)bz, (const int32_t*)bt,
      totals, (unsigned int*)(totals + (long)k * 4 * NW), (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, (int32_t*)ot, k, c, log_s);
  return (int)cudaGetLastError();
}
