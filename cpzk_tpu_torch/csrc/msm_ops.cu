// The two kernels of the signed-digit Pippenger MSM, for Hopper (sm_90a),
// with a plain C launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/msm_kernels.py.  Each is two __global__ launches on the
// thread bodies of msm_w32.cuh (the phases are described there), on the
// point arithmetic of fe25519_w32.cuh.
//
//   msm_bucket         replaces the bucket sums of
//                      cpzk_tpu/ops/msm.py::_window_sum (a sort, a prefix
//                      scan, boundary differences) for every window of
//                      ::msm_kernel:
//     msm_bucket_sort_kernel  one block per window: the counting sort of
//                             its digits and a share of the points' words
//     msm_bucket_add_kernel   a grid of (part, window): the adds, balanced
//                             over the window's entries, and the joins
//   msm_window_reduce  replaces the suffix scan and tree sum of ::_window_sum
//                      and the Horner step of ::msm_kernel:
//     msm_window_reduce_totals_kernel  one block per window: sum_j j B_j
//                                      on 64 quads of lanes
//     msm_window_reduce_scale_kernel   one block: each total times 2^(c w)
//                                      on a quad of lanes, then a tree sum
//   msm_quad_chain_kernel  no wrapper: the quads' doubling chain alone, the
//                          floor of the scale kernel's schedule, for timing
//
// Layout: points are [20, m] limb-major int32 coordinates, digits [k, m]
// signed c-bit digits (LSB window first), buckets [20, k B] with bucket j of
// window w at lane w B + j - 1 (B = 2^(c-1)), the result [20, 1].  Scratch
// (from the wrapper, cpzk_msm_bucket_scratch words) holds the points' words,
// the sorted entries and the blocks' pieces.
//
// What bounds them on an H100.  msm_bucket needs one point add (~1.6k int32
// operations) per non-zero digit: bound by operations (376,664 adds, 36 us,
// at the main path's 16,384-term chunk, c = 11).  What stands in the way:
// finding a bucket's terms (a scan of all m digits per bucket is 4e8
// compares), the points' scattered limb loads, and skewed digits (a bucket
// that holds every term is a serial chain of m adds).  So a counting sort
// makes the grouping linear, the points are read as 128 contiguous bytes
// (converted once, in the add's cached form), and every thread adds the
// same number of entries whatever the digits: the runs split the sorted
// entries, not the buckets, and the pieces of a bucket that spans runs or
// blocks are joined in log depth.  The adds then run as fast as the
// field arithmetic allows; more threads do not help.  msm_window_reduce
// needs 2 adds a bucket and the doublings (4.75 us of operations), but no
// schedule beats its chain: the top window's total must be doubled
// c (k - 1) times, one doubling after another.  So four lanes of a warp (a
// quad) share every add and doubling (an add costs three field operations
// of latency, not nine; a doubling two, not seven): the window totals run
// 64 quads a window on buckets staged in shared memory (a segment each, a
// suffix scan and a tree sum), and the scale kernel doubles each window
// total on its own quad, so the chain is c (k - 1) quad doublings and
// log2(k) quad adds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "msm_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::PT_WORDS;

constexpr int kSortThreads = cpzk::MSM_SORT_THREADS;
constexpr int kAddThreads = 128;
constexpr int kRanges = kAddThreads;  // one run a thread
// entries a thread of msm_bucket_add_kernel should get at least, and its
// blocks per SM at most (registers and shared memory allow three)
constexpr int kEntriesPerThread = 16;
constexpr int kAddBlocksPerSm = 3;
constexpr int kTotalsQuads = cpzk::MSM_TOTALS_QUADS;

// SMs of the current device, read once per device.
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int c = 0;
    if (cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    counts[dev] = c;
  }
  return counts[dev];
}

// Dynamic shared memory above 48 KB must be allowed per kernel and device
// (bytes: the most any launch of the kernel asks for).
template <typename K>
int allow_smem(K kernel, int bytes, bool* done) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (bytes <= 48 * 1024 || done[dev]) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
      cudaSuccess)
    return 1;
  done[dev] = true;
  return 0;
}

// Parts per window of msm_bucket_add_kernel: enough blocks to fill the card,
// but no fewer than kEntriesPerThread entries a thread (the digits' count
// is known only on the card, m bounds it).
int add_parts(long m, int k) {
  const int sms = sm_count() > 0 ? sm_count() : 1;
  long by_work = (m + (long)kAddThreads * kEntriesPerThread - 1) /
                 ((long)kAddThreads * kEntriesPerThread);
  const long by_card = ((long)kAddBlocksPerSm * sms + k - 1) / k;
  long p = by_work < by_card ? by_work : by_card;
  if (p > kRanges) p = kRanges;  // the last block joins p + 1 slots
  return p < 1 ? 1 : (int)p;
}

struct BucketScratch {
  uint32_t* pw;      // m points, 32 words each
  int32_t* keys;     // k x m: the sorted entries' buckets
  int32_t* ents;     // k x m: the sorted signed entries
  uint32_t* nz;      // k: non-zero digits per window
  unsigned* ticket;  // k: blocks of the window done
  uint32_t* parts;   // k x parts x 2 points: the blocks' pieces
  int32_t* pkey;     // k x parts x 2
  int32_t* phas;     // k x parts x 2
  long words;
};

BucketScratch bucket_scratch(void* base, long m, int k, int parts) {
  BucketScratch s;
  uint32_t* p = (uint32_t*)base;
  s.pw = p;
  p += m * PT_WORDS;
  s.parts = p;  // 16-byte aligned: m * 128 bytes after the base
  p += (long)k * parts * 2 * PT_WORDS;
  s.keys = (int32_t*)p;
  p += (long)k * m;
  s.ents = (int32_t*)p;
  p += (long)k * m;
  s.nz = p;
  p += k;
  s.ticket = p;
  p += k;
  s.pkey = (int32_t*)p;
  p += (long)k * parts * 2;
  s.phas = (int32_t*)p;
  p += (long)k * parts * 2;
  s.words = p - (uint32_t*)base;
  return s;
}

// dynamic shared memory the sort may ask for: its histogram and scan, and
// where they fit beside them, the sorted entries (scattered in shared
// memory, then copied out in order: on an H100 the sort of a 16,384-term
// chunk at c = 11 took 21.7 us so and 54.9 us scattering straight to
// global scratch, with random digits; with one bucket a window the whole
// call was within 1% either way)
constexpr int kSortSmemMax = 200 * 1024;

int sort_smem(int nb) { return (nb + 1 + kSortThreads + 32) * 4; }

bool sort_staged(long m, int nb) { return sort_smem(nb) + 8 * m <= kSortSmemMax; }

__global__ void __launch_bounds__(kSortThreads)
msm_bucket_sort_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                       const int32_t* __restrict__ z, const int32_t* __restrict__ t,
                       const int32_t* __restrict__ digits, BucketScratch s,
                       int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                       int32_t* __restrict__ oz, int32_t* __restrict__ ot, int m, int k,
                       int c, bool staged) {
  extern __shared__ uint32_t sort_smem_words[];
  __shared__ uint32_t n_sh;
  const int nb = 1 << (c - 1);
  uint32_t* counts = sort_smem_words;        // nb + 1
  uint32_t* part = counts + nb + 1;          // kSortThreads
  uint32_t* grp = part + kSortThreads;       // 32
  const int w = blockIdx.x, tid = threadIdx.x;
  const int32_t* row = digits + (long)w * m;
  int32_t* const out[4] = {ox, oy, oz, ot};
  const long stride = (long)k * nb, base = (long)w * nb;
  int32_t* keys = s.keys + (long)w * m;
  int32_t* ents = s.ents + (long)w * m;

  // this block's share of the points, into the kernels' form
  const int32_t* const coords[4] = {x, y, z, t};
  for (long i = cpzk::msm_split(m, w, k) + tid; i < cpzk::msm_split(m, w + 1, k);
       i += kSortThreads)
    cpzk::msm_point_words(s.pw, coords, m, i);

  for (int b = tid; b <= nb; b += kSortThreads) counts[b] = 0;
  if (tid == 0) s.ticket[w] = 0;
  __syncthreads();
  cpzk::msm_sort_count(counts, row, m, tid, kSortThreads);
  __syncthreads();
  cpzk::msm_sort_chunk_sum(part, counts, nb, tid, kSortThreads);
  __syncthreads();
  if (tid < 32) cpzk::msm_sort_scan_group(part, grp, kSortThreads, tid);
  __syncthreads();
  if (tid == 0) s.nz[w] = n_sh = cpzk::msm_sort_scan_groups(grp);
  cpzk::msm_sort_empties(counts, nb, tid, kSortThreads, out, stride, base);
  __syncthreads();
  cpzk::msm_sort_cursors(counts, part, grp, nb, tid, kSortThreads);
  __syncthreads();
  if (!staged) {
    cpzk::msm_sort_scatter(keys, ents, counts, row, m, tid, kSortThreads);
    return;
  }
  // random stores into shared memory, then coalesced ones out
  int32_t* skeys = (int32_t*)(grp + 32);
  int32_t* sents = skeys + m;
  cpzk::msm_sort_scatter(skeys, sents, counts, row, m, tid, kSortThreads);
  __syncthreads();
  for (long e = tid; e < (long)n_sh; e += kSortThreads) {
    keys[e] = skeys[e];
    ents[e] = sents[e];
  }
}

// Shared memory of msm_bucket_add_kernel: two buffers of the kRanges + 1
// joined slots, the kRanges last pieces, and their keys and has flags.
int add_smem() { return ((2 * (kRanges + 1) + kRanges) * PT_WORDS + 5 * kRanges + 3) * 4; }

__global__ void __launch_bounds__(kAddThreads)
msm_bucket_add_kernel(BucketScratch s, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz, int32_t* __restrict__ ot, int m, int k, int c,
                      int parts) {
  extern __shared__ uint4 add_smem_vec[];
  uint32_t* buf0 = (uint32_t*)add_smem_vec;
  uint32_t* buf1 = buf0 + (kRanges + 1) * PT_WORDS;
  uint32_t* lbuf = buf1 + (kRanges + 1) * PT_WORDS;
  int* key = (int*)(lbuf + kRanges * PT_WORDS);
  int* has0 = key + kRanges + 1;
  int* has1 = has0 + kRanges + 1;
  int* lkey = has1 + kRanges + 1;
  int* lhas = lkey + kRanges;
  __shared__ bool last;
  const int nb = 1 << (c - 1);
  const int p = blockIdx.x, w = blockIdx.y, tid = threadIdx.x;
  const long n = s.nz[w];
  const int32_t* keys = s.keys + (long)w * m;
  const int32_t* ents = s.ents + (long)w * m;
  int32_t* const out[4] = {ox, oy, oz, ot};
  const long stride = (long)k * nb, base = (long)w * nb;
  const long lo = cpzk::msm_split(n, p, parts), hi = cpzk::msm_split(n, p + 1, parts);
  const long piece0 = ((long)w * parts + p) * 2;

  if (lo < hi) {
    cpzk::msm_thread_run(buf0, key, has0, lbuf, lkey, lhas, tid, kRanges, keys, ents, n, lo,
                         hi, s.pw, out, stride, base);
    __syncthreads();
    for (int i = tid; i <= kRanges; i += kAddThreads)
      cpzk::msm_seg_join(buf0, key, has0, lbuf, lkey, lhas, kRanges, i);
    __syncthreads();
    int* has;
    const uint32_t* v =
        cpzk::msm_seg_reduce(buf0, has0, buf1, has1, key, kRanges + 1, tid, kAddThreads, &has);
    for (int i = tid; i <= kRanges; i += kAddThreads)
      cpzk::msm_place_slot(v, has, key, i, keys, n, lo, hi, out, stride, base,
                           s.parts + piece0 * PT_WORDS);
  }
  if (tid == 0) cpzk::msm_block_pieces(s.pkey + piece0, s.phas + piece0, keys, n, lo, hi);

  // the last block of the window joins the pieces of the buckets that span
  // blocks (each block's stores fenced before its ticket)
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&s.ticket[w], 1u) == (unsigned)parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long first = (long)w * parts * 2;
  for (int q = tid; q < parts; q += kAddThreads)
    cpzk::msm_load_pieces(buf0, key, has0, lbuf, lkey, lhas, s.parts + first * PT_WORDS,
                          s.pkey + first, s.phas + first, q);
  __syncthreads();
  for (int i = tid; i <= parts; i += kAddThreads)
    cpzk::msm_seg_join(buf0, key, has0, lbuf, lkey, lhas, parts, i);
  __syncthreads();
  int* has;
  const uint32_t* v =
      cpzk::msm_seg_reduce(buf0, has0, buf1, has1, key, parts + 1, tid, kAddThreads, &has);
  for (int i = tid; i <= parts; i += kAddThreads)
    cpzk::msm_store_slot(v, has, key, i, out, stride, base);
}

// One block per window, a quad of lanes per segment (msm_w32.cuh's
// msm_totals_* steps in order, a barrier after each).
__global__ void __launch_bounds__(4 * kTotalsQuads)
msm_window_reduce_totals_kernel(const int32_t* __restrict__ bx, const int32_t* __restrict__ by,
                                const int32_t* __restrict__ bz, const int32_t* __restrict__ bt,
                                uint32_t* __restrict__ totals, int k, int c, bool staged) {
  __shared__ uint4 sr_vec[2][kTotalsQuads * PT_WORDS / 4], sx_vec[kTotalsQuads * PT_WORDS / 4];
  uint32_t* ra = (uint32_t*)sr_vec[0];
  uint32_t* rb = (uint32_t*)sr_vec[1];
  uint32_t* sx = (uint32_t*)sx_vec;
  extern __shared__ uint4 staged_vec[];
  uint32_t* sb = staged ? (uint32_t*)staged_vec : nullptr;
  const int nb = 1 << (c - 1);
  const int nseg = cpzk::msm_totals_segments(c);
  const int log_g = cpzk::msm_totals_log_g(c, nseg);
  const int w = blockIdx.x, sg = threadIdx.x >> 2;
  const cpzk::Quad qd = cpzk::quad_of_thread(threadIdx.x);
  const bool on = sg < nseg;
  const int32_t* const coords[4] = {bx, by, bz, bt};
  const long lanes = (long)k * nb, base = (long)w * nb;
  if (sb) {
    cpzk::msm_totals_stage(sb, coords, lanes, base, nb, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  Fe run[4], x[4];
  if (on) cpzk::msm_totals_segment(run, ra, sx, sb, coords, lanes, base, sg, log_g, qd);
  __syncthreads();
  for (int d = 1; d < nseg; d <<= 1) {
    if (on) cpzk::msm_totals_scan_level(run, rb, ra, sg, nseg, d, qd);
    __syncthreads();
    uint32_t* t = ra;
    ra = rb;
    rb = t;
  }
  if (on) cpzk::msm_totals_weight(x, sx, ra, sg, nseg, log_g, qd);
  __syncthreads();
  for (int h = nseg >> 1; h >= 1; h >>= 1) {
    if (on) cpzk::msm_tree_level(x, sx, sg, h, nseg, qd);
    __syncthreads();
  }
  if (threadIdx.x == 0) cpzk::pt_store_words(totals + (long)w * PT_WORDS, x);
}

// One block: a quad for each stride of windows (msm_scale_horner), then
// their tree sum.
__global__ void __launch_bounds__(4 * kTotalsQuads)
msm_window_reduce_scale_kernel(const uint32_t* __restrict__ totals, int32_t* __restrict__ ox,
                               int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                               int32_t* __restrict__ ot, int k, int c) {
  __shared__ uint4 scale_smem_vec[kTotalsQuads * PT_WORDS / 4];
  uint32_t* sq = (uint32_t*)scale_smem_vec;
  const int nq = cpzk::msm_scale_quads(k);
  const int q = threadIdx.x >> 2;
  const cpzk::Quad qd = cpzk::quad_of_thread(threadIdx.x);
  Fe acc[4];
  if (q < nq) cpzk::msm_scale_horner(acc, sq, totals, k, c, q, nq, qd);
  __syncthreads();
  for (int h = cpzk::msm_tree_top(nq) >> 1; h >= 1; h >>= 1) {
    if (q < nq) cpzk::msm_tree_level(acc, sq, q, h, nq, qd);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int32_t* const out[4] = {ox, oy, oz, ot};
    cpzk::store_point(out, 1, 0, acc);
  }
}

// One warp, every quad: `rounds` quad doublings of the point at in (32
// words), quad 0's result to out.  Not on any path: it measures the
// latency of the doubling chain that bounds msm_window_reduce_scale_kernel.
__global__ void __launch_bounds__(32)
msm_quad_chain_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int rounds) {
  const cpzk::Quad qd = cpzk::quad_of_thread(threadIdx.x);
  Fe p[4];
  cpzk::pt_load_words(p, in);
  cpzk::quad_double_k(p, rounds, qd);
  if (threadIdx.x == 0) cpzk::pt_store_words(out, p);
}

bool sort_smem_set[64], add_smem_set[64], totals_smem_set[64];

}  // namespace

// int32 words of scratch msm_bucket needs for m terms, k windows, window
// size c on the current device (-1 if out of range).
extern "C" int cpzk_msm_bucket_scratch(int m, int k, int c) {
  if (m < 1 || k < 1 || c < 2 || c > 16) return -1;
  const long words = bucket_scratch(nullptr, m, k, add_parts(m, k)).words;
  return words > 0x7fffffffL ? -1 : (int)words;
}

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns the first CUDA error of its launches (0 =
// success).
extern "C" int cpzk_msm_bucket(const void* x, const void* y, const void* z, const void* t,
                               const void* digits, void* scratch, void* ox, void* oy,
                               void* oz, void* ot, int m, int k, int c, void* stream) {
  if (m < 1 || k < 1 || c < 2 || c > 16) return (int)cudaErrorInvalidValue;
  const int nb = 1 << (c - 1);
  const int parts = add_parts(m, k);
  const BucketScratch s = bucket_scratch(scratch, m, k, parts);
  const cudaStream_t st = (cudaStream_t)stream;
  if (allow_smem(msm_bucket_sort_kernel, kSortSmemMax, sort_smem_set) ||
      allow_smem(msm_bucket_add_kernel, add_smem(), add_smem_set))
    return (int)cudaErrorInvalidValue;
  const bool staged = sort_staged(m, nb);
  msm_bucket_sort_kernel<<<k, kSortThreads, sort_smem(nb) + (staged ? 8 * m : 0), st>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)z, (const int32_t*)t,
      (const int32_t*)digits, s, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot, m,
      k, c, staged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_bucket_add_kernel<<<dim3(parts, k), kAddThreads, add_smem(), st>>>(
      s, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot, m, k, c, parts);
  return (int)cudaGetLastError();
}

// scratch: k x 32 words of window totals.
extern "C" int cpzk_msm_window_reduce(const void* bx, const void* by, const void* bz,
                                      const void* bt, void* scratch, void* ox, void* oy,
                                      void* oz, void* ot, int k, int c, void* stream) {
  if (k < 1 || c < 2 || c > 16) return (int)cudaErrorInvalidValue;
  const int segments = cpzk::msm_totals_segments(c);
  const int threads = (4 * segments + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nb = 1 << (c - 1);
  const bool staged = nb <= cpzk::MSM_TOTALS_STAGED_BUCKETS;
  if (allow_smem(msm_window_reduce_totals_kernel,
                 cpzk::MSM_TOTALS_STAGED_BUCKETS * PT_WORDS * 4, totals_smem_set))
    return (int)cudaErrorInvalidValue;
  msm_window_reduce_totals_kernel<<<k, threads, staged ? nb * PT_WORDS * 4 : 0, st>>>(
      (const int32_t*)bx, (const int32_t*)by, (const int32_t*)bz, (const int32_t*)bt,
      (uint32_t*)scratch, k, c, staged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int quads = cpzk::msm_scale_quads(k);
  msm_window_reduce_scale_kernel<<<1, (4 * quads + 31) / 32 * 32, 0, st>>>(
      (const uint32_t*)scratch, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int32_t*)ot, k, c);
  return (int)cudaGetLastError();
}

// `rounds` quad doublings of one point (32 words at in, the kernels' form)
// into out, on one warp: a probe of the doubling chain's latency, launched
// by no wrapper.
extern "C" int cpzk_msm_quad_chain(const void* in, void* out, int rounds, void* stream) {
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  msm_quad_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint32_t*)in,
                                                             (uint32_t*)out, rounds);
  return (int)cudaGetLastError();
}
