// The per-row ladder kernels of batch verification, for Hopper (sm_90a),
// with a plain C launch interface loaded through ctypes by
// cpzk_tpu_torch/ops/ladder_kernels.py.
//
//   ladder_combined_kernel           replaces cpzk_tpu/ops/verify.py::combined_partial_kernel
//                                    (with _msm_rows, curve.build_table, table_gather,
//                                    tree_sum) and ::combined_kernel's is_identity
//   ladder_partials_identity_kernel  replaces cpzk_tpu/ops/backend.py::_partials_impl and
//                                    the identity test of chunked_combined_identity
//   ladder_each_kernel               replaces cpzk_tpu/ops/verify.py::verify_each_kernel
//
// These were XLA programs (a lax.scan of Pallas point kernels) in the JAX
// package, and on the card a launch of the point kernels, or of a table
// gather, for every ladder step: ~8,500 launches a 4096-row combined check.
// Here a lane chunk is one launch.
//
// Layout: every point coordinate is a [20, *] int32 limb array with its own
// row stride (lane chunks are column slices of the batch's arrays), every
// window array [64, *] with its own; a point shared by every lane is
// [20, 1].  One thread owns one lane and runs ladder_w32.cuh's bodies: it
// builds the lane's tables into a global scratch (2 KB a table), then runs
// the 64-step ladder with its accumulator in registers.
//
// ladder_combined_kernel: after its lane's ladder, each block sums its
// threads' points in shared memory (a tree of log2(threads) levels) and
// stores the block's partial; the last block to finish (an atomic ticket
// the entry point zeroes) sums the blocks' partials and writes the chunk's
// total as [20, 1] limbs and its identity test.  ladder_partials_identity:
// one block sums k chunk totals and tests the identity.  ladder_each: one
// bit a lane, no reduction.
//
// What bounds them (ops/ladder_kernels.py counts them): a lane of the
// combined check reads 2.3 KB and needs about 745k int32 operations (four
// tables of 14 cached adds, 64 doubling rounds of four and 256 cached
// adds), a lane of the per-row check 1.8 KB and about 1.0M, so both are
// bound by operations (0.27 and 0.25 ms at 6,144 and 4,096 lanes on 132
// SMs at 1980 MHz).  But each lane is one thread's dependent chain of
// point operations (about 570 combined, 830 per row): at the main path's
// widths (4,096 to 16,384 lanes, 128 to 512 warps for the card's 528
// schedulers) a warp is about alone on its scheduler, so the time is that
// chain's latency (one thread at n = 1, the chain floor), not the card's
// throughput.  So the design keeps one lane a thread with one-warp blocks
// (the point kernels' block_threads), interleaves each formula's
// independent multiplies (fe25519_w32.cuh), keeps the ladder step's rounds
// and terms as loops so its code stays in the instruction cache
// (ladder_w32.cuh), and lets ptxas use as many registers as it likes
// (__launch_bounds__(256, 1)).  The tables' traffic (about 40 KB a lane
// through L2) is under the operations bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ladder_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::LadderPt;
using cpzk::LadderWin;
using cpzk::PT_WORDS;

constexpr int kMaxThreads = 256;
constexpr int kPartialsThreads = 32;

struct CombinedArgs {
  LadderPt pts[4];  // r1, y1, r2, y2
  LadderWin win[4];  // a, a c, b a, b a c
  uint32_t* tables;  // n x LADDER_COMBINED_WORDS
  uint32_t* parts;   // blocks x 32 words
  unsigned* ticket;  // blocks done
  int32_t* out[4];   // the chunk's total, column 0 of [20, *]
  long out_ld;
  uint8_t* ok;
};

struct EachArgs {
  LadderPt pts[6];  // g, h, y1, y2, r1, r2
  LadderWin win[2];  // s, c
  uint32_t* tables;  // n x LADDER_EACH_WORDS
  uint8_t* out;      // [n]
};

__global__ void __launch_bounds__(kMaxThreads, 1)
ladder_combined_kernel(CombinedArgs a, int n) {
  extern __shared__ uint4 smem_vec[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_vec);
  __shared__ bool last;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long j = (long)blockIdx.x * nt + tid;
  Fe acc[4];
  if (j < n) {
    cpzk::ladder_combined_lane(acc, a.pts, a.win, a.tables + j * cpzk::LADDER_COMBINED_WORDS, j);
  } else {
    cpzk::pt_identity(acc);  // past the ragged end: the identity
  }
  cpzk::pt_store_words(s + tid * PT_WORDS, acc);
  __syncthreads();
  for (int h = cpzk::msm_tree_top(nt) >> 1; h >= 1; h >>= 1) {
    cpzk::ladder_tree_level(acc, s, tid, h, nt);
    __syncthreads();
  }
  if (tid == 0) cpzk::pt_store_words(a.parts + (long)blockIdx.x * PT_WORDS, acc);
  // the last block sums the blocks' partials (each block's store fenced
  // before its ticket)
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int k = gridDim.x;
  cpzk::ladder_parts_sum(acc, a.parts, k, tid, nt);
  cpzk::pt_store_words(s + tid * PT_WORDS, acc);
  __syncthreads();
  const int m = k < nt ? k : nt;
  for (int h = cpzk::msm_tree_top(m) >> 1; h >= 1; h >>= 1) {
    cpzk::ladder_tree_level(acc, s, tid, h, m);
    __syncthreads();
  }
  if (tid == 0) cpzk::ladder_finish(a.out, a.out_ld, a.ok, acc);
}

__global__ void __launch_bounds__(kPartialsThreads)
ladder_partials_identity_kernel(LadderPt parts, int k, uint8_t* ok) {
  __shared__ uint4 s_vec[kPartialsThreads * PT_WORDS / 4];
  uint32_t* s = reinterpret_cast<uint32_t*>(s_vec);
  const int tid = threadIdx.x;
  Fe acc[4];
  cpzk::ladder_limbs_sum(acc, parts, k, tid, kPartialsThreads);
  cpzk::pt_store_words(s + tid * PT_WORDS, acc);
  __syncthreads();
  for (int h = kPartialsThreads >> 1; h >= 1; h >>= 1) {
    cpzk::ladder_tree_level(acc, s, tid, h, kPartialsThreads);
    __syncthreads();
  }
  if (tid == 0) *ok = (uint8_t)cpzk::ladder_is_identity(acc);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
ladder_each_kernel(EachArgs a, int n) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  a.out[j] = (uint8_t)cpzk::ladder_each_lane(a.pts, a.win,
                                             a.tables + j * cpzk::LADDER_EACH_WORDS, j);
}

LadderPt point_operand(const void* const* ptrs, const long long* lds, int step) {
  LadderPt p;
  for (int k = 0; k < 4; ++k) {
    p.c[k] = (const int32_t*)ptrs[k];
    p.ld[k] = (long)lds[k];
  }
  p.step = step;
  return p;
}

}  // namespace

// cpzk_block_threads (point_ops.cu): the block size of every lane-per-thread
// kernel of the library.
extern "C" int cpzk_block_threads(int n);

// Scratch words of an n-lane call: the tables, and for the combined check
// the blocks' partials and the ticket (each = 1: the per-row check); -1 when
// that does not fit an int.
extern "C" int cpzk_ladder_scratch_words(int n, int each) {
  if (n < 1) return -1;
  const long tables = (long)n * (each ? cpzk::LADDER_EACH_WORDS : cpzk::LADDER_COMBINED_WORDS);
  const int threads = cpzk_block_threads(n);
  const long blocks = (n + threads - 1) / threads;
  const long words = each ? tables : tables + blocks * PT_WORDS + 4;
  return words > 0x7fffffffL ? -1 : (int)words;
}

// Each entry point launches on `stream` (a cudaStream_t), does not
// synchronise, and returns the first CUDA error of its work (0 = success).
// ptrs/lds: every point coordinate's pointer and row stride (4 a point, in
// the operands' order), steps: each point's column step (0 shared, 1 per
// lane), wins/wlds: the window arrays and their row strides.

// The combined check's lane chunk of n lanes: the chunk's total into out (4
// pointers, row stride out_ld) and its identity test into ok (one byte).
extern "C" int cpzk_ladder_combined(const void* const* ptrs, const long long* lds,
                                    const int* steps, const void* const* wins,
                                    const long long* wlds, void* scratch,
                                    void* const* out, const long long* out_ld, void* ok,
                                    int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  CombinedArgs a;
  for (int k = 0; k < 4; ++k) {
    a.pts[k] = point_operand(ptrs + 4 * k, lds + 4 * k, steps[k]);
    a.win[k] = LadderWin{(const int32_t*)wins[k], (long)wlds[k]};
    a.out[k] = (int32_t*)out[k];
  }
  a.out_ld = (long)*out_ld;
  a.ok = (uint8_t*)ok;
  const int threads = cpzk_block_threads(n);
  const int blocks = (n + threads - 1) / threads;
  a.tables = (uint32_t*)scratch;
  a.parts = a.tables + (long)n * cpzk::LADDER_COMBINED_WORDS;
  a.ticket = (unsigned*)(a.parts + (long)blocks * PT_WORDS);
  cudaError_t rc = cudaMemsetAsync(a.ticket, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  ladder_combined_kernel<<<blocks, threads, threads * PT_WORDS * sizeof(uint32_t),
                           (cudaStream_t)stream>>>(a, n);
  return (int)cudaGetLastError();
}

// The sum of k chunk totals ([20, k] x 4, ptrs/lds as above) == identity,
// into ok (one byte).
extern "C" int cpzk_ladder_partials_identity(const void* const* ptrs, const long long* lds,
                                             void* ok, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  ladder_partials_identity_kernel<<<1, kPartialsThreads, 0, (cudaStream_t)stream>>>(
      point_operand(ptrs, lds, 1), k, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

// The per-row checks of n lanes: one byte a lane into out (1: both
// equations hold).
extern "C" int cpzk_ladder_each(const void* const* ptrs, const long long* lds, const int* steps,
                                const void* const* wins, const long long* wlds, void* scratch,
                                void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  EachArgs a;
  for (int k = 0; k < 6; ++k) a.pts[k] = point_operand(ptrs + 4 * k, lds + 4 * k, steps[k]);
  for (int k = 0; k < 2; ++k) a.win[k] = LadderWin{(const int32_t*)wins[k], (long)wlds[k]};
  a.tables = (uint32_t*)scratch;
  a.out = (uint8_t*)out;
  const int threads = cpzk_block_threads(n);
  ladder_each_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(a, n);
  return (int)cudaGetLastError();
}
