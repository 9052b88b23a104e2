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
// [20, 1].  A lane runs on a quad of threads (ladder_w32.cuh's bodies): its
// tables go into a global scratch (2 KB a table), then the quad runs the
// 64-step ladder with the accumulator in every thread's registers.
//
// ladder_combined_kernel: four threads a lane; thread r builds term r's
// table, so the four build side by side.  After the ladders each block sums
// its quads' points by a tree of quad adds in shared memory; the blocks'
// sums are then summed in groups of as many as the block has quads, the
// last block of a group to arrive (an atomic ticket a group, zeroed by the
// entry point) summing its group into a partial of the next level, until
// one block holds the chunk's total and writes it as [20, 1] limbs with
// its identity test.  ladder_partials_identity: one block sums k chunk
// totals and tests the identity (one thread a total).  ladder_each: eight
// threads a lane, one quad an equation, run at once; the lane's bit is the
// AND of its quads'.  With g and h shared ([20, 1]) their tables are built
// once a block into shared memory, by two threads of the block's first
// lane while the lanes build their -Y tables; per lane, each lane builds
// all four.
//
// What bounds them (ops/ladder_kernels.py counts them): a lane of the
// combined check reads 2.3 KB and needs about 745k int32 operations (four
// tables of 14 cached adds, 64 doubling rounds of four and 256 cached
// adds), a lane of the per-row check 1.8 KB and about 1.0M, so both are
// bound by operations (0.27 and 0.25 ms at 6,144 and 4,096 lanes on 132
// SMs at 1980 MHz).  But a lane is a dependent chain of about 570 point
// operations (830 per row), and at the main path's widths (4,096 to
// 16,384 lanes) one thread a lane would leave about one warp on each of
// the card's 528 schedulers, and the time would be that chain's latency
// (the kernel at one lane, the chain floor), not the card's throughput.
// The quads cut
// the chain: a quad doubling round is two dependent field operations, a
// quad cached add two, where one thread runs seven and eight (in batches),
// and a quad's table entry is 32 bytes a thread, so the next step's entries
// are loaded while a step runs instead of each add waiting on a load whose
// address came from a window just read.  Four (eight) threads a lane also
// fill four (eight) times the warps: past about 8,000 lanes the kernels
// are issue-bound, and a quad's repeated linear work costs more issue a
// lane than one thread's would.  The step's rounds and terms stay loops, so
// its code stays in the instruction cache.  The tables' traffic (about 40
// KB a lane through L2) is under the operations bound.
// ladder_partials_identity reads 320 bytes a total and needs k - 1 adds:
// at the main path's k = 2 (a 16,384-row check) its bound is a fraction of
// a nanosecond, and its floor is the launch and the ceil(log2 k) dependent
// quad adds of its tree.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ladder_w32.cuh"

namespace {

using cpzk::Fe;
using cpzk::LadderPt;
using cpzk::LadderWin;
using cpzk::PT_WORDS;

// Threads a block: one warp (8 combined lanes, 4 per-row lanes).  A small
// launch spreads over the SMs, and the register file holds whole warps:
// blocks of up to 256 threads (point_ops.cu's cpzk_block_threads) left
// part of it empty (at 16,384 per-row lanes 224-thread blocks of 152
// registers fit one an SM) and ran 1.3x (per row) and 1.5x (combined) as
// long at that width on an H100, the same at the main path's (PERF.md,
// section 6).
constexpr int kThreads = 32;
// ladder_partials_identity: a quad a total, up to 32 quads
constexpr int kPartialsThreads = 4 * cpzk::LADDER_PARTIALS_QUADS;
// lanes a call at most (eight threads a lane stay within an int)
constexpr int kMaxLanes = 1 << 27;

struct CombinedArgs {
  LadderPt pts[4];   // r1, y1, r2, y2
  LadderWin win[4];  // a, a c, b a, b a c
  uint32_t* tables;  // n x LADDER_COMBINED_WORDS
  uint32_t* parts;   // the lane sum's partials, every level (ladder_reduce_points)
  unsigned* tickets;  // one a group of every level, zeroed
  int32_t* out[4];   // the chunk's total, column 0 of [20, *]
  long out_ld;
  uint8_t* ok;
};

struct EachArgs {
  LadderPt pts[6];   // g, h, y1, y2, r1, r2
  LadderWin win[2];  // s, c
  uint32_t* tables;  // n x LADDER_EACH_WORDS (LADDER_EACH_SHARED_WORDS when shared)
  uint8_t* out;      // [n]
  int shared;        // g and h shared: their tables in shared memory
};

// At most 128 registers (16 warps an SM; ptxas spills 128 bytes): on an
// H100 7% faster at 16,384 lanes than the 208 it takes unbounded, 3% at
// 6,144.
__global__ void __launch_bounds__(kThreads, 16)
ladder_combined_kernel(CombinedArgs a, int n) {
  extern __shared__ uint4 smem_vec[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem_vec);
  __shared__ bool last;
  const int tid = threadIdx.x, nq = blockDim.x >> 2, q = tid >> 2;
  const cpzk::Quad qd = cpzk::quad_of_thread(tid);
  const long j = (long)blockIdx.x * nq + q;
  uint32_t* tabs = a.tables + j * cpzk::LADDER_COMBINED_WORDS;
  Fe acc[4];
  if (j < n) cpzk::ladder_combined_tables(tabs, a.pts, j, qd);
  __syncwarp(qd.mask);
  if (j < n) {
    cpzk::ladder_combined_quad(acc, tabs, a.win, j, qd);
  } else {
    cpzk::pt_identity(acc);  // past the ragged end: the identity
  }
  if (qd.r == 0) cpzk::pt_store_words(s + q * PT_WORDS, acc);
  __syncthreads();
  for (int h = cpzk::msm_tree_top(nq) >> 1; h >= 1; h >>= 1) {
    cpzk::msm_tree_level(acc, s, q, h, nq, qd);
    __syncthreads();
  }
  // the blocks' sums in groups of nq a level (each partial's store fenced
  // before its ticket)
  uint32_t* level = a.parts;
  unsigned* tickets = a.tickets;
  long idx = blockIdx.x;
  for (long count = gridDim.x; count > 1;) {
    if (tid == 0) cpzk::pt_store_words(level + idx * PT_WORDS, acc);
    __threadfence();
    __syncthreads();
    const long group = idx / nq, groups = (count + nq - 1) / nq;
    const int size = (int)(count - group * nq < nq ? count - group * nq : nq);
    if (tid == 0) last = atomicAdd(tickets + group, 1u) == (unsigned)(size - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    cpzk::ladder_group_load(acc, level, group * nq, size, q);
    if (qd.r == 0) cpzk::pt_store_words(s + q * PT_WORDS, acc);
    __syncthreads();
    for (int h = cpzk::msm_tree_top(size) >> 1; h >= 1; h >>= 1) {
      cpzk::msm_tree_level(acc, s, q, h, size, qd);
      __syncthreads();
    }
    level += count * PT_WORDS;
    tickets += groups;
    idx = group;
    count = groups;
  }
  if (tid == 0) cpzk::ladder_finish(a.out, a.out_ld, a.ok, acc);
}

// One block of whole warps, a quad a total up to LADDER_PARTIALS_QUADS
// (ladder_w32.cuh): a quad a column, the levels that cross warps in shared
// memory, the last three in warp 0 by shuffles, the identity test where
// the total ends (quad 0).
__global__ void __launch_bounds__(kPartialsThreads)
ladder_partials_identity_kernel(LadderPt parts, int k, uint8_t* ok) {
  __shared__ uint4 s_vec[cpzk::LADDER_PARTIALS_QUADS * PT_WORDS / 4];
  uint32_t* s = reinterpret_cast<uint32_t*>(s_vec);
  const int tid = threadIdx.x, q = tid >> 2, nq = cpzk::ladder_partials_quads(k);
  const cpzk::Quad qd = cpzk::quad_of_thread(tid);
  Fe acc[4];
  cpzk::ladder_partials_load(acc, parts, k, q, nq, qd);
  int h = cpzk::msm_tree_top(nq) >> 1;
  if (h >= cpzk::LADDER_WARP_QUADS) {
    if (qd.r == 0) cpzk::pt_store_words(s + q * PT_WORDS, acc);
    __syncthreads();
    for (; h >= cpzk::LADDER_WARP_QUADS; h >>= 1) {
      cpzk::msm_tree_level(acc, s, q, h, nq, qd);
      __syncthreads();
    }
  }
  if (tid >= 32) return;
  for (; h >= 1; h >>= 1) {
    Fe y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int w = 0; w < cpzk::NW; ++w) y[c].w[w] = __shfl_down_sync(~0u, acc[c].w[w], 4 * h);
    }
    cpzk::ladder_partials_level(acc, y, q, h, nq, qd);
  }
  if (tid == 0) *ok = (uint8_t)cpzk::ladder_is_identity(acc);
}

__global__ void __launch_bounds__(kThreads, 1)
ladder_each_kernel(EachArgs a, int n) {
  extern __shared__ uint4 gh_vec[];
  uint32_t* gh = reinterpret_cast<uint32_t*>(gh_vec);
  const int tid = threadIdx.x, l = tid >> 3, e = (tid >> 2) & 1;
  const cpzk::Quad qd = cpzk::quad_of_thread(tid);
  const long j = (long)blockIdx.x * (blockDim.x >> 3) + l;
  const bool shared = a.shared != 0;
  uint32_t* tabs =
      a.tables + j * (shared ? cpzk::LADDER_EACH_SHARED_WORDS : cpzk::LADDER_EACH_WORDS);
  if (j < n) cpzk::ladder_each_tables(tabs, gh, a.pts, j, l, e, shared, qd);
  if (shared) {
    __syncthreads();
  } else {
    __syncwarp(qd.mask);
  }
  if (j >= n) return;
  uint32_t ok = cpzk::ladder_each_quad(tabs, gh, a.pts, a.win, j, e, shared, qd);
  ok &= __shfl_xor_sync(0xFFu << (tid & 24), ok, 4);  // the lane's other quad
  if ((tid & 7) == 0) a.out[j] = (uint8_t)ok;
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

// The combined check's launch for n lanes: blocks, and the lane sum's
// partials and tickets.
struct CombinedShape {
  long blocks, points, tickets;
};

CombinedShape combined_shape(int n) {
  CombinedShape c;
  c.blocks = (4L * n + kThreads - 1) / kThreads;
  c.points = cpzk::ladder_reduce_points(c.blocks, kThreads / 4, &c.tickets);
  return c;
}

constexpr int kGeneratorTableBytes = 2 * cpzk::LADDER_TABLE_WORDS * sizeof(uint32_t);

}  // namespace

// Scratch words of an n-lane call: the tables, and for the combined check
// (each = 0) the lane sum's partials and tickets; a per-row check (each =
// 1) with g and h shared (shared_generators = 1) keeps only the -Y tables
// there.  -1 when that does not fit an int.
extern "C" int cpzk_ladder_scratch_words(int n, int each, int shared_generators) {
  if (n < 1 || n > kMaxLanes) return -1;
  long words;
  if (each) {
    words = (long)n * (shared_generators ? cpzk::LADDER_EACH_SHARED_WORDS
                                         : cpzk::LADDER_EACH_WORDS);
  } else {
    const CombinedShape c = combined_shape(n);
    words = (long)n * cpzk::LADDER_COMBINED_WORDS + c.points * PT_WORDS + c.tickets;
  }
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
  if (n < 1 || n > kMaxLanes) return (int)cudaErrorInvalidValue;
  CombinedArgs a;
  for (int k = 0; k < 4; ++k) {
    a.pts[k] = point_operand(ptrs + 4 * k, lds + 4 * k, steps[k]);
    a.win[k] = LadderWin{(const int32_t*)wins[k], (long)wlds[k]};
    a.out[k] = (int32_t*)out[k];
  }
  a.out_ld = (long)*out_ld;
  a.ok = (uint8_t*)ok;
  const CombinedShape c = combined_shape(n);
  a.tables = (uint32_t*)scratch;
  a.parts = a.tables + (long)n * cpzk::LADDER_COMBINED_WORDS;
  a.tickets = (unsigned*)(a.parts + c.points * PT_WORDS);
  if (c.tickets > 0) {
    cudaError_t rc = cudaMemsetAsync(a.tickets, 0, c.tickets * sizeof(unsigned),
                                     (cudaStream_t)stream);
    if (rc != cudaSuccess) return (int)rc;
  }
  const size_t smem = kThreads / 4 * PT_WORDS * sizeof(uint32_t);
  ladder_combined_kernel<<<(unsigned)c.blocks, kThreads, smem, (cudaStream_t)stream>>>(a, n);
  return (int)cudaGetLastError();
}

// The sum of k chunk totals ([20, k] x 4, ptrs/lds as above) == identity,
// into ok (one byte).
extern "C" int cpzk_ladder_partials_identity(const void* const* ptrs, const long long* lds,
                                             void* ok, int k, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  ladder_partials_identity_kernel<<<1, cpzk::ladder_partials_threads(k), 0,
                                    (cudaStream_t)stream>>>(
      point_operand(ptrs, lds, 1), k, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

// The per-row checks of n lanes: one byte a lane into out (1: both
// equations hold).  g and h (the first two points) are shared when both
// steps are 0; the scratch is cpzk_ladder_scratch_words(n, 1, shared).
extern "C" int cpzk_ladder_each(const void* const* ptrs, const long long* lds, const int* steps,
                                const void* const* wins, const long long* wlds, void* scratch,
                                void* out, int n, void* stream) {
  if (n < 1 || n > kMaxLanes) return (int)cudaErrorInvalidValue;
  EachArgs a;
  for (int k = 0; k < 6; ++k) a.pts[k] = point_operand(ptrs + 4 * k, lds + 4 * k, steps[k]);
  for (int k = 0; k < 2; ++k) a.win[k] = LadderWin{(const int32_t*)wins[k], (long)wlds[k]};
  a.tables = (uint32_t*)scratch;
  a.out = (uint8_t*)out;
  a.shared = steps[0] == 0 && steps[1] == 0;
  ladder_each_kernel<<<(8 * n + kThreads - 1) / kThreads, kThreads,
                       a.shared ? kGeneratorTableBytes : 0, (cudaStream_t)stream>>>(a, n);
  return (int)cudaGetLastError();
}
