// Hopper tick kernel: one whole Raft tick for B clusters, node-parallel, over
// the phase functions of tick.cuh.
//
// Replaces the repository's one TPU kernel, raft_sim_tpu/experiments/
// pallas_engine.py `step_pallas` (its pl.pallas_call fuses raft_batched.step_b
// + _step_info_b over blocks of clusters held in VMEM).
//
// Thread mapping. A block holds `tc` consecutive clusters x `s` node slots:
// thread t owns cluster t % tc of the block and the nodes slot, slot + s
// (slot = t / tc), NPT = ceil(N / s) of them, 1 or 2 (a template parameter,
// so each node's NodeCtx sits in registers with compile-time indices). With
// tc = 32 a warp is 32 consecutive clusters of one node slot; with tc = 16, 8
// or 4 it is 2, 4 or 8 runs of 16, 8 or 4; every [.., B] leaf access by a
// warp stays runs of consecutive addresses, as the layout is batch-minor.
// s = N for N <= 32, else 16 x the width tier (below) with two nodes a
// thread: 32 for N <= 64, 64 for N <= 128, 128 above (node slot, then slot +
// s, so a warp is on one node at a time). The wrapper (kernels/tick_engine.py
// `block_shape`) picks tc from N and B: 32 while s <= 16, 16 at s = 32 (at
// most 512 threads a block), each halved down to 8 while that gives fewer
// than two blocks per SM; 8 at s = 64 and 4 at s = 128 (512 threads, and an
// exchange of 119,168 bytes at N = 255 where 8 clusters would pass the
// 232,448 a block may have). A smaller tc would fill more SMs at config7
// and config7x but doubles the memory sectors a warp's per-edge reads touch,
// which is what bounds the wide tiers (block_shape's note).
//
// Width tiers. Packed rows (votes, deliver mask, member rows, grant rows)
// are MW = 2, 4 or 8 words in registers and in the exchange, a template
// parameter chosen from N (tick.cuh `width_for`): the narrow bodies keep the
// registers they had before the wider tiers came, and a node's bit is picked
// by comparing word indices, never by a runtime index into a register array.
// Node ids are int8 up to 126 nodes and int16 above (types.node_dtype).
// Intermediates one node
// writes and another reads in a later phase, and the per-cluster
// accumulators, live in dynamic shared memory (tick.cuh `Xch`,
// `smem_bytes`); a __syncthreads() ends each of the seven phases, and every
// thread reaches every barrier (a thread past the ragged batch edge, or
// whose second node slot is >= N, skips the work only). Log matching reads
// the max-commit node's output log rows (prefix layout) or, on the ring,
// every higher-id partner's output rows, commit, base and base checksum,
// which their own threads of the same block wrote before the last barriers.
// The ring form is O(N^2 x CAP) a cluster on the ticks it is due (10 pairs x
// 32 slots = 320 slot visits a cluster at config6; 5,050 x 16 = 80,800 at
// N=101 and CAP=16); `log_matching_interval` spaces it out.
//
// What bounds it on an H100: memory, at 100,000 clusters -- the tick is
// integer compare/select work against the leaves it must read once and write
// once. Per cluster (kernels/tick_engine.traffic_bytes), bytes read /
// written: config3 (N=5, CAP=32) 2,087 / 2,080; config5 (N=51) 26,787 /
// 25,564; config8 6,389 / 6,402. 100,000 config3 clusters move 0.42 GB per
// tick, 0.124 ms at 3.35 TB/s. At 1,000 and 10,000 clusters the bound is
// micro-seconds and the kernel is latency-bound: the length of one worker's
// dependency chain and the number of blocks in flight decide its time. The
// first design ran one thread per cluster over every node in turn: ~30
// [MAXN] arrays indexed by a runtime node, so 19 KB of stack a thread in
// local memory, O(N^2) serial steps a phase at N=51, and 8 blocks at 1,000
// clusters. This one keeps a node's state in registers, makes each worker's
// chain O(N) (O(N^2) only for a leader's quorum match and the redirect
// slots), and runs N times the threads: 5,000 at N=5 x 1,000 clusters in
// 125 blocks, 320,000 at N=51 x 10,000 in 625 blocks. Each node's mailbox
// header is staged once in shared memory (phase 0), so the per-sender loops
// of every node read it there. The body is instantiated for the lean gate
// set (config1-config5, config3p) with the other gates compile-time off: 63
// registers a thread instead of 108, so an SM holds twice the clusters.
// Not yet done (later work): drawing the threefry inputs inside the kernel
// instead of reading them, and a CUDA graph over ticks.
//
// The wide tiers (N > 32, two nodes a thread; the lean body's kernel is
// `wide_tick_kernel`). The phase clock (below) split their time: phase 1
// takes 66-71% of a block's cycles at config5, config7 and config7x, phase
// 4 28-30%, and a leader's
// O(N^2) quorum walk only 6.5-10% of its block's phase 1. What bounds them
// is latency: each loop over a node's N edges read a per-edge leaf and
// stored an output row an edge at a time, so every edge waited a trip to
// memory (a block's phase 1 at config7x is ~5,000 cycles a node-edge). The
// wide forms of the lean body (tick.cuh `RS_WIDE_FORMS`: NPT == 2, FULL ==
// 0 -- config5, config7, config7x; the N <= 32 bodies keep their code, the
// full and mutant ones their loops): the edge loops read EDGE_BATCH edges'
// leaves together before using them, and the leader's commit comes from a
// histogram folded as the responder loop writes the row (tick.cuh `QHist`:
// O(N + 16), exact, the walk only when a majority lies above the window).
// The lean wide body takes a minimum of one 512-thread block an SM at
// widths 4 and 8, so up to 128 registers, where ptxas had held it at 64
// and spilled; at width 2 (config5) it takes two, which runs faster there,
// and keeps its spills. What bounds them after that is the memory sectors
// of their per-edge reads: a warp is tc clusters x 32 / tc node slots, so
// each read touches 32 / tc rows for tc bytes each.
//
// Build (kernels/tick_engine.py does this at first use): this file is
// compiled once per (index dtype tier, width tier), the nine nvcc runs in
// parallel,
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
//        -c -DRS_IDX_BYTES=1|2|4 -DRS_WIDTH=2|4|8 -o tick_i<k>_w<w>.o tick.cu
// and the objects are linked into one shared library (nvcc -shared). Each
// object holds its pair's (ack dtype, node dtype, nodes per thread, body)
// instantiations -- twelve at width 2 and 4, six at width 8, two thirds of
// that in the int32 tier (full and mutant bodies only) -- and
// `rs_tick_launch_i<k>_w<w>`; the (1, 2) object also holds the entry points
// `rs_tick_launch`, `rs_tick_n_ptr`, `rs_tick_smem_bytes`, `rs_tick_lean`
// and `rs_tick_body` (which body a launch runs, for the wrapper's report).
//
// The race proxy (-DRS_RACE_PROXY, a library of its own that chip_smoke.py
// and tests/test_torch_cuda.py build; never the main path): node slots and
// clusters-in-tile map to threads in reverse, and before each phase's node
// part a node poisons its exchange fields whose last reader's phase is over
// (tick.cuh `poison_fields`), so a read that depends on the thread order or
// outlives the barrier schedule shows as a difference from the plain tick.
//
// The phase clock (-DRS_PHASE_CLOCK, a library of its own that
// kernel_times.py --phases builds; never the main path): at each barrier
// thread 0 of a block adds the block's clock64() cycles since the last one
// to that phase's counter, and each live leader adds the cycles of its
// quorum order statistic to one more (`rs_tick_phase_clock` reads them,
// tick_engine.phase_split prints the shares).
#include <cuda_runtime.h>

#ifdef RS_PHASE_CLOCK
// The phase clock's counters, one set per object (each object is its own
// module without relocatable device code, so `rs_tick_phase_clock` sums the
// nine): block-cycles of phases 0-6 (thread 0 of each block, barrier to
// barrier), then the cycles leaders spend in the quorum order statistic,
// its calls, and the blocks run.
namespace rs_clock {
constexpr int SLOTS = 10, QUORUM = 7, QUORUM_CALLS = 8, BLOCKS = 9;
__device__ unsigned long long cycles[SLOTS];
}  // namespace rs_clock
#ifdef __CUDA_ARCH__
#define RS_QUORUM_TIMED(...)                                                    \
  {                                                                             \
    const long long q0_ = clock64();                                            \
    __VA_ARGS__;                                                                \
    atomicAdd(&rs_clock::cycles[rs_clock::QUORUM], (unsigned long long)(clock64() - q0_)); \
    atomicAdd(&rs_clock::cycles[rs_clock::QUORUM_CALLS], 1ull);                 \
  }
#endif
#endif

#include "tick.cuh"

#ifndef RS_IDX_BYTES
#error "compile once per index tier: -DRS_IDX_BYTES=1, 2 or 4"
#endif
#if RS_IDX_BYTES == 1
typedef int8_t TierIdx;
#elif RS_IDX_BYTES == 2
typedef int16_t TierIdx;
#elif RS_IDX_BYTES == 4
typedef int32_t TierIdx;
#else
#error "RS_IDX_BYTES must be 1, 2 or 4"
#endif
#if !defined(RS_WIDTH) || (RS_WIDTH != 2 && RS_WIDTH != 4 && RS_WIDTH != 8)
#error "compile once per width tier: -DRS_WIDTH=2, 4 or 8"
#endif

#define RS_CAT4(a, b, c, d) a##b##c##d
#define RS_LAUNCH_NAME(k, w) RS_CAT4(rs_tick_launch_i, k, _w, w)
#define RS_PART_LAUNCH RS_LAUNCH_NAME(RS_IDX_BYTES, RS_WIDTH)
#define RS_CLOCK_NAME(k, w) RS_CAT4(rs_tick_phase_clock_i, k, _w, w)

struct LaunchShape {
  unsigned grid;
  int tc, s, npt, smem;
};

#define RS_DECLARE_PART(k, w)                                                          \
  extern "C" int RS_LAUNCH_NAME(k, w)(const rs::TickArgs*, int, int, const LaunchShape*, \
                                      cudaStream_t);
RS_DECLARE_PART(1, 2)
RS_DECLARE_PART(1, 4)
RS_DECLARE_PART(1, 8)
RS_DECLARE_PART(2, 2)
RS_DECLARE_PART(2, 4)
RS_DECLARE_PART(2, 8)
RS_DECLARE_PART(4, 2)
RS_DECLARE_PART(4, 4)
RS_DECLARE_PART(4, 8)
#undef RS_DECLARE_PART
#ifdef RS_PHASE_CLOCK
#define RS_DECLARE_CLOCK(k, w) extern "C" int RS_CLOCK_NAME(k, w)(unsigned long long*, int);
RS_DECLARE_CLOCK(1, 2)
RS_DECLARE_CLOCK(1, 4)
RS_DECLARE_CLOCK(1, 8)
RS_DECLARE_CLOCK(2, 2)
RS_DECLARE_CLOCK(2, 4)
RS_DECLARE_CLOCK(2, 8)
RS_DECLARE_CLOCK(4, 2)
RS_DECLARE_CLOCK(4, 4)
RS_DECLARE_CLOCK(4, 8)
#undef RS_DECLARE_CLOCK
#endif

namespace {

constexpr int MW = RS_WIDTH;

// Phase PH for this thread: its nodes, then (node slot 0) its cluster. The
// race proxy poisons each node's exchange fields whose readers are done first.
template <class I, class A, class N, int NPT, int FULL, int PH>
__device__ __forceinline__ void run_phase(const rs::TickArgs& a, rs::NodeCtx<MW>* x,
                                          const rs::Xch<MW>& X, int64_t b, int ci, int slot,
                                          int s) {
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int i = slot + k * s;
    if (i < a.p.n) {
#ifdef RS_RACE_PROXY
      rs::poison_fields<MW, PH>(X, ci, i);
#endif
      rs::node_phase<I, A, N, MW, FULL, PH, NPT>(a.p, a.ptr, x[k], X, b, ci, i);
    }
  }
  if (slot == 0) rs::cluster_phase<MW, FULL, PH>(a.p, a.ptr, X, b, ci);
}

// The race proxy: node slots and clusters-in-tile to threads in reverse.
#ifdef RS_RACE_PROXY
#define RS_THREAD_MAP const int ci = tc - 1 - t % tc, slot = s - 1 - t / tc;
#else
#define RS_THREAD_MAP const int ci = t % tc, slot = t / tc;
#endif
#ifdef RS_PHASE_CLOCK
// Thread 0 adds the block's cycles since the last barrier to phase PH's
// counter once every thread has passed PH's barrier.
#define RS_CLOCK_START long long clk = clock64();
#define RS_CLOCK(PH)                                                           \
  if (t == 0) {                                                                \
    const long long c = clock64();                                             \
    atomicAdd(&rs_clock::cycles[PH], (unsigned long long)(c - clk));           \
    clk = c;                                                                   \
  }
#define RS_CLOCK_END \
  __syncthreads();   \
  RS_CLOCK(6)        \
  if (t == 0) atomicAdd(&rs_clock::cycles[rs_clock::BLOCKS], 1ull);
#else
#define RS_CLOCK_START
#define RS_CLOCK(PH)
#define RS_CLOCK_END
#endif
#define RS_PHASE(PH) \
  if (live) run_phase<I, A, N, NPT, FULL, PH>(a, x, X, b, ci, slot, s)
// One block's tick: the seven phases between barriers.
#define RS_TICK_BODY                                                                   \
  static_assert(W == MW, "one width tier an object");                                  \
  extern __shared__ int32_t smem[];                                                    \
  const int t = threadIdx.x;                                                           \
  RS_THREAD_MAP                                                                        \
  const int64_t b = (int64_t)blockIdx.x * tc + ci;                                     \
  const bool live = b < a.p.b; /* ragged edge masked; every barrier still reached */   \
  const rs::Xch<MW> X{smem, a.p.n, tc};                                                \
  rs::NodeCtx<MW> x[NPT];                                                              \
  RS_CLOCK_START                                                                       \
  RS_PHASE(0);                                                                         \
  __syncthreads();                                                                     \
  RS_CLOCK(0)                                                                          \
  RS_PHASE(1);                                                                         \
  __syncthreads();                                                                     \
  RS_CLOCK(1)                                                                          \
  RS_PHASE(2);                                                                         \
  __syncthreads();                                                                     \
  RS_CLOCK(2)                                                                          \
  RS_PHASE(3);                                                                         \
  __syncthreads();                                                                     \
  RS_CLOCK(3)                                                                          \
  RS_PHASE(4);                                                                         \
  __syncthreads();                                                                     \
  RS_CLOCK(4)                                                                          \
  RS_PHASE(5);                                                                         \
  __syncthreads();                                                                     \
  RS_CLOCK(5)                                                                          \
  RS_PHASE(6);                                                                         \
  RS_CLOCK_END

// One node a thread (N <= 32): up to 512 threads, and ptxas free to keep
// two blocks an SM (the lean body's 63 registers).
template <class I, class A, class N, int W, int NPT, int FULL>
__global__ void __launch_bounds__(rs::MAX_THREADS) tick_kernel(const rs::TickArgs a, int tc, int s) {
  RS_TICK_BODY
}

// The lean body at two nodes a thread (N > 32: config5, config7, config7x),
// with a minimum of blocks an SM. Without one ptxas held it at 64 registers
// (two 512-thread blocks an SM) and spilled 240-268 B a thread. One block
// an SM at widths 4 and 8 lets it keep both NodeCtx in up to 128
// registers: config7's and config7x's bodies (one wave of the card) run 8%
// and 6% faster so, with 0 B of spills. config5's (width 2, 10,000
// clusters, five waves) runs 13% faster at two blocks an SM though it
// spills, as latency wants warps more than registers there, so it keeps
// two (PERF.md §6). The full and mutant bodies at two nodes a thread run
// `tick_kernel` above, as before.
template <class I, class A, class N, int W, int NPT, int FULL>
__global__ void __launch_bounds__(rs::MAX_THREADS, W == 2 ? 2 : 1)
    wide_tick_kernel(const rs::TickArgs a, int tc, int s) {
  RS_TICK_BODY
}
#undef RS_TICK_BODY
#undef RS_PHASE
#undef RS_CLOCK_END
#undef RS_CLOCK
#undef RS_CLOCK_START
#undef RS_THREAD_MAP

int launch_kernel(void (*kern)(const rs::TickArgs, int, int), const rs::TickArgs* args,
                  const LaunchShape* sh, cudaStream_t st) {
  if (sh->smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sh->smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<sh->grid, sh->tc * sh->s, sh->smem, st>>>(*args, sh->tc, sh->s);
  return 0;
}

template <class A, class N, int NPT, int FULL>
int launch(const rs::TickArgs* args, const LaunchShape* sh, cudaStream_t st) {
  if constexpr (NPT == 1 || FULL != 0)
    return launch_kernel(tick_kernel<TierIdx, A, N, MW, NPT, FULL>, args, sh, st);
  else
    return launch_kernel(wide_tick_kernel<TierIdx, A, N, MW, NPT, FULL>, args, sh, st);
}

// The body for the config's gate set (tick.cuh `body_for`): lean (the gates
// of config1-config5, config3p and config7, FULL = 0), every gate (1), or
// every gate with the TEST-ONLY mutant hooks read from the parameters (2).
// The int32 index tier comes only with compaction, outside the lean set, so
// its objects hold the full and mutant bodies alone.
template <class A, class N, int NPT>
int launch_gates(const rs::TickArgs* args, const LaunchShape* sh, cudaStream_t st) {
  const int body = rs::body_for(args->p);
#if RS_IDX_BYTES != 4
  if (body == 0) return launch<A, N, NPT, 0>(args, sh, st);
#endif
  if (body == 2) return launch<A, N, NPT, 2>(args, sh, st);
  return launch<A, N, NPT, 1>(args, sh, st);
}

// Nodes a thread: 1 or 2 at the narrow width tier (N <= 32 or not); above it
// always 2 (block_shape's slots are half the tier's node range).
template <class A, class N>
int launch_npt(const rs::TickArgs* args, const LaunchShape* sh, cudaStream_t st) {
#if RS_WIDTH == 2
  if (sh->npt == 1) return launch_gates<A, N, 1>(args, sh, st);
#endif
  if (sh->npt == 2) return launch_gates<A, N, 2>(args, sh, st);
  return 99;
}

template <class N>
int launch_ack(const rs::TickArgs* args, int ack_bytes, const LaunchShape* sh, cudaStream_t st) {
  if (ack_bytes == 1) return launch_npt<int8_t, N>(args, sh, st);
  if (ack_bytes == 2) return launch_npt<int16_t, N>(args, sh, st);
  return 99;
}

}  // namespace

// This (index tier, width tier)'s instantiations: (ack dtype, node dtype,
// nodes a thread, gate set); 99 for a combination none takes. Node ids are
// int8 up to 126 nodes and int16 above (types.node_dtype): width tier 2 (N <=
// 64) takes int8 only, 4 (N <= 128) both, 8 (N >= 129) int16 only.
extern "C" int RS_PART_LAUNCH(const rs::TickArgs* args, int ack_bytes, int node_bytes,
                              const LaunchShape* sh, cudaStream_t st) {
#if RS_WIDTH != 8
  if (node_bytes == 1) return launch_ack<int8_t>(args, ack_bytes, sh, st);
#endif
#if RS_WIDTH != 2
  if (node_bytes == 2) return launch_ack<int16_t>(args, ack_bytes, sh, st);
#endif
  return 99;
}

#ifdef RS_PHASE_CLOCK
// This object's phase-clock counters into `out` (rs_clock::SLOTS values,
// added to what it holds), zeroed after with `reset`; a CUDA error code.
extern "C" int RS_CLOCK_NAME(RS_IDX_BYTES, RS_WIDTH)(unsigned long long* out, int reset) {
  unsigned long long got[rs_clock::SLOTS];
  cudaError_t e = cudaMemcpyFromSymbol(got, rs_clock::cycles, sizeof(got));
  if (e != cudaSuccess) return (int)e;
  for (int k = 0; k < rs_clock::SLOTS; ++k) out[k] += got[k];
  if (reset) {
    for (int k = 0; k < rs_clock::SLOTS; ++k) got[k] = 0ull;
    e = cudaMemcpyToSymbol(rs_clock::cycles, got, sizeof(got));
  }
  return (int)e;
}
#endif

#if RS_IDX_BYTES == 1 && RS_WIDTH == 2
#ifdef RS_PHASE_CLOCK
// The phase clock summed over the nine objects (each its own module).
extern "C" int rs_tick_phase_clock(unsigned long long* out, int reset) {
  for (int k = 0; k < rs_clock::SLOTS; ++k) out[k] = 0ull;
  int rc = 0;
#define RS_SUM(k, w) \
  if (!rc) rc = RS_CLOCK_NAME(k, w)(out, reset);
  RS_SUM(1, 2) RS_SUM(1, 4) RS_SUM(1, 8)
  RS_SUM(2, 2) RS_SUM(2, 4) RS_SUM(2, 8)
  RS_SUM(4, 2) RS_SUM(4, 4) RS_SUM(4, 8)
#undef RS_SUM
  return rc;
}
extern "C" int rs_tick_clock_slots() { return rs_clock::SLOTS; }
#endif

// Launches one tick on `stream` with blocks of `tc` clusters x `s` node
// slots; returns cudaGetLastError() (0 = launched), or 100+ / 99 for shapes,
// block shapes or dtype tiers this kernel does not take.
extern "C" int rs_tick_launch(const rs::TickParams* p, void* const* ptrs, int idx_bytes,
                              int ack_bytes, int node_bytes, int tc, int s, void* stream) {
  const int bad = rs::check_params(*p);
  if (bad) return 100 + bad;
  if (tc < 1 || s < 1 || tc * s > rs::MAX_THREADS) return 120;
  LaunchShape sh;
  sh.tc = tc;
  sh.s = s;
  sh.npt = (p->n + s - 1) / s;
  if (sh.npt > 2) return 121;
  const int64_t smem = rs::smem_bytes(p->n, tc);
  if (smem > 232448) return 122;  // the most a block may have on Hopper
  sh.smem = (int)smem;
  if (p->b == 0) return 0;
  sh.grid = (unsigned)((p->b + tc - 1) / tc);
  rs::TickArgs args;
  args.p = *p;
  for (int k = 0; k < rs::N_PTR; ++k) args.ptr[k] = ptrs[k];
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 99;
  const int w = rs::width_for(p->n);
#define RS_TRY(k, w_)                                                   \
  if (idx_bytes == k && w == w_)                                         \
    rc = RS_LAUNCH_NAME(k, w_)(&args, ack_bytes, node_bytes, &sh, st);
  RS_TRY(1, 2) RS_TRY(1, 4) RS_TRY(1, 8)
  RS_TRY(2, 2) RS_TRY(2, 4) RS_TRY(2, 8)
  RS_TRY(4, 2) RS_TRY(4, 4) RS_TRY(4, 8)
#undef RS_TRY
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" int rs_tick_n_ptr() { return rs::N_PTR; }
extern "C" long long rs_tick_smem_bytes(int n, int tc) { return rs::smem_bytes(n, tc); }
extern "C" int rs_tick_lean(const rs::TickParams* p) { return rs::lean_gates(*p); }
extern "C" int rs_tick_body(const rs::TickParams* p) { return rs::body_for(*p); }
#endif
