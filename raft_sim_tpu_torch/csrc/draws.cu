// Hopper draw kernel (K2): the tick's input draws -- threefry and
// `make_inputs` -- for every (tick, cluster) row of a launch, one thread per
// (row, node), over the body of draws.cuh.
//
// Replaces no TPU kernel: on the TPU, XLA fuses `jax.vmap(faults.make_inputs)`
// (raft_sim_tpu/sim/faults.py:302) into the scan program beside the tick, and
// the JAX package wrote no Pallas kernel for it. The port drew the same
// streams in plain torch, 1,400-6,200 small launches a tick (sim/faults.py over
// utils/threefry.py); this kernel is the port's counterpart of XLA's fused
// program: one launch a tick, or one a span of ticks (`draw_span`).
//
// What bounds it on an H100: integer ALU work. Every draw is a threefry2x32
// block -- 20 rounds of add, rotate (one funnel shift) and xor, five key
// injections. Its SASS in the drop loop is 69 instructions, 42 of them
// (rotates, xors, compares) for the ALU pipe alone, 4 x 16 lanes an SM a
// clock; the adds may also go to the FMA pipe (IMAD.IADD), and the SM issues
// 4 x 32 lanes a clock in all (kernels/draw_engine.sass_block_ops reads the
// counts from the build, bound_ms prices a block at the slower of the two).
// It reads 16 B of key a cluster and writes 119 B a cluster at N=5, 12 KB at
// N=255 (draw_engine.threefry_blocks and traffic_bytes count both). At
// config3's 100,000 clusters that is 15 blocks and 135 B a cluster: 3.8 us
// of ALU work at 1,980 MHz against 4 us of bytes, so at that size the kernel
// is launch-latency-bound. No tensor core, TMA or wgmma applies.
//
// Design. A block is a tile of rt consecutive rows x the N nodes of each
// (draws.cuh `tile_rows`: 32 rows at N <= 16, 8 at N = 51, 4 at N = 101, 2
// at N = 255, at most 512 threads): thread t is row t % rt and node t / rt,
// so a warp's stores are runs of rt consecutive rows of one node in the
// batch-minor layout the tick kernel reads. A thread derives its row's keys
// itself (6-9 blocks) rather than share them: the recomputation costs less
// than staging them would. What it shares is a partition window's side
// bits: drawn by every thread of a row they would be N^2 blocks a row (and
// node 0's cut counts twice N more) -- at config5, which drops nothing, most
// of the kernel's threefry work. So each thread
// draws its own node's side bit once and stages it as a byte in shared
// memory (and, with the facts, its bit of the tick before's window when
// that is another window), one barrier, then each thread packs the row's
// bytes into words for its delivery row and node 0 counts the cut edges
// (2 x n1 x (N - n1)) from the same words. The heaviest row is N = 255
// (config7x): each thread draws its 255 drop bits and one side bit, 65,280
// blocks a cluster where it drew 130,050. Threads past the ragged edge
// reach the barrier and draw nothing.
//
// The race proxy (-DRS_RACE_PROXY, a library of its own that chip_smoke.py
// builds; never the main path): rows and nodes map to threads in reverse,
// and every staged byte is poisoned (behind a barrier of its own) before
// the stage phase, so a read of a byte no thread staged this launch, or one
// a missing barrier lets run early, shows as a difference from the plain
// draws. The CPU build (draws_host.cpp) runs the stage phase and the draw
// phase of a tile in both worker orders, the staging poisoned before each.
//
// Later work (ROADMAP): drawing inside the tick kernel's prologue (no round
// trip through memory), folding the run metrics in place, and many ticks a
// launch.
//
// Build (kernels/draw_engine.py does this at first use; chip_smoke.py starts
// it, and the race proxy's, beside the tick kernel's nine objects):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
//        -Xptxas -v [-DRS_RACE_PROXY] -shared -o libdraws_<hash>.so draws.cu
#include <cuda_runtime.h>

#include "draws.cuh"

namespace {

// A block is a tile of `rt` consecutive rows x the N nodes of each
// (rd::tile_rows): thread t is row t % rt of the tile and node t / rt. The
// race proxy (RS_RACE_PROXY) maps both in reverse and poisons the staging
// before the stage phase, behind a barrier of its own, so a read of a byte
// no worker staged, or one that a missing barrier lets run early, shows.
__global__ void __launch_bounds__(rd::MAX_THREADS) draws_kernel(const rd::DrawArgs a, int rt) {
  extern __shared__ uint8_t stage_mem[];
  const int t = threadIdx.x, n = a.p.n;
  const rd::Stage st{stage_mem, rt, rd::stage_stride(n)};
#ifdef RS_RACE_PROXY
  const int local = rt - 1 - t % rt, i = n - 1 - t / rt;
  for (int64_t k = t; k < rd::stage_bytes(n, rt); k += blockDim.x) stage_mem[k] = rd::POISON;
  __syncthreads();
#else
  const int local = t % rt, i = t / rt;
#endif
  const int64_t r = (int64_t)blockIdx.x * rt + local;
  const bool live = r < a.p.rows;  // ragged edge masked; every barrier still reached
  rd::RowCtx x;
  if (live) rd::stage_node(a, st, r, local, i, x);
  __syncthreads();
  if (live) rd::draw_node(a, st, r, local, i, x);
}

// A launch no row of which can be partitioned (the scalar path without a
// partition) stages nothing: a flat grid of FLAT_THREADS-thread blocks,
// thread g node g / rows of row g % rows, so a warp is 32 consecutive rows
// of one node and its stores are 32-row runs, with no barrier. The tile
// above would cut those runs to rt rows (K2 at config3 0.0365 ms against
// 0.0329, config7 0.0562 against 0.0490; PERF.md).
constexpr int FLAT_THREADS = 256;

__global__ void __launch_bounds__(FLAT_THREADS) draws_flat_kernel(const rd::DrawArgs a) {
  const int64_t g = (int64_t)blockIdx.x * FLAT_THREADS + threadIdx.x;
  if (g >= a.p.rows * a.p.n) return;
  const int i = (int)(g / a.p.rows);
  const rd::Stage none{nullptr, 1, 0};  // no window is active: nothing staged or read
  rd::RowCtx x;
  rd::stage_node(a, none, g - (int64_t)i * a.p.rows, 0, i, x);
  rd::draw_node(a, none, g - (int64_t)i * a.p.rows, 0, i, x);
}

}  // namespace

// Launches the draws on `stream`; returns cudaGetLastError() (0 = launched),
// or 100+ for parameters this kernel does not take.
extern "C" int rs_draws_launch(const rd::DrawParams* p, void* const* ptrs, void* stream) {
  const int bad = rd::check_params(*p);
  if (bad) return 100 + bad;
  if (p->rows == 0) return 0;
  rd::DrawArgs args;
  args.p = *p;
  for (int k = 0; k < rd::N_PTR; ++k) args.ptr[k] = ptrs[k];
  if (!rd::may_partition(*p)) {
    const int64_t threads = p->rows * p->n;
    const unsigned grid = (unsigned)((threads + FLAT_THREADS - 1) / FLAT_THREADS);
    draws_flat_kernel<<<grid, FLAT_THREADS, 0, (cudaStream_t)stream>>>(args);
    return (int)cudaGetLastError();
  }
  const int rt = rd::tile_rows(p->n);
  const unsigned grid = (unsigned)((p->rows + rt - 1) / rt);
  draws_kernel<<<grid, rt * p->n, (size_t)rd::stage_bytes(p->n, rt), (cudaStream_t)stream>>>(args,
                                                                                          rt);
  return (int)cudaGetLastError();
}

extern "C" int rs_draws_n_ptr() { return rd::N_PTR; }
