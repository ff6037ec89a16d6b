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
// Design. Thread g of the grid is node i = g / rows of row r = g % rows, so a
// warp is 32 consecutive rows (clusters) of one node, and in the batch-minor
// layout the tick kernel reads each of its stores is one run of consecutive
// addresses. A thread derives its row's keys itself (6-9 blocks)
// rather than share them through shared memory behind a barrier: the
// threads of a cluster are `rows` apart, and the recomputation costs less
// than the staging would. The delivery row is packed word by word in a
// register. The heaviest row is N = 255 (config7x): each thread draws 255 drop
// bits and, under a partition, the 255 side bits -- recomputed per thread,
// 2 x 65,025 blocks a cluster, ~2.2 G instructions at 250 clusters, twice
// the floor `threefry_blocks` counts -- with 63,750 threads in flight, ~480
// an SM. Node 0's thread also writes the row's scalars and the partition's
// cut counts (2 x n1 x (N - n1), from the side bits it draws anyway), so no
// reduction crosses threads.
//
// Later work (ROADMAP): drawing inside the tick kernel's prologue (no round
// trip through memory), folding the run metrics in place, and many ticks a
// launch.
//
// Build (kernels/draw_engine.py does this at first use; chip_smoke.py starts
// it beside the tick kernel's nine objects):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
//        -Xptxas -v -shared -o libdraws_<hash>.so draws.cu
#include <cuda_runtime.h>

#include "draws.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) draws_kernel(const rd::DrawArgs a) {
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (g >= a.p.rows * a.p.n) return;
  const int i = (int)(g / a.p.rows);
  rd::draw_node(a, g - (int64_t)i * a.p.rows, i);
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
  const int64_t threads = p->rows * p->n;
  const unsigned grid = (unsigned)((threads + THREADS - 1) / THREADS);
  draws_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

extern "C" int rs_draws_n_ptr() { return rd::N_PTR; }
