// Hopper tick kernel: one whole Raft tick for B clusters, one thread per
// cluster, running the scalar per-cluster body of tick.cuh.
//
// Replaces the repository's one TPU kernel, raft_sim_tpu/experiments/
// pallas_engine.py `step_pallas` (its pl.pallas_call fuses raft_batched.step_b
// + _step_info_b over blocks of clusters held in VMEM).
//
// What bounds it on an H100: memory. The tick is integer compare/select work,
// a few thousand operations per cluster, against the leaves it must read once
// and write once every tick. Each gate makes its own legs live, and legs a
// gate leaves untouched pass through uncopied (kernels/tick_engine.leg_live):
// compaction the snapshot triple (base_term in, log_base/base_term/base_chk
// out), the mailbox's req_base/req_base_term/req_base_chk and StepInfo's
// noop_blocked; PreVote heard_clock and the packed pv_grant plane; the
// redirect client its K pipeline slots (client_pend/client_dst, client_tick
// with the offer-tick plane) and the client_target/client_bounce inputs.
// Per cluster (kernels/tick_engine.traffic_bytes), bytes read / written:
// config3 (N=5, CAP=32) 2,087 / 2,080; config3p 2,127 / 2,120; config6
// (CAP=32, E=4, int32 index tier) 3,067 / 3,104; config6r (K=5) 3,151 /
// 3,164. 100,000 config3 clusters move 0.42 GB per tick, 0.124 ms at
// 3.35 TB/s. The design keeps to one pass over those leaves: each thread
// reads its cluster's leaves, keeps every per-node intermediate in registers
// or thread-local arrays, and writes each output leaf once -- no intermediate
// ever goes to device memory. Leaves are batch-minor, so a warp's 32 threads
// read and write 32 consecutive elements of every leaf (coalesced).
// Not yet done (later work): staging the [N, N] planes in shared memory for
// N=51, drawing the threefry inputs inside the kernel instead of reading them,
// and a CUDA graph over ticks.
//
// Build (kernels/tick_engine.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtick.so tick.cu
#include <cuda_runtime.h>

#include "tick.cuh"

namespace {

struct TickArgs {
  rs::TickParams p;
  void* ptr[rs::N_PTR];
};

template <class I, class A, class N>
__global__ void __launch_bounds__(128) tick_kernel(const TickArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.p.b) rs::tick_cluster<I, A, N>(a.p, a.ptr, b);  // ragged edge masked
}

}  // namespace

#define RS_LAUNCH(I, A, N) tick_kernel<I, A, N><<<grid, block, 0, s>>>(args)

// Launches one tick on `stream`; returns cudaGetLastError() (0 = launched),
// or 100+ / 99 for shapes or dtype tiers this kernel does not take.
extern "C" int rs_tick_launch(const rs::TickParams* p, void* const* ptrs, int idx_bytes,
                              int ack_bytes, int node_bytes, void* stream) {
  const int bad = rs::check_params(*p);
  if (bad) return 100 + bad;
  if (p->b == 0) return 0;
  TickArgs args;
  args.p = *p;
  for (int k = 0; k < rs::N_PTR; ++k) args.ptr[k] = ptrs[k];
  const int block = 128;
  const unsigned grid = (unsigned)((p->b + block - 1) / block);
  cudaStream_t s = (cudaStream_t)stream;
  RS_DISPATCH_TIERS(idx_bytes, ack_bytes, node_bytes, RS_LAUNCH, return 99);
  return (int)cudaGetLastError();
}

extern "C" int rs_tick_n_ptr() { return rs::N_PTR; }
