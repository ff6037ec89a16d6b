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
// with the offer-tick plane) and the client_target/client_bounce inputs; the
// reconfiguration plane its member rows, config-entry plane, snapshot config
// context, transfer and read legs and admin inputs; the storage plane its
// durable watermarks, the fsync_fire/torn_drop inputs and the fsync-lag pair.
// Per cluster (kernels/tick_engine.traffic_bytes), bytes read / written:
// config3 (N=5, CAP=32) 2,087 / 2,080; config3p 2,127 / 2,120; config6
// (CAP=32, E=4, int32 index tier) 3,067 / 3,104; config6r (K=5) 3,151 /
// 3,164; config8 (CAP=64, reconfig + transfer + reads) 6,389 / 6,402;
// config9 (CAP=64 ring, reads + lease) 5,091 / 5,197; config10 (CAP=64,
// durable storage) 4,872 / 4,848. 100,000 config3
// clusters move 0.42 GB per tick, 0.124 ms at 3.35 TB/s. The design keeps to
// one pass over those leaves: each thread reads its cluster's leaves, keeps
// every per-node intermediate in registers or thread-local arrays, and writes
// each output leaf once -- no intermediate ever goes to device memory. Leaves
// are batch-minor, so a warp's 32 threads read and write 32 consecutive
// elements of every leaf (coalesced).
// Not yet done (later work): staging the [N, N] planes in shared memory for
// N=51, drawing the threefry inputs inside the kernel instead of reading them,
// and a CUDA graph over ticks.
//
// Build (kernels/tick_engine.py does this at first use): this file is
// compiled once per index dtype tier, the three nvcc runs in parallel,
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
//        -c -DRS_IDX_BYTES=1|2|4 -o tick_i<k>.o tick.cu
// and the objects are linked into one shared library (nvcc -shared). Each
// object holds its tier's four (ack, node) instantiations and
// `rs_tick_launch_i<k>`; the RS_IDX_BYTES=1 object also holds the entry points
// `rs_tick_launch` and `rs_tick_n_ptr`.
#include <cuda_runtime.h>

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

#define RS_CAT2(a, b) a##b
#define RS_CAT(a, b) RS_CAT2(a, b)
#define RS_TIER_LAUNCH RS_CAT(rs_tick_launch_i, RS_IDX_BYTES)

extern "C" int rs_tick_launch_i1(const rs::TickArgs*, int, int, unsigned, cudaStream_t);
extern "C" int rs_tick_launch_i2(const rs::TickArgs*, int, int, unsigned, cudaStream_t);
extern "C" int rs_tick_launch_i4(const rs::TickArgs*, int, int, unsigned, cudaStream_t);

namespace {

template <class I, class A, class N>
__global__ void __launch_bounds__(128) tick_kernel(const rs::TickArgs a) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.p.b) rs::tick_cluster<I, A, N>(a.p, a.ptr, b);  // ragged edge masked
}

template <class A, class N>
void launch(const rs::TickArgs* args, unsigned grid, cudaStream_t s) {
  tick_kernel<TierIdx, A, N><<<grid, 128, 0, s>>>(*args);
}

}  // namespace

// This tier's four (ack, node) instantiations; 99 for a combination none takes.
extern "C" int RS_TIER_LAUNCH(const rs::TickArgs* args, int ack_bytes, int node_bytes,
                              unsigned grid, cudaStream_t s) {
  if (ack_bytes == 1 && node_bytes == 1) launch<int8_t, int8_t>(args, grid, s);
  else if (ack_bytes == 2 && node_bytes == 1) launch<int16_t, int8_t>(args, grid, s);
  else if (ack_bytes == 1 && node_bytes == 2) launch<int8_t, int16_t>(args, grid, s);
  else if (ack_bytes == 2 && node_bytes == 2) launch<int16_t, int16_t>(args, grid, s);
  else return 99;
  return 0;
}

#if RS_IDX_BYTES == 1
// Launches one tick on `stream`; returns cudaGetLastError() (0 = launched),
// or 100+ / 99 for shapes or dtype tiers this kernel does not take.
extern "C" int rs_tick_launch(const rs::TickParams* p, void* const* ptrs, int idx_bytes,
                              int ack_bytes, int node_bytes, void* stream) {
  const int bad = rs::check_params(*p);
  if (bad) return 100 + bad;
  if (p->b == 0) return 0;
  rs::TickArgs args;
  args.p = *p;
  for (int k = 0; k < rs::N_PTR; ++k) args.ptr[k] = ptrs[k];
  const unsigned grid = (unsigned)((p->b + 127) / 128);
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 99;
  if (idx_bytes == 1) rc = rs_tick_launch_i1(&args, ack_bytes, node_bytes, grid, s);
  else if (idx_bytes == 2) rc = rs_tick_launch_i2(&args, ack_bytes, node_bytes, grid, s);
  else if (idx_bytes == 4) rc = rs_tick_launch_i4(&args, ack_bytes, node_bytes, grid, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

extern "C" int rs_tick_n_ptr() { return rs::N_PTR; }
#endif
