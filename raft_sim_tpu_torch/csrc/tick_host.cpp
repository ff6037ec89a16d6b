// CPU build of the tick body (tick.cuh) behind a plain C interface, for the
// tests: g++ -std=c++17 -O2 -shared -fPIC tick_host.cpp -o libtick_host.so.
// It runs the same phase functions the CUDA kernel runs, on host pointers
// laid out as tick.cu's launcher takes them: per tile of TILE clusters, each
// phase over every (cluster, node) of the tile, then the next phase -- the
// barrier's meaning -- with a NodeCtx per (cluster, node) and a host exchange
// buffer. `reverse` runs each phase's workers in reverse order (clusters,
// nodes, and the cluster part before the node parts), so an answer that
// depends on the order inside a phase (a same-phase cross-node read) differs
// from the forward run.
#include <cstddef>
#include <vector>

#include "tick.cuh"

namespace {

constexpr int TILE = 4;  // clusters per tile; batches of 5, 7 and 3 leave a ragged tile

template <class I, class A, class N, bool FULL, int PH>
void run_phase(const rs::TickParams& p, void* const* ptrs, std::vector<rs::NodeCtx>& ctx,
               const rs::Xch& X, int64_t b0, bool reverse) {
  const int n = p.n;
  const int live = (int)(p.b - b0 < TILE ? p.b - b0 : TILE);  // clusters of this tile
  auto cluster = [&](int ci) { rs::cluster_phase<FULL, PH>(p, ptrs, X, b0 + ci, ci); };
  auto node = [&](int ci, int i) {
    rs::node_phase<I, A, N, FULL, PH>(p, ptrs, ctx[(std::size_t)ci * n + i], X, b0 + ci, ci, i);
  };
  if (reverse) {
    for (int ci = live - 1; ci >= 0; --ci) cluster(ci);
    for (int ci = live - 1; ci >= 0; --ci)
      for (int i = n - 1; i >= 0; --i) node(ci, i);
  } else {
    for (int ci = 0; ci < live; ++ci)
      for (int i = 0; i < n; ++i) node(ci, i);
    for (int ci = 0; ci < live; ++ci) cluster(ci);
  }
}

template <class I, class A, class N, bool FULL>
void run_tick(const rs::TickParams& p, void* const* ptrs, bool reverse) {
  std::vector<rs::NodeCtx> ctx((std::size_t)TILE * p.n);
  std::vector<int32_t> xbuf((std::size_t)(rs::smem_bytes(p.n, TILE) / 4));
  const rs::Xch X{xbuf.data(), p.n, TILE};
  for (int64_t b0 = 0; b0 < p.b; b0 += TILE) {
    run_phase<I, A, N, FULL, 0>(p, ptrs, ctx, X, b0, reverse);
    run_phase<I, A, N, FULL, 1>(p, ptrs, ctx, X, b0, reverse);
    run_phase<I, A, N, FULL, 2>(p, ptrs, ctx, X, b0, reverse);
    run_phase<I, A, N, FULL, 3>(p, ptrs, ctx, X, b0, reverse);
    run_phase<I, A, N, FULL, 4>(p, ptrs, ctx, X, b0, reverse);
    run_phase<I, A, N, FULL, 5>(p, ptrs, ctx, X, b0, reverse);
    run_phase<I, A, N, FULL, 6>(p, ptrs, ctx, X, b0, reverse);
  }
}

}  // namespace

// The body for the config's gate set: lean (FULL = false) or every gate.
#define RS_HOST_CALL(I, A, N)                                                   \
  (rs::lean_gates(*p) ? run_tick<I, A, N, false>(*p, ptrs, reverse != 0)        \
                      : run_tick<I, A, N, true>(*p, ptrs, reverse != 0))

extern "C" int rs_tick_host(const rs::TickParams* p, void* const* ptrs, int idx_bytes,
                            int ack_bytes, int node_bytes, int reverse) {
  const int bad = rs::check_params(*p);
  if (bad) return 100 + bad;
  RS_DISPATCH_TIERS(idx_bytes, ack_bytes, node_bytes, RS_HOST_CALL, return 99);
  return 0;
}

extern "C" int rs_tick_n_ptr() { return rs::N_PTR; }
extern "C" long long rs_tick_smem_bytes(int n, int tc) { return rs::smem_bytes(n, tc); }
extern "C" int rs_tick_lean(const rs::TickParams* p) { return rs::lean_gates(*p); }
