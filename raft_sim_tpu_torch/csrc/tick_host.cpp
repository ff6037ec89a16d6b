// CPU build of the tick body (tick.cuh) behind a plain C interface, for the
// tests: g++ -std=c++17 -O2 -shared -fPIC tick_host.cpp -o libtick_host.so.
// It runs the same per-cluster function the CUDA kernel runs, one cluster
// after another, on host pointers laid out as tick.cu's launcher takes them.
#include "tick.cuh"

#define RS_HOST_CALL(I, A, N) \
  for (int64_t b = 0; b < p->b; ++b) rs::tick_cluster<I, A, N>(*p, ptrs, b)

extern "C" int rs_tick_host(const rs::TickParams* p, void* const* ptrs, int idx_bytes,
                            int ack_bytes, int node_bytes) {
  const int bad = rs::check_params(*p);
  if (bad) return 100 + bad;
  RS_DISPATCH_TIERS(idx_bytes, ack_bytes, node_bytes, RS_HOST_CALL, return 99);
  return 0;
}

extern "C" int rs_tick_n_ptr() { return rs::N_PTR; }
