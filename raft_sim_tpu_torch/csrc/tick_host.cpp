// CPU build of the tick body (tick.cuh) behind a plain C interface, for the
// tests. It runs the same phase functions the CUDA kernel runs, on host
// pointers laid out as tick.cu's launcher takes them: per tile of TILE
// clusters, each phase over every (cluster, node) of the tile, then the next
// phase -- the barrier's meaning -- with a NodeCtx per (cluster, node) and a
// host exchange buffer. `reverse` runs each phase's workers in reverse order
// (clusters, nodes, and the cluster part before the node parts), so an answer
// that depends on the order inside a phase (a same-phase cross-node read)
// differs from the forward run. `poison` overwrites each exchange field after
// its last reader's phase (tick.cuh `poison_fields`, the card's race proxy),
// so a read past that schedule differs too.
//
// Built in parts, one per (width tier, node-id bytes) the body is
// instantiated for, compiled in parallel and linked into one library:
//   g++ -std=c++17 -O2 -fPIC -c -DRS_HOST_WIDTH=2|4|8 -DRS_HOST_NODE_BYTES=1|2
//       tick_host.cpp -o part.o            (pairs 2/1, 4/1, 4/2, 8/2)
//   g++ -shared -o libtick_host.so part*.o
// The 2/1 part also holds the entry points.
#include <cstddef>
#include <vector>

#include "tick.cuh"

#if !defined(RS_HOST_WIDTH) || !defined(RS_HOST_NODE_BYTES)
#error "compile once per part: -DRS_HOST_WIDTH=2|4|8 -DRS_HOST_NODE_BYTES=1|2"
#endif
#if RS_HOST_NODE_BYTES == 1
typedef int8_t PartNode;
#else
typedef int16_t PartNode;
#endif

#define RS_CAT4(a, b, c, d) a##b##c##d
#define RS_PART_NAME(w, nb) RS_CAT4(rs_tick_host_w, w, _n, nb)
#define RS_PART RS_PART_NAME(RS_HOST_WIDTH, RS_HOST_NODE_BYTES)

namespace {

constexpr int TILE = 4;  // clusters per tile; batches of 5, 7 and 3 leave a ragged tile
constexpr int MW = RS_HOST_WIDTH;

template <class I, class A, class N, int FULL, int NPT, int PH>
void run_phase(const rs::TickParams& p, void* const* ptrs, std::vector<rs::NodeCtx<MW>>& ctx,
               const rs::Xch<MW>& X, int64_t b0, bool reverse, bool poison) {
  const int n = p.n;
  const int live = (int)(p.b - b0 < TILE ? p.b - b0 : TILE);  // clusters of this tile
  auto cluster = [&](int ci) { rs::cluster_phase<MW, FULL, PH>(p, ptrs, X, b0 + ci, ci); };
  auto node = [&](int ci, int i) {
    if (poison) rs::poison_fields<MW, PH>(X, ci, i);
    rs::node_phase<I, A, N, MW, FULL, PH, NPT>(p, ptrs, ctx[(std::size_t)ci * n + i], X, b0 + ci,
                                               ci, i);
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

template <class I, class A, class N, int FULL, int NPT>
void run_tick(const rs::TickParams& p, void* const* ptrs, bool reverse, bool poison) {
  std::vector<rs::NodeCtx<MW>> ctx((std::size_t)TILE * p.n);
  std::vector<int32_t> xbuf((std::size_t)(rs::smem_bytes(p.n, TILE) / 4));
  const rs::Xch<MW> X{xbuf.data(), p.n, TILE};
  for (int64_t b0 = 0; b0 < p.b; b0 += TILE) {
    run_phase<I, A, N, FULL, NPT, 0>(p, ptrs, ctx, X, b0, reverse, poison);
    run_phase<I, A, N, FULL, NPT, 1>(p, ptrs, ctx, X, b0, reverse, poison);
    run_phase<I, A, N, FULL, NPT, 2>(p, ptrs, ctx, X, b0, reverse, poison);
    run_phase<I, A, N, FULL, NPT, 3>(p, ptrs, ctx, X, b0, reverse, poison);
    run_phase<I, A, N, FULL, NPT, 4>(p, ptrs, ctx, X, b0, reverse, poison);
    run_phase<I, A, N, FULL, NPT, 5>(p, ptrs, ctx, X, b0, reverse, poison);
    run_phase<I, A, N, FULL, NPT, 6>(p, ptrs, ctx, X, b0, reverse, poison);
  }
}

// The card's nodes a thread for N (block_shape: 1 up to 32 nodes, else 2),
// which selects the body's wide forms.
template <class I, class A, int FULL>
void run_npt(const rs::TickParams& p, void* const* ptrs, bool reverse, bool poison) {
  if (MW == 2 && p.n <= 32) run_tick<I, A, PartNode, FULL, 1>(p, ptrs, reverse, poison);
  else run_tick<I, A, PartNode, FULL, 2>(p, ptrs, reverse, poison);
}

// The body for the config's gate set (tick.cuh `body_for`): lean (FULL =
// 0), every gate (1), or every gate with the mutant hooks read from p (2).
template <class I, class A>
void run_gates(const rs::TickParams& p, void* const* ptrs, bool reverse, bool poison) {
  const int body = rs::body_for(p);
  if (body == 0) run_npt<I, A, 0>(p, ptrs, reverse, poison);
  else if (body == 2) run_npt<I, A, 2>(p, ptrs, reverse, poison);
  else run_npt<I, A, 1>(p, ptrs, reverse, poison);
}

}  // namespace

// This part's (index, ack) tiers: 1 = int8, 2 = int16, 4 = int32 (the index
// tier under compaction); 99 for a combination the card's launcher does not take.
extern "C" int RS_PART(const rs::TickParams* p, void* const* ptrs, int idx_bytes, int ack_bytes,
                       int reverse, int poison) {
  const bool rev = reverse != 0, poi = poison != 0;
  if (ack_bytes == 1) {
    if (idx_bytes == 1) run_gates<int8_t, int8_t>(*p, ptrs, rev, poi);
    else if (idx_bytes == 2) run_gates<int16_t, int8_t>(*p, ptrs, rev, poi);
    else if (idx_bytes == 4) run_gates<int32_t, int8_t>(*p, ptrs, rev, poi);
    else return 99;
  } else if (ack_bytes == 2) {
    if (idx_bytes == 1) run_gates<int8_t, int16_t>(*p, ptrs, rev, poi);
    else if (idx_bytes == 2) run_gates<int16_t, int16_t>(*p, ptrs, rev, poi);
    else if (idx_bytes == 4) run_gates<int32_t, int16_t>(*p, ptrs, rev, poi);
    else return 99;
  } else {
    return 99;
  }
  return 0;
}

#if RS_HOST_WIDTH == 2 && RS_HOST_NODE_BYTES == 1
typedef int (*PartFn)(const rs::TickParams*, void* const*, int, int, int, int);
extern "C" int rs_tick_host_w4_n1(const rs::TickParams*, void* const*, int, int, int, int);
extern "C" int rs_tick_host_w4_n2(const rs::TickParams*, void* const*, int, int, int, int);
extern "C" int rs_tick_host_w8_n2(const rs::TickParams*, void* const*, int, int, int, int);

// The part for N's width tier and the node-id tier (types.node_dtype: int8
// up to 126 nodes); 99 for a pair no part holds.
extern "C" int rs_tick_host(const rs::TickParams* p, void* const* ptrs, int idx_bytes,
                            int ack_bytes, int node_bytes, int reverse, int poison) {
  const int bad = rs::check_params(*p);
  if (bad) return 100 + bad;
  const int w = rs::width_for(p->n);
  PartFn part = nullptr;
  if (w == 2 && node_bytes == 1) part = rs_tick_host_w2_n1;
  else if (w == 4 && node_bytes == 1) part = rs_tick_host_w4_n1;
  else if (w == 4 && node_bytes == 2) part = rs_tick_host_w4_n2;
  else if (w == 8 && node_bytes == 2) part = rs_tick_host_w8_n2;
  if (!part) return 99;
  return part(p, ptrs, idx_bytes, ack_bytes, reverse, poison);
}

extern "C" int rs_tick_n_ptr() { return rs::N_PTR; }
extern "C" long long rs_tick_smem_bytes(int n, int tc) { return rs::smem_bytes(n, tc); }
extern "C" int rs_tick_lean(const rs::TickParams* p) { return rs::lean_gates(*p); }
extern "C" int rs_tick_body(const rs::TickParams* p) { return rs::body_for(*p); }

// The wide quorum commit (tick.cuh `QHist`, `quorum_select`) on one leader's
// row of n int32 values (its own slot i read as `self`), over the members of
// `mask` (rs::MAXW words, or null for every node) with majority `maj`:
// max(the maj-th largest, base), as the card's leaders compute it above 32
// nodes; `walk` 1 runs `qmatch` alone instead (clamped the same way).
extern "C" int rs_tick_quorum_match(const int32_t* row, int n, int i, int self,
                                    const uint32_t* mask, int maj, int base, int walk) {
  if (walk) return rs::imax(rs::qmatch<rs::MAXW>(row, 1, n, i, self, mask, maj), base);
  rs::QHist q;
  rs::qhist_clear(q);
  for (int r = 0; r < n; ++r)
    if (!mask || rs::has_bit<rs::MAXW>(mask, r)) rs::qhist_add(q, base, r == i ? self : row[r]);
  return rs::quorum_select<rs::MAXW>(q, base, row, 1, n, i, self, mask, maj);
}
#endif
