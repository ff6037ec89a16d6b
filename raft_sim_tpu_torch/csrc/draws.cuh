// The tick's input draws for a row of clusters, one worker per (row, node):
// the body of the Hopper draw kernel (draws.cu) and of its CPU build
// (draws_host.cpp).
//
// Semantics are raft_sim_tpu/sim/faults.py `make_inputs` under
// `jax.vmap` (the port's sim/faults.py `make_inputs`, `draw_span` and
// `trace_fault_inputs`), leaf for leaf and bit for bit: JAX's partitionable
// threefry2x32 streams keyed by (cluster key, tick), the scalar-config path
// with its gated-off fields as the plain version emits them (all delivered,
// skew 1, zeros, NIL, all alive), the scenario path (a `[B, S]` genome, the
// segment active at the row's tick, every mechanism drawn), and the trace
// plane's fault facts (the crash edge and the partition's cut counts at the
// tick and the tick before).
//
// A row is one (tick, cluster): row r draws cluster r % kb (its key and its
// genome row) at tick now[r] when a per-row tick leaf is given, else at
// now0 + r / kb. So `make_inputs` is kb = rows at one tick, and `draw_span`
// (ticks t0 .. t0 + T - 1 of a fleet of kb clusters) is rows = T x kb in one
// launch, with no copy of the keys or the genome.
//
// Work split: worker (r, i) derives the row's keys itself (a handful of
// threefry blocks: cheaper than a barrier to share them) and, in a stage
// phase, draws node i's side bit of the row's partition window (and of the
// tick before's, with the facts) into the tile's staging; after a barrier
// it draws node i's row of the delivery plane (its N drop bits, and the
// partition's cut edges from the staged side bits, packed into W words),
// its skew, election timeout, liveness at the tick and the tick before,
// and its storage draws. Worker (r, 0) also writes the row's scalars: the
// client command, the redirect routing, the admin offers and the fact
// counts. A partition's cut-edge count is 2 x n1 x (N - n1) on an active
// window (n1 nodes on one side), counted from the staged words.
//
// Output layout: every leaf [T, F, kb], batch-minor within each tick group
// (the layout the tick kernel reads), F the leaf's per-row width (N*W
// words, N, K or 1); one tick is T = 1.
//
// Integer rules: uint32 for every draw, key and threshold (wrapping adds,
// unsigned compares and remainders, as JAX's uint32); ticks in int64 with
// floor division and floor modulo (Python's and jnp's `//` and `%`); a tick
// enters a key as its uint32 bit pattern (fold_in(k, -1) at tick 0's "tick
// before").
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define RD_HD __host__ __device__ __forceinline__
#else
#define RD_HD inline
#endif

namespace rd {

constexpr int32_t NIL = -1;
constexpr uint32_t HALF_U32 = 0x80000000u;
constexpr int MAXN = 255;  // nodes per cluster (RaftConfig's ceiling)
constexpr int MAXK = 16;   // redirect pipeline slots (RaftConfig.client_pipeline <= 16)

// Leaf pointers, in the order kernels/draw_engine.PTR_ORDER lists them.
enum Ptr {
  // Read: the clusters' keys (int64 [kb, 2], uint32 words), the per-row tick
  // (int32 [rows] or null), the genome's 14 leaves ([kb, S]: int64 carrying
  // uint32 thresholds, int32 the rest; null on the scalar path).
  D_KEYS, D_NOW,
  G_DROP, G_PART_PERIOD, G_PART, G_CRASH, G_CRASH_DOWN, G_SKEW, G_CLIENT_INTERVAL,
  G_RECONFIG_INTERVAL, G_TRANSFER_INTERVAL, G_READ_INTERVAL, G_FSYNC_INTERVAL,
  G_FSYNC_JITTER, G_TORN, G_TORN_SPAN,
  // Written: StepInputs, then the fault facts (null without `facts`).
  O_DELIVER_MASK, O_SKEW, O_TIMEOUT_DRAW, O_CLIENT_CMD, O_CLIENT_TARGET, O_CLIENT_BOUNCE,
  O_ALIVE, O_RESTARTED, O_RECONFIG_CMD, O_TRANSFER_CMD, O_READ_CMD, O_FSYNC_FIRE,
  O_TORN_DROP,
  F_CRASHED, F_CUT_NOW, F_CUT_PREV,
  N_PTR
};

// One launch's parameters (kernels/draw_engine.DrawParams). The scalar
// path's fault settings are the config's, thresholds already uint32
// (faults.p_to_u32); a gate that is off carries threshold 0 or interval 0,
// which draws the gated-off value.
struct DrawParams {
  int64_t rows;  // (tick, cluster) rows drawn
  int64_t kb;    // clusters (key rows); row r is cluster r % kb
  int64_t now0;  // row r's tick without a per-row tick leaf: now0 + r / kb
  int32_t n;     // nodes
  int32_t w;     // packed words a delivery row: ceil(n / 32)
  int32_t k;     // client_bounce slots (RaftConfig.client_pipeline)
  int32_t genome;   // 1: the scenario path (G_* leaves), 0: the scalar path
  int32_t s_count;  // genome segments S
  int32_t seg_len;  // genome segment ticks
  int32_t facts;    // 1: write the fault facts
  int32_t redirect;  // RaftConfig.client_redirect (both paths)
  int32_t el_min, el_range;  // election timeout draw: [el_min, el_min + el_range)
  int32_t crash_period;      // the crash schedule's window (both paths)
  // The scalar path.
  int32_t drop_uniform;  // the per-cluster uniform rate bits(k_rate) % (drop_base + 1)
  uint32_t drop_t, drop_base;
  int32_t part_period;
  uint32_t part_t, skew_t, crash_t;
  int32_t crash_down;
  int32_t client_interval, reconfig_interval, transfer_interval, read_interval;
  int32_t fsync_interval;
  uint32_t jit_t, torn_t;
  int32_t torn_span;
};

struct DrawArgs {
  DrawParams p;
  void* ptr[N_PTR];
};

// Checks the shape limits of this body; 0 when it can draw.
inline int check_params(const DrawParams& p) {
  if (p.n < 2 || p.n > MAXN) return 1;
  if (p.w != (p.n + 31) / 32) return 2;
  if (p.k < 1 || p.k > MAXK) return 3;
  if (p.rows < 0 || p.kb < 1 || p.rows % p.kb != 0) return 4;
  if (p.genome && (p.s_count < 1 || p.seg_len < 1)) return 5;
  if (p.crash_period < 1 || p.el_range < 1) return 6;
  return 0;
}

// ---- threefry2x32, as jax/_src/prng.py lowers it --------------------------

struct Key {
  uint32_t a, b;
};

RD_HD uint32_t rotl(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// The 20-round block over the counter (x0, x1): four rounds of add, rotate,
// xor between five key injections.
RD_HD Key threefry2x32(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k0 = k.a, k1 = k.b, k2 = k.a ^ k.b ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define RD_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
#define RD_EVEN RD_ROUND(13) RD_ROUND(15) RD_ROUND(26) RD_ROUND(6)
#define RD_ODD RD_ROUND(17) RD_ROUND(29) RD_ROUND(16) RD_ROUND(24)
  RD_EVEN x0 += k1; x1 += k2 + 1u;
  RD_ODD x0 += k2; x1 += k0 + 2u;
  RD_EVEN x0 += k0; x1 += k1 + 3u;
  RD_ODD x0 += k1; x1 += k2 + 4u;
  RD_EVEN x0 += k2; x1 += k0 + 5u;
#undef RD_EVEN
#undef RD_ODD
#undef RD_ROUND
  return Key{x0, x1};
}

// fold_in(k, d) and split(k, n)[d]: the same block, counter (0, d).
RD_HD Key fold_in(Key k, uint32_t d) { return threefry2x32(k, 0u, d); }

// bits(k, shape)[pos]: the flat row-major position hi:lo as the counter,
// the block's two words xored.
RD_HD uint32_t bits(Key k, uint64_t pos) {
  const Key o = threefry2x32(k, (uint32_t)(pos >> 32), (uint32_t)pos);
  return o.a ^ o.b;
}

// randint(k, shape, lo, hi)[pos] in int32: jax's two-draw algorithm over
// split(k), all in wrapping uint32 (the multiplier (2^16 mod span)^2 wraps
// too); a span of hi <= lo is 1.
RD_HD int32_t randint(Key k, uint64_t pos, int64_t lo, int64_t hi) {
  const uint32_t span = hi > lo ? (uint32_t)(hi - lo) : 1u;
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t higher = bits(fold_in(k, 0u), pos), lower = bits(fold_in(k, 1u), pos);
  const uint32_t off = ((higher % span) * mult + lower % span) % span;
  return (int32_t)((uint32_t)lo + off);
}

// ---- ticks ----------------------------------------------------------------

RD_HD int64_t floordiv(int64_t x, int64_t m) {  // m > 0
  const int64_t q = x / m;
  return (q * m > x) ? q - 1 : q;
}

RD_HD int64_t pmod(int64_t x, int64_t m) { return x - floordiv(x, m) * m; }  // m > 0

// A per-cluster cadence (interval 0 = off) fires at tick `now`.
RD_HD bool cadence(int32_t interval, int64_t now) {
  return interval > 0 && pmod(now, interval) == 0;
}

// The fault setting a row draws under: the genome's segment at its tick, or
// the config's.
struct Fault {
  uint32_t drop, part, crash, skew, jit, torn;
  int32_t part_period, crash_down, client_interval, reconfig_interval, transfer_interval,
      read_interval, fsync_interval, torn_span;
};

RD_HD Fault fault_at(const DrawArgs& a, int64_t c, int64_t now, Key key) {
  const DrawParams& p = a.p;
  Fault f;
  if (p.genome) {
    // genome_at: column clip(now // seg_len, 0, S - 1) of the cluster's row.
    int64_t seg = floordiv(now, p.seg_len);
    seg = seg < 0 ? 0 : (seg > p.s_count - 1 ? p.s_count - 1 : seg);
    const int64_t at = c * p.s_count + seg;
#define RD_U32(P) ((uint32_t)((const int64_t*)a.ptr[P])[at])
#define RD_I32(P) (((const int32_t*)a.ptr[P])[at])
    f.drop = RD_U32(G_DROP);
    f.part_period = RD_I32(G_PART_PERIOD);
    f.part = RD_U32(G_PART);
    f.crash = RD_U32(G_CRASH);
    f.crash_down = RD_I32(G_CRASH_DOWN);
    f.skew = RD_U32(G_SKEW);
    f.client_interval = RD_I32(G_CLIENT_INTERVAL);
    f.reconfig_interval = RD_I32(G_RECONFIG_INTERVAL);
    f.transfer_interval = RD_I32(G_TRANSFER_INTERVAL);
    f.read_interval = RD_I32(G_READ_INTERVAL);
    f.fsync_interval = RD_I32(G_FSYNC_INTERVAL);
    f.jit = RD_U32(G_FSYNC_JITTER);
    f.torn = RD_U32(G_TORN);
    f.torn_span = RD_I32(G_TORN_SPAN);
#undef RD_U32
#undef RD_I32
  } else {
    // The uniform rate draws from k_rate = split(key, 3)[1].
    f.drop = p.drop_uniform ? bits(fold_in(key, 1u), 0) % (p.drop_base + 1u) : p.drop_t;
    f.part_period = p.part_period;
    f.part = p.part_t;
    f.crash = p.crash_t;
    f.crash_down = p.crash_down;
    f.skew = p.skew_t;
    f.client_interval = p.client_interval;
    f.reconfig_interval = p.reconfig_interval;
    f.transfer_interval = p.transfer_interval;
    f.read_interval = p.read_interval;
    f.fsync_interval = p.fsync_interval;
    f.jit = p.jit_t;
    f.torn = p.torn_t;
    f.torn_span = p.torn_span;
  }
  return f;
}

// The rolling partition's window at tick `now`: whether it cuts, and the key
// of its side draws (group[j] = bits(k_group, j) < 2^31).
struct Window {
  bool active;
  Key k_group;
};

RD_HD Window partition_at(Key k_part, int64_t now, int32_t period, uint32_t part_t) {
  Window w{false, Key{0u, 0u}};
  if (period <= 0 || part_t == 0u) return w;  // inactive: the draw cannot fire
  const Key wkey = fold_in(k_part, (uint32_t)floordiv(now, period));
  w.active = bits(fold_in(wkey, 1u), 0) < part_t;
  w.k_group = fold_in(wkey, 0u);
  return w;
}

// Node i alive at tick t under the crash schedule keyed by ckey (a tick below
// 0 reports alive): in window t // period, node i crashes with threshold
// crash_t and is down over [start, start + dur) of the window.
RD_HD bool alive_at(Key ckey, int64_t t, int i, int32_t period, uint32_t crash_t,
                    int32_t crash_down) {
  if (t < 0 || crash_t == 0u) return true;
  const int64_t window = floordiv(t, period), off = t - window * period;
  const Key wkey = fold_in(ckey, (uint32_t)window);
  if (!(bits(fold_in(wkey, 0u), (uint64_t)i) < crash_t)) return true;
  const int32_t start = randint(fold_in(wkey, 1u), (uint64_t)i, 0, period);
  const int32_t dur = randint(fold_in(wkey, 2u), (uint64_t)i, 1, (int64_t)crash_down + 1);
  return !(off >= start && off < (int64_t)start + dur);
}

// ---- the side-bit staging ----------------------------------------------------
//
// A partition window's side draws are one per node (group[j] = bits(k_group,
// j) < 2^31), shared by every node of the row: each worker draws its own
// node's side bit once and stages it as a byte, a barrier, then every worker
// of the row packs the bytes into words where its delivery row needs them.
// Two staged rows a row of the tile: the window at the row's tick, and (with
// the facts) the window at the tick before, for the cut counts.

constexpr int MAX_THREADS = 512;  // workers a tile (draws.cu's blocks)

// Whether some row of a launch may draw under an active partition window:
// the genome path (any segment may partition), or the scalar path with a
// partition period and probability. Without, nothing is ever staged, and
// draws.cu launches its flat form.
RD_HD bool may_partition(const DrawParams& p) {
  return p.genome || (p.part_period > 0 && p.part_t != 0u);
}
constexpr uint8_t POISON = 0xA5;  // the race proxy's staged byte

// Rows a tile for N nodes: the largest power of two up to 32 whose rows x N
// workers fit MAX_THREADS (32 at N <= 16, 8 at N = 51, 4 at N = 101, 2 at
// N = 255), so a warp's stores are runs of that many consecutive rows.
RD_HD int tile_rows(int n) {
  int rt = 32;
  while (rt > 1 && rt * n > MAX_THREADS) rt >>= 1;
  return rt;
}

// Bytes a staged row: N rounded up to whole words of four bytes.
RD_HD int stage_stride(int n) { return (n + 3) & ~3; }

// The staging bytes of a tile of `rt` rows: [2][rt][stride].
RD_HD int64_t stage_bytes(int n, int rt) { return 2 * (int64_t)rt * stage_stride(n); }

struct Stage {
  uint8_t* base;
  int rt, stride;
  RD_HD uint8_t* row(int which, int local) const {
    return base + ((int64_t)which * rt + local) * stride;
  }
};

// Word wd of a staged row (bits j - 32 wd for nodes j of the word below n).
RD_HD uint32_t staged_word(const uint8_t* row, int n, int wd) {
  uint32_t word = 0u;
  for (int q = 0; q < 8; ++q) {
    const int j = wd * 32 + q * 4;
    if (j >= n) break;
    const uint8_t* at = row + j;
    // Bit 0 of each byte (a padding byte past n holds whatever the memory
    // held; its bit lands above `live` and is cut below).
    const uint32_t b = ((uint32_t)at[0] | ((uint32_t)at[1] << 8) | ((uint32_t)at[2] << 16) |
                        ((uint32_t)at[3] << 24)) & 0x01010101u;
    word |= ((b | (b >> 7) | (b >> 14) | (b >> 21)) & 0xFu) << (q * 4);
  }
  const int live = n - wd * 32;  // bits of the word that are nodes
  return live >= 32 ? word : word & ((1u << live) - 1u);
}

// Edges a window cuts from its staged row: 2 x n1 x (N - n1).
RD_HD int32_t staged_cut(const uint8_t* row, int n, int w) {
  int n1 = 0;
  for (int wd = 0; wd < w; ++wd) {
    const uint32_t word = staged_word(row, n, wd);
#ifdef __CUDA_ARCH__
    n1 += __popc(word);
#else
    n1 += __builtin_popcount(word);
#endif
  }
  return 2 * n1 * (n - n1);
}

// ---- one worker -----------------------------------------------------------

// Element f of a leaf F wide for row r (cluster c of tick group g).
RD_HD int64_t at(const DrawParams& p, int64_t r, int64_t F, int64_t f) {
  const int64_t g = r / p.kb, c = r - g * p.kb;
  return (g * F + f) * p.kb + c;
}

// What a worker carries from its stage phase to its draw phase.
struct RowCtx {
  int64_t now, c;
  Key tkey, k_part;
  Fault f;
  Window win, prev;  // the windows at now and now - 1 (prev: with the facts)
  bool side_i;
};

// Phase 1, row r (slot `local` of the tile), node i: the row's keys and
// fault setting, and node i's side bits staged for the row's windows.
RD_HD void stage_node(const DrawArgs& a, const Stage& st, int64_t r, int local, int i,
                      RowCtx& x) {
  const DrawParams& p = a.p;
  x.c = r % p.kb;
  x.now = a.ptr[D_NOW] ? (int64_t)((const int32_t*)a.ptr[D_NOW])[r] : p.now0 + r / p.kb;
  const int64_t* kw = (const int64_t*)a.ptr[D_KEYS];
  const Key key{(uint32_t)kw[2 * x.c], (uint32_t)kw[2 * x.c + 1]};
  // split(key, 3) = (k_ticks, k_rate, k_part); tkey = fold_in(k_ticks, now);
  // split(tkey, 3) = (k_drop, k_timeout, k_skew).
  x.tkey = fold_in(fold_in(key, 0u), (uint32_t)x.now);
  x.k_part = fold_in(key, 2u);
  x.f = fault_at(a, x.c, x.now, key);
  x.win = partition_at(x.k_part, x.now, x.f.part_period, x.f.part);
  x.side_i = x.win.active && bits(x.win.k_group, (uint64_t)i) < HALF_U32;
  if (x.win.active) st.row(0, local)[i] = (uint8_t)x.side_i;
  x.prev = Window{false, Key{0u, 0u}};
  if (p.facts && x.now - 1 >= 0) {
    // The tick before shares the window unless it crosses a window's edge.
    const bool same = x.f.part_period > 0 &&
                      floordiv(x.now - 1, x.f.part_period) == floordiv(x.now, x.f.part_period);
    x.prev = same ? x.win : partition_at(x.k_part, x.now - 1, x.f.part_period, x.f.part);
    if (x.prev.active)
      st.row(1, local)[i] = same ? (uint8_t)x.side_i
                                 : (uint8_t)(bits(x.prev.k_group, (uint64_t)i) < HALF_U32);
  }
}

// Phase 2 (after every worker of the tile staged): node i's draws, and
// (i == 0) the row's scalars.
RD_HD void draw_node(const DrawArgs& a, const Stage& st, int64_t r, int local, int i,
                     const RowCtx& x) {
  const DrawParams& p = a.p;
  const int n = p.n;
  const int64_t now = x.now;
  const Fault& f = x.f;
  const Key tkey = x.tkey, k_part = x.k_part;
#define RD_OUT(T, P, F, v) ((T*)a.ptr[P])[at(p, r, (F), (v))]

  // The delivery row: bit j of word j / 32 is the edge j -> i, delivered
  // unless its drop draw fires or the partition puts j on the other side.
  const uint8_t* sides = st.row(0, local);
  const Key k_drop = fold_in(tkey, 0u);
  for (int wd = 0; wd < p.w; ++wd) {
    uint32_t word = 0u;
    const int hi = (wd + 1) * 32 < n ? (wd + 1) * 32 : n;
    // The drop draw's counter i * N + j runs beside j, so a draw adds
    // nothing to its threefry block but the counter's two words.
    uint64_t ctr = (uint64_t)i * n + (uint64_t)(wd * 32);
    for (int j = wd * 32; j < hi; ++j, ++ctr) {
      const bool ok = !(f.drop != 0u && bits(k_drop, ctr) < f.drop);
      word |= (uint32_t)ok << (j - wd * 32);
    }
    if (x.win.active) {  // the edges from node i's own side of the window
      const uint32_t side = staged_word(sides, n, wd);
      word &= x.side_i ? side : ~side;
    }
    RD_OUT(int32_t, O_DELIVER_MASK, (int64_t)n * p.w, (int64_t)i * p.w + wd) = (int32_t)word;
  }

  // Skew: 0 (a stall) below skew_t / 2, 2 (a jump) below skew_t, else 1.
  int32_t skew = 1;
  if (f.skew != 0u) {
    const uint32_t s = bits(fold_in(tkey, 2u), (uint64_t)i);
    skew = s < (f.skew >> 1) ? 0 : (s < f.skew ? 2 : 1);
  }
  RD_OUT(int32_t, O_SKEW, n, i) = skew;
  RD_OUT(int32_t, O_TIMEOUT_DRAW, n, i) =
      randint(fold_in(tkey, 1u), (uint64_t)i, p.el_min, (int64_t)p.el_min + p.el_range);

  // The crash schedule at now and now - 1, both under the segment at now.
  const Key ckey = fold_in(k_part, 0xFFFFFFFFu);
  const bool alive = alive_at(ckey, now, i, p.crash_period, f.crash, f.crash_down);
  const bool alive_prev = alive_at(ckey, now - 1, i, p.crash_period, f.crash, f.crash_down);
  RD_OUT(uint8_t, O_ALIVE, n, i) = alive;
  RD_OUT(uint8_t, O_RESTARTED, n, i) = alive && !alive_prev;
  if (p.facts) RD_OUT(uint8_t, F_CRASHED, n, i) = alive_prev && !alive;

  // The storage draws, split(fold_in(tkey, 7), 3): a flush on the cadence
  // tick unless the jitter draw stalls it; the torn tail drawn every tick.
  const Key k_disk = fold_in(tkey, 7u);
  bool fire = cadence(f.fsync_interval, now);
  if (fire && f.jit != 0u) fire = !(bits(fold_in(k_disk, 0u), (uint64_t)i) < f.jit);
  int32_t torn = 0;
  if (f.torn != 0u && bits(fold_in(k_disk, 1u), (uint64_t)i) < f.torn)
    torn = randint(fold_in(k_disk, 2u), (uint64_t)i, 1, (int64_t)f.torn_span + 1);
  RD_OUT(uint8_t, O_FSYNC_FIRE, n, i) = fire;
  RD_OUT(int32_t, O_TORN_DROP, n, i) = torn;

  if (i != 0) return;
  // ---- the row's scalars ----
  RD_OUT(int32_t, O_CLIENT_CMD, 1, 0) =
      cadence(f.client_interval, now) ? (int32_t)(now + 1) : NIL;
  // Redirect routing, split(fold_in(tkey, 3), 2): a target, K bounce slots.
  const Key k_route = fold_in(tkey, 3u);
  RD_OUT(int32_t, O_CLIENT_TARGET, 1, 0) = p.redirect ? randint(fold_in(k_route, 0u), 0, 0, n) : 0;
  for (int s = 0; s < p.k; ++s)
    RD_OUT(int32_t, O_CLIENT_BOUNCE, p.k, s) =
        p.redirect ? randint(fold_in(k_route, 1u), (uint64_t)s, 0, n) : 0;
  // Admin offers, split(fold_in(tkey, 5), 2): toggles and transfers on their
  // cadence from tick 1, reads on theirs from tick 0.
  const Key k_admin = fold_in(tkey, 5u);
  RD_OUT(int32_t, O_RECONFIG_CMD, 1, 0) = cadence(f.reconfig_interval, now) && now > 0
                                              ? randint(fold_in(k_admin, 0u), 0, 0, n)
                                              : NIL;
  RD_OUT(int32_t, O_TRANSFER_CMD, 1, 0) = cadence(f.transfer_interval, now) && now > 0
                                              ? randint(fold_in(k_admin, 1u), 0, 0, n)
                                              : NIL;
  RD_OUT(int32_t, O_READ_CMD, 1, 0) = cadence(f.read_interval, now) ? 1 : NIL;
  if (p.facts) {
    // The cut counts from the staged rows (0 before tick 0 or off a window).
    RD_OUT(int32_t, F_CUT_NOW, 1, 0) =
        x.win.active && now >= 0 ? staged_cut(st.row(0, local), n, p.w) : 0;
    RD_OUT(int32_t, F_CUT_PREV, 1, 0) = x.prev.active ? staged_cut(st.row(1, local), n, p.w) : 0;
  }
#undef RD_OUT
}

}  // namespace rd
