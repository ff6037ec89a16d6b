// One Raft tick for one cluster, as a scalar algorithm: the per-cluster body of
// the Hopper tick kernel (tick.cu) and of its CPU build (tick_host.cpp).
//
// Semantics are raft_sim_tpu/models/raft_batched.py `_step_b` + `_step_info_b`
// (dense layout, single device) over the gate set of presets config1-config10
// and config3p: invariants, log matching, the client's cadence (direct, or the
// redirect client with its K-deep pipeline) with the offer-tick latency plane,
// drop, partitions, skew, crash/restart, ring-log compaction with the
// InstallSnapshot analogue, PreVote, and the reconfiguration plane: log-carried
// joint-consensus membership (with the snapshot config context under
// compaction), TimeoutNow transfer, ReadIndex and lease reads, and the durable
// storage plane (fsync watermarks, the durability gate, crash recovery).
// Every leaf it writes equals the JAX tick's. The JAX form is a vectorised
// `where` lattice over [N, N, B] planes; here thread b walks its own cluster
// with loops over nodes and log entries, in the JAX phase order (-1 restart
// and recovery, 0 delivery, 1 term adoption, 2 RequestVote, 3 AppendEntries
// and snapshot install, 3.5 PreVote requests, 3.7 TimeoutNow receipt,
// 4 responses, 4.5 PreVote promotion, 5 commit, 5.2 transfer and reads,
// latency, 5.5 compaction and the ring checksum, 6 no-op / config entry /
// client injection / redirect routing, 7 timers, 7.5 fsync flush and the
// durability gate, 8 outbox, prefix checksum, end-of-tick configuration,
// 9 StepInfo).
//
// Membership: every quorum a node tests (elections, pre-votes, commit, read
// confirmation, leases, transfer targets) is masked by that node's TICK-START
// member rows (m_old / m_new, dual while its cfg_pend is open); the rows
// derived from the log at the end of the tick go to the output only.
//
// Durable storage: three snapshots of the watermark. `dur_mid` is the
// tick-start dur_len clamped by phase 3's truncation, and is what a leader's
// own slot in the commit quorum reads (phase 5); the flush (phase 7.5) snaps
// to the final log length, term and vote, and the ack clamp reads that
// post-flush value. Recovery (phase -1) rewinds term/vote/log_len at load.
//
// Layout: every leaf is batch-minor. Leaf [d0, d1, ..., B] element
// (i, j, ..., b) sits at ((i * d1 + j) * ... ) * B + b, so neighbouring
// threads touch neighbouring addresses. The wrapper (kernels/tick_engine.py)
// passes one pointer per leaf in the order of the Ptr enum below; output
// leaves are fresh buffers, never aliases of inputs. A leg whose gate is off
// gets a null pointer and is never touched (the wrapper passes it through).
//
// Log layout: without compaction 1-based entry i sits at slot i - 1; under
// compaction (P.comp) at slot (i - 1) mod CAP, with the live entries
// (log_base, log_len] and the compacted prefix summarised by (log_base,
// base_term, base_chk).
//
// Integer rules: uint32 legs (packed planes, checksums) use uint32_t, whose
// arithmetic wraps mod 2^32 like the JAX uint32 leaves; signed values never
// overflow on a well-formed state (the JAX dtype-tier bounds), and signed
// modulo is taken only through pmod (floor modulo, as jnp's `%`).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define RS_HD __host__ __device__ __forceinline__
#else
#define RS_HD inline
#endif

namespace rs {

constexpr int MAXN = 64;  // nodes per cluster this body supports
constexpr int MAXW = 2;   // packed words per node row (ceil(MAXN / 32))
constexpr int MAXE = 16;  // entries per AppendEntries window
constexpr int MAXK = 16;  // redirect pipeline slots (RaftConfig.client_pipeline <= 16)
constexpr int BINS = 16;  // latency histogram bins (types.LAT_HIST_BINS)

constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, PRECANDIDATE = 3;
constexpr int NIL = -1, NOOP = -2;
constexpr int REQ_VOTE = 1, REQ_APPEND = 2, REQ_PREVOTE = 3, REQ_TIMEOUT_NOW = 4;
constexpr int RESP_VOTE = 1, RESP_APPEND = 2, RESP_PREVOTE = 3;

// Leaf pointers, in the order tick_engine.PTR_ORDER lists them.
enum Ptr {
  // ClusterState, read
  S_ROLE, S_TERM, S_VOTED_FOR, S_LEADER_ID, S_VOTES, S_NEXT_INDEX,
  S_MATCH_INDEX, S_ACK_AGE, S_COMMIT_INDEX, S_COMMIT_CHK, S_LOG_BASE,
  S_BASE_TERM, S_BASE_CHK, S_LOG_TERM, S_LOG_VAL, S_LOG_TICK, S_LOG_LEN,
  S_CLOCK, S_DEADLINE, S_HEARD_CLOCK, S_CLIENT_PEND, S_CLIENT_DST,
  S_CLIENT_TICK, S_LAT_FRONTIER, S_NOW, S_MEMBER_OLD, S_MEMBER_NEW,
  S_CFG_EPOCH, S_CFG_PEND, S_LOG_CFG, S_BASE_MOLD, S_BASE_PEND, S_BASE_EPOCH,
  S_XFER_TO, S_READ_IDX, S_READ_TICK, S_READ_ACKS, S_READ_FR, S_DUR_LEN,
  S_DUR_TERM, S_DUR_VOTE,
  // Mailbox, read
  M_REQ_TYPE, M_REQ_TERM, M_REQ_COMMIT, M_REQ_LAST_INDEX, M_REQ_LAST_TERM,
  M_ENT_START, M_ENT_PREV_TERM, M_ENT_COUNT, M_ENT_TERM, M_ENT_VAL,
  M_ENT_TICK, M_REQ_BASE, M_REQ_BASE_TERM, M_REQ_BASE_CHK, M_REQ_OFF,
  M_RESP_KIND, M_PV_GRANT, M_V_TO, M_A_OK_TO, M_A_MATCH, M_A_HINT,
  M_RESP_TERM, M_XFER_TGT, M_REQ_DISRUPT, M_ENT_CFG, M_REQ_BASE_MOLD,
  M_REQ_BASE_PEND, M_REQ_BASE_EPOCH,
  // StepInputs, read
  I_DELIVER_MASK, I_SKEW, I_TIMEOUT_DRAW, I_CLIENT_CMD, I_CLIENT_TARGET,
  I_CLIENT_BOUNCE, I_ALIVE, I_RESTARTED, I_RECONFIG_CMD, I_TRANSFER_CMD,
  I_READ_CMD, I_FSYNC_FIRE, I_TORN_DROP,
  // ClusterState, written
  O_ROLE, O_TERM, O_VOTED_FOR, O_LEADER_ID, O_VOTES, O_NEXT_INDEX,
  O_MATCH_INDEX, O_ACK_AGE, O_COMMIT_INDEX, O_COMMIT_CHK, O_LOG_BASE,
  O_BASE_TERM, O_BASE_CHK, O_LOG_TERM, O_LOG_VAL, O_LOG_TICK, O_LOG_LEN,
  O_CLOCK, O_DEADLINE, O_HEARD_CLOCK, O_CLIENT_PEND, O_CLIENT_DST,
  O_CLIENT_TICK, O_LAT_FRONTIER, O_NOW, O_MEMBER_OLD, O_MEMBER_NEW,
  O_CFG_EPOCH, O_CFG_PEND, O_LOG_CFG, O_BASE_MOLD, O_BASE_PEND, O_BASE_EPOCH,
  O_XFER_TO, O_READ_IDX, O_READ_TICK, O_READ_ACKS, O_READ_FR, O_DUR_LEN,
  O_DUR_TERM, O_DUR_VOTE,
  // Mailbox, written
  OM_REQ_TYPE, OM_REQ_TERM, OM_REQ_COMMIT, OM_REQ_LAST_INDEX,
  OM_REQ_LAST_TERM, OM_ENT_START, OM_ENT_PREV_TERM, OM_ENT_COUNT,
  OM_ENT_TERM, OM_ENT_VAL, OM_ENT_TICK, OM_REQ_BASE, OM_REQ_BASE_TERM,
  OM_REQ_BASE_CHK, OM_REQ_OFF, OM_RESP_KIND, OM_PV_GRANT, OM_V_TO,
  OM_A_OK_TO, OM_A_MATCH, OM_A_HINT, OM_RESP_TERM, OM_XFER_TGT,
  OM_REQ_DISRUPT, OM_ENT_CFG, OM_REQ_BASE_MOLD, OM_REQ_BASE_PEND,
  OM_REQ_BASE_EPOCH,
  // StepInfo, written
  F_VIOL_ELECTION_SAFETY, F_VIOL_COMMIT, F_VIOL_LOG_MATCHING, F_LEADER,
  F_N_LEADERS, F_MAX_TERM, F_MAX_COMMIT, F_MIN_COMMIT, F_MSGS_DELIVERED,
  F_CMDS_INJECTED, F_LAT_SUM, F_LAT_CNT, F_LAT_HIST, F_LAT_EXCLUDED,
  F_NOOP_BLOCKED, F_READS_SERVED, F_READ_LAT_SUM, F_READ_HIST,
  F_VIOL_READ_STALE, F_FSYNC_LAG_SUM, F_FSYNC_LAG_MAX,
  N_PTR
};

struct TickParams {
  int64_t b;             // clusters: the batch-minor stride
  int32_t n, e, cap, w;  // nodes, window entries, log capacity, words per row
  int32_t quorum, heartbeat, ack_sat, ack_timeout;
  int32_t check_invariants;  // cfg.check_invariants
  int32_t log_matching_due;  // the host-side cadence decision for this tick
  int32_t track;             // cfg.track_offer_ticks (offer-tick plane live)
  int32_t comp;              // cfg.compaction (ring log + snapshot catch-up)
  int32_t compact_margin;    // cfg.compact_margin
  int32_t pre_vote;          // cfg.pre_vote
  int32_t election_min;      // cfg.election_min_ticks (the PreVote quiet window)
  int32_t redirect;          // cfg.client_redirect (the K-deep pipeline)
  int32_t k;                 // cfg.client_pipeline
  int32_t reconfig;          // cfg.reconfig (log-carried membership)
  int32_t transfer;          // cfg.leader_transfer (TimeoutNow)
  int32_t reads;             // cfg.read_index (ReadIndex reads)
  int32_t lease;             // cfg.read_lease (lease reads)
  int32_t lease_ticks;       // cfg.read_lease_ticks (the lease window on ack_age)
  int32_t durable;           // cfg.durable_storage (fsync watermarks, recovery)
  int32_t durable_acks;      // cfg.durable_acks (the durability gate; 1 in production)
};

RS_HD int imin(int a, int b) { return a < b ? a : b; }
RS_HD int imax(int a, int b) { return a > b ? a : b; }
RS_HD int iclamp(int x, int lo, int hi) { return imin(imax(x, lo), hi); }
RS_HD int pmod(int x, int m) {  // floor modulo (jnp's `%`), m > 0
  const int r = x % m;
  return r < 0 ? r + m : r;
}

RS_HD int popcount32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// floor(log2(v)) clamped to [0, BINS) (log_ops.log2_bin); v in {0, 1} -> 0.
RS_HD int log2_bin(int v) {
  int bl = 0;
  for (int sft = 16; sft >= 1; sft >>= 1) {
    if (v >= (1 << sft)) {
      bl += sft;
      v >>= sft;
    }
  }
  return imin(bl, BINS - 1);
}

// Committed-prefix checksum weights of 0-based entry k (log_ops.chk_weights_at).
RS_HD uint32_t chk_w_term(uint32_t k) { return (k * 2654435761u + 0x9E3779B9u) | 1u; }
RS_HD uint32_t chk_w_val(uint32_t k) { return (k * 0x85EBCA77u + 0xC2B2AE3Du) | 1u; }

// Set bits of the packed row a & b (b == nullptr: all of a).
RS_HD int popc_and(const uint32_t* a, const uint32_t* b, int W) {
  int c = 0;
  for (int w = 0; w < W; ++w) c += popcount32(b ? (a[w] & b[w]) : a[w]);
  return c;
}

RS_HD bool has_bit(const uint32_t* row, int i) { return (row[i >> 5] >> (i & 31)) & 1u; }

// The maj-th largest of mws[k] over the members k of `mask` (0 when there
// are fewer): the configuration-masked quorum match of one leader.
RS_HD int masked_qmatch(const int* mws, int n, const uint32_t* mask, int maj) {
  int qm = 0;
  for (int c = 0; c < n; ++c) {
    if (!has_bit(mask, c)) continue;
    int cnt = 0;
    for (int k = 0; k < n; ++k) cnt += has_bit(mask, k) && mws[k] >= mws[c];
    if (cnt >= maj && mws[c] > qm) qm = mws[c];
  }
  return qm;
}

// One parity fold over a node's config entries with absolute index in
// (lo, hi], slot k holding entry anchor + pmod(k - anchor, cap) + 1 on a ring
// (k + 1 otherwise): final entries (code < 0) toggle bit -code - 1 of `fold`;
// returns the entry count, and the latest entry's index and code.
struct CfgFold {
  uint32_t fold[MAXW];
  int hi, code_hi, count;
};

RS_HD CfgFold fold_cfg(const int32_t* row, int64_t B, int cap, int n, int W, bool ring,
                       int anchor, int lo, int hi) {
  CfgFold f;
  for (int w = 0; w < W; ++w) f.fold[w] = 0u;
  f.hi = f.code_hi = f.count = 0;
  for (int k = 0; k < cap; ++k) {
    const int abs1 = ring ? anchor + pmod(k - anchor, cap) + 1 : k + 1;
    if (abs1 <= lo || abs1 > hi) continue;
    const int code = row[(int64_t)k * B];
    if (code == 0) continue;
    ++f.count;
    if (abs1 > f.hi) {
      f.hi = abs1;
      f.code_hi = code;
    }
    const int v = -code - 1;
    if (code < 0 && v < n) f.fold[v >> 5] ^= 1u << (v & 31);
  }
  return f;
}

// Term of 1-based entry idx in the row whose slot s sits at row[s * B]
// (log_ops.term_at_b / term_at_rb): 0 for "no entry"; on a ring, base_term at
// or below the base; without the ring, 0 outside [1, cap].
RS_HD int term_at(const int32_t* row, int64_t B, int cap, bool ring, int base, int bterm,
                  int idx) {
  if (ring) {
    if (idx == 0) return 0;
    if (idx <= base) return bterm;
    return row[(int64_t)pmod(idx - 1, cap) * B];
  }
  return (idx >= 1 && idx <= cap) ? row[(int64_t)(idx - 1) * B] : 0;
}

template <class IdxT, class AckT, class NodeT>
RS_HD void tick_cluster(const TickParams& P, void* const* ptr, int64_t b) {
  const int n = P.n, e = P.e, cap = P.cap, W = P.w;
  const bool comp = P.comp != 0, pv = P.pre_vote != 0;
  const bool rcf = P.reconfig != 0, xfr = P.transfer != 0, rdx = P.reads != 0;
  const bool rdl = P.lease != 0;
  const bool dur = P.durable != 0;
  const bool dacks = dur && P.durable_acks != 0;  // the durability gate
  const bool hc_live = pv || rdl || rcf;  // heard_clock: quiet rule and vote denial
  const bool deny = rcf || rdl;           // the heard-a-leader vote denial
  const bool disrupt_live = xfr && deny;  // req_disrupt overrides the denial
  const int64_t B = P.b;
  // Batch-minor offsets: [N, B] and [N, inner, B].
#define RS_AT1(i) ((int64_t)(i) * B + b)
#define RS_AT2(i, j, inner) (((int64_t)(i) * (inner) + (j)) * B + b)
#define RS_IN(T, P_) ((const T*)ptr[P_])
#define RS_OUT(T, P_) ((T*)ptr[P_])
#define RS_ROW(arr, i) ((arr) + RS_AT2(i, 0, cap))  // slot s of node i at [s * B]

  const int32_t now = RS_IN(int32_t, S_NOW)[b];
  const int32_t lat_frontier0 = RS_IN(int32_t, S_LAT_FRONTIER)[b];
  const int32_t client_cmd = RS_IN(int32_t, I_CLIENT_CMD)[b];
  const int32_t* log_term_in = RS_IN(int32_t, S_LOG_TERM);
  const int32_t* log_val_in = RS_IN(int32_t, S_LOG_VAL);
  const int32_t* log_tick_in = RS_IN(int32_t, S_LOG_TICK);
  const int32_t* log_cfg_in = RS_IN(int32_t, S_LOG_CFG);
  int32_t* log_term = RS_OUT(int32_t, O_LOG_TERM);
  int32_t* log_val = RS_OUT(int32_t, O_LOG_VAL);
  int32_t* log_tick = RS_OUT(int32_t, O_LOG_TICK);
  int32_t* log_cfg = RS_OUT(int32_t, O_LOG_CFG);
  const IdxT* next_in = RS_IN(IdxT, S_NEXT_INDEX);
  const IdxT* match_in = RS_IN(IdxT, S_MATCH_INDEX);
  const AckT* ack_in = RS_IN(AckT, S_ACK_AGE);
  IdxT* next_out = RS_OUT(IdxT, O_NEXT_INDEX);
  IdxT* match_out = RS_OUT(IdxT, O_MATCH_INDEX);
  AckT* ack_out = RS_OUT(AckT, O_ACK_AGE);
  const int8_t* resp_kind_in = RS_IN(int8_t, M_RESP_KIND);
  const int8_t* req_off_in = RS_IN(int8_t, M_REQ_OFF);

  // Per-node state, after phase -1 (restart).
  bool alive[MAXN], rs_[MAXN], up[MAXN];
  int role[MAXN], term[MAXN], vf[MAXN], lid[MAXN];
  int len0[MAXN], llen[MAXN], commit0[MAXN], commit[MAXN];
  int base0[MAXN], bterm0[MAXN], base[MAXN], bterm[MAXN];  // input and current snapshot
  int clock0[MAXN], clock1[MAXN], deadline0[MAXN], tdraw[MAXN], heard[MAXN];
  bool heard_recent[MAXN];  // heard a leader within election_min of the tick's clock
  int my_last_term[MAXN];
  uint32_t votes[MAXN][MAXW], mask[MAXN][MAXW], pvg[MAXN][MAXW];
  uint32_t chk0[MAXN], bchk[MAXN], chk_new[MAXN];
  // Membership: tick-start rows and the snapshot config context.
  uint32_t m_old[MAXN][MAXW], m_new[MAXN][MAXW], bmold[MAXN][MAXW];
  bool joint[MAXN], member_b[MAXN];
  int maj_old[MAXN], maj_new[MAXN], cfg_pend0[MAXN], bpend[MAXN], bepoch[MAXN];
  // Transfer and reads, after the restart wipe.
  int xfer0[MAXN], xto[MAXN], read_idx0[MAXN], read_tick0[MAXN], read_fr0[MAXN];
  uint32_t acks[MAXN][MAXW];
  // Mailbox headers, per sender / responder.
  int rtype[MAXN], rterm[MAXN], rli[MAXN], rlt[MAXN], xtgt[MAXN];
  bool disrupt[MAXN];
  int resp_term[MAXN], v_to[MAXN], a_ok_to[MAXN], a_match[MAXN], a_hint[MAXN];
  // Per-node facts carried between phases.
  bool saw_higher[MAXN], granted_any[MAXN], has_ae[MAXN], win[MAXN], pre_win[MAXN];
  bool applied_snap[MAXN], is_leader[MAXN], heartbeat[MAXN], start_el[MAXN], start_pv[MAXN];
  bool xfer_elect[MAXN], xe[MAXN], xpend[MAXN];
  int grant_to[MAXN], age_t[MAXN];
  uint32_t fresh[MAXN][MAXW];  // peers acked within the lease window (lease)
  int len4[MAXN];  // log length after phase 3: the phase-4/phase-8 `len_i`
  // Durable storage: the watermark after phase 3's truncation, and the grants
  // a flush newly covered this tick (phase 7.5).
  int dur_mid[MAXN];
  bool late_grant[MAXN];

  for (int i = 0; i < n; ++i) {
    alive[i] = RS_IN(uint8_t, I_ALIVE)[RS_AT1(i)] != 0;
    rs_[i] = RS_IN(uint8_t, I_RESTARTED)[RS_AT1(i)] != 0;
    up[i] = alive[i] && !rs_[i];
    tdraw[i] = RS_IN(int32_t, I_TIMEOUT_DRAW)[RS_AT1(i)];
    clock0[i] = RS_IN(int32_t, S_CLOCK)[RS_AT1(i)];
    clock1[i] = clock0[i] + RS_IN(int32_t, I_SKEW)[RS_AT1(i)];
    base0[i] = base[i] = RS_IN(int32_t, S_LOG_BASE)[RS_AT1(i)];
    bterm0[i] = bterm[i] = comp ? RS_IN(int32_t, S_BASE_TERM)[RS_AT1(i)] : 0;
    bchk[i] = RS_IN(uint32_t, S_BASE_CHK)[RS_AT1(i)];
    role[i] = rs_[i] ? FOLLOWER : RS_IN(int32_t, S_ROLE)[RS_AT1(i)];
    lid[i] = rs_[i] ? NIL : RS_IN(int32_t, S_LEADER_ID)[RS_AT1(i)];
    term[i] = RS_IN(int32_t, S_TERM)[RS_AT1(i)];
    vf[i] = RS_IN(int32_t, S_VOTED_FOR)[RS_AT1(i)];
    len0[i] = RS_IN(int32_t, S_LOG_LEN)[RS_AT1(i)];
    if (dur && rs_[i]) {
      // Crash recovery: term and vote rewind to the durable snapshot; the
      // log keeps its fsynced prefix (a floor) and the rest less a torn tail.
      term[i] = RS_IN(int32_t, S_DUR_TERM)[RS_AT1(i)];
      vf[i] = RS_IN(int32_t, S_DUR_VOTE)[RS_AT1(i)];
      len0[i] = imax(RS_IN(int32_t, S_DUR_LEN)[RS_AT1(i)],
                     len0[i] - RS_IN(int32_t, I_TORN_DROP)[RS_AT1(i)]);
    }
    commit0[i] = rs_[i] ? base0[i] : RS_IN(int32_t, S_COMMIT_INDEX)[RS_AT1(i)];
    chk0[i] = rs_[i] ? bchk[i] : RS_IN(uint32_t, S_COMMIT_CHK)[RS_AT1(i)];
    deadline0[i] = rs_[i] ? clock0[i] + tdraw[i] : RS_IN(int32_t, S_DEADLINE)[RS_AT1(i)];
    // A restarted node remembers no leader contact.
    heard[i] = !hc_live ? 0
               : rs_[i] ? clock0[i] - P.election_min
                        : RS_IN(int32_t, S_HEARD_CLOCK)[RS_AT1(i)];
    for (int w = 0; w < W; ++w) {
      votes[i][w] = rs_[i] ? 0u : RS_IN(uint32_t, S_VOTES)[RS_AT2(i, w, W)];
      mask[i][w] = RS_IN(uint32_t, I_DELIVER_MASK)[RS_AT2(i, w, W)];
      pvg[i][w] = 0u;
    }
    // The reconfiguration plane's legs are loaded (and their local arrays
    // touched) only under their gates; every later read is gated the same way.
    if (deny) heard_recent[i] = clock1[i] - heard[i] < P.election_min;
    if (rcf) {
      cfg_pend0[i] = RS_IN(int32_t, S_CFG_PEND)[RS_AT1(i)];
      joint[i] = cfg_pend0[i] > 0;
      bpend[i] = RS_IN(int32_t, S_BASE_PEND)[RS_AT1(i)];
      bepoch[i] = RS_IN(int32_t, S_BASE_EPOCH)[RS_AT1(i)];
      for (int w = 0; w < W; ++w) {
        m_old[i][w] = RS_IN(uint32_t, S_MEMBER_OLD)[RS_AT2(i, w, W)];
        m_new[i][w] = RS_IN(uint32_t, S_MEMBER_NEW)[RS_AT2(i, w, W)];
        bmold[i][w] = RS_IN(uint32_t, S_BASE_MOLD)[RS_AT2(i, w, W)];
      }
      maj_old[i] = popc_and(m_old[i], nullptr, W) / 2 + 1;
      maj_new[i] = popc_and(m_new[i], nullptr, W) / 2 + 1;
      member_b[i] = has_bit(m_old[i], i) || has_bit(m_new[i], i);  // i in its own view
    }
    // Volatile transfer and read state dies with the process.
    if (xfr) {
      xfer0[i] = rs_[i] ? NIL : RS_IN(int32_t, S_XFER_TO)[RS_AT1(i)];
      xtgt[i] = RS_IN(NodeT, M_XFER_TGT)[RS_AT1(i)];
    }
    if (disrupt_live) disrupt[i] = RS_IN(int8_t, M_REQ_DISRUPT)[RS_AT1(i)] != 0;
    if (rdx) {
      read_idx0[i] = rs_[i] ? 0 : RS_IN(int32_t, S_READ_IDX)[RS_AT1(i)];
      read_tick0[i] = rs_[i] ? 0 : RS_IN(int32_t, S_READ_TICK)[RS_AT1(i)];
      for (int w = 0; w < W; ++w)
        acks[i][w] = rs_[i] ? 0u : RS_IN(uint32_t, S_READ_ACKS)[RS_AT2(i, w, W)];
    }
    if (rdl) read_fr0[i] = rs_[i] ? 0 : RS_IN(int32_t, S_READ_FR)[RS_AT1(i)];
    rtype[i] = RS_IN(int32_t, M_REQ_TYPE)[RS_AT1(i)];
    rterm[i] = RS_IN(int32_t, M_REQ_TERM)[RS_AT1(i)];
    rli[i] = RS_IN(int32_t, M_REQ_LAST_INDEX)[RS_AT1(i)];
    rlt[i] = RS_IN(int32_t, M_REQ_LAST_TERM)[RS_AT1(i)];
    resp_term[i] = RS_IN(int32_t, M_RESP_TERM)[RS_AT1(i)];
    v_to[i] = RS_IN(NodeT, M_V_TO)[RS_AT1(i)];
    a_ok_to[i] = RS_IN(NodeT, M_A_OK_TO)[RS_AT1(i)];
    a_match[i] = RS_IN(IdxT, M_A_MATCH)[RS_AT1(i)];
    a_hint[i] = RS_IN(IdxT, M_A_HINT)[RS_AT1(i)];
    // The log copies forward; phases 3 and 6 overwrite what they append.
    for (int k = 0; k < cap; ++k) {
      log_term[RS_AT2(i, k, cap)] = log_term_in[RS_AT2(i, k, cap)];
      log_val[RS_AT2(i, k, cap)] = log_val_in[RS_AT2(i, k, cap)];
      if (P.track) log_tick[RS_AT2(i, k, cap)] = log_tick_in[RS_AT2(i, k, cap)];
      if (rcf) log_cfg[RS_AT2(i, k, cap)] = log_cfg_in[RS_AT2(i, k, cap)];
    }
  }

  // Quorum test of node i over a packed row: its own member rows, dual while
  // joint (reconfig), else the fixed majority.
#define RS_QUORUM(i, rows)                                                          \
  (rcf ? (popc_and(rows, m_old[i], W) >= maj_old[i] &&                             \
          (!joint[i] || popc_and(rows, m_new[i], W) >= maj_new[i]))                \
       : popc_and(rows, nullptr, W) >= P.quorum)

  // ---- phase 0: delivery. The message on physical edge [dst d, src s] is
  // delivered iff d is up now and was at send time, s is alive, s != d, and
  // bit s of d's mask row is set. Requests ride [sender, receiver] edges,
  // responses [receiver, responder] -- the same physical edge test.
#define RS_DELIVERED(d, s) \
  (up[d] && (s) != (d) && alive[s] && ((mask[d][(s) >> 5] >> ((s) & 31)) & 1u))
  // Voter v denies candidate c's RequestVote: v heard a leader recently and
  // the request carries no transfer sanction.
#define RS_DENIED(c, v) (deny && heard_recent[v] && !(disrupt_live && disrupt[c]))

  // ---- phase 1: term adoption (PreVote probes carry a prospective term,
  // never adopted; a denied RequestVote under reconfig is not processed) ------
  int msgs = 0;
  for (int d = 0; d < n; ++d) {
    int in_term = 0;
    for (int s = 0; s < n; ++s) {
      if (!RS_DELIVERED(d, s)) continue;
      if (rtype[s] != 0) {
        ++msgs;
        const bool probe = pv && rtype[s] == REQ_PREVOTE;
        const bool denied = rcf && rtype[s] == REQ_VOTE && RS_DENIED(s, d);
        if (!probe && !denied) in_term = imax(in_term, rterm[s]);
      }
      if (resp_kind_in[RS_AT2(d, s, n)] != 0) {
        ++msgs;
        in_term = imax(in_term, resp_term[s]);
      }
    }
    saw_higher[d] = in_term > term[d];
    if (saw_higher[d]) {
      term[d] = in_term;
      role[d] = FOLLOWER;
      vf[d] = NIL;
      lid[d] = NIL;
      for (int w = 0; w < W; ++w) votes[d][w] = 0u;
    }
    my_last_term[d] = term_at(RS_ROW(log_term_in, d), B, cap, comp, base0[d], bterm0[d], len0[d]);
  }

  // Up-to-date test of candidate c's log against voter v's (phases 2 and 3.5).
#define RS_UTD(c, v) \
  (rlt[c] > my_last_term[v] || (rlt[c] == my_last_term[v] && rli[c] >= len0[v]))

  // ---- phase 2: RequestVote requests --------------------------------------
  for (int v = 0; v < n; ++v) {
    int lowest = n;
    bool grant_prev = false;  // the candidate v already voted for is grantable
    for (int c = 0; c < n; ++c) {
      if (!RS_DELIVERED(v, c) || rtype[c] != REQ_VOTE || rterm[c] != term[v]) continue;
      if (!RS_UTD(c, v) || RS_DENIED(c, v)) continue;
      if (c < lowest) lowest = c;
      if (c == vf[v]) grant_prev = true;
    }
    granted_any[v] = (vf[v] != NIL) ? grant_prev : (lowest < n);
    if (vf[v] == NIL && granted_any[v]) vf[v] = lowest;
    grant_to[v] = granted_any[v] ? vf[v] : NIL;
  }

  // ---- phase 3: AppendEntries requests and snapshot install ----------------
  for (int f = 0; f < n; ++f) {
    int src = n;
    for (int l = 0; l < n; ++l) {
      if (RS_DELIVERED(f, l) && rtype[l] == REQ_APPEND && rterm[l] == term[f]) {
        src = l;
        break;
      }
    }
    has_ae[f] = src < n;
    int j_in = 0, ws_in = 0, lcommit = 0, ecount = 0, eprev = 0;
    int w_term[MAXE], w_val[MAXE], w_tick[MAXE], w_cfg[MAXE];
    for (int k = 0; k < e; ++k) w_term[k] = w_val[k] = w_tick[k] = w_cfg[k] = 0;
    if (has_ae[f]) {
      j_in = req_off_in[RS_AT2(src, f, n)];
      ws_in = RS_IN(int32_t, M_ENT_START)[RS_AT1(src)];
      lcommit = RS_IN(int32_t, M_REQ_COMMIT)[RS_AT1(src)];
      ecount = RS_IN(int32_t, M_ENT_COUNT)[RS_AT1(src)];
      eprev = RS_IN(int32_t, M_ENT_PREV_TERM)[RS_AT1(src)];
      for (int k = 0; k < e; ++k) {
        w_term[k] = RS_IN(int32_t, M_ENT_TERM)[RS_AT2(src, k, e)];
        w_val[k] = RS_IN(int32_t, M_ENT_VAL)[RS_AT2(src, k, e)];
        if (P.track) w_tick[k] = RS_IN(int32_t, M_ENT_TICK)[RS_AT2(src, k, e)];
        if (rcf) w_cfg[k] = RS_IN(int32_t, M_ENT_CFG)[RS_AT2(src, k, e)];
      }
    }
    // The InstallSnapshot analogue: offset sentinel -1.
    const bool snap = comp && has_ae[f] && j_in < 0;
    const bool ae_norm = has_ae[f] && !snap;
    const int j = iclamp(j_in, 0, e);
    const int prev_i = ae_norm ? ws_in + j : 0;
    const int n_ent = ae_norm ? iclamp(ecount - j, 0, e) : 0;
    const int prev_t = (j == 0) ? eprev : w_term[j - 1];
    const int off = iclamp(j, 0, e - 1);  // this receiver's entries start at slot j
    if (has_ae[f]) {
      if (role[f] == CANDIDATE || (pv && role[f] == PRECANDIDATE)) role[f] = FOLLOWER;
      lid[f] = src;
    }
    const int stored_prev =
        term_at(RS_ROW(log_term_in, f), B, cap, comp, base0[f], bterm0[f], prev_i);
    // Under compaction a prev below the base is committed and compacted.
    const bool ae_ok = ae_norm && (prev_i == 0 || (comp && prev_i < base0[f]) ||
                                   (prev_i <= len0[f] && stored_prev == prev_t));
    // Entries [lo, n_acc) of the window are written: the ring skips what is
    // already compacted and accepts only what it can hold.
    const int lo = comp ? iclamp(base0[f] - prev_i, 0, e) : 0;
    const int n_acc = comp ? imin(n_ent, imax(base0[f] + cap - prev_i, 0)) : n_ent;
    bool mismatch = false;
    for (int k = lo; k < n_acc; ++k) {
      if (prev_i + k < len0[f]) {
        const int sl = comp ? pmod(prev_i + k, cap) : iclamp(prev_i + k, 0, cap - 1);
        if (log_term_in[RS_AT2(f, sl, cap)] != w_term[imin(off + k, e - 1)]) mismatch = true;
      }
    }
    const int appended = comp ? prev_i + n_acc : imin(prev_i + n_ent, cap);
    llen[f] = ae_ok ? (mismatch ? appended : imax(len0[f], appended)) : len0[f];
    if (dur) dur_mid[f] = imin(RS_IN(int32_t, S_DUR_LEN)[RS_AT1(f)], llen[f]);
    if (ae_ok) {
      for (int k = lo; k < n_acc; ++k) {
        const int slot = comp ? pmod(prev_i + k, cap) : prev_i + k;
        if (slot < 0 || slot >= cap) continue;
        const int wk = imin(off + k, e - 1);
        log_term[RS_AT2(f, slot, cap)] = w_term[wk];
        log_val[RS_AT2(f, slot, cap)] = w_val[wk];
        if (P.track) log_tick[RS_AT2(f, slot, cap)] = w_tick[wk];
        // Non-config entries ship 0 and scrub stale commands off reused slots.
        if (rcf) log_cfg[RS_AT2(f, slot, cap)] = w_cfg[wk];
      }
    }
    const int last_new = imax(imin(prev_i + n_acc, llen[f]), 0);
    commit[f] = ae_ok ? imax(commit0[f], imin(lcommit, last_new)) : commit0[f];
    // Snapshot install: adopt the sender's base (and config context); keep our
    // suffix when it extends through L with L's term, else wipe the log to L.
    int L = 0;
    applied_snap[f] = false;
    if (snap) {
      L = RS_IN(int32_t, M_REQ_BASE)[RS_AT1(src)];
      const int Lt = RS_IN(int32_t, M_REQ_BASE_TERM)[RS_AT1(src)];
      if (L > base0[f]) {
        applied_snap[f] = true;
        const bool keep = L <= len0[f] &&
            term_at(RS_ROW(log_term_in, f), B, cap, true, base0[f], bterm0[f], L) == Lt;
        bterm[f] = Lt;
        bchk[f] = RS_IN(uint32_t, M_REQ_BASE_CHK)[RS_AT1(src)];
        base[f] = L;
        if (!keep) llen[f] = L;
        commit[f] = imax(commit[f], L);
        if (rcf) {
          for (int w = 0; w < W; ++w)
            bmold[f][w] = RS_IN(uint32_t, M_REQ_BASE_MOLD)[RS_AT2(src, w, W)];
          bpend[f] = RS_IN(int32_t, M_REQ_BASE_PEND)[RS_AT1(src)];
          bepoch[f] = RS_IN(int32_t, M_REQ_BASE_EPOCH)[RS_AT1(src)];
        }
      }
    }
    len4[f] = llen[f];
    // Snapshot receivers always ack, with match = the snapshot index.
    RS_OUT(NodeT, OM_A_OK_TO)[RS_AT1(f)] = (NodeT)((ae_ok || snap) ? src : NIL);
    RS_OUT(IdxT, OM_A_MATCH)[RS_AT1(f)] = (IdxT)(snap ? L : (ae_ok ? last_new : 0));
    RS_OUT(IdxT, OM_A_HINT)[RS_AT1(f)] = (IdxT)llen[f];
  }

  // ---- phase 3.5: PreVote requests. A voter grants a probe of a term at
  // least its own from an up-to-date log, unless it heard a leader within
  // election_min ticks of its clock or leads itself. -------------------------
  for (int v = 0; v < n; ++v) {
    if (hc_live && has_ae[v]) heard[v] = clock1[v];
    if (!pv) continue;
    const bool quiet = clock1[v] - heard[v] >= P.election_min && role[v] != LEADER;
    if (!quiet) continue;
    for (int c = 0; c < n; ++c) {
      if (RS_DELIVERED(v, c) && rtype[c] == REQ_PREVOTE && rterm[c] >= term[v] && RS_UTD(c, v))
        pvg[c][v >> 5] |= 1u << (v & 31);
    }
  }

  // ---- phase 3.7: TimeoutNow receipt: the target of a current-term
  // TimeoutNow starts an election this tick (non-voters never campaign). -----
  for (int r = 0; r < n && xfr; ++r) {
    bool tn = false;
    for (int s = 0; s < n; ++s)
      tn = tn || (RS_DELIVERED(r, s) && rtype[s] == REQ_TIMEOUT_NOW && xtgt[s] == r &&
                  rterm[s] == term[r]);
    xfer_elect[r] = tn && alive[r] && role[r] != LEADER && (!rcf || member_b[r]);
  }

  // ---- phases 4 + 5, per node: responses, PreVote promotion, then leader
  // commit ----------------------------------------------------------------------
  uint32_t aresp_bits[MAXW];
  for (int q = 0; q < n; ++q) {
    if (role[q] == CANDIDATE) {
      for (int r = 0; r < n; ++r) {
        if (RS_DELIVERED(q, r) && resp_kind_in[RS_AT2(q, r, n)] == RESP_VOTE &&
            v_to[r] == q && resp_term[r] == term[q])
          votes[q][r >> 5] |= 1u << (r & 31);
      }
    }
    // A removed node cannot win on banked votes.
    win[q] = role[q] == CANDIDATE && RS_QUORUM(q, votes[q]) && alive[q] && (!rcf || member_b[q]);
    if (win[q]) {
      role[q] = LEADER;
      lid[q] = q;
    }
    // Phase 4.5: pre-vote grants ride the packed pv_grant plane.
    pre_win[q] = false;
    if (pv && role[q] == PRECANDIDATE) {
      const uint32_t* grant_row = RS_IN(uint32_t, M_PV_GRANT);
      for (int r = 0; r < n; ++r) {
        if (RS_DELIVERED(q, r) && resp_kind_in[RS_AT2(q, r, n)] == RESP_PREVOTE &&
            ((grant_row[RS_AT2(q, r >> 5, W)] >> (r & 31)) & 1u))
          votes[q][r >> 5] |= 1u << (r & 31);
      }
      pre_win[q] = RS_QUORUM(q, votes[q]) && alive[q] && (!rcf || member_b[q]);
      if (pre_win[q]) {
        term[q] += 1;
        role[q] = CANDIDATE;
        vf[q] = q;
        for (int w = 0; w < W; ++w) votes[q][w] = (w == (q >> 5)) ? (1u << (q & 31)) : 0u;
      }
    }
    const int len_i = len4[q];
    const int xt = xfr ? iclamp(xfer0[q], 0, n - 1) : -1;  // the pending transfer's target
    int mws[MAXN];                                         // match_with_self row
    if (rdx)
      for (int w = 0; w < W; ++w) aresp_bits[w] = fresh[q][w] = 0u;
    if (xfr) age_t[q] = 0;
    for (int r = 0; r < n; ++r) {
      int nx = rs_[q] ? 1 : (int)next_in[RS_AT2(q, r, n)];
      int mt = rs_[q] ? 0 : (int)match_in[RS_AT2(q, r, n)];
      int ag = rs_[q] ? P.ack_sat : (int)ack_in[RS_AT2(q, r, n)];
      if (win[q]) {
        nx = len_i + 1;
        mt = 0;
      }
      const bool aresp = RS_DELIVERED(q, r) && resp_kind_in[RS_AT2(q, r, n)] == RESP_APPEND &&
                         role[q] == LEADER && resp_term[r] == term[q];
      if (aresp) {
        if (rdx) aresp_bits[r >> 5] |= 1u << (r & 31);
        if (a_ok_to[r] == q) {
          mt = imax(mt, a_match[r]);
          nx = imax(nx, a_match[r] + 1);
        } else {
          nx = imax(imin(nx - 1, a_hint[r] + 1), 1);
        }
      }
      ag = imin(ag + 1, P.ack_sat);
      if (win[q] || aresp) ag = 0;
      if (rdl && ag <= P.lease_ticks) fresh[q][r >> 5] |= 1u << (r & 31);
      if (r == xt) age_t[q] = ag;
      next_out[RS_AT2(q, r, n)] = (IdxT)nx;
      match_out[RS_AT2(q, r, n)] = (IdxT)mt;
      ack_out[RS_AT2(q, r, n)] = (AckT)ag;
      // Under the durability gate a leader's own slot is its durable length.
      mws[r] = (r == q) ? (dacks ? dur_mid[q] : len_i) : mt;
    }
    if (rdx) {  // a pending read on a leader banks this tick's acks
      const bool keep_r = role[q] == LEADER && read_idx0[q] > 0;
      for (int w = 0; w < W; ++w) acks[q][w] = keep_r ? (acks[q][w] | aresp_bits[w]) : 0u;
    }
    is_leader[q] = role[q] == LEADER;
    if (is_leader[q] && alive[q]) {
      // The quorum-th largest match: the largest value reached by at least
      // `quorum` entries of the row (an exact order statistic); under
      // reconfig, over the leader's own members, the min of both while joint.
      int qm = 0;
      if (rcf) {
        qm = masked_qmatch(mws, n, m_old[q], maj_old[q]);
        if (joint[q]) qm = imin(qm, masked_qmatch(mws, n, m_new[q], maj_new[q]));
      } else {
        for (int c = 0; c < n; ++c) {
          int cnt = 0;
          for (int k = 0; k < n; ++k) cnt += mws[k] >= mws[c];
          if (cnt >= P.quorum && mws[c] > qm) qm = mws[c];
        }
      }
      const int qt = term_at(RS_ROW(log_term, q), B, cap, comp, base[q], bterm[q], qm);
      if (qm > commit[q] && qt == term[q]) commit[q] = qm;
    }
  }

  int maxc = 0, hnode = -1;  // the lowest-id max-commit node
  for (int i = 0; i < n; ++i) {
    if (hnode < 0 || commit[i] > maxc) {
      maxc = commit[i];
      hnode = i;
    }
  }

  // ---- phase 5.2: transfer keep/accept. A pending transfer survives while
  // its leader leads and the target stays responsive; the lowest-id live
  // leader takes a new target that is a voter of its own target config. ------
  if (xfr) {
    const int t_x = RS_IN(int32_t, I_TRANSFER_CMD)[b];
    int ldx = n;
    for (int i = n - 1; i >= 0; --i)
      if (is_leader[i] && alive[i] && (!rcf || member_b[i])) ldx = i;
    for (int i = 0; i < n; ++i) {
      const bool keep_x = is_leader[i] && xfer0[i] != NIL && age_t[i] <= P.ack_timeout;
      xto[i] = keep_x ? xfer0[i] : NIL;
      const bool t_voter = !rcf || (t_x >= 0 && t_x < n && has_bit(m_new[i], t_x));
      if (t_x != NIL && t_voter && i == ldx && t_x != i && xto[i] == NIL) xto[i] = t_x;
      xpend[i] = xto[i] != NIL;
    }
  }
#define RS_XPEND(i) (xfr && xpend[i])

  // ---- phase 5.2: ReadIndex and lease reads. A pending read serves once its
  // acks (with self) reach the leader's quorum, or at once on a lease (a
  // quorum acked within lease_ticks); the lowest-id leader with a committed
  // entry of its term captures a new read at commit + 1. ------------------
  int reads_served = 0, low_cap = n;
  uint32_t read_lat_sum = 0u;
  int read_hist[BINS];
  bool serve[MAXN], viol_stale = false;
  for (int k = 0; k < BINS; ++k) read_hist[k] = 0;
  if (rdx) {
    const int read_cmd = RS_IN(int32_t, I_READ_CMD)[b];
    for (int i = 0; i < n; ++i) {
      const bool pend0 = read_idx0[i] > 0;
      const bool keep_r = is_leader[i] && pend0;
      uint32_t self_row[MAXW];
      for (int w = 0; w < W; ++w) self_row[w] = acks[i][w] | ((w == (i >> 5)) ? 1u << (i & 31) : 0u);
      serve[i] = keep_r && alive[i] && RS_QUORUM(i, self_row);
      if (rdl) {
        for (int w = 0; w < W; ++w) self_row[w] = fresh[i][w] | ((w == (i >> 5)) ? 1u << (i & 31) : 0u);
        // A pending transfer's handoff covers the read path.
        const bool lease_ok = RS_QUORUM(i, self_row) && !RS_XPEND(i);
        serve[i] = serve[i] || (keep_r && alive[i] && lease_ok);
      }
      if (serve[i]) {
        const int lat = imax(now + 1 - read_tick0[i], 1);
        ++reads_served;
        read_lat_sum += (uint32_t)lat;
        ++read_hist[log2_bin(lat)];
        if (P.check_invariants && rdl && read_idx0[i] - 1 < read_fr0[i]) viol_stale = true;
      }
      const bool cur_committed =
          term_at(RS_ROW(log_term, i), B, cap, comp, base[i], bterm[i], commit[i]) == term[i];
      const bool can_cap = read_cmd != NIL && is_leader[i] && alive[i] && !pend0 &&
                           cur_committed && !RS_XPEND(i);
      if (can_cap && low_cap == n) low_cap = i;
    }
    const int fr_now = imax(lat_frontier0, maxc);
    for (int i = 0; i < n; ++i) {
      const bool pend0 = read_idx0[i] > 0;
      const bool cleared = serve[i] || (pend0 && !(is_leader[i] && pend0));
      const bool cap_r = i == low_cap;
      const int ridx = cap_r ? commit[i] + 1 : cleared ? 0 : read_idx0[i];
      const int rtick = cap_r ? now + 1 : cleared ? 0 : read_tick0[i];
      RS_OUT(int32_t, O_READ_IDX)[RS_AT1(i)] = ridx;
      RS_OUT(int32_t, O_READ_TICK)[RS_AT1(i)] = rtick;
      for (int w = 0; w < W; ++w)
        RS_OUT(uint32_t, O_READ_ACKS)[RS_AT2(i, w, W)] = (cap_r || serve[i]) ? 0u : acks[i][w];
      if (rdl)  // the staleness anchor: the frontier at capture
        RS_OUT(int32_t, O_READ_FR)[RS_AT1(i)] = cap_r ? fr_now : cleared ? 0 : read_fr0[i];
    }
  }

  // ---- offer->commit latency (offer-tick plane) ----------------------------
  uint32_t lat_sum = 0;
  int lat_cnt = 0, crossed = 0;
  int hist[BINS];
  for (int k = 0; k < BINS; ++k) hist[k] = 0;
  if (P.track) {
    for (int i = 0; i < n; ++i) {
      const bool lead_ok = is_leader[i] && alive[i];
      // Entries newly past the carried frontier: 1-based (frontier, commit].
      // Without the ring slot k holds entry k + 1, so only those slots are
      // visited; on the ring every slot is, at its absolute index.
      const int k0 = comp ? 0 : imax(lat_frontier0, 0);
      const int k1 = comp ? cap : imin(commit[i], cap);
      for (int k = k0; k < k1; ++k) {
        const int abs1 = comp ? base[i] + pmod(k - base[i], cap) + 1 : k + 1;
        if (abs1 <= lat_frontier0 || abs1 > commit[i]) continue;
        const int tk = log_tick[RS_AT2(i, k, cap)];
        if (tk < 1 || tk > now) continue;  // not a client entry
        if (lead_ok) {
          const int lat = now - tk + 1;
          lat_sum += (uint32_t)lat;
          ++lat_cnt;
          ++hist[log2_bin(lat)];
        }
        if (i == hnode) ++crossed;
      }
    }
  }
  RS_OUT(int32_t, O_LAT_FRONTIER)[b] = P.track ? imax(lat_frontier0, maxc) : lat_frontier0;

  // ---- phase 5.5: compaction and the ring checksum. The checksum (and the
  // config fold of the compacted span) is anchored at the post-install,
  // pre-advance base and runs before phase 6: an injection into a slot this
  // tick's rebase freed would otherwise alias. -------------------------------
  bool chk_bad = false;
  if (comp) {
    for (int i = 0; i < n; ++i) {
      const int base_mid = base[i];
      const uint32_t bchk_mid = bchk[i];
      const int base2 = imax(base_mid, imin(commit[i], llen[i] - (cap - P.compact_margin)));
      bterm[i] = term_at(RS_ROW(log_term, i), B, cap, true, base_mid, bterm[i], base2);
      if (rcf) {
        const CfgFold f = fold_cfg(RS_ROW(log_cfg, i), B, cap, n, W, true, base_mid, base_mid, base2);
        for (int w = 0; w < W; ++w) bmold[i][w] ^= f.fold[w];
        if (f.hi > 0) bpend[i] = f.code_hi > 0 ? f.code_hi : 0;
        bepoch[i] += f.count;
      }
      base[i] = base2;
      const int co = imax(commit0[i], base_mid);  // snapshot installs skip the check
      uint32_t s_co = 0u, s_bf = 0u, s_cn = 0u;
      for (int k = 0; k < cap; ++k) {
        const int a0 = base_mid + pmod(k - base_mid, cap);  // 0-based entry index of slot k
        const uint32_t c =
            (uint32_t)log_term[RS_AT2(i, k, cap)] * chk_w_term((uint32_t)a0) +
            (uint32_t)log_val[RS_AT2(i, k, cap)] * chk_w_val((uint32_t)a0);
        if (a0 < co) s_co += c;
        if (a0 < base2) s_bf += c;
        if (a0 < commit[i]) s_cn += c;
      }
      if (P.check_invariants && bchk_mid + s_co != chk0[i] && !applied_snap[i]) chk_bad = true;
      bchk[i] = bchk_mid + s_bf;
      chk_new[i] = bchk_mid + s_cn;
    }
  }

  // ---- phase 6: election-win no-op, config entry, client injection, redirect
  // routing: one append per node, at priority no-op > config > client. Under
  // compaction a fresh leader's no-op needs a free slot, and client commands
  // stop `reserve` slots short so the no-op always finds one. ---------------
  const int reserve = imax(1, P.compact_margin / 2);
  int noop_blocked = 0, cmds = 0;
  bool noop[MAXN], node_ok[MAXN], client_ok[MAXN], cfg_write[MAXN];
  int wval[MAXN], wtick[MAXN], cfg_code[MAXN];
  for (int i = 0; i < n; ++i) {
    const bool has_slot = llen[i] - base[i] < cap;
    noop[i] = comp && win[i] && has_slot;
    if (comp && win[i] && !has_slot) ++noop_blocked;
    const bool room = comp ? llen[i] - base[i] < cap - reserve : has_slot;
    node_ok[i] = is_leader[i] && alive[i] && room && !noop[i];
  }
  if (rcf) {
    // A joint entry on the admin's toggle (lowest-id eligible leader, not
    // joint, leaving at least 2 voters); a final entry once the governing
    // joint entry commits on the leader. Judged on each leader's own
    // tick-start configuration.
    const int t_r = RS_IN(int32_t, I_RECONFIG_CMD)[b];
    const bool t_ok = t_r != NIL && t_r >= 0 && t_r < n;
    int ldj = n;
    for (int i = n - 1; i >= 0; --i)
      if (node_ok[i] && member_b[i] && !joint[i]) ldj = i;
    for (int i = 0; i < n; ++i) {
      const bool ld_ok = node_ok[i] && member_b[i];
      int toggled = 0;
      for (int w = 0; w < W; ++w)
        toggled += popcount32(m_new[i][w] ^ ((t_ok && w == (t_r >> 5)) ? 1u << (t_r & 31) : 0u));
      const bool accept_j = t_ok && i == ldj && ld_ok && !joint[i] && toggled >= 2;
      int pend_v = n;  // the open toggle: the lowest bit the two rows differ on
      for (int v = n - 1; v >= 0; --v)
        if (has_bit(m_old[i], v) != has_bit(m_new[i], v)) pend_v = v;
      const bool accept_f = ld_ok && joint[i] && commit[i] >= cfg_pend0[i];
      cfg_code[i] = accept_j ? t_r + 1 : accept_f ? -(pend_v + 1) : 0;
      cfg_write[i] = accept_j || accept_f;
    }
  }
  for (int i = 0; i < n; ++i) {
    // The slot holds a config entry; a pending transfer refuses clients.
    node_ok[i] = node_ok[i] && !(rcf && cfg_write[i]) && !RS_XPEND(i);
    client_ok[i] = !P.redirect && client_cmd != NIL && node_ok[i];
    wval[i] = client_cmd;
    wtick[i] = now + 1;  // a direct offer is accepted on its offer tick
    if (client_ok[i]) cmds = 1;  // offers, not appends
  }
  if (P.redirect) {
    // K-deep pipeline: the first free slot takes a fresh offer; each pending
    // offer goes to its target node, which accepts its lowest slot if it
    // leads; the rest chase the target's believed leader or bounce.
    const int K = P.k;
    int pend[MAXK], tgt[MAXK], ptk[MAXK], low_k[MAXN];
    bool fresh_done = false;
    for (int k = 0; k < K; ++k) {
      pend[k] = RS_IN(int32_t, S_CLIENT_PEND)[RS_AT1(k)];
      tgt[k] = RS_IN(int32_t, S_CLIENT_DST)[RS_AT1(k)];
      ptk[k] = P.track ? RS_IN(int32_t, S_CLIENT_TICK)[RS_AT1(k)] : 0;
      if (!fresh_done && pend[k] == NIL) {
        fresh_done = true;
        if (client_cmd != NIL) {
          pend[k] = client_cmd;
          tgt[k] = RS_IN(int32_t, I_CLIENT_TARGET)[b];
          ptk[k] = now + 1;  // the offer stamp rides the slot
        }
      }
    }
    for (int i = 0; i < n; ++i) low_k[i] = K;
    for (int k = K - 1; k >= 0; --k)
      if (pend[k] != NIL && tgt[k] >= 0 && tgt[k] < n) low_k[tgt[k]] = k;
    for (int i = 0; i < n; ++i) {
      client_ok[i] = low_k[i] < K && node_ok[i];
      if (client_ok[i]) {
        wval[i] = pend[low_k[i]];
        wtick[i] = ptk[low_k[i]];
      }
    }
    for (int k = 0; k < K; ++k) {
      const bool active = pend[k] != NIL;
      const int t = tgt[k];
      const bool valid = active && t >= 0 && t < n;
      const bool accepted = valid && low_k[t] == k && node_ok[t];
      cmds += accepted;
      const bool pend_on = active && !accepted;
      const int tgt_ld = valid ? lid[t] : NIL;
      const bool tgt_up = valid && alive[t];
      RS_OUT(int32_t, O_CLIENT_PEND)[RS_AT1(k)] = pend_on ? pend[k] : NIL;
      RS_OUT(int32_t, O_CLIENT_DST)[RS_AT1(k)] =
          !pend_on ? 0
          : (tgt_up && tgt_ld != NIL) ? tgt_ld
                                      : RS_IN(int32_t, I_CLIENT_BOUNCE)[RS_AT1(k)];
      if (P.track) RS_OUT(int32_t, O_CLIENT_TICK)[RS_AT1(k)] = pend_on ? ptk[k] : 0;
    }
  }
  for (int i = 0; i < n; ++i) {
    const bool cfg_w = rcf && cfg_write[i];
    if (!(noop[i] || cfg_w || client_ok[i])) continue;
    const int pos = comp ? pmod(llen[i], cap) : llen[i];
    if (pos >= 0 && pos < cap) {
      // No-op and config entries carry stamp 0; config entries value 0, their
      // command riding the config plane (0 for every other entry).
      const bool proto = noop[i] || cfg_w;
      log_term[RS_AT2(i, pos, cap)] = term[i];
      log_val[RS_AT2(i, pos, cap)] = noop[i] ? NOOP : cfg_w ? 0 : wval[i];
      if (P.track) log_tick[RS_AT2(i, pos, cap)] = proto ? 0 : wtick[i];
      if (rcf) log_cfg[RS_AT2(i, pos, cap)] = cfg_code[i];
    }
    llen[i] += 1;
  }

  // ---- phase 7: timers -----------------------------------------------------
  for (int i = 0; i < n; ++i) {
    const int clock = clock1[i];
    int dl = (granted_any[i] || has_ae[i] || saw_higher[i]) ? clock + tdraw[i] : deadline0[i];
    if (win[i]) dl = clock + P.heartbeat;
    if (pre_win[i]) dl = clock + tdraw[i];
    const bool expired = clock >= dl && alive[i];
    heartbeat[i] = expired && is_leader[i];
    if (heartbeat[i]) dl = clock + P.heartbeat;
    // Under PreVote expiry starts a probe (no term bump); the real election
    // started at the phase-4.5 promotion. Non-voters never campaign, and a
    // TimeoutNow target skips the probe: its election starts now.
    const bool voter = !rcf || member_b[i];
    const bool xfer_el = xfr && xfer_elect[i];
    const bool xe_i = xfer_el && !pre_win[i] && !is_leader[i];
    if (xfr) xe[i] = xe_i;
    start_pv[i] = pv && expired && !is_leader[i] && voter && !xfer_el;
    start_el[i] = pv ? pre_win[i] : expired && !is_leader[i] && voter;
    if (start_pv[i]) {
      role[i] = PRECANDIDATE;
      lid[i] = NIL;
      for (int w = 0; w < W; ++w) votes[i][w] = (w == (i >> 5)) ? (1u << (i & 31)) : 0u;
      dl = clock + tdraw[i];
    }
    const bool bump = xe_i || (!pv && start_el[i]);
    if (bump) {
      term[i] += 1;
      vf[i] = i;
      role[i] = CANDIDATE;
      lid[i] = NIL;
      for (int w = 0; w < W; ++w) votes[i][w] = (w == (i >> 5)) ? (1u << (i & 31)) : 0u;
      dl = clock + tdraw[i];
    }
    start_el[i] = start_el[i] || xe_i;
    RS_OUT(int32_t, O_CLOCK)[RS_AT1(i)] = clock;
    RS_OUT(int32_t, O_DEADLINE)[RS_AT1(i)] = dl;
  }

  // ---- phase 7.5: fsync flush and the durability gate. A live node's due
  // flush snaps its durable snapshot to its final log length, term and vote;
  // its AppendEntries ack names only fsynced entries, and a vote grant is
  // sent once durable -- a flush that newly covers a grant made on an earlier
  // tick sends it late (phase 8). -------------------------------------------
  int lag_sum = 0, lag_max = -2147483647 - 1;
  for (int i = 0; i < n && dur; ++i) {
    const bool fs = alive[i] && RS_IN(uint8_t, I_FSYNC_FIRE)[RS_AT1(i)] != 0;
    const int d_term = RS_IN(int32_t, S_DUR_TERM)[RS_AT1(i)];
    const int d_vote = RS_IN(int32_t, S_DUR_VOTE)[RS_AT1(i)];
    const int len2 = fs ? llen[i] : dur_mid[i];
    const int term2 = fs ? term[i] : d_term;
    const int vote2 = fs ? vf[i] : d_vote;
    RS_OUT(int32_t, O_DUR_LEN)[RS_AT1(i)] = len2;
    RS_OUT(int32_t, O_DUR_TERM)[RS_AT1(i)] = term2;
    RS_OUT(int32_t, O_DUR_VOTE)[RS_AT1(i)] = vote2;
    late_grant[i] = false;
    if (dacks) {
      IdxT* am = RS_OUT(IdxT, OM_A_MATCH) + RS_AT1(i);
      *am = (IdxT)imin((int)*am, len2);
      const bool covered0 = d_term == term[i] && d_vote == vf[i] && vf[i] != NIL;
      const bool covered2 = term2 == term[i] && vote2 == vf[i] && vf[i] != NIL;
      grant_to[i] = covered2 ? vf[i] : NIL;
      late_grant[i] = covered2 && !covered0 && !granted_any[i];
    }
    lag_sum += llen[i] - len2;
    lag_max = imax(lag_max, llen[i] - len2);
  }

  // ---- phase 8: outbox -----------------------------------------------------
  for (int i = 0; i < n; ++i) {
    const bool send = win[i] || heartbeat[i];
    const int len_i = len4[i];
    // Shared window start: the minimum prev over responsive peers, else over
    // all peers, clamped to the pre-injection length and (ring) the base.
    int ws_resp = 0x7FFFFFFF, ws_all = 0x7FFFFFFF;
    for (int j = 0; j < n; ++j) {
      if (j == i) continue;
      const int prev = imin(imax((int)next_out[RS_AT2(i, j, n)] - 1, 0), len_i);
      ws_all = imin(ws_all, prev);
      if ((int)ack_out[RS_AT2(i, j, n)] <= P.ack_timeout) ws_resp = imin(ws_resp, prev);
    }
    int ws = imin(ws_resp == 0x7FFFFFFF ? ws_all : ws_resp, len_i);
    if (comp) ws = imax(ws, base[i]);
    for (int j = 0; j < n; ++j) {
      const int prev = imin(imax((int)next_out[RS_AT2(i, j, n)] - 1, 0), len_i);
      int off_j = 0;
      if (send && j != i) off_j = (comp && prev < base[i]) ? -1 : iclamp(prev - ws, 0, e);
      RS_OUT(int8_t, OM_REQ_OFF)[RS_AT2(i, j, n)] = (int8_t)off_j;
    }
    const int n_ship = iclamp(llen[i] - ws, 0, e);
    for (int k = 0; k < e; ++k) {
      const bool used = send && k < n_ship;
      const int slot = comp ? pmod(ws + k, cap) : iclamp(ws + k, 0, cap - 1);
      RS_OUT(int32_t, OM_ENT_TERM)[RS_AT2(i, k, e)] = used ? log_term[RS_AT2(i, slot, cap)] : 0;
      RS_OUT(int32_t, OM_ENT_VAL)[RS_AT2(i, k, e)] = used ? log_val[RS_AT2(i, slot, cap)] : 0;
      if (P.track)
        RS_OUT(int32_t, OM_ENT_TICK)[RS_AT2(i, k, e)] = used ? log_tick[RS_AT2(i, slot, cap)] : 0;
      if (rcf)
        RS_OUT(int32_t, OM_ENT_CFG)[RS_AT2(i, k, e)] = used ? log_cfg[RS_AT2(i, slot, cap)] : 0;
    }
    int req_type = start_el[i] ? REQ_VOTE : (send ? REQ_APPEND : 0);
    if (start_pv[i]) req_type = REQ_PREVOTE;
    const bool rv_like = start_el[i] || start_pv[i];
    const int l = llen[i];
    const int last_term = term_at(RS_ROW(log_term, i), B, cap, comp, base[i], bterm[i], l);
    const int pterm = term_at(RS_ROW(log_term, i), B, cap, comp, base[i], bterm[i], ws);
    // A probe carries the prospective term.
    const int req_term = start_pv[i] ? term[i] + 1 : (req_type != 0 ? term[i] : 0);
    if (xfr) {
      // TimeoutNow replaces the heartbeat once the target's match reaches the
      // leader's (post-injection) log length.
      const bool fire = send && xto[i] != NIL &&
                        (int)match_out[RS_AT2(i, iclamp(xto[i], 0, n - 1), n)] >= l;
      if (fire) req_type = REQ_TIMEOUT_NOW;
      RS_OUT(NodeT, OM_XFER_TGT)[RS_AT1(i)] = (NodeT)(fire ? xto[i] : NIL);
      if (disrupt_live) RS_OUT(int8_t, OM_REQ_DISRUPT)[RS_AT1(i)] = (int8_t)xe[i];
    }
    RS_OUT(int32_t, OM_REQ_TYPE)[RS_AT1(i)] = req_type;
    RS_OUT(int32_t, OM_REQ_TERM)[RS_AT1(i)] = req_term;
    RS_OUT(int32_t, OM_REQ_COMMIT)[RS_AT1(i)] = send ? commit[i] : 0;
    RS_OUT(int32_t, OM_REQ_LAST_INDEX)[RS_AT1(i)] = rv_like ? l : 0;
    RS_OUT(int32_t, OM_REQ_LAST_TERM)[RS_AT1(i)] = rv_like ? last_term : 0;
    RS_OUT(int32_t, OM_ENT_START)[RS_AT1(i)] = send ? ws : 0;
    RS_OUT(int32_t, OM_ENT_PREV_TERM)[RS_AT1(i)] = send ? pterm : 0;
    RS_OUT(int32_t, OM_ENT_COUNT)[RS_AT1(i)] = send ? n_ship : 0;
    if (comp) {
      RS_OUT(int32_t, OM_REQ_BASE)[RS_AT1(i)] = send ? base[i] : 0;
      RS_OUT(int32_t, OM_REQ_BASE_TERM)[RS_AT1(i)] = send ? bterm[i] : 0;
      RS_OUT(uint32_t, OM_REQ_BASE_CHK)[RS_AT1(i)] = send ? bchk[i] : 0u;
      if (rcf) {  // the snapshot config context rides the header
        for (int w = 0; w < W; ++w)
          RS_OUT(uint32_t, OM_REQ_BASE_MOLD)[RS_AT2(i, w, W)] = send ? bmold[i][w] : 0u;
        RS_OUT(int32_t, OM_REQ_BASE_PEND)[RS_AT1(i)] = send ? bpend[i] : 0;
        RS_OUT(int32_t, OM_REQ_BASE_EPOCH)[RS_AT1(i)] = send ? bepoch[i] : 0;
      }
    }
    if (pv)
      for (int w = 0; w < W; ++w) RS_OUT(uint32_t, OM_PV_GRANT)[RS_AT2(i, w, W)] = pvg[i][w];
    RS_OUT(NodeT, OM_V_TO)[RS_AT1(i)] = (NodeT)grant_to[i];
    RS_OUT(int32_t, OM_RESP_TERM)[RS_AT1(i)] = term[i];
    // Responses on edge [requester i, responder v]: the type of the request
    // v received from i this tick (a TimeoutNow gets none).
    for (int v = 0; v < n; ++v) {
      int kind = 0;
      if (RS_DELIVERED(v, i)) {
        kind = rtype[i] == REQ_VOTE      ? RESP_VOTE
               : rtype[i] == REQ_APPEND  ? RESP_APPEND
               : rtype[i] == REQ_PREVOTE ? RESP_PREVOTE
                                         : 0;
      }
      // The late RESP_VOTE, only on an edge with no other response.
      if (dacks && kind == 0 && late_grant[v] && vf[v] == i) kind = RESP_VOTE;
      RS_OUT(int8_t, OM_RESP_KIND)[RS_AT2(i, v, n)] = (int8_t)kind;
    }
  }

  // ---- committed-prefix checksum (prefix form), end-of-tick configuration
  // and state -------------------------------------------------------------------
  for (int i = 0; i < n; ++i) {
    if (!comp) {
      chk_new[i] = chk0[i];
      if (P.check_invariants) {
        uint32_t s_old = 0u, s_new = 0u;
        const int hi = imin(imax(commit0[i], commit[i]), cap);
        for (int k = 0; k < hi; ++k) {
          const uint32_t c = (uint32_t)log_term[RS_AT2(i, k, cap)] * chk_w_term((uint32_t)k) +
                             (uint32_t)log_val[RS_AT2(i, k, cap)] * chk_w_val((uint32_t)k);
          if (k < commit0[i]) s_old += c;
          if (k < commit[i]) s_new += c;
        }
        if (s_old != chk0[i]) chk_bad = true;
        chk_new[i] = s_new;
      }
    }
    if (rcf) {
      // The node's configuration from its own log (base, llen] and snapshot
      // context: C_old folds the final entries' toggles; the latest entry's
      // sign decides jointness. A removed leader steps down once its removal
      // commits on it; a removed candidate stops campaigning.
      const CfgFold f = fold_cfg(RS_ROW(log_cfg, i), B, cap, n, W, comp, base[i], base[i], llen[i]);
      const int pend_code = f.hi > 0 ? f.code_hi : bpend[i];
      const bool joint2 = pend_code > 0;
      const int pv_ = pend_code - 1;
      uint32_t d_old[MAXW], d_new[MAXW];
      for (int w = 0; w < W; ++w) {
        d_old[w] = bmold[i][w] ^ f.fold[w];
        const uint32_t tb = (joint2 && pv_ < n && w == (pv_ >> 5)) ? 1u << (pv_ & 31) : 0u;
        d_new[w] = d_old[w] ^ tb;
        RS_OUT(uint32_t, O_MEMBER_OLD)[RS_AT2(i, w, W)] = d_old[w];
        RS_OUT(uint32_t, O_MEMBER_NEW)[RS_AT2(i, w, W)] = d_new[w];
      }
      RS_OUT(int32_t, O_CFG_PEND)[RS_AT1(i)] = joint2 ? (f.hi > 0 ? f.hi : imax(base[i], 1)) : 0;
      RS_OUT(int32_t, O_CFG_EPOCH)[RS_AT1(i)] = bepoch[i] + f.count;
      const bool self_in = has_bit(d_old, i) || has_bit(d_new, i);
      const bool cand = role[i] == CANDIDATE || role[i] == PRECANDIDATE;
      if (!self_in && ((role[i] == LEADER && commit[i] >= imax(f.hi, base[i])) || cand)) {
        role[i] = FOLLOWER;
        lid[i] = NIL;
      }
      if (comp) {
        for (int w = 0; w < W; ++w) RS_OUT(uint32_t, O_BASE_MOLD)[RS_AT2(i, w, W)] = bmold[i][w];
        RS_OUT(int32_t, O_BASE_PEND)[RS_AT1(i)] = bpend[i];
        RS_OUT(int32_t, O_BASE_EPOCH)[RS_AT1(i)] = bepoch[i];
      }
    }
    if (xfr) RS_OUT(int32_t, O_XFER_TO)[RS_AT1(i)] = xto[i];
    RS_OUT(int32_t, O_ROLE)[RS_AT1(i)] = role[i];
    RS_OUT(int32_t, O_TERM)[RS_AT1(i)] = term[i];
    RS_OUT(int32_t, O_VOTED_FOR)[RS_AT1(i)] = vf[i];
    RS_OUT(int32_t, O_LEADER_ID)[RS_AT1(i)] = lid[i];
    for (int w = 0; w < W; ++w) RS_OUT(uint32_t, O_VOTES)[RS_AT2(i, w, W)] = votes[i][w];
    RS_OUT(int32_t, O_COMMIT_INDEX)[RS_AT1(i)] = commit[i];
    RS_OUT(uint32_t, O_COMMIT_CHK)[RS_AT1(i)] = chk_new[i];
    RS_OUT(int32_t, O_LOG_LEN)[RS_AT1(i)] = llen[i];
    if (comp) {
      RS_OUT(int32_t, O_LOG_BASE)[RS_AT1(i)] = base[i];
      RS_OUT(int32_t, O_BASE_TERM)[RS_AT1(i)] = bterm[i];
      RS_OUT(uint32_t, O_BASE_CHK)[RS_AT1(i)] = bchk[i];
    }
    if (hc_live) RS_OUT(int32_t, O_HEARD_CLOCK)[RS_AT1(i)] = heard[i];
  }
  RS_OUT(int32_t, O_NOW)[b] = now + 1;

  // ---- phase 9: StepInfo ---------------------------------------------------
  bool viol_election = false, viol_commit = false, viol_match = false;
  int leader = NIL, n_leaders = 0, max_term = -2147483647 - 1, max_commit = maxc;
  int min_commit = 2147483647;
  for (int i = 0; i < n; ++i) {
    const bool ldr = role[i] == LEADER;
    if (ldr && alive[i]) {
      if (leader == NIL) leader = i;
      ++n_leaders;
    }
    if (P.check_invariants) {
      for (int j = i + 1; j < n && ldr; ++j)
        if (role[j] == LEADER && term[j] == term[i]) viol_election = true;
      if (commit[i] < commit0[i] || commit[i] > llen[i] || commit[i] < base[i] ||
          llen[i] - base[i] > cap)
        viol_commit = true;
    }
    max_term = imax(max_term, term[i]);
    max_commit = imax(max_commit, commit[i]);
    min_commit = imin(min_commit, commit[i]);
  }
  if (P.check_invariants && chk_bad) viol_commit = true;
  if (P.log_matching_due) {
    // Every pair agrees on its common committed prefix iff every node agrees
    // with the max-commit node on its own committed prefix (equality is
    // transitive), so one pass against node hnode decides the pairwise check.
    // (Prefix layout only: the wrapper refuses log matching under compaction.)
    for (int i = 0; i < n && !viol_match; ++i) {
      if (i == hnode) continue;
      const int hi = imin(commit[i], cap);
      for (int k = 0; k < hi; ++k) {
        if (log_term[RS_AT2(i, k, cap)] != log_term[RS_AT2(hnode, k, cap)] ||
            log_val[RS_AT2(i, k, cap)] != log_val[RS_AT2(hnode, k, cap)]) {
          viol_match = true;
          break;
        }
      }
    }
  }
  RS_OUT(uint8_t, F_VIOL_ELECTION_SAFETY)[b] = viol_election;
  RS_OUT(uint8_t, F_VIOL_COMMIT)[b] = viol_commit;
  RS_OUT(uint8_t, F_VIOL_LOG_MATCHING)[b] = viol_match;
  RS_OUT(int32_t, F_LEADER)[b] = leader;
  RS_OUT(int32_t, F_N_LEADERS)[b] = n_leaders;
  RS_OUT(int32_t, F_MAX_TERM)[b] = max_term;
  RS_OUT(int32_t, F_MAX_COMMIT)[b] = max_commit;
  RS_OUT(int32_t, F_MIN_COMMIT)[b] = min_commit;
  RS_OUT(int32_t, F_MSGS_DELIVERED)[b] = msgs;
  RS_OUT(int32_t, F_CMDS_INJECTED)[b] = cmds;
  RS_OUT(int32_t, F_LAT_SUM)[b] = (int32_t)lat_sum;
  RS_OUT(int32_t, F_LAT_CNT)[b] = lat_cnt;
  for (int k = 0; k < BINS; ++k) RS_OUT(int32_t, F_LAT_HIST)[(int64_t)k * B + b] = hist[k];
  RS_OUT(int32_t, F_LAT_EXCLUDED)[b] = imax(crossed - lat_cnt, 0);
  if (comp) RS_OUT(int32_t, F_NOOP_BLOCKED)[b] = noop_blocked;
  if (rdx) {
    RS_OUT(int32_t, F_READS_SERVED)[b] = reads_served;
    RS_OUT(int32_t, F_READ_LAT_SUM)[b] = (int32_t)read_lat_sum;
    for (int k = 0; k < BINS; ++k) RS_OUT(int32_t, F_READ_HIST)[(int64_t)k * B + b] = read_hist[k];
  }
  if (rdl) RS_OUT(uint8_t, F_VIOL_READ_STALE)[b] = viol_stale;
  if (dur) {
    RS_OUT(int32_t, F_FSYNC_LAG_SUM)[b] = lag_sum;
    RS_OUT(int32_t, F_FSYNC_LAG_MAX)[b] = lag_max;
  }

#undef RS_XPEND
#undef RS_QUORUM
#undef RS_DENIED
#undef RS_UTD
#undef RS_DELIVERED
#undef RS_ROW
#undef RS_AT1
#undef RS_AT2
#undef RS_IN
#undef RS_OUT
}

// One launch's arguments, passed by value to the kernel.
struct TickArgs {
  TickParams p;
  void* ptr[N_PTR];
};

// Calls CALL(IdxT, AckT, NodeT) for the dtype tiers given as byte widths
// (1 = int8, 2 = int16, 4 = int32: the index tier under compaction);
// evaluates FAIL for any other combination.
#define RS_DISPATCH_TIERS(ib, ab, nb, CALL, FAIL)                   \
  do {                                                              \
    if (ib == 1 && ab == 1 && nb == 1) { CALL(int8_t, int8_t, int8_t); }       \
    else if (ib == 2 && ab == 1 && nb == 1) { CALL(int16_t, int8_t, int8_t); } \
    else if (ib == 1 && ab == 2 && nb == 1) { CALL(int8_t, int16_t, int8_t); } \
    else if (ib == 2 && ab == 2 && nb == 1) { CALL(int16_t, int16_t, int8_t); } \
    else if (ib == 1 && ab == 1 && nb == 2) { CALL(int8_t, int8_t, int16_t); } \
    else if (ib == 2 && ab == 1 && nb == 2) { CALL(int16_t, int8_t, int16_t); } \
    else if (ib == 1 && ab == 2 && nb == 2) { CALL(int8_t, int16_t, int16_t); } \
    else if (ib == 2 && ab == 2 && nb == 2) { CALL(int16_t, int16_t, int16_t); } \
    else if (ib == 4 && ab == 1 && nb == 1) { CALL(int32_t, int8_t, int8_t); } \
    else if (ib == 4 && ab == 2 && nb == 1) { CALL(int32_t, int16_t, int8_t); } \
    else if (ib == 4 && ab == 1 && nb == 2) { CALL(int32_t, int8_t, int16_t); } \
    else if (ib == 4 && ab == 2 && nb == 2) { CALL(int32_t, int16_t, int16_t); } \
    else { FAIL; }                                                  \
  } while (0)

// Checks the shape limits of this body; 0 when it can run the tick.
inline int check_params(const TickParams& p) {
  if (p.n < 2 || p.n > MAXN) return 1;
  if (p.w != (p.n + 31) / 32 || p.w > MAXW) return 2;
  if (p.e < 1 || p.e > MAXE || p.cap < 1) return 3;
  if (p.quorum < 1 || p.b < 0) return 4;
  if (p.redirect && (p.k < 1 || p.k > MAXK)) return 5;
  return 0;
}

}  // namespace rs
