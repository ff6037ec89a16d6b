// One Raft tick for a tile of clusters, node-parallel: the body of the Hopper
// tick kernel (tick.cu) and of its CPU build (tick_host.cpp).
//
// Semantics are raft_sim_tpu/models/raft_batched.py `_step_b` + `_step_info_b`
// (dense layout, single device) over the gate set of presets config1-config10
// and config3p: invariants, log matching, the client's cadence (direct, or the
// redirect client with its K-deep pipeline) with the offer-tick latency plane,
// drop, partitions, skew, crash/restart, ring-log compaction with the
// InstallSnapshot analogue, PreVote, and the reconfiguration plane: log-carried
// joint-consensus membership (with the snapshot config context under
// compaction), TimeoutNow transfer, ReadIndex and lease reads, and the durable
// storage plane (fsync watermarks, the durability gate, crash recovery),
// and the eight TEST-ONLY mutant hooks of scenario/mutation.py (each weakens
// one rule at its JAX site: the config entry and derivation, the truncation
// rollback, ReadIndex confirmation, TimeoutNow election, the lease window,
// the durability gate, the persisted vote). Every leaf it writes equals the
// JAX tick's.
//
// Any N from 2 to 255 (RaftConfig's range), dense layout: the body is a
// template on the width tier MW (packed words a row: 2 up to 64 nodes, 4 up
// to 128, 8 above; `width_for`).
//
// Work split: one worker per (cluster, node). A worker keeps its node's state
// in a NodeCtx (registers on the card) and runs the tick as a sequence of
// phase functions; a barrier ends each phase. A worker reads its own node's
// values, any node's INPUT leaves (the deliver-mask rows and the mailbox's
// per-edge planes straight from device memory; mailbox headers and
// alive/up from their copy in the exchange, staged in phase 0), and other
// nodes' INTERMEDIATES only through the exchange (`Xch`), and only values
// written in an earlier phase. Cluster-scoped work (the accumulators, the redirect
// pipeline's K slots, the [B]-shaped outputs) runs on one worker per cluster
// (`cluster_phase`), under the same rule. Counters summed over nodes go to
// per-cluster accumulators by atomic add / min / max / or, whose result does
// not depend on the order of the workers.
//
// Phases (JAX phase numbers in brackets):
//   0 each node stages its mailbox header and alive/up flags in the exchange
//     (every node's loops over senders read them there); (cluster) zero the
//     accumulators.
//   1 load [-1 restart and recovery], term adoption [1], RequestVote [2],
//     AppendEntries and snapshot install [3], the PreVote voter's grant row
//     [3.5], TimeoutNow receipt [3.7], responses, PreVote promotion and leader
//     commit [4, 4.5, 5]. Exports commit, leader id, transfer eligibility and
//     the grant row.
//   2 the max-commit node, transfer keep/accept and ReadIndex/lease serving
//     [5.2], offer latency, compaction and the ring checksum [5.5], the no-op
//     slot [6]. Exports read-capture and config-toggle eligibility.
//     (cluster) the latency frontier and `now`.
//   3 read capture [5.2], config entry, client offer and injection [6], timers
//     [7], fsync flush and the durability gate [7.5]. Exports node_ok and the
//     late vote.
//   4 outbox [8], prefix checksum and end-of-tick configuration, state out,
//     the node's StepInfo terms [9]. Exports final role and term.
//     (cluster) the redirect pipeline's K slots.
//   5 election safety and log matching [9].
//   6 (cluster) StepInfo out.
//
// Membership: every quorum a node tests (elections, pre-votes, commit, read
// confirmation, leases, transfer targets) is masked by that node's TICK-START
// member rows (m_old / m_new, dual while its cfg_pend is open); the rows
// derived from the log at the end of the tick go to the output only.
//
// Durable storage: three snapshots of the watermark. `dur_mid` is the
// tick-start dur_len clamped by phase 3's truncation, and is what a leader's
// own slot in the commit quorum reads; the flush (phase 7.5) snaps to the
// final log length, term and vote, and the ack clamp reads that post-flush
// value. Recovery (phase -1) rewinds term/vote/log_len at load.
//
// Layout: every leaf is batch-minor. Leaf [d0, d1, ..., B] element
// (i, j, ..., b) sits at ((i * d1 + j) * ... ) * B + b, so workers of
// neighbouring clusters touch neighbouring addresses. The wrapper
// (kernels/tick_engine.py) passes one pointer per leaf in the order of the
// Ptr enum below; output leaves are fresh buffers, never aliases of inputs. A
// leg whose gate is off gets a null pointer and is never touched (the wrapper
// passes it through). A worker reads back only output rows of its own node,
// except log matching (phase 5), which reads the max-commit node's log rows
// (prefix layout) or every higher-id partner's log rows, commit, base and
// base checksum (ring layout) after the barriers that end every such write.
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
#define RS_UNROLL _Pragma("unroll")
#else
#define RS_HD inline
#define RS_UNROLL
#endif

namespace rs {

constexpr int MAXN = 255;  // nodes per cluster this body supports (RaftConfig's ceiling)
constexpr int MAXW = 8;    // packed words per node row (ceil(MAXN / 32))
constexpr int MAXE = 127;  // entries per AppendEntries window (RaftConfig's ceiling; the int8 offset)
constexpr int MAXK = 16;  // redirect pipeline slots (RaftConfig.client_pipeline <= 16)
constexpr int BINS = 16;  // latency histogram bins (types.LAT_HIST_BINS)
constexpr int MAX_THREADS = 512;  // workers per block (tick.cu)

// The body's width tier for N nodes: packed words a row in registers and in
// the exchange (MW). Rows of a narrower config keep their top words 0; three
// tiers keep the narrow bodies' registers what they were at N <= 64.
RS_HD constexpr int width_for(int n) { return n <= 64 ? 2 : n <= 128 ? 4 : 8; }

constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2, PRECANDIDATE = 3;
constexpr int NIL = -1, NOOP = -2;
constexpr int REQ_VOTE = 1, REQ_APPEND = 2, REQ_PREVOTE = 3, REQ_TIMEOUT_NOW = 4;
constexpr int RESP_VOTE = 1, RESP_APPEND = 2, RESP_PREVOTE = 3;
constexpr int32_t I32_MIN = -2147483647 - 1, I32_MAX = 2147483647;

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
  F_VIOL_READ_STALE, F_FSYNC_LAG_SUM, F_FSYNC_LAG_MAX, F_LM_SKIPPED_PAIRS,
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
  // The TEST-ONLY mutant hooks (RaftConfig properties, 1 in production),
  // read by the mutant body only (`mutant_body`). lease_skew_safe needs no
  // flag: the host passes its window as lease_ticks.
  int32_t joint_consensus;      // 0: a membership change is one final entry
  int32_t act_on_append;        // 0: configurations derive from the committed prefix
  int32_t truncation_rollback;  // 0: a truncation that lost config entries keeps the old
  int32_t read_confirm;         // 0: ReadIndex without confirmation or the capture gate
  int32_t xfer_election;        // 0: TimeoutNow fires at once and the target takes over
  int32_t persist_vote;         // 0: crash recovery forgets votedFor
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

// Packed rows are MW words (the body's width tier, `width_for`); words at and
// past a config's W are kept 0, so every row operation runs over all MW words
// with compile-time indices: a node's bit is picked by comparing its word
// index with each word's, never by indexing a row with a runtime value (a
// register array so indexed would go to local memory). MW = 2 keeps the
// two-word forms the narrow bodies were tuned with.
// Set bits of the packed row a & b (b == nullptr: all of a).
template <int MW>
RS_HD int popc_and(const uint32_t* a, const uint32_t* b) {
  int c = 0;
  for (int w = 0; w < MW; ++w) c += popcount32(b ? (a[w] & b[w]) : a[w]);
  return c;
}

template <int MW>
RS_HD uint32_t word_of(const uint32_t* row, int i) {
  if constexpr (MW == 2) {
    return i < 32 ? row[0] : row[1];
  } else {
    uint32_t v = row[0];
    for (int w = 1; w < MW; ++w) v = (i >> 5) == w ? row[w] : v;
    return v;
  }
}
template <int MW>
RS_HD bool has_bit(const uint32_t* row, int i) { return (word_of<MW>(row, i) >> (i & 31)) & 1u; }
template <int MW>
RS_HD void set_bit(uint32_t* row, int i) {
  if constexpr (MW == 2) {
    if (i < 32) row[0] |= 1u << (i & 31);
    else row[1] |= 1u << (i & 31);
  } else {
    for (int w = 0; w < MW; ++w) row[w] |= (w == (i >> 5)) ? 1u << (i & 31) : 0u;
  }
}
template <int MW>
RS_HD void flip_bit(uint32_t* row, int i) {
  if constexpr (MW == 2) {
    if (i < 32) row[0] ^= 1u << (i & 31);
    else row[1] ^= 1u << (i & 31);
  } else {
    for (int w = 0; w < MW; ++w) row[w] ^= (w == (i >> 5)) ? 1u << (i & 31) : 0u;
  }
}
template <int MW>
RS_HD void self_row(uint32_t* row, int i) {  // only bit i
  for (int w = 0; w < MW; ++w) row[w] = (w == (i >> 5)) ? 1u << (i & 31) : 0u;
}

// One parity fold over a node's config entries with absolute index in
// (lo, hi], slot k holding entry anchor + pmod(k - anchor, cap) + 1 on a ring
// (k + 1 otherwise): final entries (code < 0; every entry with `all_final`,
// the single-server mutant) toggle bit |code| - 1 of `fold`; returns the
// entry count, and the latest entry's index and code.
template <int MW>
struct CfgFold {
  uint32_t fold[MW];
  int hi, code_hi, count;
};

template <int MW>
RS_HD CfgFold<MW> fold_cfg(const int32_t* row, int64_t B, int cap, int n, bool ring, int anchor,
                           int lo, int hi, bool all_final) {
  CfgFold<MW> f;
  for (int w = 0; w < MW; ++w) f.fold[w] = 0u;
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
    const int v = (code < 0 || !all_final) ? -code - 1 : code - 1;
    if ((code < 0 || all_final) && v < n) flip_bit<MW>(f.fold, v);
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

// The lean gate set: none of compaction, the redirect client, the
// reconfiguration plane (membership, transfer, reads, leases) or durable
// storage; PreVote stays a runtime gate -- config1-config5, config3p,
// config4c and config7. The body is instantiated for it with those gates
// compile-time off (FULL = 0), so their code and per-node state drop out,
// for every gate (FULL = 1), and for every gate with the mutant hooks
// (FULL = 2, `mutant_body`); the launch picks by the config (`body_for`).
inline bool lean_gates(const TickParams& p) {
  return !(p.comp || p.redirect || p.reconfig || p.transfer || p.reads || p.lease || p.durable);
}

// A TEST-ONLY mutant hook is off. Every one of them lives in a plane outside
// the lean set, so a lean config runs the lean body whatever its hooks say;
// any other config with a hook off runs the mutant body (FULL = 2): the full
// body with each hook read from P, so the production full body (FULL = 1)
// keeps the code it had without them.
inline bool mutant_body(const TickParams& p) {
  return !(p.joint_consensus && p.act_on_append && p.truncation_rollback && p.read_confirm &&
           p.xfer_election && p.persist_vote);
}

// The body a launch runs: 0 lean, 1 full, 2 mutant.
inline int body_for(const TickParams& p) { return lean_gates(p) ? 0 : mutant_body(p) ? 2 : 1; }

// The gates of one config, decoded once per phase. `full` is a compile-time
// constant: 0 turns every gate outside the lean set off; below 2 every
// mutant hook is on (production), and 2 reads the hooks from P.
struct Gates {
  bool comp, pv, redir, rcf, xfr, rdx, rdl, dur, dacks, hc_live, deny, disrupt_live;
  bool jc, aoa, trb, rconf, xel, pvote;  // the mutant hooks, true in production
  RS_HD Gates(const TickParams& P, int full)
      : comp(full && P.comp != 0), pv(P.pre_vote != 0), redir(full && P.redirect != 0),
        rcf(full && P.reconfig != 0), xfr(full && P.transfer != 0), rdx(full && P.reads != 0),
        rdl(full && P.lease != 0), dur(full && P.durable != 0),
        dacks(dur && P.durable_acks != 0),  // the durability gate
        hc_live(pv || rdl || rcf),          // heard_clock: quiet rule, vote denial
        deny(rcf || rdl),                   // the heard-a-leader vote denial
        disrupt_live(xfr && deny),          // req_disrupt overrides it
        jc(full != 2 || P.joint_consensus != 0), aoa(full != 2 || P.act_on_append != 0),
        trb(full != 2 || P.truncation_rollback != 0), rconf(full != 2 || P.read_confirm != 0),
        xel(full != 2 || P.xfer_election != 0), pvote(full != 2 || P.persist_vote != 0) {}
};

// ---- The exchange: shared memory on the card, a host buffer in the CPU build.
// Per-node intermediates one node writes and others read in a later phase,
// [field][node][cluster-in-tile], then per-cluster accumulators
// [field][cluster-in-tile]; all int32. The fields past the PreVote grant row
// (MW words) sit at offsets that follow the width tier (`XTail`).
enum XField {
  // Each node's mailbox header and up/alive flags, staged in phase 0 and read
  // by every node of its cluster from phase 1 on.
  X_HFLAGS,      // bit 0 alive, bit 1 up (alive and not restarted)
  X_HRTYPE,      // req_type
  X_HRTERM,      // req_term
  X_HRLI,        // req_last_index
  X_HRLT,        // req_last_term
  X_HRESP_TERM,  // resp_term
  X_HVTO,        // v_to
  X_HAOKTO,      // a_ok_to
  X_HAMATCH,     // a_match
  X_HAHINT,      // a_hint
  X_HDISRUPT,    // req_disrupt (transfer beside a vote denial)
  X_HXTGT,       // xfer_tgt (transfer)
  X_COMMIT,  // commit after phase 5 (phase 1): the max-commit node, read frontier
  X_LID,     // leader id after phase 5 (phase 1): redirect chase
  X_ELIGX,   // live leader and voter (phase 1): transfer's lowest-id leader
  X_PVG,     // PreVote grant row of a voter, MW words (phase 1): pv_grant out
};
template <int MW>
struct XTail {
  enum {
    CANCAP = X_PVG + MW,  // may capture a read (phase 2): lowest-id capture
    LDJ,     // may take the admin toggle (phase 2): lowest-id joint entry
    NODEOK,  // may take a client command (phase 3): redirect acceptance
    LATE,    // late vote's candidate, else NIL (phase 3): late RESP_VOTE
    ROLE,    // final role (phase 4): election safety
    TERM,    // final term (phase 4): election safety
    NXF
  };
};
enum AccField {
  A_MSGS, A_CMDS, A_LAT_SUM, A_LAT_CNT, A_CROSSED, A_NOOP_BLOCKED, A_READS, A_READ_LAT_SUM,
  A_VIOL_STALE, A_LAG_SUM, A_LAG_MAX, A_CHK_BAD, A_VIOL_ELECTION, A_VIOL_COMMIT,
  A_VIOL_MATCH, A_LEADER, A_N_LEADERS, A_MAX_TERM, A_MAX_COMMIT, A_MIN_COMMIT,
  A_HIST, A_READ_HIST = A_HIST + BINS, A_LM_SKIPPED = A_READ_HIST + BINS, NACC
};

// Exchange bytes for a tile of `tc` clusters of `n` nodes (at n's width tier).
inline int64_t smem_bytes(int n, int tc) {
  const int w = width_for(n);
  const int64_t nxf = w == 2 ? (int)XTail<2>::NXF : w == 4 ? (int)XTail<4>::NXF
                                                   : (int)XTail<8>::NXF;
  return 4 * (int64_t)tc * (nxf * n + NACC);
}

template <int MW>
struct Xch {
  int32_t* base;
  int n, tc;
  RS_HD int32_t& at(int f, int node, int ci) const {
    return base[((int64_t)f * n + node) * tc + ci];
  }
  RS_HD int32_t* acc(int f, int ci) const {
    return base + ((int64_t)XTail<MW>::NXF * n + f) * tc + ci;
  }
};

// Accumulator updates: atomic on the card (any order gives the same integer),
// plain on the host. Sums wrap mod 2^32 like the JAX uint32 / int32 leaves.
RS_HD void acc_add(int32_t* p, int v) {
#ifdef __CUDA_ARCH__
  atomicAdd((unsigned*)p, (unsigned)v);
#else
  *p = (int32_t)((uint32_t)*p + (uint32_t)v);
#endif
}
RS_HD void acc_max(int32_t* p, int v) {
#ifdef __CUDA_ARCH__
  atomicMax(p, v);
#else
  if (v > *p) *p = v;
#endif
}
RS_HD void acc_min(int32_t* p, int v) {
#ifdef __CUDA_ARCH__
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}

// One node's state, carried between phases (registers on the card). Rows are
// MW words with the words past W zero.
template <int MW>
struct NodeCtx {
  bool alive, rs, up, heard_recent, joint, member_b;
  bool saw_higher, granted_any, has_ae, win, pre_win, applied_snap, is_leader;
  bool heartbeat, start_el, start_pv, xfer_elect, xe, xpend, late_grant, serve;
  bool noop, node_ok, client_ok, cfg_write;
  int role, term, vf, lid, len0, llen, len4, commit0, commit;
  int base0, bterm0, base, bterm, clock1, deadline0, tdraw, heard, my_last_term;
  int maj_old, maj_new, cfg_pend0, bpend, bepoch;
  int xfer0, xto, read_idx0, read_tick0, read_fr0;
  int grant_to, age_t, dur_mid, hnode, maxc, wval, wtick, cfg_code;
  uint32_t chk0, bchk, chk_new;
  uint32_t votes[MW], mask[MW], m_old[MW], m_new[MW], bmold[MW];
  uint32_t acks[MW], fresh[MW];
};

// Batch-minor offsets ([N, B] and [N, inner, B]) and leaf access, inside a
// phase function with locals `ptr`, `B` and `b` in scope.
#define RS_AT1(i) ((int64_t)(i) * B + b)
#define RS_AT2(i, j, inner) (((int64_t)(i) * (inner) + (j)) * B + b)
#define RS_IN(T, P_) ((const T*)ptr[P_])
#define RS_OUT(T, P_) ((T*)ptr[P_])
#define RS_ROW(arr, i) ((arr) + RS_AT2(i, 0, P.cap))  // slot s of node i at [s * B]
// Input leaves of any node of the cluster, from the staged headers.
#define RS_H(f, j) (X.at(f, j, ci))
#define RS_ALIVE(j) ((RS_H(X_HFLAGS, j) & 1) != 0)
#define RS_UP(j) ((RS_H(X_HFLAGS, j) & 2) != 0)
#define RS_RTYPE(j) RS_H(X_HRTYPE, j)
#define RS_RTERM(j) RS_H(X_HRTERM, j)
// The message on physical edge [dst i (this node), src s] is delivered iff i
// is up now and was at send time, s is alive, s != i, and bit s of i's mask
// row is set. Requests ride [sender, receiver] edges, responses [receiver,
// responder] -- the same physical edge test.
#define RS_DELIVERED(s) (x.up && (s) != i && RS_ALIVE(s) && has_bit<MW>(x.mask, s))
// Up-to-date test of candidate c's log against this node's (phases 2, 3.5).
#define RS_UTD(c)                                                          \
  (RS_H(X_HRLT, c) > x.my_last_term ||                                     \
   (RS_H(X_HRLT, c) == x.my_last_term && RS_H(X_HRLI, c) >= x.len0))
// This voter denies candidate c's RequestVote: it heard a leader recently and
// the request carries no transfer sanction.
#define RS_DENIED(c) \
  (g.deny && x.heard_recent && !(g.disrupt_live && RS_H(X_HDISRUPT, c) != 0))
// Quorum test over a packed row: this node's own member rows, dual while
// joint (reconfig), else the fixed majority.
#define RS_QUORUM(rows)                                                     \
  (g.rcf ? (popc_and<MW>(rows, x.m_old) >= x.maj_old &&                     \
            (!x.joint || popc_and<MW>(rows, x.m_new) >= x.maj_new))         \
         : popc_and<MW>(rows, nullptr) >= P.quorum)
#define RS_XPEND (g.xfr && x.xpend)
#define RS_PHASE_ARGS \
  const TickParams &P, void *const *ptr, NodeCtx<MW> &x, const Xch<MW> &X, int64_t b, int ci, int i

// In the wide forms (below) a worker's loops over a node's edges read the
// per-edge leaves of EDGE_BATCH edges together before it uses them: each read
// is a trip to memory, and one edge at a time (a store between two reads,
// which the compiler may not reorder) kept a wide node's loops
// latency-bound.
constexpr int EDGE_BATCH = 4;
// The wide forms -- these batched reads and the quorum histogram (`QHist`)
// -- are the lean wide body's (config5, config7, config7x): the full and
// mutant bodies already spill at 128 registers, and the forms took their
// stack frame from 192 to 800-848 B at width 4 (PERF.md §6), so they keep
// the one-edge loops and the walk.
#define RS_WIDE_FORMS (NPT == 2 && FULL == 0)

// The phase clock's hook around a leader's quorum order statistic (tick.cu
// defines it under RS_PHASE_CLOCK); elsewhere the statement runs alone.
#ifndef RS_QUORUM_TIMED
#define RS_QUORUM_TIMED(...) __VA_ARGS__
#endif

// The maj-th largest of a leader's match_with_self row over the members of
// `mask` (nullptr: every node; 0 when fewer qualify): the row is this node's
// own match_index output row, with `self` at its own slot. A candidate value
// no larger than the best so far cannot raise it, so its count is skipped.
template <int MW, class IdxT>
RS_HD int qmatch(const IdxT* mrow, int64_t B, int n, int i, int self, const uint32_t* mask,
                 int maj) {
  int qm = 0;
  for (int c = 0; c < n; ++c) {
    if (mask && !has_bit<MW>(mask, c)) continue;
    const int vc = c == i ? self : (int)mrow[(int64_t)c * B];
    if (vc <= qm) continue;
    int cnt = 0;
    for (int k = 0; k < n; ++k) {
      if (mask && !has_bit<MW>(mask, k)) continue;
      cnt += (k == i ? self : (int)mrow[(int64_t)k * B]) >= vc;
    }
    if (cnt >= maj) qm = vc;
  }
  return qm;
}

// The quorum commit of the wide forms (`RS_WIDE_FORMS`; the host build takes
// them for the same N and gates). `qmatch` re-reads the row up to N^2 times on one
// thread (65,025 reads at N = 255) while the cluster's other threads wait at
// the next barrier; this form folds each member's value into a histogram as
// the responder loop writes it, then scans the histogram. The result is used
// only where it exceeds the leader's commit `base`, so only values above
// base matter: the maj-th largest value exceeds base iff at least maj
// member values do, and it is then the maj-th largest among those alone --
// a value at or below base cannot change the commit. Values in the window
// (base, base + QH] get a byte counter each (QH = 16: CAP at config5/7/7x,
// and a leader's values rarely pass len_i - commit <= CAP); the values above
// it are counted, and if maj of them or more lie there the exact walk
// (`qmatch`) runs instead, so the result is always exact.
constexpr int QH = 16;  // window values a histogram counts

struct QHist {
  uint32_t h[QH / 4];  // byte counter d (word d / 4, byte d % 4): value base + 1 + d
  int hi;              // member values above base + QH
};

RS_HD void qhist_clear(QHist& q) {
  for (int w = 0; w < QH / 4; ++w) q.h[w] = 0u;
  q.hi = 0;
}

RS_HD void qhist_add(QHist& q, int base, int v) {
  const unsigned d = (unsigned)(v - base - 1);  // wraps past QH for v <= base
  if (d < (unsigned)QH) {
    const uint32_t inc = 1u << ((d & 3u) * 8u);
    for (int w = 0; w < QH / 4; ++w) q.h[w] += (unsigned)w == (d >> 2) ? inc : 0u;
  } else if (v > base) {
    ++q.hi;
  }
}

// max(the maj-th largest value added, base), or -1 when maj or more values
// lie above the window (the caller runs the exact walk).
RS_HD int qhist_select(const QHist& q, int base, int maj) {
  if (q.hi >= maj) return -1;
  int cum = q.hi;
  for (int d = QH - 1; d >= 0; --d) {
    cum += (int)((q.h[d >> 2] >> ((d & 3) * 8)) & 0xFFu);
    if (cum >= maj) return base + 1 + d;
  }
  return base;
}

// The quorum commit candidate from a histogram of one member set:
// max(maj-th largest of the row over `mask`, base), exact (the walk on the
// rare overflow).
template <int MW, class IdxT>
RS_HD int quorum_select(const QHist& q, int base, const IdxT* mrow, int64_t B, int n, int i,
                        int self, const uint32_t* mask, int maj) {
  const int qm = qhist_select(q, base, maj);
  return qm >= 0 ? qm : imax(qmatch<MW>(mrow, B, n, i, self, mask, maj), base);
}

// ---- phase 0: this node's mailbox header and liveness into the exchange.
template <class IdxT, class AckT, class NodeT, int MW, int FULL>
RS_HD void phase_headers(RS_PHASE_ARGS) {
  const Gates g(P, FULL);
  const int64_t B = P.b;
  const bool alive = RS_IN(uint8_t, I_ALIVE)[RS_AT1(i)] != 0;
  const bool up = alive && RS_IN(uint8_t, I_RESTARTED)[RS_AT1(i)] == 0;
  X.at(X_HFLAGS, i, ci) = (alive ? 1 : 0) | (up ? 2 : 0);
  X.at(X_HRTYPE, i, ci) = RS_IN(int32_t, M_REQ_TYPE)[RS_AT1(i)];
  X.at(X_HRTERM, i, ci) = RS_IN(int32_t, M_REQ_TERM)[RS_AT1(i)];
  X.at(X_HRLI, i, ci) = RS_IN(int32_t, M_REQ_LAST_INDEX)[RS_AT1(i)];
  X.at(X_HRLT, i, ci) = RS_IN(int32_t, M_REQ_LAST_TERM)[RS_AT1(i)];
  X.at(X_HRESP_TERM, i, ci) = RS_IN(int32_t, M_RESP_TERM)[RS_AT1(i)];
  X.at(X_HVTO, i, ci) = RS_IN(NodeT, M_V_TO)[RS_AT1(i)];
  X.at(X_HAOKTO, i, ci) = RS_IN(NodeT, M_A_OK_TO)[RS_AT1(i)];
  X.at(X_HAMATCH, i, ci) = RS_IN(IdxT, M_A_MATCH)[RS_AT1(i)];
  X.at(X_HAHINT, i, ci) = RS_IN(IdxT, M_A_HINT)[RS_AT1(i)];
  if (g.disrupt_live) X.at(X_HDISRUPT, i, ci) = RS_IN(int8_t, M_REQ_DISRUPT)[RS_AT1(i)];
  if (g.xfr) X.at(X_HXTGT, i, ci) = RS_IN(NodeT, M_XFER_TGT)[RS_AT1(i)];
  (void)x;
}

// ---- phase 1: everything a node decides from the tick's inputs and its own
// state: restart and recovery, term adoption, votes, AppendEntries, its
// PreVote grants, TimeoutNow receipt, responses and commit. -----------------
template <class IdxT, class AckT, class NodeT, int MW, int FULL, int NPT>
RS_HD void phase_load_to_commit(RS_PHASE_ARGS) {
  const Gates g(P, FULL);
  const int64_t B = P.b;
  const int n = P.n, e = P.e, cap = P.cap, W = P.w;
  const int32_t* log_term_in = RS_IN(int32_t, S_LOG_TERM);
  int32_t* log_term = RS_OUT(int32_t, O_LOG_TERM);
  int32_t* log_val = RS_OUT(int32_t, O_LOG_VAL);
  int32_t* log_tick = RS_OUT(int32_t, O_LOG_TICK);
  int32_t* log_cfg = RS_OUT(int32_t, O_LOG_CFG);
  const int8_t* resp_kind_in = RS_IN(int8_t, M_RESP_KIND);

  // ---- phase -1: load, restart wipe and crash recovery.
  x.alive = RS_IN(uint8_t, I_ALIVE)[RS_AT1(i)] != 0;
  x.rs = RS_IN(uint8_t, I_RESTARTED)[RS_AT1(i)] != 0;
  x.up = x.alive && !x.rs;
  x.tdraw = RS_IN(int32_t, I_TIMEOUT_DRAW)[RS_AT1(i)];
  const int clock0 = RS_IN(int32_t, S_CLOCK)[RS_AT1(i)];
  x.clock1 = clock0 + RS_IN(int32_t, I_SKEW)[RS_AT1(i)];
  x.base0 = x.base = RS_IN(int32_t, S_LOG_BASE)[RS_AT1(i)];
  x.bterm0 = x.bterm = g.comp ? RS_IN(int32_t, S_BASE_TERM)[RS_AT1(i)] : 0;
  x.bchk = RS_IN(uint32_t, S_BASE_CHK)[RS_AT1(i)];
  x.role = x.rs ? FOLLOWER : RS_IN(int32_t, S_ROLE)[RS_AT1(i)];
  x.lid = x.rs ? NIL : RS_IN(int32_t, S_LEADER_ID)[RS_AT1(i)];
  x.term = RS_IN(int32_t, S_TERM)[RS_AT1(i)];
  x.vf = RS_IN(int32_t, S_VOTED_FOR)[RS_AT1(i)];
  x.len0 = RS_IN(int32_t, S_LOG_LEN)[RS_AT1(i)];
  if (g.dur && x.rs) {
    // Crash recovery: term and vote rewind to the durable snapshot; the log
    // keeps its fsynced prefix (a floor) and the rest less a torn tail.
    x.term = RS_IN(int32_t, S_DUR_TERM)[RS_AT1(i)];
    x.vf = g.pvote ? RS_IN(int32_t, S_DUR_VOTE)[RS_AT1(i)] : NIL;  // the volatile-vote mutant
    x.len0 = imax(RS_IN(int32_t, S_DUR_LEN)[RS_AT1(i)],
                  x.len0 - RS_IN(int32_t, I_TORN_DROP)[RS_AT1(i)]);
  }
  x.commit0 = x.rs ? x.base0 : RS_IN(int32_t, S_COMMIT_INDEX)[RS_AT1(i)];
  x.chk0 = x.rs ? x.bchk : RS_IN(uint32_t, S_COMMIT_CHK)[RS_AT1(i)];
  x.deadline0 = x.rs ? clock0 + x.tdraw : RS_IN(int32_t, S_DEADLINE)[RS_AT1(i)];
  // A restarted node remembers no leader contact.
  x.heard = !g.hc_live ? 0
            : x.rs     ? clock0 - P.election_min
                       : RS_IN(int32_t, S_HEARD_CLOCK)[RS_AT1(i)];
  for (int w = 0; w < MW; ++w) {
    const bool live_w = w < W;
    x.votes[w] = (live_w && !x.rs) ? RS_IN(uint32_t, S_VOTES)[RS_AT2(i, w, W)] : 0u;
    x.mask[w] = live_w ? RS_IN(uint32_t, I_DELIVER_MASK)[RS_AT2(i, w, W)] : 0u;
    x.m_old[w] = x.m_new[w] = x.bmold[w] = x.acks[w] = x.fresh[w] = 0u;
  }
  // The reconfiguration plane's legs are loaded only under their gates;
  // every later read is gated the same way.
  x.heard_recent = g.deny && x.clock1 - x.heard < P.election_min;
  x.joint = false;
  x.member_b = true;
  x.cfg_pend0 = x.bpend = x.bepoch = x.maj_old = x.maj_new = 0;
  if (g.rcf) {
    x.cfg_pend0 = RS_IN(int32_t, S_CFG_PEND)[RS_AT1(i)];
    x.joint = x.cfg_pend0 > 0;
    x.bpend = RS_IN(int32_t, S_BASE_PEND)[RS_AT1(i)];
    x.bepoch = RS_IN(int32_t, S_BASE_EPOCH)[RS_AT1(i)];
    for (int w = 0; w < MW; ++w) {
      if (w >= W) continue;
      x.m_old[w] = RS_IN(uint32_t, S_MEMBER_OLD)[RS_AT2(i, w, W)];
      x.m_new[w] = RS_IN(uint32_t, S_MEMBER_NEW)[RS_AT2(i, w, W)];
      x.bmold[w] = RS_IN(uint32_t, S_BASE_MOLD)[RS_AT2(i, w, W)];
    }
    x.maj_old = popc_and<MW>(x.m_old, nullptr) / 2 + 1;
    x.maj_new = popc_and<MW>(x.m_new, nullptr) / 2 + 1;
    x.member_b = has_bit<MW>(x.m_old, i) || has_bit<MW>(x.m_new, i);  // i in its own view
  }
  // Volatile transfer and read state dies with the process.
  x.xfer0 = x.xto = NIL;
  if (g.xfr) x.xfer0 = x.rs ? NIL : RS_IN(int32_t, S_XFER_TO)[RS_AT1(i)];
  x.read_idx0 = x.read_tick0 = x.read_fr0 = 0;
  if (g.rdx) {
    x.read_idx0 = x.rs ? 0 : RS_IN(int32_t, S_READ_IDX)[RS_AT1(i)];
    x.read_tick0 = x.rs ? 0 : RS_IN(int32_t, S_READ_TICK)[RS_AT1(i)];
    for (int w = 0; w < MW; ++w)
      if (w < W) x.acks[w] = x.rs ? 0u : RS_IN(uint32_t, S_READ_ACKS)[RS_AT2(i, w, W)];
  }
  if (g.rdl) x.read_fr0 = x.rs ? 0 : RS_IN(int32_t, S_READ_FR)[RS_AT1(i)];
  // The log copies forward; phases 3 and 6 overwrite what they append.
  for (int k = 0; k < cap; ++k) {
    log_term[RS_AT2(i, k, cap)] = log_term_in[RS_AT2(i, k, cap)];
    log_val[RS_AT2(i, k, cap)] = RS_IN(int32_t, S_LOG_VAL)[RS_AT2(i, k, cap)];
    if (P.track) log_tick[RS_AT2(i, k, cap)] = RS_IN(int32_t, S_LOG_TICK)[RS_AT2(i, k, cap)];
    if (g.rcf) log_cfg[RS_AT2(i, k, cap)] = RS_IN(int32_t, S_LOG_CFG)[RS_AT2(i, k, cap)];
  }

  // ---- phase 1: term adoption (PreVote probes carry a prospective term,
  // never adopted; a denied RequestVote under reconfig is not processed).
  int msgs = 0, in_term = 0;
  // Sender s's message and response (RK: its response-kind read).
#define RS_ADOPT(RK)                                                      \
  if (RS_DELIVERED(s)) {                                                  \
    const int rt = RS_RTYPE(s);                                           \
    if (rt != 0) {                                                        \
      ++msgs;                                                             \
      const bool probe = g.pv && rt == REQ_PREVOTE;                       \
      const bool denied = g.rcf && rt == REQ_VOTE && RS_DENIED(s);        \
      if (!probe && !denied) in_term = imax(in_term, RS_RTERM(s));        \
    }                                                                     \
    if ((RK) != 0) {                                                      \
      ++msgs;                                                             \
      in_term = imax(in_term, RS_H(X_HRESP_TERM, s));                     \
    }                                                                     \
  }
  if (RS_WIDE_FORMS) {
    // In the wide forms the per-edge reads of EDGE_BATCH senders are issued
    // together, ahead of their use (`EDGE_BATCH`).
    for (int s0 = 0; s0 < n; s0 += EDGE_BATCH) {
      int8_t rk[EDGE_BATCH];
RS_UNROLL
      for (int u = 0; u < EDGE_BATCH; ++u) rk[u] = resp_kind_in[RS_AT2(i, imin(s0 + u, n - 1), n)];
RS_UNROLL
      for (int u = 0; u < EDGE_BATCH; ++u) {
        const int s = s0 + u;
        if (s < n) RS_ADOPT(rk[u])
      }
    }
  } else {
    for (int s = 0; s < n; ++s) RS_ADOPT(resp_kind_in[RS_AT2(i, s, n)])
  }
#undef RS_ADOPT
  if (msgs) acc_add(X.acc(A_MSGS, ci), msgs);
  x.saw_higher = in_term > x.term;
  if (x.saw_higher) {
    x.term = in_term;
    x.role = FOLLOWER;
    x.vf = NIL;
    x.lid = NIL;
    for (int w = 0; w < MW; ++w) x.votes[w] = 0u;
  }
  x.my_last_term = term_at(RS_ROW(log_term_in, i), B, cap, g.comp, x.base0, x.bterm0, x.len0);

  // ---- phase 2: RequestVote requests.
  {
    int lowest = n;
    bool grant_prev = false;  // the candidate this node already voted for is grantable
    for (int c = 0; c < n; ++c) {
      if (!RS_DELIVERED(c) || RS_RTYPE(c) != REQ_VOTE || RS_RTERM(c) != x.term) continue;
      if (!RS_UTD(c) || RS_DENIED(c)) continue;
      if (c < lowest) lowest = c;
      if (c == x.vf) grant_prev = true;
    }
    x.granted_any = (x.vf != NIL) ? grant_prev : (lowest < n);
    if (x.vf == NIL && x.granted_any) x.vf = lowest;
    x.grant_to = x.granted_any ? x.vf : NIL;
  }

  // ---- phase 3: AppendEntries requests and snapshot install. The window's
  // entries are read from the sender's mailbox row where they are used.
  {
    int src = n;
    for (int l = 0; l < n; ++l) {
      if (RS_DELIVERED(l) && RS_RTYPE(l) == REQ_APPEND && RS_RTERM(l) == x.term) {
        src = l;
        break;
      }
    }
    x.has_ae = src < n;
    const int32_t* ent_term = RS_IN(int32_t, M_ENT_TERM);
    int j_in = 0, ws_in = 0, lcommit = 0, ecount = 0, eprev = 0;
    if (x.has_ae) {
      j_in = RS_IN(int8_t, M_REQ_OFF)[RS_AT2(src, i, n)];
      ws_in = RS_IN(int32_t, M_ENT_START)[RS_AT1(src)];
      lcommit = RS_IN(int32_t, M_REQ_COMMIT)[RS_AT1(src)];
      ecount = RS_IN(int32_t, M_ENT_COUNT)[RS_AT1(src)];
      eprev = RS_IN(int32_t, M_ENT_PREV_TERM)[RS_AT1(src)];
    }
    // Window entry k of the sender (0 without a sender).
#define RS_WIN(P_, k) (x.has_ae ? RS_IN(int32_t, P_)[RS_AT2(src, k, e)] : 0)
    // The InstallSnapshot analogue: offset sentinel -1.
    const bool snap = g.comp && x.has_ae && j_in < 0;
    const bool ae_norm = x.has_ae && !snap;
    const int j = iclamp(j_in, 0, e);
    const int prev_i = ae_norm ? ws_in + j : 0;
    const int n_ent = ae_norm ? iclamp(ecount - j, 0, e) : 0;
    const int prev_t = (j == 0) ? eprev : RS_WIN(M_ENT_TERM, j - 1);
    const int off = iclamp(j, 0, e - 1);  // this receiver's entries start at slot j
    if (x.has_ae) {
      if (x.role == CANDIDATE || (g.pv && x.role == PRECANDIDATE)) x.role = FOLLOWER;
      x.lid = src;
    }
    const int stored_prev =
        term_at(RS_ROW(log_term_in, i), B, cap, g.comp, x.base0, x.bterm0, prev_i);
    // Under compaction a prev below the base is committed and compacted.
    const bool ae_ok = ae_norm && (prev_i == 0 || (g.comp && prev_i < x.base0) ||
                                   (prev_i <= x.len0 && stored_prev == prev_t));
    // Entries [lo, n_acc) of the window are written: the ring skips what is
    // already compacted and accepts only what it can hold.
    const int lo = g.comp ? iclamp(x.base0 - prev_i, 0, e) : 0;
    const int n_acc = g.comp ? imin(n_ent, imax(x.base0 + cap - prev_i, 0)) : n_ent;
    bool mismatch = false;
    for (int k = lo; k < n_acc; ++k) {
      if (prev_i + k < x.len0) {
        const int sl = g.comp ? pmod(prev_i + k, cap) : iclamp(prev_i + k, 0, cap - 1);
        if (log_term_in[RS_AT2(i, sl, cap)] != ent_term[RS_AT2(src, imin(off + k, e - 1), e)])
          mismatch = true;
      }
    }
    const int appended = g.comp ? prev_i + n_acc : imin(prev_i + n_ent, cap);
    x.llen = ae_ok ? (mismatch ? appended : imax(x.len0, appended)) : x.len0;
    x.dur_mid = g.dur ? imin(RS_IN(int32_t, S_DUR_LEN)[RS_AT1(i)], x.llen) : 0;
    if (ae_ok) {
      for (int k = lo; k < n_acc; ++k) {
        const int slot = g.comp ? pmod(prev_i + k, cap) : prev_i + k;
        if (slot < 0 || slot >= cap) continue;
        const int wk = imin(off + k, e - 1);
        log_term[RS_AT2(i, slot, cap)] = RS_WIN(M_ENT_TERM, wk);
        log_val[RS_AT2(i, slot, cap)] = RS_WIN(M_ENT_VAL, wk);
        if (P.track) log_tick[RS_AT2(i, slot, cap)] = RS_WIN(M_ENT_TICK, wk);
        // Non-config entries ship 0 and scrub stale commands off reused slots.
        if (g.rcf) log_cfg[RS_AT2(i, slot, cap)] = RS_WIN(M_ENT_CFG, wk);
      }
    }
#undef RS_WIN
    const int last_new = imax(imin(prev_i + n_acc, x.llen), 0);
    x.commit = ae_ok ? imax(x.commit0, imin(lcommit, last_new)) : x.commit0;
    // Snapshot install: adopt the sender's base (and config context); keep our
    // suffix when it extends through L with L's term, else wipe the log to L.
    int L = 0;
    x.applied_snap = false;
    if (snap) {
      L = RS_IN(int32_t, M_REQ_BASE)[RS_AT1(src)];
      const int Lt = RS_IN(int32_t, M_REQ_BASE_TERM)[RS_AT1(src)];
      if (L > x.base0) {
        x.applied_snap = true;
        const bool keep = L <= x.len0 &&
            term_at(RS_ROW(log_term_in, i), B, cap, true, x.base0, x.bterm0, L) == Lt;
        x.bterm = Lt;
        x.bchk = RS_IN(uint32_t, M_REQ_BASE_CHK)[RS_AT1(src)];
        x.base = L;
        if (!keep) x.llen = L;
        x.commit = imax(x.commit, L);
        if (g.rcf) {
          for (int w = 0; w < MW; ++w)
            if (w < W) x.bmold[w] = RS_IN(uint32_t, M_REQ_BASE_MOLD)[RS_AT2(src, w, W)];
          x.bpend = RS_IN(int32_t, M_REQ_BASE_PEND)[RS_AT1(src)];
          x.bepoch = RS_IN(int32_t, M_REQ_BASE_EPOCH)[RS_AT1(src)];
        }
      }
    }
    x.len4 = x.llen;
    // Snapshot receivers always ack, with match = the snapshot index.
    RS_OUT(NodeT, OM_A_OK_TO)[RS_AT1(i)] = (NodeT)((ae_ok || snap) ? src : NIL);
    RS_OUT(IdxT, OM_A_MATCH)[RS_AT1(i)] = (IdxT)(snap ? L : (ae_ok ? last_new : 0));
    RS_OUT(IdxT, OM_A_HINT)[RS_AT1(i)] = (IdxT)x.llen;
  }

  // ---- phase 3.5: this voter's PreVote grants. It grants a probe of a term
  // at least its own from an up-to-date log, unless it heard a leader within
  // election_min ticks of its clock or leads itself. The grant row goes to
  // the exchange; each candidate gathers its column in phase 4.
  if (g.hc_live && x.has_ae) x.heard = x.clock1;
  if (g.pv) {
    uint32_t row[MW] = {};
    const bool quiet = x.clock1 - x.heard >= P.election_min && x.role != LEADER;
    if (quiet) {
      for (int c = 0; c < n; ++c) {
        if (RS_DELIVERED(c) && RS_RTYPE(c) == REQ_PREVOTE && RS_RTERM(c) >= x.term && RS_UTD(c))
          set_bit<MW>(row, c);
      }
    }
    for (int w = 0; w < MW; ++w) X.at(X_PVG + w, i, ci) = (int32_t)row[w];
  }

  // ---- phase 3.7: TimeoutNow receipt: the target of a current-term
  // TimeoutNow starts an election this tick (non-voters never campaign).
  x.xfer_elect = false;
  if (g.xfr) {
    bool tn = false;
    for (int s = 0; s < n; ++s)
      tn = tn || (RS_DELIVERED(s) && RS_RTYPE(s) == REQ_TIMEOUT_NOW &&
                  RS_H(X_HXTGT, s) == i && RS_RTERM(s) == x.term);
    x.xfer_elect = tn && x.alive && x.role != LEADER && (!g.rcf || x.member_b);
  }
  // The blind-transfer mutant: the target takes leadership at once, a coup
  // that rides the election win's bookkeeping below.
  const bool coup = g.xfr && !g.xel && x.xfer_elect;
  if (coup) {
    x.term += 1;
    x.role = LEADER;
    x.lid = i;
    x.xfer_elect = false;
  }

  // ---- phases 4 + 5: responses, PreVote promotion, then leader commit.
  if (x.role == CANDIDATE) {
    for (int r = 0; r < n; ++r) {
      if (RS_DELIVERED(r) && resp_kind_in[RS_AT2(i, r, n)] == RESP_VOTE &&
          RS_H(X_HVTO, r) == i && RS_H(X_HRESP_TERM, r) == x.term)
        set_bit<MW>(x.votes, r);
    }
  }
  // A removed node cannot win on banked votes.
  x.win = (x.role == CANDIDATE && RS_QUORUM(x.votes) && x.alive && (!g.rcf || x.member_b)) ||
          coup;
  if (x.win) {
    x.role = LEADER;
    x.lid = i;
  }
  // Phase 4.5: pre-vote grants ride the packed pv_grant plane.
  x.pre_win = false;
  if (g.pv && x.role == PRECANDIDATE) {
    const uint32_t* grant_row = RS_IN(uint32_t, M_PV_GRANT);
    for (int r = 0; r < n; ++r) {
      if (RS_DELIVERED(r) && resp_kind_in[RS_AT2(i, r, n)] == RESP_PREVOTE &&
          ((grant_row[RS_AT2(i, r >> 5, W)] >> (r & 31)) & 1u))
        set_bit<MW>(x.votes, r);
    }
    x.pre_win = RS_QUORUM(x.votes) && x.alive && (!g.rcf || x.member_b);
    if (x.pre_win) {
      x.term += 1;
      x.role = CANDIDATE;
      x.vf = i;
      self_row<MW>(x.votes, i);
    }
  }
  {
    const IdxT* next_in = RS_IN(IdxT, S_NEXT_INDEX);
    const IdxT* match_in = RS_IN(IdxT, S_MATCH_INDEX);
    const AckT* ack_in = RS_IN(AckT, S_ACK_AGE);
    IdxT* next_out = RS_OUT(IdxT, O_NEXT_INDEX);
    IdxT* match_out = RS_OUT(IdxT, O_MATCH_INDEX);
    AckT* ack_out = RS_OUT(AckT, O_ACK_AGE);
    const int len_i = x.len4;
    const int xt = g.xfr ? iclamp(x.xfer0, 0, n - 1) : -1;  // the pending transfer's target
    uint32_t aresp_bits[MW] = {};
    x.age_t = 0;
    // In the lean wide body a live leader folds its row into the quorum
    // histogram (`QHist`) as it writes it, its own slot read as its length
    // (the lean gates have no durability gate and no member sets).
    const bool fold = RS_WIDE_FORMS && x.role == LEADER && x.alive;
    QHist q;
    if (RS_WIDE_FORMS) qhist_clear(q);
    // Receiver r's next, match and ack age (NX, MT, AG: the reads of its
    // leaves, RK its response kind).
#define RS_RESPOND(NX, MT, AG, RK)                                                     \
  {                                                                                    \
    int nx = x.rs ? 1 : (NX);                                                          \
    int mt = x.rs ? 0 : (MT);                                                          \
    int ag = x.rs ? P.ack_sat : (AG);                                                  \
    if (x.win) {                                                                       \
      nx = len_i + 1;                                                                  \
      mt = 0;                                                                          \
    }                                                                                  \
    const bool aresp = RS_DELIVERED(r) && (RK) == RESP_APPEND && x.role == LEADER &&   \
                       RS_H(X_HRESP_TERM, r) == x.term;                                \
    if (aresp) {                                                                       \
      if (g.rdx) set_bit<MW>(aresp_bits, r);                                           \
      const int am = RS_H(X_HAMATCH, r);                                               \
      if (RS_H(X_HAOKTO, r) == i) {                                                    \
        mt = imax(mt, am);                                                             \
        nx = imax(nx, am + 1);                                                         \
      } else {                                                                         \
        nx = imax(imin(nx - 1, RS_H(X_HAHINT, r) + 1), 1);                             \
      }                                                                                \
    }                                                                                  \
    ag = imin(ag + 1, P.ack_sat);                                                      \
    if (x.win || aresp) ag = 0;                                                        \
    if (g.rdl && ag <= P.lease_ticks) set_bit<MW>(x.fresh, r);                         \
    if (r == xt) x.age_t = ag;                                                         \
    next_out[RS_AT2(i, r, n)] = (IdxT)nx;                                              \
    match_out[RS_AT2(i, r, n)] = (IdxT)mt;                                             \
    ack_out[RS_AT2(i, r, n)] = (AckT)ag;                                               \
    /* What the walk would read back: the stored value, its length at i. */          \
    if (RS_WIDE_FORMS && fold) qhist_add(q, x.commit, r == i ? len_i : (int)(IdxT)mt); \
  }
    if (RS_WIDE_FORMS) {
      for (int r0 = 0; r0 < n; r0 += EDGE_BATCH) {
        int nxu[EDGE_BATCH], mtu[EDGE_BATCH], agu[EDGE_BATCH], rku[EDGE_BATCH];
RS_UNROLL
        for (int u = 0; u < EDGE_BATCH; ++u) {
          const int64_t at = RS_AT2(i, imin(r0 + u, n - 1), n);
          nxu[u] = next_in[at];
          mtu[u] = match_in[at];
          agu[u] = ack_in[at];
          rku[u] = resp_kind_in[at];
        }
RS_UNROLL
        for (int u = 0; u < EDGE_BATCH; ++u) {
          const int r = r0 + u;
          if (r < n) RS_RESPOND(nxu[u], mtu[u], agu[u], rku[u])
        }
      }
    } else {
      for (int r = 0; r < n; ++r)
        RS_RESPOND((int)next_in[RS_AT2(i, r, n)], (int)match_in[RS_AT2(i, r, n)],
                   (int)ack_in[RS_AT2(i, r, n)], resp_kind_in[RS_AT2(i, r, n)])
    }
#undef RS_RESPOND
    if (g.rdx) {  // a pending read on a leader banks this tick's acks
      const bool keep_r = x.role == LEADER && x.read_idx0 > 0;
      for (int w = 0; w < MW; ++w) x.acks[w] = keep_r ? (x.acks[w] | aresp_bits[w]) : 0u;
    }
    x.is_leader = x.role == LEADER;
    if (x.is_leader && x.alive) {
      // The quorum-th largest match: the largest value reached by at least
      // `quorum` entries of the row (an exact order statistic); under
      // reconfig, over the leader's own members, the min of both while joint.
      // Under the durability gate a leader's own slot is its durable length.
      // The lean wide body takes it from the histogram (`QHist`):
      // max(that, commit), which moves the commit exactly when the walk's
      // value does.
      const IdxT* mrow = match_out + RS_AT2(i, 0, n);
      const int self = g.dacks ? x.dur_mid : len_i;
      int qm;
      RS_QUORUM_TIMED(
        if (RS_WIDE_FORMS) {
          qm = quorum_select<MW>(q, x.commit, mrow, B, n, i, self, (const uint32_t*)nullptr,
                                 P.quorum);
        } else if (g.rcf) {
          qm = qmatch<MW>(mrow, B, n, i, self, x.m_old, x.maj_old);
          if (x.joint) qm = imin(qm, qmatch<MW>(mrow, B, n, i, self, x.m_new, x.maj_new));
        } else {
          qm = qmatch<MW>(mrow, B, n, i, self, (const uint32_t*)nullptr, P.quorum);
        }
      )
      const int qt = term_at(RS_ROW(log_term, i), B, cap, g.comp, x.base, x.bterm, qm);
      if (qm > x.commit && qt == x.term) x.commit = qm;
    }
  }
  X.at(X_COMMIT, i, ci) = x.commit;
  X.at(X_LID, i, ci) = x.lid;
  X.at(X_ELIGX, i, ci) = x.is_leader && x.alive && (!g.rcf || x.member_b);
}

// ---- phase 2: what needs the other nodes' phase-1 commit, leadership and
// eligibility: the max-commit node, transfer keep/accept, serving reads,
// offer latency, compaction and the ring checksum, the no-op slot. --------
template <class IdxT, class AckT, class NodeT, int MW, int FULL>
RS_HD void phase_serve_and_compact(RS_PHASE_ARGS) {
  using XT = XTail<MW>;
  const Gates g(P, FULL);
  const int64_t B = P.b;
  const int n = P.n, cap = P.cap;
  const int32_t now = RS_IN(int32_t, S_NOW)[b];
  const int32_t lat_frontier0 = RS_IN(int32_t, S_LAT_FRONTIER)[b];
  int32_t* log_term = RS_OUT(int32_t, O_LOG_TERM);
  int32_t* log_val = RS_OUT(int32_t, O_LOG_VAL);

  // The lowest-id max-commit node.
  x.maxc = 0;
  x.hnode = -1;
  for (int j = 0; j < n; ++j) {
    const int c = X.at(X_COMMIT, j, ci);
    if (x.hnode < 0 || c > x.maxc) {
      x.maxc = c;
      x.hnode = j;
    }
  }

  // ---- phase 5.2: transfer keep/accept. A pending transfer survives while
  // its leader leads and the target stays responsive; the lowest-id live
  // leader takes a new target that is a voter of its own target config.
  x.xpend = false;
  if (g.xfr) {
    const int t_x = RS_IN(int32_t, I_TRANSFER_CMD)[b];
    int ldx = n;
    for (int j = 0; j < n && ldx == n; ++j)
      if (X.at(X_ELIGX, j, ci)) ldx = j;
    const bool keep_x = x.is_leader && x.xfer0 != NIL && x.age_t <= P.ack_timeout;
    x.xto = keep_x ? x.xfer0 : NIL;
    const bool t_voter = !g.rcf || (t_x >= 0 && t_x < n && has_bit<MW>(x.m_new, t_x));
    if (t_x != NIL && t_voter && i == ldx && t_x != i && x.xto == NIL) x.xto = t_x;
    x.xpend = x.xto != NIL;
  }

  // ---- phase 5.2: ReadIndex and lease reads. A pending read serves once its
  // acks (with self) reach the leader's quorum, or at once on a lease (a
  // quorum acked within lease_ticks); the lowest-id leader with a committed
  // entry of its term captures a new read at commit + 1 (phase 3).
  x.serve = false;
  if (g.rdx) {
    const int read_cmd = RS_IN(int32_t, I_READ_CMD)[b];
    const bool pend0 = x.read_idx0 > 0;
    const bool keep_r = x.is_leader && pend0;
    uint32_t row[MW];
    self_row<MW>(row, i);
    for (int w = 0; w < MW; ++w) row[w] |= x.acks[w];
    x.serve = keep_r && x.alive && (!g.rconf || RS_QUORUM(row));  // stale-read: no round
    if (g.rdl) {
      self_row<MW>(row, i);
      for (int w = 0; w < MW; ++w) row[w] |= x.fresh[w];
      // A pending transfer's handoff covers the read path.
      const bool lease_ok = RS_QUORUM(row) && !RS_XPEND;
      x.serve = x.serve || (keep_r && x.alive && lease_ok);
    }
    if (x.serve) {
      const int lat = imax(now + 1 - x.read_tick0, 1);
      acc_add(X.acc(A_READS, ci), 1);
      acc_add(X.acc(A_READ_LAT_SUM, ci), lat);
      acc_add(X.acc(A_READ_HIST + log2_bin(lat), ci), 1);
      if (P.check_invariants && g.rdl && x.read_idx0 - 1 < x.read_fr0)
        acc_max(X.acc(A_VIOL_STALE, ci), 1);
    }
    const bool cur_committed =
        term_at(RS_ROW(log_term, i), B, cap, g.comp, x.base, x.bterm, x.commit) == x.term;
    X.at(XT::CANCAP, i, ci) = read_cmd != NIL && x.is_leader && x.alive && !pend0 &&
                              (cur_committed || !g.rconf) && !RS_XPEND;
  }

  // ---- offer->commit latency (offer-tick plane): entries newly past the
  // carried frontier, 1-based (frontier, commit]. Without the ring slot k
  // holds entry k + 1, so only those slots are visited; on the ring every
  // slot is, at its absolute index.
  if (P.track) {
    const bool lead_ok = x.is_leader && x.alive;
    const int32_t* log_tick = RS_OUT(int32_t, O_LOG_TICK);
    uint32_t lat_sum = 0u;
    int lat_cnt = 0, crossed = 0;
    const int k0 = g.comp ? 0 : imax(lat_frontier0, 0);
    const int k1 = g.comp ? cap : imin(x.commit, cap);
    for (int k = k0; k < k1; ++k) {
      const int abs1 = g.comp ? x.base + pmod(k - x.base, cap) + 1 : k + 1;
      if (abs1 <= lat_frontier0 || abs1 > x.commit) continue;
      const int tk = log_tick[RS_AT2(i, k, cap)];
      if (tk < 1 || tk > now) continue;  // not a client entry
      if (lead_ok) {
        const int lat = now - tk + 1;
        lat_sum += (uint32_t)lat;
        ++lat_cnt;
        acc_add(X.acc(A_HIST + log2_bin(lat), ci), 1);
      }
      if (i == x.hnode) ++crossed;
    }
    if (lat_cnt) {
      acc_add(X.acc(A_LAT_SUM, ci), (int)lat_sum);
      acc_add(X.acc(A_LAT_CNT, ci), lat_cnt);
    }
    if (crossed) acc_add(X.acc(A_CROSSED, ci), crossed);
  }

  // ---- phase 5.5: compaction and the ring checksum. The checksum (and the
  // config fold of the compacted span) is anchored at the post-install,
  // pre-advance base and runs before phase 6: an injection into a slot this
  // tick's rebase freed would otherwise alias.
  if (g.comp) {
    const int base_mid = x.base;
    const uint32_t bchk_mid = x.bchk;
    const int base2 = imax(base_mid, imin(x.commit, x.llen - (cap - P.compact_margin)));
    x.bterm = term_at(RS_ROW(log_term, i), B, cap, true, base_mid, x.bterm, base2);
    if (g.rcf) {
      const CfgFold<MW> f = fold_cfg<MW>(RS_ROW(RS_OUT(int32_t, O_LOG_CFG), i), B, cap, n,
                                         true, base_mid, base_mid, base2, !g.jc);
      for (int w = 0; w < MW; ++w) x.bmold[w] ^= f.fold[w];
      if (g.jc && f.hi > 0) x.bpend = f.code_hi > 0 ? f.code_hi : 0;
      x.bepoch += f.count;
    }
    x.base = base2;
    const int co = imax(x.commit0, base_mid);  // snapshot installs skip the check
    uint32_t s_co = 0u, s_bf = 0u, s_cn = 0u;
    for (int k = 0; k < cap; ++k) {
      const int a0 = base_mid + pmod(k - base_mid, cap);  // 0-based entry index of slot k
      const uint32_t c = (uint32_t)log_term[RS_AT2(i, k, cap)] * chk_w_term((uint32_t)a0) +
                         (uint32_t)log_val[RS_AT2(i, k, cap)] * chk_w_val((uint32_t)a0);
      if (a0 < co) s_co += c;
      if (a0 < base2) s_bf += c;
      if (a0 < x.commit) s_cn += c;
    }
    if (P.check_invariants && bchk_mid + s_co != x.chk0 && !x.applied_snap)
      acc_max(X.acc(A_CHK_BAD, ci), 1);
    x.bchk = bchk_mid + s_bf;
    x.chk_new = bchk_mid + s_cn;
  }

  // ---- phase 6, first part: the election-win no-op. Under compaction a
  // fresh leader's no-op needs a free slot, and client commands stop
  // `reserve` slots short so the no-op always finds one.
  const int reserve = imax(1, P.compact_margin / 2);
  const bool has_slot = x.llen - x.base < cap;
  x.noop = g.comp && x.win && has_slot;
  if (g.comp && x.win && !has_slot) acc_add(X.acc(A_NOOP_BLOCKED, ci), 1);
  const bool room = g.comp ? x.llen - x.base < cap - reserve : has_slot;
  x.node_ok = x.is_leader && x.alive && room && !x.noop;
  if (g.rcf) X.at(XT::LDJ, i, ci) = x.node_ok && x.member_b && !x.joint;
}

// Phase 2, per cluster: the latency frontier and the tick counter.
template <int MW>
RS_HD void cluster_frontier(const TickParams& P, void* const* ptr, const Xch<MW>& X, int64_t b,
                            int ci) {
  int maxc = X.at(X_COMMIT, 0, ci);
  for (int j = 1; j < P.n; ++j) maxc = imax(maxc, X.at(X_COMMIT, j, ci));
  const int32_t lat_frontier0 = RS_IN(int32_t, S_LAT_FRONTIER)[b];
  RS_OUT(int32_t, O_LAT_FRONTIER)[b] = P.track ? imax(lat_frontier0, maxc) : lat_frontier0;
  RS_OUT(int32_t, O_NOW)[b] = RS_IN(int32_t, S_NOW)[b] + 1;
}

// The redirect pipeline's slot k after this tick's fresh offer: the first
// free slot takes it (with the offer stamp). Every worker of a cluster
// derives the same slots from the inputs.
struct Slot {
  int pend, tgt, tick;
};

RS_HD Slot redirect_slot(const TickParams& P, void* const* ptr, int64_t b, int k, int fresh_k) {
  const int64_t B = P.b;
  Slot sl;
  sl.pend = RS_IN(int32_t, S_CLIENT_PEND)[RS_AT1(k)];
  sl.tgt = RS_IN(int32_t, S_CLIENT_DST)[RS_AT1(k)];
  sl.tick = P.track ? RS_IN(int32_t, S_CLIENT_TICK)[RS_AT1(k)] : 0;
  const int32_t client_cmd = RS_IN(int32_t, I_CLIENT_CMD)[b];
  if (k == fresh_k && client_cmd != NIL) {
    sl.pend = client_cmd;
    sl.tgt = RS_IN(int32_t, I_CLIENT_TARGET)[b];
    sl.tick = RS_IN(int32_t, S_NOW)[b] + 1;
  }
  return sl;
}

// The first free pipeline slot (K when none is free).
RS_HD int redirect_fresh_slot(const TickParams& P, void* const* ptr, int64_t b) {
  const int64_t B = P.b;
  for (int k = 0; k < P.k; ++k)
    if (RS_IN(int32_t, S_CLIENT_PEND)[RS_AT1(k)] == NIL) return k;
  return P.k;
}

// ---- phase 3: read capture, the one append a node makes (no-op > config
// entry > client), timers, and the fsync flush. ---------------------------
template <class IdxT, class AckT, class NodeT, int MW, int FULL>
RS_HD void phase_append_and_timers(RS_PHASE_ARGS) {
  using XT = XTail<MW>;
  const Gates g(P, FULL);
  const int64_t B = P.b;
  const int n = P.n, cap = P.cap, W = P.w;
  const int32_t now = RS_IN(int32_t, S_NOW)[b];
  const int32_t client_cmd = RS_IN(int32_t, I_CLIENT_CMD)[b];

  // ---- phase 5.2, read capture: the lowest-id node that may capture does.
  if (g.rdx) {
    const bool pend0 = x.read_idx0 > 0;
    const bool cleared = x.serve || (pend0 && !(x.is_leader && pend0));
    bool cap_r = X.at(XT::CANCAP, i, ci) != 0;
    for (int j = 0; j < i && cap_r; ++j)
      if (X.at(XT::CANCAP, j, ci)) cap_r = false;
    const int ridx = cap_r ? x.commit + 1 : cleared ? 0 : x.read_idx0;
    const int rtick = cap_r ? now + 1 : cleared ? 0 : x.read_tick0;
    RS_OUT(int32_t, O_READ_IDX)[RS_AT1(i)] = ridx;
    RS_OUT(int32_t, O_READ_TICK)[RS_AT1(i)] = rtick;
    for (int w = 0; w < MW; ++w)
      if (w < W) RS_OUT(uint32_t, O_READ_ACKS)[RS_AT2(i, w, W)] = (cap_r || x.serve) ? 0u : x.acks[w];
    if (g.rdl) {  // the staleness anchor: the frontier at capture
      const int fr_now = imax(RS_IN(int32_t, S_LAT_FRONTIER)[b], x.maxc);
      RS_OUT(int32_t, O_READ_FR)[RS_AT1(i)] = cap_r ? fr_now : cleared ? 0 : x.read_fr0;
    }
  }

  // ---- phase 6: config entry, client offer, injection.
  x.cfg_write = false;
  x.cfg_code = 0;
  if (g.rcf) {
    // A joint entry on the admin's toggle (lowest-id eligible leader, not
    // joint, leaving at least 2 voters); a final entry once the governing
    // joint entry commits on the leader. Judged on each leader's own
    // tick-start configuration.
    const int t_r = RS_IN(int32_t, I_RECONFIG_CMD)[b];
    const bool t_ok = t_r != NIL && t_r >= 0 && t_r < n;
    int ldj = n;
    for (int j = 0; j < n && ldj == n; ++j)
      if (X.at(XT::LDJ, j, ci)) ldj = j;
    const bool ld_ok = x.node_ok && x.member_b;
    int toggled = 0;
    for (int w = 0; w < MW; ++w)
      toggled += popcount32(x.m_new[w] ^ ((t_ok && w == (t_r >> 5)) ? 1u << (t_r & 31) : 0u));
    const bool accept_j = t_ok && i == ldj && ld_ok && !x.joint && toggled >= 2;
    int pend_v = n;  // the open toggle: the lowest bit the two rows differ on
    for (int v = 0; v < n && pend_v == n; ++v)
      if (has_bit<MW>(x.m_old, v) != has_bit<MW>(x.m_new, v)) pend_v = v;
    const bool accept_f = g.jc && ld_ok && x.joint && x.commit >= x.cfg_pend0;
    x.cfg_code = accept_j ? t_r + 1 : accept_f ? -(pend_v + 1) : 0;
    x.cfg_write = accept_j || accept_f;
  }
  // The slot holds a config entry; a pending transfer refuses clients.
  x.node_ok = x.node_ok && !(g.rcf && x.cfg_write) && !RS_XPEND;
  x.client_ok = !g.redir && client_cmd != NIL && x.node_ok;
  x.wval = client_cmd;
  x.wtick = now + 1;  // a direct offer is accepted on its offer tick
  if (x.client_ok) acc_max(X.acc(A_CMDS, ci), 1);  // offers, not appends
  if (g.redir) {
    // K-deep pipeline: each pending offer goes to its target node, which
    // accepts its lowest slot if it leads (the slots' outputs: phase 4).
    const int fresh_k = redirect_fresh_slot(P, ptr, b);
    for (int k = 0; k < P.k; ++k) {
      const Slot sl = redirect_slot(P, ptr, b, k, fresh_k);
      if (sl.pend != NIL && sl.tgt == i) {
        x.client_ok = x.node_ok;
        x.wval = sl.pend;
        x.wtick = sl.tick;
        break;
      }
    }
    X.at(XT::NODEOK, i, ci) = x.node_ok;
  }
  {
    const bool cfg_w = g.rcf && x.cfg_write;
    if (x.noop || cfg_w || x.client_ok) {
      const int pos = g.comp ? pmod(x.llen, cap) : x.llen;
      if (pos >= 0 && pos < cap) {
        // No-op and config entries carry stamp 0; config entries value 0,
        // their command riding the config plane (0 for every other entry).
        const bool proto = x.noop || cfg_w;
        RS_OUT(int32_t, O_LOG_TERM)[RS_AT2(i, pos, cap)] = x.term;
        RS_OUT(int32_t, O_LOG_VAL)[RS_AT2(i, pos, cap)] = x.noop ? NOOP : cfg_w ? 0 : x.wval;
        if (P.track) RS_OUT(int32_t, O_LOG_TICK)[RS_AT2(i, pos, cap)] = proto ? 0 : x.wtick;
        if (g.rcf) RS_OUT(int32_t, O_LOG_CFG)[RS_AT2(i, pos, cap)] = x.cfg_code;
      }
      x.llen += 1;
    }
  }

  // ---- phase 7: timers.
  {
    const int clock = x.clock1;
    int dl = (x.granted_any || x.has_ae || x.saw_higher) ? clock + x.tdraw : x.deadline0;
    if (x.win) dl = clock + P.heartbeat;
    if (x.pre_win) dl = clock + x.tdraw;
    const bool expired = clock >= dl && x.alive;
    x.heartbeat = expired && x.is_leader;
    if (x.heartbeat) dl = clock + P.heartbeat;
    // Under PreVote expiry starts a probe (no term bump); the real election
    // started at the phase-4.5 promotion. Non-voters never campaign, and a
    // TimeoutNow target skips the probe: its election starts now.
    const bool voter = !g.rcf || x.member_b;
    const bool xfer_el = g.xfr && x.xfer_elect;
    x.xe = xfer_el && !x.pre_win && !x.is_leader;
    x.start_pv = g.pv && expired && !x.is_leader && voter && !xfer_el;
    x.start_el = g.pv ? x.pre_win : expired && !x.is_leader && voter;
    if (x.start_pv) {
      x.role = PRECANDIDATE;
      x.lid = NIL;
      self_row<MW>(x.votes, i);
      dl = clock + x.tdraw;
    }
    const bool bump = x.xe || (!g.pv && x.start_el);
    if (bump) {
      x.term += 1;
      x.vf = i;
      x.role = CANDIDATE;
      x.lid = NIL;
      self_row<MW>(x.votes, i);
      dl = clock + x.tdraw;
    }
    x.start_el = x.start_el || x.xe;
    RS_OUT(int32_t, O_CLOCK)[RS_AT1(i)] = clock;
    RS_OUT(int32_t, O_DEADLINE)[RS_AT1(i)] = dl;
  }

  // ---- phase 7.5: fsync flush and the durability gate. A live node's due
  // flush snaps its durable snapshot to its final log length, term and vote;
  // its AppendEntries ack names only fsynced entries, and a vote grant is
  // sent once durable -- a flush that newly covers a grant made on an earlier
  // tick sends it late (phase 8).
  x.late_grant = false;
  if (g.dur) {
    const bool fs = x.alive && RS_IN(uint8_t, I_FSYNC_FIRE)[RS_AT1(i)] != 0;
    const int d_term = RS_IN(int32_t, S_DUR_TERM)[RS_AT1(i)];
    const int d_vote = RS_IN(int32_t, S_DUR_VOTE)[RS_AT1(i)];
    const int len2 = fs ? x.llen : x.dur_mid;
    const int term2 = fs ? x.term : d_term;
    const int vote2 = fs ? x.vf : d_vote;
    RS_OUT(int32_t, O_DUR_LEN)[RS_AT1(i)] = len2;
    RS_OUT(int32_t, O_DUR_TERM)[RS_AT1(i)] = term2;
    RS_OUT(int32_t, O_DUR_VOTE)[RS_AT1(i)] = vote2;
    if (g.dacks) {
      IdxT* am = RS_OUT(IdxT, OM_A_MATCH) + RS_AT1(i);
      *am = (IdxT)imin((int)*am, len2);
      const bool covered0 = d_term == x.term && d_vote == x.vf && x.vf != NIL;
      const bool covered2 = term2 == x.term && vote2 == x.vf && x.vf != NIL;
      x.grant_to = covered2 ? x.vf : NIL;
      x.late_grant = covered2 && !covered0 && !x.granted_any;
      X.at(XT::LATE, i, ci) = x.late_grant ? x.vf : NIL;
    }
    acc_add(X.acc(A_LAG_SUM, ci), x.llen - len2);
    acc_max(X.acc(A_LAG_MAX, ci), x.llen - len2);
  }
}

// A set of node ids, one bit a node: one 64-bit word at the narrow width
// tier, MW packed words above it.
template <int MW>
struct NodeSet {
  uint32_t row[MW] = {};
  RS_HD bool has(int t) const { return has_bit<MW>(row, t); }
  RS_HD void set(int t) { set_bit<MW>(row, t); }
};
template <>
struct NodeSet<2> {
  uint64_t bits = 0;
  RS_HD bool has(int t) const { return (bits >> t) & 1u; }
  RS_HD void set(int t) { bits |= (uint64_t)1 << t; }
};

// Phase 4, per cluster: the redirect pipeline's K slots. An offer is
// accepted by its target when the target takes a client command and this is
// the lowest pending slot naming it; the rest chase the target's believed
// leader, or bounce while the target is down or knows none.
template <int MW, int FULL>
RS_HD void cluster_redirect(const TickParams& P, void* const* ptr, const Xch<MW>& X, int64_t b,
                            int ci) {
  if (!Gates(P, FULL).redir) return;
  using XT = XTail<MW>;
  const int64_t B = P.b;
  const int n = P.n;
  const int fresh_k = redirect_fresh_slot(P, ptr, b);
  NodeSet<MW> claimed;  // targets a lower pending slot names
  int cmds = 0;
  for (int k = 0; k < P.k; ++k) {
    const Slot sl = redirect_slot(P, ptr, b, k, fresh_k);
    const bool active = sl.pend != NIL;
    const int t = sl.tgt;
    const bool valid = active && t >= 0 && t < n;
    const bool lowest = valid && !claimed.has(t);
    if (valid) claimed.set(t);
    const bool accepted = lowest && X.at(XT::NODEOK, t, ci) != 0;
    cmds += accepted;
    const bool pend_on = active && !accepted;
    const int tgt_ld = valid ? X.at(X_LID, t, ci) : NIL;
    const bool tgt_up = valid && RS_ALIVE(t);
    RS_OUT(int32_t, O_CLIENT_PEND)[RS_AT1(k)] = pend_on ? sl.pend : NIL;
    RS_OUT(int32_t, O_CLIENT_DST)[RS_AT1(k)] =
        !pend_on ? 0
        : (tgt_up && tgt_ld != NIL) ? tgt_ld
                                    : RS_IN(int32_t, I_CLIENT_BOUNCE)[RS_AT1(k)];
    if (P.track) RS_OUT(int32_t, O_CLIENT_TICK)[RS_AT1(k)] = pend_on ? sl.tick : 0;
  }
  if (cmds) acc_add(X.acc(A_CMDS, ci), cmds);
}

// ---- phase 4: outbox, prefix checksum, end-of-tick configuration, state
// out, and this node's StepInfo terms. -------------------------------------
template <class IdxT, class AckT, class NodeT, int MW, int FULL, int NPT>
RS_HD void phase_outbox_and_state(RS_PHASE_ARGS) {
  using XT = XTail<MW>;
  const Gates g(P, FULL);
  const int64_t B = P.b;
  const int n = P.n, e = P.e, cap = P.cap, W = P.w;
  const int32_t* log_term = RS_OUT(int32_t, O_LOG_TERM);
  const int32_t* log_val = RS_OUT(int32_t, O_LOG_VAL);
  const IdxT* next_out = RS_OUT(IdxT, O_NEXT_INDEX);
  const AckT* ack_out = RS_OUT(AckT, O_ACK_AGE);

  // ---- phase 8: outbox.
  const bool send = x.win || x.heartbeat;
  const int len_i = x.len4;
  // Shared window start: the minimum prev over responsive peers, else over
  // all peers, clamped to the pre-injection length and (ring) the base.
  int ws_resp = I32_MAX, ws_all = I32_MAX;
  // Peer j's prev (NX: its next-index read, AG its ack-age read).
#define RS_WINDOW(NX, AG)                                                   \
  if (j != i) {                                                             \
    const int prev = imin(imax((int)(NX) - 1, 0), len_i);                   \
    ws_all = imin(ws_all, prev);                                            \
    if ((int)(AG) <= P.ack_timeout) ws_resp = imin(ws_resp, prev);          \
  }
#define RS_OFFSET(NX)                                                                   \
  {                                                                                     \
    const int prev = imin(imax((int)(NX) - 1, 0), len_i);                               \
    int off_j = 0;                                                                      \
    if (send && j != i) off_j = (g.comp && prev < x.base) ? -1 : iclamp(prev - ws, 0, e); \
    RS_OUT(int8_t, OM_REQ_OFF)[RS_AT2(i, j, n)] = (int8_t)off_j;                        \
  }
  if (RS_WIDE_FORMS) {  // the reads of EDGE_BATCH peers together (`EDGE_BATCH`)
    for (int j0 = 0; j0 < n; j0 += EDGE_BATCH) {
      int nxu[EDGE_BATCH], agu[EDGE_BATCH];
RS_UNROLL
      for (int u = 0; u < EDGE_BATCH; ++u) {
        const int64_t at = RS_AT2(i, imin(j0 + u, n - 1), n);
        nxu[u] = next_out[at];
        agu[u] = ack_out[at];
      }
RS_UNROLL
      for (int u = 0; u < EDGE_BATCH; ++u) {
        const int j = j0 + u;
        if (j < n) RS_WINDOW(nxu[u], agu[u])
      }
    }
  } else {
    for (int j = 0; j < n; ++j) RS_WINDOW(next_out[RS_AT2(i, j, n)], ack_out[RS_AT2(i, j, n)])
  }
  int ws = imin(ws_resp == I32_MAX ? ws_all : ws_resp, len_i);
  if (g.comp) ws = imax(ws, x.base);
  if (RS_WIDE_FORMS) {
    for (int j0 = 0; j0 < n; j0 += EDGE_BATCH) {
      int nxu[EDGE_BATCH];
RS_UNROLL
      for (int u = 0; u < EDGE_BATCH; ++u) nxu[u] = next_out[RS_AT2(i, imin(j0 + u, n - 1), n)];
RS_UNROLL
      for (int u = 0; u < EDGE_BATCH; ++u) {
        const int j = j0 + u;
        if (j < n) RS_OFFSET(nxu[u])
      }
    }
  } else {
    for (int j = 0; j < n; ++j) RS_OFFSET(next_out[RS_AT2(i, j, n)])
  }
#undef RS_OFFSET
#undef RS_WINDOW
  const int n_ship = iclamp(x.llen - ws, 0, e);
  for (int k = 0; k < e; ++k) {
    const bool used = send && k < n_ship;
    const int slot = g.comp ? pmod(ws + k, cap) : iclamp(ws + k, 0, cap - 1);
    RS_OUT(int32_t, OM_ENT_TERM)[RS_AT2(i, k, e)] = used ? log_term[RS_AT2(i, slot, cap)] : 0;
    RS_OUT(int32_t, OM_ENT_VAL)[RS_AT2(i, k, e)] = used ? log_val[RS_AT2(i, slot, cap)] : 0;
    if (P.track)
      RS_OUT(int32_t, OM_ENT_TICK)[RS_AT2(i, k, e)] =
          used ? RS_OUT(int32_t, O_LOG_TICK)[RS_AT2(i, slot, cap)] : 0;
    if (g.rcf)
      RS_OUT(int32_t, OM_ENT_CFG)[RS_AT2(i, k, e)] =
          used ? RS_OUT(int32_t, O_LOG_CFG)[RS_AT2(i, slot, cap)] : 0;
  }
  int req_type = x.start_el ? REQ_VOTE : (send ? REQ_APPEND : 0);
  if (x.start_pv) req_type = REQ_PREVOTE;
  const bool rv_like = x.start_el || x.start_pv;
  const int l = x.llen;
  const int last_term = term_at(RS_ROW(log_term, i), B, cap, g.comp, x.base, x.bterm, l);
  const int pterm = term_at(RS_ROW(log_term, i), B, cap, g.comp, x.base, x.bterm, ws);
  // A probe carries the prospective term.
  const int req_term = x.start_pv ? x.term + 1 : (req_type != 0 ? x.term : 0);
  if (g.xfr) {
    // TimeoutNow replaces the heartbeat once the target's match reaches the
    // leader's (post-injection) log length.
    const bool fire = send && x.xto != NIL &&
        (!g.xel || (int)RS_OUT(IdxT, O_MATCH_INDEX)[RS_AT2(i, iclamp(x.xto, 0, n - 1), n)] >= l);
    if (fire) req_type = REQ_TIMEOUT_NOW;
    RS_OUT(NodeT, OM_XFER_TGT)[RS_AT1(i)] = (NodeT)(fire ? x.xto : NIL);
    if (g.disrupt_live) RS_OUT(int8_t, OM_REQ_DISRUPT)[RS_AT1(i)] = (int8_t)x.xe;
  }
  RS_OUT(int32_t, OM_REQ_TYPE)[RS_AT1(i)] = req_type;
  RS_OUT(int32_t, OM_REQ_TERM)[RS_AT1(i)] = req_term;
  RS_OUT(int32_t, OM_REQ_COMMIT)[RS_AT1(i)] = send ? x.commit : 0;
  RS_OUT(int32_t, OM_REQ_LAST_INDEX)[RS_AT1(i)] = rv_like ? l : 0;
  RS_OUT(int32_t, OM_REQ_LAST_TERM)[RS_AT1(i)] = rv_like ? last_term : 0;
  RS_OUT(int32_t, OM_ENT_START)[RS_AT1(i)] = send ? ws : 0;
  RS_OUT(int32_t, OM_ENT_PREV_TERM)[RS_AT1(i)] = send ? pterm : 0;
  RS_OUT(int32_t, OM_ENT_COUNT)[RS_AT1(i)] = send ? n_ship : 0;
  if (g.comp) {
    RS_OUT(int32_t, OM_REQ_BASE)[RS_AT1(i)] = send ? x.base : 0;
    RS_OUT(int32_t, OM_REQ_BASE_TERM)[RS_AT1(i)] = send ? x.bterm : 0;
    RS_OUT(uint32_t, OM_REQ_BASE_CHK)[RS_AT1(i)] = send ? x.bchk : 0u;
    if (g.rcf) {  // the snapshot config context rides the header
      for (int w = 0; w < MW; ++w)
        if (w < W) RS_OUT(uint32_t, OM_REQ_BASE_MOLD)[RS_AT2(i, w, W)] = send ? x.bmold[w] : 0u;
      RS_OUT(int32_t, OM_REQ_BASE_PEND)[RS_AT1(i)] = send ? x.bpend : 0;
      RS_OUT(int32_t, OM_REQ_BASE_EPOCH)[RS_AT1(i)] = send ? x.bepoch : 0;
    }
  }
  if (g.pv) {
    // This candidate's pv_grant row: bit v where voter v's phase-1 grant row
    // names it.
    uint32_t pvg[MW] = {};
    for (int v = 0; v < n; ++v)
      if ((((uint32_t)X.at(X_PVG + (i >> 5), v, ci)) >> (i & 31)) & 1u) set_bit<MW>(pvg, v);
    for (int w = 0; w < MW; ++w)
      if (w < W) RS_OUT(uint32_t, OM_PV_GRANT)[RS_AT2(i, w, W)] = pvg[w];
  }
  RS_OUT(NodeT, OM_V_TO)[RS_AT1(i)] = (NodeT)x.grant_to;
  RS_OUT(int32_t, OM_RESP_TERM)[RS_AT1(i)] = x.term;
  // Responses on edge [requester i, responder v]: the type of the request
  // v received from i this tick (a TimeoutNow gets none). Delivery to v is
  // the input test of v's row.
  {
    const int rt = RS_RTYPE(i);
    const int kind_req = rt == REQ_VOTE      ? RESP_VOTE
                         : rt == REQ_APPEND  ? RESP_APPEND
                         : rt == REQ_PREVOTE ? RESP_PREVOTE
                                             : 0;
    for (int v = 0; v < n; ++v) {
      int kind = 0;
      if (kind_req != 0 && v != i && x.alive && RS_UP(v) &&
          ((RS_IN(uint32_t, I_DELIVER_MASK)[RS_AT2(v, i >> 5, W)] >> (i & 31)) & 1u))
        kind = kind_req;
      // The late RESP_VOTE, only on an edge with no other response.
      if (g.dacks && kind == 0 && X.at(XT::LATE, v, ci) == i) kind = RESP_VOTE;
      RS_OUT(int8_t, OM_RESP_KIND)[RS_AT2(i, v, n)] = (int8_t)kind;
    }
  }

  // ---- committed-prefix checksum (prefix form), end-of-tick configuration
  // and state.
  if (!g.comp) {
    x.chk_new = x.chk0;
    if (P.check_invariants) {
      uint32_t s_old = 0u, s_new = 0u;
      const int hi = imin(imax(x.commit0, x.commit), cap);
      for (int k = 0; k < hi; ++k) {
        const uint32_t c = (uint32_t)log_term[RS_AT2(i, k, cap)] * chk_w_term((uint32_t)k) +
                           (uint32_t)log_val[RS_AT2(i, k, cap)] * chk_w_val((uint32_t)k);
        if (k < x.commit0) s_old += c;
        if (k < x.commit) s_new += c;
      }
      if (s_old != x.chk0) acc_max(X.acc(A_CHK_BAD, ci), 1);
      x.chk_new = s_new;
    }
  }
  if (g.rcf) {
    // The node's configuration from its own log (base, llen] and snapshot
    // context: C_old folds the final entries' toggles; the latest entry's
    // sign decides jointness. A removed leader steps down once its removal
    // commits on it; a removed candidate stops campaigning.
    // The act-on-commit mutant derives from the committed prefix only; the
    // single-server mutant is never joint; the truncation-rollback mutant
    // keeps the tick-start configuration where the entry count dropped.
    const CfgFold<MW> f = fold_cfg<MW>(RS_ROW(RS_OUT(int32_t, O_LOG_CFG), i), B, cap, n,
                                       g.comp, x.base, x.base,
                                       g.aoa ? x.llen : imin(x.commit, x.llen), !g.jc);
    const int pend_code = f.hi > 0 ? f.code_hi : x.bpend;
    const bool joint2 = g.jc && pend_code > 0;
    const int pv_ = pend_code - 1;
    int epoch = x.bepoch + f.count;
    int cfg_pend = joint2 ? (f.hi > 0 ? f.hi : imax(x.base, 1)) : 0;
    const int epoch0 = g.trb ? 0 : RS_IN(int32_t, S_CFG_EPOCH)[RS_AT1(i)];
    const bool rolled = !g.trb && epoch < epoch0;
    uint32_t d_old[MW], d_new[MW];
    for (int w = 0; w < MW; ++w) {
      d_old[w] = x.bmold[w] ^ f.fold[w];
      const uint32_t tb = (joint2 && pv_ < n && w == (pv_ >> 5)) ? 1u << (pv_ & 31) : 0u;
      d_new[w] = d_old[w] ^ tb;
      if (rolled) {
        d_old[w] = x.m_old[w];
        d_new[w] = x.m_new[w];
      }
      if (w < W) {
        RS_OUT(uint32_t, O_MEMBER_OLD)[RS_AT2(i, w, W)] = d_old[w];
        RS_OUT(uint32_t, O_MEMBER_NEW)[RS_AT2(i, w, W)] = d_new[w];
      }
    }
    if (rolled) {
      epoch = epoch0;
      cfg_pend = x.cfg_pend0;
    }
    RS_OUT(int32_t, O_CFG_PEND)[RS_AT1(i)] = cfg_pend;
    RS_OUT(int32_t, O_CFG_EPOCH)[RS_AT1(i)] = epoch;
    const bool self_in = has_bit<MW>(d_old, i) || has_bit<MW>(d_new, i);
    const bool cand = x.role == CANDIDATE || x.role == PRECANDIDATE;
    if (!self_in && ((x.role == LEADER && x.commit >= imax(f.hi, x.base)) || cand)) {
      x.role = FOLLOWER;
      x.lid = NIL;
    }
    if (g.comp) {
      for (int w = 0; w < MW; ++w)
        if (w < W) RS_OUT(uint32_t, O_BASE_MOLD)[RS_AT2(i, w, W)] = x.bmold[w];
      RS_OUT(int32_t, O_BASE_PEND)[RS_AT1(i)] = x.bpend;
      RS_OUT(int32_t, O_BASE_EPOCH)[RS_AT1(i)] = x.bepoch;
    }
  }
  if (g.xfr) RS_OUT(int32_t, O_XFER_TO)[RS_AT1(i)] = x.xto;
  RS_OUT(int32_t, O_ROLE)[RS_AT1(i)] = x.role;
  RS_OUT(int32_t, O_TERM)[RS_AT1(i)] = x.term;
  RS_OUT(int32_t, O_VOTED_FOR)[RS_AT1(i)] = x.vf;
  RS_OUT(int32_t, O_LEADER_ID)[RS_AT1(i)] = x.lid;
  for (int w = 0; w < MW; ++w)
    if (w < W) RS_OUT(uint32_t, O_VOTES)[RS_AT2(i, w, W)] = x.votes[w];
  RS_OUT(int32_t, O_COMMIT_INDEX)[RS_AT1(i)] = x.commit;
  RS_OUT(uint32_t, O_COMMIT_CHK)[RS_AT1(i)] = x.chk_new;
  RS_OUT(int32_t, O_LOG_LEN)[RS_AT1(i)] = x.llen;
  if (g.comp) {
    RS_OUT(int32_t, O_LOG_BASE)[RS_AT1(i)] = x.base;
    RS_OUT(int32_t, O_BASE_TERM)[RS_AT1(i)] = x.bterm;
    RS_OUT(uint32_t, O_BASE_CHK)[RS_AT1(i)] = x.bchk;
  }
  if (g.hc_live) RS_OUT(int32_t, O_HEARD_CLOCK)[RS_AT1(i)] = x.heard;

  // ---- phase 9, this node's terms.
  X.at(XT::ROLE, i, ci) = x.role;
  X.at(XT::TERM, i, ci) = x.term;
  if (x.role == LEADER && x.alive) {
    acc_min(X.acc(A_LEADER, ci), i);
    acc_add(X.acc(A_N_LEADERS, ci), 1);
  }
  if (P.check_invariants && (x.commit < x.commit0 || x.commit > x.llen || x.commit < x.base ||
                             x.llen - x.base > cap))
    acc_max(X.acc(A_VIOL_COMMIT, ci), 1);
  acc_max(X.acc(A_MAX_TERM, ci), x.term);
  acc_max(X.acc(A_MAX_COMMIT, ci), x.commit);
  acc_min(X.acc(A_MIN_COMMIT, ci), x.commit);
}

// Ring-form log matching of node i against every partner j > i (the JAX
// `_step_info_b` ring form): for a comparable pair (min commit >= max base
// mb), slot s of both rings is compared where both slots' absolute 0-based
// indices lie in [mb, min commit), and each node's checksum at mb (its base
// checksum plus its entries below mb, at their absolute indices) must equal
// the other's. Partner j's final rows and header leaves are its outputs,
// written before the last barriers; node i's are its own.
template <int MW>
RS_HD void ring_pair_checks(const TickParams& P, void* const* ptr, const NodeCtx<MW>& x,
                            const Xch<MW>& X, int64_t b, int ci, int i) {
  const int64_t B = P.b;
  const int n = P.n, cap = P.cap;
  const int32_t* log_term = RS_OUT(int32_t, O_LOG_TERM);
  const int32_t* log_val = RS_OUT(int32_t, O_LOG_VAL);
  const int32_t* commit_out = RS_OUT(int32_t, O_COMMIT_INDEX);
  const int32_t* base_out = RS_OUT(int32_t, O_LOG_BASE);
  const uint32_t* bchk_out = RS_OUT(uint32_t, O_BASE_CHK);
  int skipped = 0;
  bool bad = false;
  for (int j = i + 1; j < n; ++j) {
    const int bj = base_out[RS_AT1(j)];
    const int minc = imin(x.commit, commit_out[RS_AT1(j)]), mb = imax(x.base, bj);
    if (minc < mb) {
      ++skipped;
      continue;
    }
    if (bad) continue;
    uint32_t chk_i = x.bchk, chk_j = bchk_out[RS_AT1(j)];
    for (int sl = 0; sl < cap; ++sl) {
      const int ai = x.base + pmod(sl - x.base, cap), aj = bj + pmod(sl - bj, cap);
      const int ti = log_term[RS_AT2(i, sl, cap)], vi = log_val[RS_AT2(i, sl, cap)];
      const int tj = log_term[RS_AT2(j, sl, cap)], vj = log_val[RS_AT2(j, sl, cap)];
      if (ai >= mb && ai < minc && aj >= mb && aj < minc && (ti != tj || vi != vj)) bad = true;
      if (ai < mb) chk_i += (uint32_t)ti * chk_w_term((uint32_t)ai) + (uint32_t)vi * chk_w_val((uint32_t)ai);
      if (aj < mb) chk_j += (uint32_t)tj * chk_w_term((uint32_t)aj) + (uint32_t)vj * chk_w_val((uint32_t)aj);
    }
    if (chk_i != chk_j) bad = true;
  }
  if (skipped) acc_add(X.acc(A_LM_SKIPPED, ci), skipped);
  if (bad) acc_max(X.acc(A_VIOL_MATCH, ci), 1);
}

// ---- phase 5: the pairwise checks. Two leaders of one term break election
// safety. Log matching, prefix layout: every pair agrees on its common
// committed prefix iff every node agrees with the max-commit node on its own
// committed prefix (equality is transitive), so each node checks itself
// against that node's final log rows (written by their own worker before the
// last barriers). On the ring (compaction) a pair is comparable only when
// min(commit) >= max(base), so transitivity breaks at an incomparable pair:
// each node checks every partner j > i from j's final rows, commit, base and
// base checksum (`ring_pair_checks`), and counts the incomparable pairs. --
template <class IdxT, class AckT, class NodeT, int MW, int FULL>
RS_HD void phase_pair_checks(RS_PHASE_ARGS) {
  using XT = XTail<MW>;
  const Gates g(P, FULL);
  const int64_t B = P.b;
  const int n = P.n, cap = P.cap;
  if (P.check_invariants && x.role == LEADER) {
    for (int j = i + 1; j < n; ++j)
      if (X.at(XT::ROLE, j, ci) == LEADER && X.at(XT::TERM, j, ci) == x.term) {
        acc_max(X.acc(A_VIOL_ELECTION, ci), 1);
        break;
      }
  }
  if (g.comp) {
    if (P.log_matching_due) ring_pair_checks<MW>(P, ptr, x, X, b, ci, i);
  } else if (P.log_matching_due && i != x.hnode) {
    const int32_t* log_term = RS_OUT(int32_t, O_LOG_TERM);
    const int32_t* log_val = RS_OUT(int32_t, O_LOG_VAL);
    const int h = x.hnode;
    const int hi = imin(x.commit, cap);
    for (int k = 0; k < hi; ++k) {
      if (log_term[RS_AT2(i, k, cap)] != log_term[RS_AT2(h, k, cap)] ||
          log_val[RS_AT2(i, k, cap)] != log_val[RS_AT2(h, k, cap)]) {
        acc_max(X.acc(A_VIOL_MATCH, ci), 1);
        break;
      }
    }
  }
}

// Phase 0, per cluster: the accumulators' identities.
template <int MW>
RS_HD void cluster_init(const Xch<MW>& X, int ci) {
  for (int f = 0; f < NACC; ++f) *X.acc(f, ci) = 0;
  *X.acc(A_LAG_MAX, ci) = I32_MIN;
  *X.acc(A_MAX_TERM, ci) = I32_MIN;
  *X.acc(A_MAX_COMMIT, ci) = I32_MIN;
  *X.acc(A_LEADER, ci) = I32_MAX;
  *X.acc(A_MIN_COMMIT, ci) = I32_MAX;
}

// Phase 6, per cluster: StepInfo out.
template <int MW, int FULL>
RS_HD void cluster_info(const TickParams& P, void* const* ptr, const Xch<MW>& X, int64_t b,
                        int ci) {
  const Gates g(P, FULL);
  const int64_t B = P.b;
  const int a_viol_commit = *X.acc(A_VIOL_COMMIT, ci) | (P.check_invariants && *X.acc(A_CHK_BAD, ci));
  const int leader = *X.acc(A_LEADER, ci);
  RS_OUT(uint8_t, F_VIOL_ELECTION_SAFETY)[b] = (uint8_t)(*X.acc(A_VIOL_ELECTION, ci) != 0);
  RS_OUT(uint8_t, F_VIOL_COMMIT)[b] = (uint8_t)(a_viol_commit != 0);
  RS_OUT(uint8_t, F_VIOL_LOG_MATCHING)[b] = (uint8_t)(*X.acc(A_VIOL_MATCH, ci) != 0);
  RS_OUT(int32_t, F_LEADER)[b] = leader == I32_MAX ? NIL : leader;
  RS_OUT(int32_t, F_N_LEADERS)[b] = *X.acc(A_N_LEADERS, ci);
  RS_OUT(int32_t, F_MAX_TERM)[b] = *X.acc(A_MAX_TERM, ci);
  RS_OUT(int32_t, F_MAX_COMMIT)[b] = *X.acc(A_MAX_COMMIT, ci);
  RS_OUT(int32_t, F_MIN_COMMIT)[b] = *X.acc(A_MIN_COMMIT, ci);
  RS_OUT(int32_t, F_MSGS_DELIVERED)[b] = *X.acc(A_MSGS, ci);
  RS_OUT(int32_t, F_CMDS_INJECTED)[b] = *X.acc(A_CMDS, ci);
  RS_OUT(int32_t, F_LAT_SUM)[b] = *X.acc(A_LAT_SUM, ci);
  RS_OUT(int32_t, F_LAT_CNT)[b] = *X.acc(A_LAT_CNT, ci);
  for (int k = 0; k < BINS; ++k) RS_OUT(int32_t, F_LAT_HIST)[RS_AT1(k)] = *X.acc(A_HIST + k, ci);
  RS_OUT(int32_t, F_LAT_EXCLUDED)[b] = imax(*X.acc(A_CROSSED, ci) - *X.acc(A_LAT_CNT, ci), 0);
  if (g.comp) {
    RS_OUT(int32_t, F_NOOP_BLOCKED)[b] = *X.acc(A_NOOP_BLOCKED, ci);
    // Live under compaction with log matching on (zero off its cadence).
    int32_t* skipped = RS_OUT(int32_t, F_LM_SKIPPED_PAIRS);
    if (skipped) skipped[b] = *X.acc(A_LM_SKIPPED, ci);
  }
  if (g.rdx) {
    RS_OUT(int32_t, F_READS_SERVED)[b] = *X.acc(A_READS, ci);
    RS_OUT(int32_t, F_READ_LAT_SUM)[b] = *X.acc(A_READ_LAT_SUM, ci);
    for (int k = 0; k < BINS; ++k)
      RS_OUT(int32_t, F_READ_HIST)[RS_AT1(k)] = *X.acc(A_READ_HIST + k, ci);
  }
  if (g.rdl) RS_OUT(uint8_t, F_VIOL_READ_STALE)[b] = (uint8_t)(*X.acc(A_VIOL_STALE, ci) != 0);
  if (g.dur) {
    RS_OUT(int32_t, F_FSYNC_LAG_SUM)[b] = *X.acc(A_LAG_SUM, ci);
    RS_OUT(int32_t, F_FSYNC_LAG_MAX)[b] = *X.acc(A_LAG_MAX, ci);
  }
}

// The node part of phase PH (a barrier ends each phase).
// NPT: the card's nodes a thread, 1 up to 32 nodes, else 2 (the host build
// mirrors it); 2 selects the wide forms (the quorum histograms).
template <class IdxT, class AckT, class NodeT, int MW, int FULL, int PH, int NPT>
RS_HD void node_phase(RS_PHASE_ARGS) {
  if (PH == 0) phase_headers<IdxT, AckT, NodeT, MW, FULL>(P, ptr, x, X, b, ci, i);
  if (PH == 1) phase_load_to_commit<IdxT, AckT, NodeT, MW, FULL, NPT>(P, ptr, x, X, b, ci, i);
  if (PH == 2) phase_serve_and_compact<IdxT, AckT, NodeT, MW, FULL>(P, ptr, x, X, b, ci, i);
  if (PH == 3) phase_append_and_timers<IdxT, AckT, NodeT, MW, FULL>(P, ptr, x, X, b, ci, i);
  if (PH == 4) phase_outbox_and_state<IdxT, AckT, NodeT, MW, FULL, NPT>(P, ptr, x, X, b, ci, i);
  if (PH == 5) phase_pair_checks<IdxT, AckT, NodeT, MW, FULL>(P, ptr, x, X, b, ci, i);
}

// The cluster part of phase PH. It reads exchange values of earlier phases
// only, so it may run before, after or beside the same phase's node parts.
template <int MW, int FULL, int PH>
RS_HD void cluster_phase(const TickParams& P, void* const* ptr, const Xch<MW>& X, int64_t b,
                         int ci) {
  if (PH == 0) cluster_init(X, ci);
  if (PH == 2) cluster_frontier(P, ptr, X, b, ci);
  if (PH == 4) cluster_redirect<MW, FULL>(P, ptr, X, b, ci);
  if (PH == 6) cluster_info<MW, FULL>(P, ptr, X, b, ci);
}

// The race proxy's poison, never on the main path (tick.cu built with
// RS_RACE_PROXY; the CPU build on request): at the start of phase PH, before
// its node part, each node overwrites the exchange fields of its own slot
// whose last reader ran in phase PH - 1. A read of one in a later phase sees
// the pattern instead of the value -- and on the card so does a read that a
// missing barrier lets run late. The schedule is the readers' (phase 1 reads
// the staged headers; phase 2 the commit and transfer eligibility; phase 3
// the read-capture and toggle flags; phase 4 the flags, request type, grant
// rows, leader id, node_ok and late vote; phase 5 the final role and term).
constexpr int32_t POISON = -1515870811;  // 0xA5A5A5A5

template <int MW, int PH>
RS_HD void poison_fields(const Xch<MW>& X, int ci, int i) {
  using XT = XTail<MW>;
  if (PH == 2)
    for (int f = X_HRTERM; f <= X_HXTGT; ++f) X.at(f, i, ci) = POISON;
  if (PH == 3) X.at(X_COMMIT, i, ci) = X.at(X_ELIGX, i, ci) = POISON;
  if (PH == 4) X.at(XT::CANCAP, i, ci) = X.at(XT::LDJ, i, ci) = POISON;
  if (PH == 5) {
    X.at(X_HFLAGS, i, ci) = X.at(X_HRTYPE, i, ci) = X.at(X_LID, i, ci) = POISON;
    for (int w = 0; w < MW; ++w) X.at(X_PVG + w, i, ci) = POISON;
    X.at(XT::NODEOK, i, ci) = X.at(XT::LATE, i, ci) = POISON;
  }
  if (PH == 6) X.at(XT::ROLE, i, ci) = X.at(XT::TERM, i, ci) = POISON;
}

#undef RS_PHASE_ARGS
#undef RS_XPEND
#undef RS_QUORUM
#undef RS_DENIED
#undef RS_UTD
#undef RS_DELIVERED
#undef RS_RTERM
#undef RS_RTYPE
#undef RS_UP
#undef RS_ALIVE
#undef RS_H
#undef RS_ROW
#undef RS_OUT
#undef RS_IN
#undef RS_AT2
#undef RS_AT1

// One launch's arguments, passed by value to the kernel.
struct TickArgs {
  TickParams p;
  void* ptr[N_PTR];
};

// Checks the shape limits of this body; 0 when it can run the tick.
inline int check_params(const TickParams& p) {
  if (p.n < 2 || p.n > MAXN) return 1;
  if (p.w != (p.n + 31) / 32 || p.w > MAXW) return 2;
  if (p.e < 1 || p.e > MAXE || p.cap < 1 || p.e > p.cap) return 3;
  if (p.quorum < 1 || p.b < 0) return 4;
  if (p.redirect && (p.k < 1 || p.k > MAXK)) return 5;
  return 0;
}

}  // namespace rs
