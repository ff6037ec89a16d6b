// One Raft tick for one cluster, as a scalar algorithm: the per-cluster body of
// the Hopper tick kernel (tick.cu) and of its CPU build (tick_host.cpp).
//
// Semantics are raft_sim_tpu/models/raft_batched.py `_step_b` + `_step_info_b`
// (dense layout, single device) over the gate set of presets config1-config5:
// invariants, log matching, the direct client's cadence with the offer-tick
// latency plane, drop, partitions and skew. Every leaf it writes equals the
// JAX tick's. The JAX form is a vectorised `where` lattice over [N, N, B]
// planes; here thread b walks its own cluster with loops over nodes and log
// entries, in the JAX phase order (-1 restart, 0 delivery, 1 term adoption,
// 2 RequestVote, 3 AppendEntries, 4 responses, 5 commit, latency, 6 client
// injection, 7 timers, 8 outbox, checksum, 9 StepInfo).
//
// Layout: every leaf is batch-minor. Leaf [d0, d1, ..., B] element
// (i, j, ..., b) sits at ((i * d1 + j) * ... ) * B + b, so neighbouring
// threads touch neighbouring addresses. The wrapper (kernels/tick_engine.py)
// passes one pointer per leaf in the order of the Ptr enum below; output
// leaves are fresh buffers, never aliases of inputs.
//
// Integer rules: uint32 legs (packed planes, checksums) use uint32_t, whose
// arithmetic wraps mod 2^32 like the JAX uint32 leaves; signed values never
// overflow on a well-formed state (the JAX dtype-tier bounds), and no signed
// division or modulo is taken.
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
constexpr int BINS = 16;  // latency histogram bins (types.LAT_HIST_BINS)

constexpr int FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
constexpr int NIL = -1;
constexpr int REQ_VOTE = 1, REQ_APPEND = 2;
constexpr int RESP_VOTE = 1, RESP_APPEND = 2;

// Leaf pointers, in the order tick_engine.PTR_ORDER lists them.
enum Ptr {
  // ClusterState, read
  S_ROLE, S_TERM, S_VOTED_FOR, S_LEADER_ID, S_VOTES, S_NEXT_INDEX,
  S_MATCH_INDEX, S_ACK_AGE, S_COMMIT_INDEX, S_COMMIT_CHK, S_LOG_BASE,
  S_BASE_CHK, S_LOG_TERM, S_LOG_VAL, S_LOG_TICK, S_LOG_LEN, S_CLOCK,
  S_DEADLINE, S_LAT_FRONTIER, S_NOW,
  // Mailbox, read
  M_REQ_TYPE, M_REQ_TERM, M_REQ_COMMIT, M_REQ_LAST_INDEX, M_REQ_LAST_TERM,
  M_ENT_START, M_ENT_PREV_TERM, M_ENT_COUNT, M_ENT_TERM, M_ENT_VAL,
  M_ENT_TICK, M_REQ_OFF, M_RESP_KIND, M_V_TO, M_A_OK_TO, M_A_MATCH,
  M_A_HINT, M_RESP_TERM,
  // StepInputs, read
  I_DELIVER_MASK, I_SKEW, I_TIMEOUT_DRAW, I_CLIENT_CMD, I_ALIVE, I_RESTARTED,
  // ClusterState, written
  O_ROLE, O_TERM, O_VOTED_FOR, O_LEADER_ID, O_VOTES, O_NEXT_INDEX,
  O_MATCH_INDEX, O_ACK_AGE, O_COMMIT_INDEX, O_COMMIT_CHK, O_LOG_TERM,
  O_LOG_VAL, O_LOG_TICK, O_LOG_LEN, O_CLOCK, O_DEADLINE, O_LAT_FRONTIER,
  O_NOW,
  // Mailbox, written
  OM_REQ_TYPE, OM_REQ_TERM, OM_REQ_COMMIT, OM_REQ_LAST_INDEX,
  OM_REQ_LAST_TERM, OM_ENT_START, OM_ENT_PREV_TERM, OM_ENT_COUNT,
  OM_ENT_TERM, OM_ENT_VAL, OM_ENT_TICK, OM_REQ_OFF, OM_RESP_KIND, OM_V_TO,
  OM_A_OK_TO, OM_A_MATCH, OM_A_HINT, OM_RESP_TERM,
  // StepInfo, written
  F_VIOL_ELECTION_SAFETY, F_VIOL_COMMIT, F_VIOL_LOG_MATCHING, F_LEADER,
  F_N_LEADERS, F_MAX_TERM, F_MAX_COMMIT, F_MIN_COMMIT, F_MSGS_DELIVERED,
  F_CMDS_INJECTED, F_LAT_SUM, F_LAT_CNT, F_LAT_HIST, F_LAT_EXCLUDED,
  N_PTR
};

struct TickParams {
  int64_t b;             // clusters: the batch-minor stride
  int32_t n, e, cap, w;  // nodes, window entries, log capacity, words per row
  int32_t quorum, heartbeat, ack_sat, ack_timeout;
  int32_t check_invariants;  // cfg.check_invariants
  int32_t log_matching_due;  // the host-side cadence decision for this tick
  int32_t track;             // cfg.track_offer_ticks (offer-tick plane live)
};

RS_HD int imin(int a, int b) { return a < b ? a : b; }
RS_HD int imax(int a, int b) { return a > b ? a : b; }
RS_HD int iclamp(int x, int lo, int hi) { return imin(imax(x, lo), hi); }

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

template <class IdxT, class AckT, class NodeT>
RS_HD void tick_cluster(const TickParams& P, void* const* ptr, int64_t b) {
  const int n = P.n, e = P.e, cap = P.cap, W = P.w;
  const int64_t B = P.b;
  // Batch-minor offsets: [N, B] and [N, inner, B].
#define RS_AT1(i) ((int64_t)(i) * B + b)
#define RS_AT2(i, j, inner) (((int64_t)(i) * (inner) + (j)) * B + b)
#define RS_IN(T, P_) ((const T*)ptr[P_])
#define RS_OUT(T, P_) ((T*)ptr[P_])

  const int32_t now = RS_IN(int32_t, S_NOW)[b];
  const int32_t lat_frontier0 = RS_IN(int32_t, S_LAT_FRONTIER)[b];
  const int32_t client_cmd = RS_IN(int32_t, I_CLIENT_CMD)[b];
  const int32_t* log_term_in = RS_IN(int32_t, S_LOG_TERM);
  const int32_t* log_val_in = RS_IN(int32_t, S_LOG_VAL);
  const int32_t* log_tick_in = RS_IN(int32_t, S_LOG_TICK);
  int32_t* log_term = RS_OUT(int32_t, O_LOG_TERM);
  int32_t* log_val = RS_OUT(int32_t, O_LOG_VAL);
  int32_t* log_tick = RS_OUT(int32_t, O_LOG_TICK);
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
  int len0[MAXN], llen[MAXN], base[MAXN], commit0[MAXN], commit[MAXN];
  int clock0[MAXN], deadline0[MAXN], tdraw[MAXN], my_last_term[MAXN];
  uint32_t votes[MAXN][MAXW], mask[MAXN][MAXW], chk0[MAXN];
  // Mailbox headers, per sender / responder.
  int rtype[MAXN], rterm[MAXN], rli[MAXN], rlt[MAXN];
  int resp_term[MAXN], v_to[MAXN], a_ok_to[MAXN], a_match[MAXN], a_hint[MAXN];
  // Per-node facts carried between phases.
  bool saw_higher[MAXN], granted_any[MAXN], has_ae[MAXN], win[MAXN];
  bool is_leader[MAXN], heartbeat[MAXN], start_el[MAXN];
  int grant_to[MAXN];
  int len4[MAXN];  // log length after phase 3: the phase-4/phase-8 `len_i`

  for (int i = 0; i < n; ++i) {
    alive[i] = RS_IN(uint8_t, I_ALIVE)[RS_AT1(i)] != 0;
    rs_[i] = RS_IN(uint8_t, I_RESTARTED)[RS_AT1(i)] != 0;
    up[i] = alive[i] && !rs_[i];
    tdraw[i] = RS_IN(int32_t, I_TIMEOUT_DRAW)[RS_AT1(i)];
    clock0[i] = RS_IN(int32_t, S_CLOCK)[RS_AT1(i)];
    base[i] = RS_IN(int32_t, S_LOG_BASE)[RS_AT1(i)];
    role[i] = rs_[i] ? FOLLOWER : RS_IN(int32_t, S_ROLE)[RS_AT1(i)];
    lid[i] = rs_[i] ? NIL : RS_IN(int32_t, S_LEADER_ID)[RS_AT1(i)];
    term[i] = RS_IN(int32_t, S_TERM)[RS_AT1(i)];
    vf[i] = RS_IN(int32_t, S_VOTED_FOR)[RS_AT1(i)];
    len0[i] = RS_IN(int32_t, S_LOG_LEN)[RS_AT1(i)];
    commit0[i] = rs_[i] ? base[i] : RS_IN(int32_t, S_COMMIT_INDEX)[RS_AT1(i)];
    chk0[i] = rs_[i] ? RS_IN(uint32_t, S_BASE_CHK)[RS_AT1(i)]
                     : RS_IN(uint32_t, S_COMMIT_CHK)[RS_AT1(i)];
    deadline0[i] = rs_[i] ? clock0[i] + tdraw[i] : RS_IN(int32_t, S_DEADLINE)[RS_AT1(i)];
    for (int w = 0; w < W; ++w) {
      votes[i][w] = rs_[i] ? 0u : RS_IN(uint32_t, S_VOTES)[RS_AT2(i, w, W)];
      mask[i][w] = RS_IN(uint32_t, I_DELIVER_MASK)[RS_AT2(i, w, W)];
    }
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
    }
  }

  // ---- phase 0: delivery. The message on physical edge [dst d, src s] is
  // delivered iff d is up now and was at send time, s is alive, s != d, and
  // bit s of d's mask row is set. Requests ride [sender, receiver] edges,
  // responses [receiver, responder] -- the same physical edge test.
#define RS_DELIVERED(d, s) \
  (up[d] && (s) != (d) && alive[s] && ((mask[d][(s) >> 5] >> ((s) & 31)) & 1u))

  // ---- phase 1: term adoption --------------------------------------------
  int msgs = 0;
  for (int d = 0; d < n; ++d) {
    int in_term = 0;
    for (int s = 0; s < n; ++s) {
      if (!RS_DELIVERED(d, s)) continue;
      if (rtype[s] != 0) {
        ++msgs;
        in_term = imax(in_term, rterm[s]);
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
    const int l = len0[d];
    my_last_term[d] = (l >= 1 && l <= cap) ? log_term_in[RS_AT2(d, l - 1, cap)] : 0;
  }

  // ---- phase 2: RequestVote requests --------------------------------------
  for (int v = 0; v < n; ++v) {
    int lowest = n;
    bool grant_prev = false;  // the candidate v already voted for is grantable
    for (int c = 0; c < n; ++c) {
      if (!RS_DELIVERED(v, c) || rtype[c] != REQ_VOTE || rterm[c] != term[v]) continue;
      const bool utd = rlt[c] > my_last_term[v] ||
                       (rlt[c] == my_last_term[v] && rli[c] >= len0[v]);
      if (!utd) continue;
      if (c < lowest) lowest = c;
      if (c == vf[v]) grant_prev = true;
    }
    granted_any[v] = (vf[v] != NIL) ? grant_prev : (lowest < n);
    if (vf[v] == NIL && granted_any[v]) vf[v] = lowest;
    grant_to[v] = granted_any[v] ? vf[v] : NIL;
  }

  // ---- phase 3: AppendEntries requests -------------------------------------
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
    int w_term[MAXE], w_val[MAXE], w_tick[MAXE];
    for (int k = 0; k < e; ++k) w_term[k] = w_val[k] = w_tick[k] = 0;
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
      }
    }
    const int j = iclamp(j_in, 0, e);
    const int prev_i = has_ae[f] ? ws_in + j : 0;
    const int n_ent = has_ae[f] ? iclamp(ecount - j, 0, e) : 0;
    const int prev_t = (j == 0) ? eprev : w_term[j - 1];
    const int off = iclamp(j, 0, e - 1);  // this receiver's entries start at slot j
    if (has_ae[f]) {
      if (role[f] == CANDIDATE) role[f] = FOLLOWER;
      lid[f] = src;
    }
    const int stored_prev =
        (prev_i >= 1 && prev_i <= cap) ? log_term_in[RS_AT2(f, prev_i - 1, cap)] : 0;
    const bool ae_ok = has_ae[f] && (prev_i == 0 || (prev_i <= len0[f] && stored_prev == prev_t));
    bool mismatch = false;
    for (int k = 0; k < n_ent; ++k) {
      if (prev_i + k < len0[f]) {
        const int stored = log_term_in[RS_AT2(f, iclamp(prev_i + k, 0, cap - 1), cap)];
        if (stored != w_term[imin(off + k, e - 1)]) mismatch = true;
      }
    }
    const int appended = imin(prev_i + n_ent, cap);
    llen[f] = ae_ok ? (mismatch ? appended : imax(len0[f], appended)) : len0[f];
    len4[f] = llen[f];
    if (ae_ok) {
      for (int k = 0; k < n_ent; ++k) {
        const int slot = prev_i + k;
        if (slot < 0 || slot >= cap) continue;
        const int wk = imin(off + k, e - 1);
        log_term[RS_AT2(f, slot, cap)] = w_term[wk];
        log_val[RS_AT2(f, slot, cap)] = w_val[wk];
        if (P.track) log_tick[RS_AT2(f, slot, cap)] = w_tick[wk];
      }
    }
    const int last_new = imax(imin(prev_i + n_ent, llen[f]), 0);
    commit[f] = ae_ok ? imax(commit0[f], imin(lcommit, last_new)) : commit0[f];
    RS_OUT(NodeT, OM_A_OK_TO)[RS_AT1(f)] = (NodeT)(ae_ok ? src : NIL);
    RS_OUT(IdxT, OM_A_MATCH)[RS_AT1(f)] = (IdxT)(ae_ok ? last_new : 0);
    RS_OUT(IdxT, OM_A_HINT)[RS_AT1(f)] = (IdxT)llen[f];
  }

  // ---- phases 4 + 5, per node: responses, then leader commit ---------------
  for (int q = 0; q < n; ++q) {
    if (role[q] == CANDIDATE) {
      for (int r = 0; r < n; ++r) {
        if (RS_DELIVERED(q, r) && resp_kind_in[RS_AT2(q, r, n)] == RESP_VOTE &&
            v_to[r] == q && resp_term[r] == term[q])
          votes[q][r >> 5] |= 1u << (r & 31);
      }
    }
    int nvotes = 0;
    for (int w = 0; w < W; ++w) nvotes += popcount32(votes[q][w]);
    win[q] = role[q] == CANDIDATE && nvotes >= P.quorum && alive[q];
    if (win[q]) {
      role[q] = LEADER;
      lid[q] = q;
    }
    const int len_i = len4[q];
    int mws[MAXN];              // match_with_self row
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
        if (a_ok_to[r] == q) {
          mt = imax(mt, a_match[r]);
          nx = imax(nx, a_match[r] + 1);
        } else {
          nx = imax(imin(nx - 1, a_hint[r] + 1), 1);
        }
      }
      ag = imin(ag + 1, P.ack_sat);
      if (win[q] || aresp) ag = 0;
      next_out[RS_AT2(q, r, n)] = (IdxT)nx;
      match_out[RS_AT2(q, r, n)] = (IdxT)mt;
      ack_out[RS_AT2(q, r, n)] = (AckT)ag;
      mws[r] = (r == q) ? len_i : mt;
    }
    is_leader[q] = role[q] == LEADER;
    if (is_leader[q] && alive[q]) {
      // The quorum-th largest match: the largest value reached by at least
      // `quorum` entries of the row (an exact order statistic).
      int qm = 0;
      for (int c = 0; c < n; ++c) {
        int cnt = 0;
        for (int k = 0; k < n; ++k) cnt += mws[k] >= mws[c];
        if (cnt >= P.quorum && mws[c] > qm) qm = mws[c];
      }
      const int qt = (qm >= 1 && qm <= cap) ? log_term[RS_AT2(q, qm - 1, cap)] : 0;
      if (qm > commit[q] && qt == term[q]) commit[q] = qm;
    }
  }

  // ---- offer->commit latency (offer-tick plane) ----------------------------
  int maxc = 0, hnode = -1;  // the lowest-id max-commit node
  for (int i = 0; i < n; ++i) {
    if (hnode < 0 || commit[i] > maxc) {
      maxc = commit[i];
      hnode = i;
    }
  }
  uint32_t lat_sum = 0;
  int lat_cnt = 0, crossed = 0;
  int hist[BINS];
  for (int k = 0; k < BINS; ++k) hist[k] = 0;
  if (P.track) {
    for (int i = 0; i < n; ++i) {
      const bool lead_ok = is_leader[i] && alive[i];
      // Entries newly past the carried frontier: 1-based (frontier, commit].
      const int hi = imin(commit[i], cap);
      for (int k = imax(lat_frontier0, 0); k < hi; ++k) {
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

  // ---- phase 6: client command injection -----------------------------------
  bool any_client = false;
  for (int i = 0; i < n; ++i) {
    const bool ok = client_cmd != NIL && is_leader[i] && alive[i] && llen[i] - base[i] < cap;
    if (!ok) continue;
    any_client = true;
    const int pos = llen[i];
    if (pos >= 0 && pos < cap) {
      log_term[RS_AT2(i, pos, cap)] = term[i];
      log_val[RS_AT2(i, pos, cap)] = client_cmd;
      if (P.track) log_tick[RS_AT2(i, pos, cap)] = now + 1;
    }
    llen[i] += 1;
  }

  // ---- phase 7: timers -----------------------------------------------------
  for (int i = 0; i < n; ++i) {
    const int clock = clock0[i] + RS_IN(int32_t, I_SKEW)[RS_AT1(i)];
    int dl = (granted_any[i] || has_ae[i] || saw_higher[i]) ? clock + tdraw[i] : deadline0[i];
    if (win[i]) dl = clock + P.heartbeat;
    const bool expired = clock >= dl && alive[i];
    heartbeat[i] = expired && is_leader[i];
    if (heartbeat[i]) dl = clock + P.heartbeat;
    start_el[i] = expired && !is_leader[i];
    if (start_el[i]) {
      term[i] += 1;
      role[i] = CANDIDATE;
      vf[i] = i;
      lid[i] = NIL;
      for (int w = 0; w < W; ++w) votes[i][w] = (w == (i >> 5)) ? (1u << (i & 31)) : 0u;
      dl = clock + tdraw[i];
    }
    RS_OUT(int32_t, O_CLOCK)[RS_AT1(i)] = clock;
    RS_OUT(int32_t, O_DEADLINE)[RS_AT1(i)] = dl;
  }

  // ---- phase 8: outbox -----------------------------------------------------
  const int K = cap + 1;
  for (int i = 0; i < n; ++i) {
    const bool send = win[i] || heartbeat[i];
    const int len_i = len4[i];
    // Shared window start: minimum prev over responsive peers, else over all
    // peers (responsive peers ride +0, unresponsive +K, self +2K).
    int m = 0x7FFFFFFF;
    for (int j = 0; j < n; ++j) {
      const int prev = imin(imax((int)next_out[RS_AT2(i, j, n)] - 1, 0), len_i);
      const int enc = prev + (j == i ? 2 * K
                              : ((int)ack_out[RS_AT2(i, j, n)] <= P.ack_timeout ? 0 : K));
      m = imin(m, enc);
    }
    int ws = imax(m >= K ? m - K : m, 0);
    ws = imin(ws, len_i);
    for (int j = 0; j < n; ++j) {
      const int prev = imin(imax((int)next_out[RS_AT2(i, j, n)] - 1, 0), len_i);
      RS_OUT(int8_t, OM_REQ_OFF)[RS_AT2(i, j, n)] =
          (int8_t)((send && j != i) ? iclamp(prev - ws, 0, e) : 0);
    }
    const int n_ship = iclamp(llen[i] - ws, 0, e);
    for (int k = 0; k < e; ++k) {
      const bool used = send && k < n_ship;
      const int slot = iclamp(ws + k, 0, cap - 1);
      RS_OUT(int32_t, OM_ENT_TERM)[RS_AT2(i, k, e)] = used ? log_term[RS_AT2(i, slot, cap)] : 0;
      RS_OUT(int32_t, OM_ENT_VAL)[RS_AT2(i, k, e)] = used ? log_val[RS_AT2(i, slot, cap)] : 0;
      if (P.track)
        RS_OUT(int32_t, OM_ENT_TICK)[RS_AT2(i, k, e)] = used ? log_tick[RS_AT2(i, slot, cap)] : 0;
    }
    const int req_type = start_el[i] ? REQ_VOTE : (send ? REQ_APPEND : 0);
    const int l = llen[i];
    const int last_term = (l >= 1 && l <= cap) ? log_term[RS_AT2(i, l - 1, cap)] : 0;
    const int pterm = (ws >= 1 && ws <= cap) ? log_term[RS_AT2(i, ws - 1, cap)] : 0;
    RS_OUT(int32_t, OM_REQ_TYPE)[RS_AT1(i)] = req_type;
    RS_OUT(int32_t, OM_REQ_TERM)[RS_AT1(i)] = req_type != 0 ? term[i] : 0;
    RS_OUT(int32_t, OM_REQ_COMMIT)[RS_AT1(i)] = send ? commit[i] : 0;
    RS_OUT(int32_t, OM_REQ_LAST_INDEX)[RS_AT1(i)] = start_el[i] ? l : 0;
    RS_OUT(int32_t, OM_REQ_LAST_TERM)[RS_AT1(i)] = start_el[i] ? last_term : 0;
    RS_OUT(int32_t, OM_ENT_START)[RS_AT1(i)] = send ? ws : 0;
    RS_OUT(int32_t, OM_ENT_PREV_TERM)[RS_AT1(i)] = send ? pterm : 0;
    RS_OUT(int32_t, OM_ENT_COUNT)[RS_AT1(i)] = send ? n_ship : 0;
    RS_OUT(NodeT, OM_V_TO)[RS_AT1(i)] = (NodeT)grant_to[i];
    RS_OUT(int32_t, OM_RESP_TERM)[RS_AT1(i)] = term[i];
    // Responses on edge [requester i, responder v]: the type of the request
    // v received from i this tick.
    for (int v = 0; v < n; ++v) {
      int kind = 0;
      if (RS_DELIVERED(v, i)) kind = rtype[i] == REQ_VOTE ? RESP_VOTE : (rtype[i] == REQ_APPEND ? RESP_APPEND : 0);
      RS_OUT(int8_t, OM_RESP_KIND)[RS_AT2(i, v, n)] = (int8_t)kind;
    }
  }

  // ---- committed-prefix checksum + end-of-tick state ------------------------
  bool chk_bad = false;
  for (int i = 0; i < n; ++i) {
    uint32_t chk_new = chk0[i];
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
      chk_new = s_new;
    }
    RS_OUT(int32_t, O_ROLE)[RS_AT1(i)] = role[i];
    RS_OUT(int32_t, O_TERM)[RS_AT1(i)] = term[i];
    RS_OUT(int32_t, O_VOTED_FOR)[RS_AT1(i)] = vf[i];
    RS_OUT(int32_t, O_LEADER_ID)[RS_AT1(i)] = lid[i];
    for (int w = 0; w < W; ++w) RS_OUT(uint32_t, O_VOTES)[RS_AT2(i, w, W)] = votes[i][w];
    RS_OUT(int32_t, O_COMMIT_INDEX)[RS_AT1(i)] = commit[i];
    RS_OUT(uint32_t, O_COMMIT_CHK)[RS_AT1(i)] = chk_new;
    RS_OUT(int32_t, O_LOG_LEN)[RS_AT1(i)] = llen[i];
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
  RS_OUT(int32_t, F_CMDS_INJECTED)[b] = any_client ? 1 : 0;
  RS_OUT(int32_t, F_LAT_SUM)[b] = (int32_t)lat_sum;
  RS_OUT(int32_t, F_LAT_CNT)[b] = lat_cnt;
  for (int k = 0; k < BINS; ++k) RS_OUT(int32_t, F_LAT_HIST)[(int64_t)k * B + b] = hist[k];
  RS_OUT(int32_t, F_LAT_EXCLUDED)[b] = imax(crossed - lat_cnt, 0);

#undef RS_DELIVERED
#undef RS_AT1
#undef RS_AT2
#undef RS_IN
#undef RS_OUT
}

// Calls CALL(IdxT, AckT, NodeT) for the dtype tiers given as byte widths
// (1 = int8, 2 = int16); evaluates FAIL for any other combination.
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
    else { FAIL; }                                                  \
  } while (0)

// Checks the shape limits of this body; 0 when it can run the tick.
inline int check_params(const TickParams& p) {
  if (p.n < 2 || p.n > MAXN) return 1;
  if (p.w != (p.n + 31) / 32 || p.w > MAXW) return 2;
  if (p.e < 1 || p.e > MAXE || p.cap < 1) return 3;
  if (p.quorum < 1 || p.b < 0) return 4;
  return 0;
}

}  // namespace rs
