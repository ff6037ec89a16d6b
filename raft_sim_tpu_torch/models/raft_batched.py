"""Batch-minor Raft tick, plain PyTorch: the port of
raft_sim_tpu/models/raft_batched.py `_step_b` + `_step_info_b` (dense layout,
single device).

This is the plain version of the Hopper tick kernel (kernels/tick_engine.py,
csrc/tick.cuh): CPU tests hold it against the JAX `step_b`, and the card holds
the kernel against it. It restates the JAX tick phase by phase over batch-minor
tensors (`[N, B]`, `[N, N, B]`, `[N, CAP, B]`, ...), with gathers where the JAX
form does one-hot reductions and a sort for the quorum order statistic; the
values are the JAX package's. Read the JAX module for the protocol reasoning
behind each phase -- the comments here only mark the phases.

Gate set: invariants, log matching at `log_matching_interval`, the client's
cadence (direct, or the redirect client with its K-deep pipeline) with the
offer-tick latency plane, drop, partitions, skew, crash/restart (phase -1
runs unconditionally, as in JAX), ring-log compaction with the snapshot
catch-up (`compact_margin > 0`) and PreVote. Every other structural gate
raises NotImplementedError naming the gate (`unsupported_gates`), and so does
log matching under compaction (the JAX ring form with `lm_skipped_pairs` is
not ported). Gated-off legs pass through untouched; gated-off StepInfo leaves
are zeros with the JAX dtype and shape.
"""

from __future__ import annotations

import torch

from raft_sim_tpu_torch.ops import bitplane, log_ops
from raft_sim_tpu_torch.types import (
    CANDIDATE,
    FOLLOWER,
    LAT_HIST_BINS,
    LEADER,
    NIL,
    NOOP,
    PRECANDIDATE,
    REQ_APPEND,
    REQ_PREVOTE,
    REQ_VOTE,
    RESP_APPEND,
    RESP_PREVOTE,
    RESP_VOTE,
    ClusterState,
    StepInfo,
    StepInputs,
    node_dtype,
)
from raft_sim_tpu_torch.utils.config import RaftConfig

I32 = torch.int32
BIG = 2**31 - 1


def unsupported_gates(cfg: RaftConfig) -> list[str]:
    """Structural gates of `cfg` the port's tick does not take yet."""
    checks = [
        ("reconfig", cfg.reconfig),
        ("transfer", cfg.leader_transfer),
        ("reads", cfg.read_index),
        ("lease", cfg.read_lease),
        ("durable_storage", cfg.durable_storage),
        ("compact_planes", cfg.compact_planes),
        ("track_trace", cfg.track_trace),
        ("serve_ingest", cfg.serve_ingest),
        ("log matching under compaction", cfg.compaction and cfg.check_log_matching),
    ]
    return [name for name, on in checks if on]


def check_gates(cfg: RaftConfig, who: str) -> None:
    gates = unsupported_gates(cfg)
    if gates:
        raise NotImplementedError(f"{who} does not support {', '.join(gates)} yet")


def to_batch_minor(tree):
    """[B, ...]-leading NamedTuple (nested) -> [..., B]-trailing, contiguous."""
    return _map(lambda x: x.movedim(0, -1).contiguous(), tree)


def from_batch_minor(tree):
    return _map(lambda x: x.movedim(-1, 0).contiguous(), tree)


def _map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    return fn(tree)


def log_matching_due(cfg: RaftConfig, s: ClusterState, now: int | None) -> bool:
    """Whether this tick runs the log-matching check: the JAX lax.cond on the
    batch's (lockstep) post-tick `now`, as a host-side branch. `now` is the
    host's copy of the pre-tick counter; without it one value is read back."""
    if not cfg.check_log_matching:
        return False
    if cfg.log_matching_interval == 1:
        return True
    if now is None:
        now = int(s.now.reshape(-1)[0])
    return (now + 1) % cfg.log_matching_interval == 0


def step_b(
    cfg: RaftConfig, s: ClusterState, inp: StepInputs, now: int | None = None
) -> tuple[ClusterState, StepInfo]:
    """One tick for B clusters at once; every tensor carries a trailing batch
    axis. `now` is the host's copy of `s.now` (all clusters in lockstep)."""
    check_gates(cfg, "step_b")
    n, e, cap = cfg.n_nodes, cfg.max_entries_per_rpc, cfg.log_capacity
    track = cfg.track_offer_ticks
    comp = cfg.compaction
    pv = cfg.pre_vote
    dev = s.role.device
    b = s.role.shape[-1]
    idt = s.next_index.dtype
    adt = s.ack_age.dtype
    ndt = node_dtype(cfg)
    ids = torch.arange(n, dtype=I32, device=dev)
    ids2 = ids[:, None]  # [N, 1]
    snd_ids = ids[:, None, None]  # [sender, 1, 1]
    eye3 = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]  # [N, N, 1]
    eye_p3 = bitplane.eye(n, dev)[:, :, None]  # [N, W, 1]
    alive = inp.alive

    # ---- phase -1: restart ----------------------------------------------------
    rs = inp.restarted
    rs2 = rs[:, None, :]
    s = s._replace(
        role=torch.where(rs, FOLLOWER, s.role),
        leader_id=torch.where(rs, NIL, s.leader_id),
        votes=torch.where(rs2, 0, s.votes),
        next_index=torch.where(rs2, 1, s.next_index),
        match_index=torch.where(rs2, 0, s.match_index),
        ack_age=torch.where(rs2, cfg.ack_age_sat, s.ack_age),
        commit_index=torch.where(rs, s.log_base, s.commit_index),
        commit_chk=torch.where(rs, s.base_chk, s.commit_chk),
        deadline=torch.where(rs, s.clock + inp.timeout_draw, s.deadline),
    )
    if pv:  # a restarted node remembers no leader contact
        s = s._replace(
            heard_clock=torch.where(rs, s.clock - cfg.election_min_ticks, s.heard_clock)
        )
    mb = s.mailbox
    base, bterm, bchk = s.log_base, s.base_term, s.base_chk

    def term_at(log_term, index1):  # reads base/bterm as they stand at the call
        if comp:
            return log_ops.term_at_rb(log_term, base, bterm, index1)
        return log_ops.term_at_b(log_term, index1)

    # ---- phase 0: delivery ----------------------------------------------------
    dst_up = alive & ~rs
    dmask = bitplane.unpack(inp.deliver_mask, n, axis=1)  # [dst, src, B]
    deliver = dmask & ~eye3 & alive[None, :, :] & dst_up[:, None, :]  # [dst, src, B]
    req_in = deliver.transpose(0, 1) & (mb.req_type != 0)[:, None, :]  # [snd, rcv, B]
    resp_in = deliver & (mb.resp_kind != 0)  # [rcv, responder, B]

    # ---- phase 1: term adoption (PreVote probes carry a prospective term) -----
    term_req = req_in & (mb.req_type != REQ_PREVOTE)[:, None, :] if pv else req_in
    in_term = torch.maximum(
        torch.where(term_req, mb.req_term[:, None, :], 0).amax(0),
        torch.where(resp_in, mb.resp_term[None, :, :], 0).amax(1),
    )
    saw_higher = in_term > s.term
    term = torch.maximum(s.term, in_term)
    role = torch.where(saw_higher, FOLLOWER, s.role)
    voted_for = torch.where(saw_higher, NIL, s.voted_for)
    leader_id = torch.where(saw_higher, NIL, s.leader_id)
    votes = torch.where(saw_higher[:, None, :], 0, s.votes)
    my_last_idx, my_last_term = s.log_len, term_at(s.log_term, s.log_len)

    # ---- phase 2: RequestVote requests ----------------------------------------
    is_rv = req_in & (mb.req_type == REQ_VOTE)[:, None, :]  # [cand, voter, B]
    cur_rv = is_rv & (mb.req_term[:, None, :] == term[None, :, :])
    up_to_date = (mb.req_last_term[:, None, :] > my_last_term[None, :, :]) | (
        (mb.req_last_term[:, None, :] == my_last_term[None, :, :])
        & (mb.req_last_index[:, None, :] >= my_last_idx[None, :, :])
    )
    can_grant = cur_rv & up_to_date
    lowest = torch.where(can_grant, snd_ids, n).amin(0)  # [N, B]
    has_vote = (voted_for != NIL)[None, :, :]
    grant = (has_vote & can_grant & (snd_ids == voted_for[None, :, :])) | (
        ~has_vote & can_grant & (snd_ids == lowest[None, :, :])
    )
    granted_any = grant.any(0)
    voted_for = torch.where((voted_for == NIL) & granted_any, lowest, voted_for)
    grant_to = torch.where(granted_any, voted_for, NIL).to(ndt)

    # ---- phase 3: AppendEntries requests --------------------------------------
    is_ae = req_in & (mb.req_type == REQ_APPEND)[:, None, :]  # [leader, follower, B]
    cur_ae = is_ae & (mb.req_term[:, None, :] == term[None, :, :])
    ae_src = torch.where(cur_ae, snd_ids, n).amin(0)  # [N, B]
    has_ae = ae_src < n
    src = ae_src.clamp(max=n - 1).to(torch.int64)  # [rcv, B] selected sender

    def pick_h(h):  # [N(sender), B] header of each receiver's selected sender
        return torch.where(has_ae, torch.gather(h, 0, src), 0)

    def pick_w(w):  # [N(sender), E, B] window of each receiver's selected sender
        got = torch.gather(w, 0, src[:, None, :].expand(n, e, b))
        return torch.where(has_ae[:, None, :], got, 0)

    j_in = torch.where(
        has_ae, torch.gather(mb.req_off, 0, src[None]).squeeze(0).to(I32), 0
    )
    snap = has_ae & (j_in < 0) if comp else torch.zeros_like(has_ae)  # InstallSnapshot
    ae_norm = has_ae & ~snap
    j_nn = j_in.clamp(0, e)
    ws_in = pick_h(mb.ent_start)
    lcommit = pick_h(mb.req_commit)
    prev_i = torch.where(ae_norm, ws_in + j_nn, 0)
    n_ent = torch.where(ae_norm, (pick_h(mb.ent_count) - j_nn).clamp(0, e), 0)
    w_term_in = pick_w(mb.ent_term)
    ext = torch.cat([pick_h(mb.ent_prev_term)[:, None, :], w_term_in], dim=1)
    prev_t = torch.gather(ext, 1, j_nn.to(torch.int64)[:, None, :]).squeeze(1)
    off = j_nn.clamp(0, e - 1)
    ent_term_in = log_ops.window_b(w_term_in, off, e)
    ent_val_in = log_ops.window_b(pick_w(mb.ent_val), off, e)
    stepdown = (role == CANDIDATE) | (role == PRECANDIDATE) if pv else role == CANDIDATE
    role = torch.where(has_ae & stepdown, FOLLOWER, role)
    leader_id = torch.where(has_ae, ae_src, leader_id)
    prev_stored_term = term_at(s.log_term, prev_i)
    consistent = (prev_i == 0) | ((prev_i <= s.log_len) & (prev_stored_term == prev_t))
    if comp:  # below the base: committed and compacted, consistent
        consistent = consistent | (prev_i < base)
    ae_ok = ae_norm & consistent
    ks_e = torch.arange(e, dtype=I32, device=dev)[None, :, None]
    if comp:
        lo = (base - prev_i).clamp(0, e)
        n_acc = torch.minimum(n_ent, (base + cap - prev_i).clamp(min=0))
        in_ent = (ks_e >= lo[:, None, :]) & (ks_e < n_acc[:, None, :])
        stored = log_ops.window_rb(s.log_term, prev_i, e)
        appended_len = prev_i + n_acc
    else:
        n_acc = n_ent
        in_ent = ks_e < n_ent[:, None, :]
        stored = log_ops.window_b(s.log_term, prev_i, e)
        appended_len = (prev_i + n_ent).clamp(max=cap)
    exists = prev_i[:, None, :] + ks_e < s.log_len[:, None, :]
    any_mismatch = (in_ent & exists & (stored != ent_term_in)).any(1)
    new_len = torch.where(
        any_mismatch, appended_len, torch.maximum(s.log_len, appended_len)
    )
    log_len = torch.where(ae_ok, new_len, s.log_len)

    def write(arr, vals):
        if comp:
            return log_ops.write_window_rb(arr, prev_i, vals, ae_ok, lo, n_acc)
        return log_ops.write_window_b(arr, prev_i, vals, ae_ok, n_ent)

    log_term_arr = write(s.log_term, ent_term_in)
    log_val_arr = write(s.log_val, ent_val_in)
    if track:
        log_tick_arr = write(s.log_tick, log_ops.window_b(pick_w(mb.ent_tick), off, e))
    else:
        log_tick_arr = s.log_tick
    last_new = torch.minimum(prev_i + n_acc, log_len).clamp(min=0)
    commit = torch.where(
        ae_ok,
        torch.maximum(s.commit_index, torch.minimum(lcommit, last_new)),
        s.commit_index,
    )
    if comp:
        # Snapshot install: adopt the sender's base, keeping our suffix when it
        # extends through L with L's term, else wiping the log to L.
        L = torch.where(snap, pick_h(mb.req_base), 0)
        Lt = pick_h(mb.req_base_term)
        Lchk = pick_h(mb.req_base_chk)
        apply_snap = snap & (L > base)
        keep = apply_snap & (L <= s.log_len) & (term_at(s.log_term, L) == Lt)
        wipe = apply_snap & ~keep
        bterm = torch.where(apply_snap, Lt, bterm)
        bchk = torch.where(apply_snap, Lchk, bchk)
        base = torch.where(apply_snap, L, base)
        log_len = torch.where(wipe, L, log_len)
        commit = torch.where(apply_snap, torch.maximum(commit, L), commit)
        out_a_ok_to = torch.where(ae_ok | snap, ae_src, NIL).to(ndt)
        out_a_match = torch.where(snap, L, torch.where(ae_ok, last_new, 0)).to(idt)
    else:
        apply_snap = snap
        out_a_ok_to = torch.where(ae_ok, ae_src, NIL).to(ndt)
        out_a_match = torch.where(ae_ok, last_new, 0).to(idt)
    out_a_hint = log_len.to(idt)

    # ---- phase 3.5: PreVote requests ------------------------------------------
    clock = s.clock + inp.skew  # phase 7's clock
    if pv:
        heard = torch.where(has_ae, clock, s.heard_clock)
        is_pv = req_in & (mb.req_type == REQ_PREVOTE)[:, None, :]  # [cand, voter, B]
        quiet = (clock - heard >= cfg.election_min_ticks) & (role != LEADER)
        pv_grant = (
            is_pv
            & (mb.req_term[:, None, :] >= term[None, :, :])
            & up_to_date
            & quiet[None, :, :]
        )
    else:
        heard = s.heard_clock

    # ---- phase 4: responses ---------------------------------------------------
    vresp = resp_in & (mb.resp_kind == RESP_VOTE)
    new_votes = (
        vresp
        & (mb.v_to.to(I32)[None, :, :] == ids2[:, None, :])
        & (mb.resp_term[None, :, :] == term[:, None, :])
        & (role == CANDIDATE)[:, None, :]
    )
    votes = votes | bitplane.pack(new_votes, axis=1)
    win = (role == CANDIDATE) & (bitplane.count(votes, axis=1) >= cfg.quorum) & alive
    role = torch.where(win, LEADER, role)
    leader_id = torch.where(win, ids2, leader_id)
    len_i = log_len.to(idt)
    next_index = torch.where(win[:, None, :], (len_i + 1)[:, None, :], s.next_index)
    match_index = torch.where(win[:, None, :], 0, s.match_index)

    # ---- phase 4.5: PreVote responses and promotion ---------------------------
    if pv:
        pvresp = resp_in & (mb.resp_kind == RESP_PREVOTE)
        new_pv = torch.where(
            (role == PRECANDIDATE)[:, None, :], bitplane.pack(pvresp, axis=1) & mb.pv_grant, 0
        )
        votes = votes | new_pv
        pre_win = (role == PRECANDIDATE) & (bitplane.count(votes, axis=1) >= cfg.quorum) & alive
        term = term + pre_win.to(I32)
        role = torch.where(pre_win, CANDIDATE, role)
        voted_for = torch.where(pre_win, ids2, voted_for)
        votes = torch.where(pre_win[:, None, :], eye_p3, votes)

    aresp = (
        resp_in
        & (mb.resp_kind == RESP_APPEND)
        & (role == LEADER)[:, None, :]
        & (mb.resp_term[None, :, :] == term[:, None, :])
    )
    ok_mine = mb.a_ok_to.to(I32)[None, :, :] == ids2[:, None, :]
    a_succ = aresp & ok_mine
    a_fail = aresp & ~ok_mine
    am = mb.a_match[None, :, :]
    ah = mb.a_hint[None, :, :]
    match_index = torch.where(a_succ, torch.maximum(match_index, am), match_index)
    next_index = torch.where(a_succ, torch.maximum(next_index, am + 1), next_index)
    next_index = torch.where(
        a_fail, torch.minimum(next_index - 1, ah + 1).clamp(min=1), next_index
    )
    ack_age = (s.ack_age.to(I32) + 1).clamp(max=cfg.ack_age_sat).to(adt)
    ack_age = torch.where(win[:, None, :] | aresp, 0, ack_age)

    # ---- phase 5: leader commit advancement ------------------------------------
    is_leader = role == LEADER
    match_with_self = torch.where(eye3, len_i[:, None, :], match_index).to(I32)
    # The quorum-th largest match per leader: an order statistic, so any exact
    # method equals the JAX counting forms.
    quorum_match = torch.sort(match_with_self, dim=1, descending=True).values[
        :, cfg.quorum - 1, :
    ]
    quorum_term = term_at(log_term_arr, quorum_match)
    commit = torch.where(
        is_leader & alive & (quorum_match > commit) & (quorum_term == term),
        quorum_match,
        commit,
    )

    # ---- offer->commit latency ----------------------------------------------
    if track:
        sl = torch.arange(cap, dtype=I32, device=dev)[None, :, None]
        abs1 = base[:, None, :] + (sl - base[:, None, :]) % cap + 1 if comp else sl + 1
        newly = (abs1 > s.lat_frontier[None, None, :]) & (abs1 <= commit[:, None, :])
        cli = (log_tick_arr >= 1) & (log_tick_arr <= s.now[None, None, :])
        lm = (is_leader & alive)[:, None, :] & newly & cli
        lats = torch.where(lm, s.now[None, None, :] - log_tick_arr + 1, 0)
        lat_sum = lats.sum((0, 1)).to(I32)
        lat_cnt = lm.sum((0, 1)).to(I32)
        is_maxc = commit == commit.amax(0)[None, :]
        hnode = torch.where(is_maxc, ids2, n).amin(0)
        crossed = (ids2 == hnode[None, :])[:, None, :] & newly & cli
        lat_excluded = (crossed.sum((0, 1)).to(I32) - lat_cnt).clamp(min=0)
        bin_ = log_ops.log2_bin(lats, LAT_HIST_BINS)
        bins = torch.arange(LAT_HIST_BINS, dtype=I32, device=dev)[None, None, :, None]
        lat_hist = ((bins == bin_[:, :, None, :]) & lm[:, :, None, :]).sum((0, 1)).to(I32)
        lat_frontier = torch.maximum(s.lat_frontier, commit.amax(0))
    else:
        lat_sum = torch.zeros_like(s.now)
        lat_cnt = torch.zeros_like(s.now)
        lat_hist = torch.zeros((LAT_HIST_BINS, b), dtype=I32, device=dev)
        lat_excluded = torch.zeros_like(s.now)
        lat_frontier = s.lat_frontier

    if comp:
        # ---- phase 5.5: log compaction --------------------------------------------
        base_mid, bchk_mid = base, bchk  # post-install, pre-advance: the checksum anchor
        base2 = torch.maximum(base, torch.minimum(commit, log_len - (cap - cfg.compact_margin)))
        bterm = term_at(log_term_arr, base2)
        base = base2
        # ---- committed-prefix checksum, ring form (before phase 6: an injection
        # into a slot this tick's rebase freed would alias) -----------------------
        co = torch.maximum(s.commit_index, base_mid)  # snapshot installs skip the check
        s_co, s_bf, s_cn = log_ops.ring_chk_b(log_term_arr, log_val_arr, base_mid, (co, base, commit))
        add = lambda x, y: bitplane.i32(bitplane.u32(x) + bitplane.u32(y))  # noqa: E731
        if cfg.check_invariants:
            chk_ok = (add(bchk_mid, s_co) == s.commit_chk) | apply_snap
        else:
            chk_ok = torch.ones_like(s.commit_index, dtype=torch.bool)
        bchk = add(bchk_mid, s_bf)
        chk_new = add(bchk_mid, s_cn)

    # ---- phase 6: client injection, redirect routing, election-win no-op ------
    if comp:
        reserve = max(1, cfg.compact_margin // 2)
        has_slot = log_len - base < cap
        noop = win & has_slot
        room = log_len - base < cap - reserve
        noop_blocked = (win & ~has_slot).sum(0).to(I32)
    else:
        noop = torch.zeros_like(is_leader)
        room = log_len - base < cap
        noop_blocked = torch.zeros_like(s.now)
    node_ok = is_leader & alive & room & ~noop
    if cfg.client_redirect:
        kdim = cfg.client_pipeline
        kk = torch.arange(kdim, dtype=I32, device=dev)
        free = s.client_pend == NIL  # [K, B]
        first_free = free & (free.to(I32).cumsum(0) == 1)
        fresh = (inp.client_cmd != NIL)[None, :] & first_free
        pend = torch.where(fresh, inp.client_cmd[None, :], s.client_pend)
        tgt = torch.where(fresh, inp.client_target[None, :], s.client_dst)
        ptick = torch.where(fresh, (s.now + 1)[None, :], s.client_tick)
        active = pend != NIL
        tgt_oh = active[:, None, :] & (tgt[:, None, :] == ids[None, :, None])  # [K, N, B]
        low_k = torch.where(tgt_oh, kk[:, None, None], kdim).amin(0)  # [N, B]
        client_ok = (low_k < kdim) & node_ok
        sel_k = tgt_oh & (kk[:, None, None] == low_k[None, :, :]) & node_ok[None, :, :]
        wval_cl = torch.where(sel_k, pend[:, None, :], 0).sum(0).to(I32)
        wtick_cl = torch.where(sel_k, ptick[:, None, :], 0).sum(0).to(I32)
        accepted_k = sel_k.any(1)  # [K, B]
        cmds_cnt = accepted_k.sum(0).to(I32)
        tgt_ld = torch.where(tgt_oh, leader_id[None, :, :], NIL).amax(1)  # [K, B]
        tgt_up = (tgt_oh & alive[None, :, :]).any(1)
        pend_on = active & ~accepted_k
        client_pend = torch.where(pend_on, pend, NIL)
        client_dst = torch.where(
            pend_on, torch.where(tgt_up & (tgt_ld != NIL), tgt_ld, inp.client_bounce), 0
        )
        client_tick = torch.where(pend_on, ptick, 0) if track else s.client_tick
    else:
        client_ok = (inp.client_cmd[None, :] != NIL) & node_ok
        wval_cl = inp.client_cmd[None, :].expand(n, b)
        wtick_cl = (s.now + 1)[None, :].expand(n, b)
        cmds_cnt = client_ok.any(0).to(I32)
        client_pend, client_dst, client_tick = s.client_pend, s.client_dst, s.client_tick
    do_write = noop | client_ok
    inj_pos = torch.where(do_write, log_len % cap if comp else log_len, cap)
    inj_oh = torch.arange(cap, dtype=I32, device=dev)[None, :, None] == inj_pos[:, None, :]
    log_term_arr = torch.where(inj_oh, term[:, None, :], log_term_arr)
    log_val_arr = torch.where(inj_oh, torch.where(noop, NOOP, wval_cl)[:, None, :], log_val_arr)
    if track:  # no-op entries carry stamp 0
        log_tick_arr = torch.where(inj_oh, torch.where(noop, 0, wtick_cl)[:, None, :], log_tick_arr)
    log_len = log_len + do_write.to(I32)

    # ---- phase 7: timers ------------------------------------------------------
    reset_election = granted_any | has_ae | saw_higher
    deadline = torch.where(reset_election, clock + inp.timeout_draw, s.deadline)
    deadline = torch.where(win, clock + cfg.heartbeat_ticks, deadline)
    if pv:
        deadline = torch.where(pre_win, clock + inp.timeout_draw, deadline)
    expired = (clock >= deadline) & alive
    heartbeat = expired & is_leader
    deadline = torch.where(heartbeat, clock + cfg.heartbeat_ticks, deadline)
    if pv:
        # Expiry starts a pre-vote probe; real elections start at promotions.
        start_prevote = expired & ~is_leader
        role = torch.where(start_prevote, PRECANDIDATE, role)
        leader_id = torch.where(start_prevote, NIL, leader_id)
        votes = torch.where(start_prevote[:, None, :], eye_p3, votes)
        deadline = torch.where(start_prevote, clock + inp.timeout_draw, deadline)
        start_election = pre_win
        rv_like = start_election | start_prevote
    else:
        start_election = expired & ~is_leader
        term = term + start_election.to(I32)
        role = torch.where(start_election, CANDIDATE, role)
        voted_for = torch.where(start_election, ids2, voted_for)
        leader_id = torch.where(start_election, NIL, leader_id)
        votes = torch.where(start_election[:, None, :], eye_p3, votes)
        deadline = torch.where(start_election, clock + inp.timeout_draw, deadline)
        rv_like = start_election

    # ---- phase 8: outbox ------------------------------------------------------
    send_append = win | heartbeat
    new_last_idx, new_last_term = log_len, term_at(log_term_arr, log_len)
    ae_edge = send_append[:, None, :] & ~eye3
    out_req_type = torch.where(
        start_election, REQ_VOTE, torch.where(send_append, REQ_APPEND, 0)
    ).to(I32)
    if pv:
        out_req_type = torch.where(start_prevote, REQ_PREVOTE, out_req_type)
    out_req_term = torch.where(out_req_type != 0, term, 0)
    if pv:
        out_req_term = torch.where(start_prevote, term + 1, out_req_term)  # prospective
    len32 = len_i.to(I32)  # the phase-4 (pre-injection) length
    prev_out = torch.minimum((next_index.to(I32) - 1).clamp(min=0), len32[:, None, :])
    responsive = ack_age <= cfg.ack_timeout_ticks
    if comp:
        # Absolute indices: the two-pass min (responsive peers, else all peers).
        ws_resp = torch.where(eye3 | ~responsive, BIG, prev_out).amin(1)
        ws_all = torch.where(eye3, BIG, prev_out).amin(1)
        ws = torch.where(ws_resp == BIG, ws_all, ws_resp)
    else:
        k_ = cap + 1
        enc = prev_out + torch.where(eye3, 2 * k_, torch.where(responsive, 0, k_)).to(I32)
        m = enc.amin(1)
        ws = torch.where(m >= k_, m - k_, m).clamp(min=0)
    ws = torch.minimum(ws, len32)
    if comp:  # the window starts at or above the base
        ws = torch.maximum(ws, base)
    off_j = (prev_out - ws[:, None, :]).clamp(0, e)
    out_req_off = torch.where(ae_edge, off_j, 0)
    if comp:  # peers whose prev fell below the base get the InstallSnapshot sentinel
        out_req_off = torch.where(ae_edge & (prev_out < base[:, None, :]), -1, out_req_off)
    out_req_off = out_req_off.to(torch.int8)
    window = log_ops.window_rb if comp else log_ops.window_b
    n_ship = (log_len - ws).clamp(0, e)
    ship_used = send_append[:, None, :] & (ks_e < n_ship[:, None, :])
    out_ent_term = torch.where(ship_used, window(log_term_arr, ws, e), 0)
    out_ent_val = torch.where(ship_used, window(log_val_arr, ws, e), 0)
    if track:
        out_ent_tick = torch.where(ship_used, window(log_tick_arr, ws, e), 0)
    else:
        out_ent_tick = mb.ent_tick
    out_resp_kind = torch.where(is_rv, RESP_VOTE, 0) + torch.where(is_ae, RESP_APPEND, 0)
    if pv:
        out_resp_kind = out_resp_kind + torch.where(is_pv, RESP_PREVOTE, 0)
        out_pv_grant = bitplane.pack(pv_grant, axis=1)  # [cand, W(bit = voter), B]
    else:
        out_pv_grant = mb.pv_grant
    pterm = term_at(log_term_arr, ws)
    z = torch.zeros_like(base)
    new_mb = mb._replace(
        req_type=out_req_type,
        req_term=out_req_term,
        req_commit=torch.where(send_append, commit, 0),
        req_last_index=torch.where(rv_like, new_last_idx, 0),
        req_last_term=torch.where(rv_like, new_last_term, 0),
        ent_start=torch.where(send_append, ws, 0),
        ent_prev_term=torch.where(send_append, pterm, 0),
        ent_count=torch.where(send_append, n_ship, 0),
        ent_term=out_ent_term,
        ent_val=out_ent_val,
        ent_tick=out_ent_tick,
        req_base=torch.where(send_append, base, z) if comp else mb.req_base,
        req_base_term=torch.where(send_append, bterm, z) if comp else mb.req_base_term,
        req_base_chk=torch.where(send_append, bchk, z) if comp else mb.req_base_chk,
        req_off=out_req_off,
        resp_kind=out_resp_kind.to(torch.int8),
        pv_grant=out_pv_grant,
        v_to=grant_to,
        a_ok_to=out_a_ok_to,
        a_match=out_a_match,
        a_hint=out_a_hint,
        resp_term=term,
    )

    # Committed-prefix checksum, prefix form (the JAX log_ops module comment).
    if not comp:
        if cfg.check_invariants:
            chk_old, chk_new = log_ops.prefix_chk2_b(
                log_term_arr, log_val_arr, s.commit_index, commit
            )
            chk_ok = chk_old == s.commit_chk
        else:
            chk_new = s.commit_chk
            chk_ok = torch.ones_like(s.commit_index, dtype=torch.bool)

    new_state = s._replace(
        role=role,
        term=term,
        voted_for=voted_for,
        leader_id=leader_id,
        votes=votes,
        next_index=next_index,
        match_index=match_index,
        ack_age=ack_age,
        commit_index=commit,
        commit_chk=chk_new,
        log_base=base,
        base_term=bterm,
        base_chk=bchk,
        log_term=log_term_arr,
        log_val=log_val_arr,
        log_tick=log_tick_arr,
        log_len=log_len,
        clock=clock,
        deadline=deadline,
        heard_clock=heard,
        client_pend=client_pend,
        client_dst=client_dst,
        client_tick=client_tick,
        lat_frontier=lat_frontier,
        now=s.now + 1,
        mailbox=new_mb,
    )
    info = _step_info_b(
        cfg, s, new_state, req_in, resp_in, alive, cmds_cnt, chk_ok,
        lat_sum, lat_cnt, lat_hist, lat_excluded, noop_blocked,
        log_matching_due(cfg, s, now),
    )
    # Broadcasts over the transposed request plane leave some results in a
    # permuted layout; the carry is kept contiguous (the kernel requires it).
    return _map(torch.Tensor.contiguous, new_state), _map(torch.Tensor.contiguous, info)


def _step_info_b(
    cfg, old, new, req_in, resp_in, alive, cmds_cnt, chk_ok,
    lat_sum, lat_cnt, lat_hist, lat_excluded, noop_blocked, lm_due,
) -> StepInfo:
    """Batched phase 9 (the JAX `_step_info_b`). All outputs [B] (histograms
    [BINS, B])."""
    n = cfg.n_nodes
    dev = new.role.device
    b = new.role.shape[-1]
    f = torch.zeros((b,), dtype=torch.bool, device=dev)
    z = torch.zeros((b,), dtype=I32, device=dev)
    ids1 = torch.arange(n, dtype=I32, device=dev)[:, None]
    is_leader = new.role == LEADER
    live_leader = is_leader & alive
    if cfg.check_invariants:
        eye3 = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]
        pair_bad = (
            is_leader[:, None, :]
            & is_leader[None, :, :]
            & (new.term[:, None, :] == new.term[None, :, :])
            & ~eye3
        )
        viol_election = pair_bad.any(0).any(0)
        viol_commit = (
            (new.commit_index < old.commit_index)
            | (new.commit_index > new.log_len)
            | (new.commit_index < new.log_base)
            | (new.log_len - new.log_base > cfg.log_capacity)
            | ~chk_ok
        ).any(0)
    else:
        viol_election = f
        viol_commit = f
    if lm_due:
        minc = torch.minimum(new.commit_index[:, None, :], new.commit_index[None, :, :])
        differ = (new.log_term[:, None] != new.log_term[None, :]) | (
            new.log_val[:, None] != new.log_val[None, :]
        )  # [N, N, CAP, B]
        slots = torch.arange(cfg.log_capacity, dtype=I32, device=dev)[None, None, :, None]
        viol_match = ((slots < minc[:, :, None, :]) & differ).flatten(0, 2).any(0)
    else:
        viol_match = f
    leader = torch.where(live_leader, ids1, n).amin(0)
    return StepInfo(
        viol_election_safety=viol_election,
        viol_commit=viol_commit,
        viol_log_matching=viol_match,
        leader=torch.where(leader < n, leader, NIL).to(I32),
        n_leaders=live_leader.sum(0).to(I32),
        max_term=new.term.amax(0),
        max_commit=new.commit_index.amax(0),
        min_commit=new.commit_index.amin(0),
        msgs_delivered=(req_in.sum((0, 1)) + resp_in.sum((0, 1))).to(I32),
        cmds_injected=cmds_cnt,
        lat_sum=lat_sum,
        lat_cnt=lat_cnt,
        lat_hist=lat_hist,
        lat_excluded=lat_excluded,
        noop_blocked=noop_blocked,
        lm_skipped_pairs=z,
        reads_served=z.clone(),
        read_lat_sum=z.clone(),
        read_hist=torch.zeros((LAT_HIST_BINS, b), dtype=I32, device=dev),
        viol_read_stale=f.clone(),
        fsync_lag_sum=z.clone(),
        fsync_lag_max=z.clone(),
    )
