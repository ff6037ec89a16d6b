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
catch-up (`compact_margin > 0`), PreVote, and the reconfiguration plane:
log-carried joint-consensus membership (`reconfig`, with its snapshot config
context under compaction), TimeoutNow leadership transfer (`transfer`),
ReadIndex reads (`reads`) and lease reads (`lease`), and the durable
storage plane (`dur`: fsync watermarks, the durability gate on acks and vote
grants, crash recovery to the durable snapshot). The serve gates
(`serve_ingest`, `serve_reads`) add no leg: their offers arrive as the
inputs' client_cmd/read_cmd planes. The eight TEST-ONLY mutant hooks
(RaftConfig properties, True in production; scenario/mutation.py turns one
off) each weaken one rule at its JAX site: `joint_consensus` and
`act_on_append` in the config derivation (models/cfglog.py) and the config
entry of phase 6, `truncation_rollback` at the end-of-tick configuration,
`read_confirm` in ReadIndex serving and capture, `xfer_election` in
TimeoutNow receipt and fire, `lease_skew_safe` in the lease window,
`durable_acks` in the durability gate and `persist_vote` in crash recovery
(storage/plane.py). `track_trace` changes nothing in the tick: the trace
plane reads its state delta outside it (trace/events.py). Under the
compacted carry layout (`compact_planes`, ops/tile.py) `step_b` unpacks the
state and inputs, runs the dense tick and repacks, as the JAX `step_b` does.
Under compaction
log matching takes the JAX ring form (comparable pairs, checksums at the
larger base) and counts the pairs it cannot compare (`lm_skipped_pairs`).
Gated-off legs pass through untouched; gated-off StepInfo leaves are zeros
with the JAX dtype and shape.

Node-axis sharding (parallel/nodeshard.py): with a `NodeShardCtx`, `step_b`
ticks this shard's `nl` node rows of every cluster (peer axes padded to
`n_pad`), meeting the other shards at the JAX package's collective points
through the context's exchange (parallel/comm.py): the mailbox gather at
tick start (`_gather_mailbox`), the folds of the per-cluster `[B]`
reductions, and the leaders-by-term gather of the election-safety check.
The sharded surface is the JAX one (`nodeshard.check_shardable`): no
reconfiguration, transfer, reads, durable storage, redirect client or log
matching. With `sh=None` the tick is the single-device one, unchanged.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from raft_sim_tpu_torch.models import cfglog
from raft_sim_tpu_torch.ops import bitplane, log_ops
from raft_sim_tpu_torch.storage import plane as storage_plane
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
    REQ_TIMEOUT_NOW,
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


def _local_folds(pairs) -> list:
    """Node-axis folds on one device: each value is already the cluster's."""
    return [x for x, _ in pairs]


class NodeShardCtx(NamedTuple):
    """This shard's place on the node axis (the JAX NodeShardCtx): the
    padded node count `n_pad` = shards x `nl`, this shard's `rank`, and the
    `exchange` (parallel/comm.Exchange) the shards' collectives meet at.
    Every state and mailbox leg carries this shard's `nl` rows, the rows its
    own nodes write; pad rows (ids >= n_nodes) are nodes dead every tick."""

    exchange: object
    rank: int
    nl: int
    n_pad: int

    @property
    def row0(self) -> int:
        """The first global node row of this shard."""
        return self.rank * self.nl


def _loc(x: torch.Tensor, sh: NodeShardCtx) -> torch.Tensor:
    """This shard's node rows of a full [n_pad, ...] per-node tensor."""
    return x[sh.row0:sh.row0 + sh.nl]


# The mailbox legs the sharded tick reads from every sender (JAX
# `_gather_mailbox`); the rest stay local: gated off on the sharded surface,
# never read, passed through.
_GATHERED = ("req_type", "req_term", "req_commit", "req_last_index", "req_last_term",
             "ent_start", "ent_prev_term", "ent_count", "ent_term", "ent_val",
             "req_off", "resp_kind", "v_to", "a_ok_to", "a_match", "a_hint", "resp_term")


def _gather_mailbox(cfg: RaftConfig, mb, sh: NodeShardCtx):
    """THE tick-start collective: one gather of the writer-major local
    mailbox over the node axis, reoriented to the receiver view the body
    reads. Headers [nl, ...] -> [n_pad, ...]; req_off [nl(snd), n_pad(rcv)]
    -> [n_pad(snd), nl(local rcv)]; resp_kind, carried transposed
    [nl(responder), n_pad(receiver)] -> [nl(local receiver), n_pad];
    pv_grant, carried [nl(voter), W(candidate bits)] -> [nl(local
    candidate), W(voter bits)]."""
    names = list(_GATHERED)
    if cfg.track_offer_ticks:
        names.append("ent_tick")
    if cfg.compaction:
        names += ["req_base", "req_base_term", "req_base_chk"]
    if cfg.pre_vote:
        names.append("pv_grant")
    got = dict(zip(names, sh.exchange.all_gather(
        sh.rank, tuple(getattr(mb, f) for f in names), 0, kind="mailbox_gather")))
    lo, hi = sh.row0, sh.row0 + sh.nl
    got["req_off"] = got["req_off"][:, lo:hi]
    got["resp_kind"] = got["resp_kind"].transpose(0, 1)[lo:hi]
    if cfg.pre_vote:
        pv = bitplane.unpack(got["pv_grant"], sh.n_pad, axis=1).transpose(0, 1)[lo:hi]
        got["pv_grant"] = bitplane.pack(pv, axis=1)
    return mb._replace(**got)


def lease_window(cfg: RaftConfig) -> int:
    """The lease window on the ack_age plane: read_lease_ticks, or the no-skew
    bound election_min_ticks + 2 under the lease_skew_safe mutant."""
    return cfg.read_lease_ticks if cfg.lease_skew_safe else cfg.election_min_ticks + 2


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
    cfg: RaftConfig, s: ClusterState, inp: StepInputs, now: int | None = None,
    sh: NodeShardCtx | None = None,
) -> tuple[ClusterState, StepInfo]:
    """One tick for B clusters at once; every tensor carries a trailing batch
    axis. `now` is the host's copy of `s.now` (all clusters in lockstep).
    Under `compact_planes` the state and inputs are unpacked, the dense tick
    runs, and the new state is repacked with the gated-off legs of `s`.
    `sh` ticks one node shard (module docstring): `s` holds its rows, `inp`
    the full padded inputs."""
    if not cfg.compact_planes:
        return _step_b(cfg, s, inp, now, sh)
    assert sh is None  # sharded carries run dense (parallel/nodeshard.py)
    from raft_sim_tpu_torch.ops import tile

    return tile.through_dense(cfg, s, inp, lambda c, d, i: _step_b(c, d, i, now))


def _step_b(
    cfg: RaftConfig, s: ClusterState, inp: StepInputs, now: int | None = None,
    sh: NodeShardCtx | None = None,
) -> tuple[ClusterState, StepInfo]:
    """The dense batch-minor tick body; one node shard's with `sh`."""
    n, e, cap = cfg.n_nodes, cfg.max_entries_per_rpc, cfg.log_capacity
    track = cfg.track_offer_ticks
    comp = cfg.compaction
    pv = cfg.pre_vote
    rcf = cfg.reconfig  # log-carried joint-consensus membership
    xfr = cfg.leader_transfer  # TimeoutNow transfer
    rdx = cfg.read_index  # ReadIndex reads
    rdl = cfg.read_lease  # lease reads
    dur = cfg.durable_storage  # fsync watermarks and crash recovery
    dacks = dur and cfg.durable_acks  # the durability gate on acks and grants
    hc_live = pv or rdl or rcf  # heard_clock: the quiet rule and the vote denial
    dev = s.role.device
    b = s.role.shape[-1]
    idt = s.next_index.dtype
    adt = s.ack_age.dtype
    ndt = node_dtype(cfg)
    ids = torch.arange(n, dtype=I32, device=dev)
    if sh is None:
        nl = npd = n  # local rows and the peer axis: the full square
        ids2 = ids[:, None]  # [N, 1]
        snd_ids = ids[:, None, None]  # [sender, 1, 1]
        eye3 = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]  # [N, N, 1]
        pad_self = eye3  # self (and, sharded, pad) peers: skipped by the window min
        eye_p3 = bitplane.eye(n, dev)[:, :, None]  # [N, W, 1]
        gfolds = _local_folds
        alive_full = inp.alive
    else:
        assert not (rcf or xfr or rdx or rdl or dur or cfg.client_redirect
                    or cfg.check_log_matching)  # nodeshard.check_shardable
        nl, npd = sh.nl, sh.n_pad
        ids2 = sh.row0 + torch.arange(nl, dtype=I32, device=dev)[:, None]  # global ids
        peers = torch.arange(npd, dtype=I32, device=dev)
        snd_ids = peers[:, None, None]
        eye3 = ids2[:, :, None] == peers[None, :, None]  # [nl(self), n_pad(peer), 1]
        pad_self = eye3 | (peers >= n)[None, :, None]
        eye_p3 = _loc(bitplane.eye(npd, dev), sh)[:, :, None]  # [nl, W, 1]
        gfolds = functools.partial(sh.exchange.folds, sh.rank)  # one meeting a call
        # The delivery gates read the senders' liveness; everything else
        # reads this shard's rows.
        alive_full = inp.alive
        inp = inp._replace(alive=_loc(inp.alive, sh), restarted=_loc(inp.restarted, sh),
                           skew=_loc(inp.skew, sh), timeout_draw=_loc(inp.timeout_draw, sh),
                           deliver_mask=_loc(inp.deliver_mask, sh))
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
    if dur:  # crash recovery: rewind to the durable snapshot
        r_term, r_vote, r_len = storage_plane.recover(
            cfg, rs, inp.torn_drop, s.dur_len, s.dur_term, s.dur_vote,
            s.term, s.voted_for, s.log_len,
        )
        s = s._replace(term=r_term, voted_for=r_vote, log_len=r_len)
    if hc_live:  # a restarted node remembers no leader contact
        s = s._replace(
            heard_clock=torch.where(rs, s.clock - cfg.election_min_ticks, s.heard_clock)
        )
    if xfr:  # a pending transfer is volatile leader state
        s = s._replace(xfer_to=torch.where(rs, NIL, s.xfer_to))
    if rdx:  # pending reads die with the process
        s = s._replace(
            read_idx=torch.where(rs, 0, s.read_idx),
            read_tick=torch.where(rs, 0, s.read_tick),
            read_acks=torch.where(rs2, 0, s.read_acks),
        )
        if rdl:
            s = s._replace(read_fr=torch.where(rs, 0, s.read_fr))
    mb = s.mailbox if sh is None else _gather_mailbox(cfg, s.mailbox, sh)
    base, bterm, bchk = s.log_base, s.base_term, s.base_chk

    def term_at(log_term, index1):  # reads base/bterm as they stand at the call
        if comp:
            return log_ops.term_at_rb(log_term, base, bterm, index1)
        return log_ops.term_at_b(log_term, index1)

    # Membership: each node's tick-start derived rows mask every quorum test
    # it makes, dual while its own cfg_pend marks an open joint entry.
    if rcf:
        bmold, bpend, bepoch = s.base_mold, s.base_pend, s.base_epoch
        m_old, m_new = s.member_old, s.member_new  # [N, W, B]
        joint = s.cfg_pend > 0
        maj_old = bitplane.count(m_old, axis=1) // 2 + 1
        maj_new = bitplane.count(m_new, axis=1) // 2 + 1
        member_b = (((m_old | m_new) & eye_p3) != 0).any(1)  # node i in its own view

        def packed_quorum(rows):  # [N, W, B] packed grant rows -> [N, B]
            ok = bitplane.count(rows & m_old, axis=1) >= maj_old
            return ok & (~joint | (bitplane.count(rows & m_new, axis=1) >= maj_new))
    else:

        def packed_quorum(rows):
            return bitplane.count(rows, axis=1) >= cfg.quorum

    # ---- phase 0: delivery ----------------------------------------------------
    dst_up = alive & ~rs
    dmask = bitplane.unpack(inp.deliver_mask, npd, axis=1)  # [dst, src, B]
    deliver = dmask & ~eye3 & alive_full[None, :, :] & dst_up[:, None, :]  # [dst, src, B]
    req_in = deliver.transpose(0, 1) & (mb.req_type != 0)[:, None, :]  # [snd, rcv, B]
    resp_in = deliver & (mb.resp_kind != 0)  # [rcv, responder, B]

    # Heard-a-leader vote denial (reconfig and lease), which a transfer's
    # sanctioned RequestVote (req_disrupt) overrides.
    if rcf or rdl:
        heard_recent = (s.clock + inp.skew) - s.heard_clock < cfg.election_min_ticks
        if xfr:
            rv_denied = heard_recent[None, :, :] & (mb.req_disrupt == 0)[:, None, :]
        else:
            rv_denied = heard_recent[None, :, :].expand(n, n, b)

    # ---- phase 1: term adoption (PreVote probes carry a prospective term) -----
    term_req = req_in & (mb.req_type != REQ_PREVOTE)[:, None, :] if pv else req_in
    if rcf:  # a denied RequestVote is not processed: no term adoption either
        term_req = term_req & ~((mb.req_type == REQ_VOTE)[:, None, :] & rv_denied)
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
    if rcf or rdl:
        can_grant = can_grant & ~rv_denied
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
        got = torch.gather(w, 0, src[:, None, :].expand(nl, e, b))
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
    if dur:  # the watermark after the conflict truncation
        dur_mid = torch.minimum(s.dur_len, log_len)

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
    if rcf:  # non-config entries ship 0 and scrub stale commands off reused slots
        log_cfg_arr = write(s.log_cfg, log_ops.window_b(pick_w(mb.ent_cfg), off, e))
    else:
        log_cfg_arr = s.log_cfg
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
        if rcf:  # the snapshot's config context installs with it
            got = torch.gather(mb.req_base_mold, 0, src[:, None, :].expand(m_old.shape))
            bmold = torch.where(apply_snap[:, None, :], got, bmold)
            bpend = torch.where(apply_snap, pick_h(mb.req_base_pend), bpend)
            bepoch = torch.where(apply_snap, pick_h(mb.req_base_epoch), bepoch)
        out_a_ok_to = torch.where(ae_ok | snap, ae_src, NIL).to(ndt)
        out_a_match = torch.where(snap, L, torch.where(ae_ok, last_new, 0)).to(idt)
    else:
        apply_snap = snap
        out_a_ok_to = torch.where(ae_ok, ae_src, NIL).to(ndt)
        out_a_match = torch.where(ae_ok, last_new, 0).to(idt)
    out_a_hint = log_len.to(idt)

    # ---- phase 3.5: PreVote requests ------------------------------------------
    clock = s.clock + inp.skew  # phase 7's clock
    heard = torch.where(has_ae, clock, s.heard_clock) if hc_live else s.heard_clock
    if pv:
        is_pv = req_in & (mb.req_type == REQ_PREVOTE)[:, None, :]  # [cand, voter, B]
        quiet = (clock - heard >= cfg.election_min_ticks) & (role != LEADER)
        pv_grant = (
            is_pv
            & (mb.req_term[:, None, :] >= term[None, :, :])
            & up_to_date
            & quiet[None, :, :]
        )

    # ---- phase 3.7: TimeoutNow receipt ----------------------------------------
    if xfr:
        is_tn = req_in & (mb.req_type == REQ_TIMEOUT_NOW)[:, None, :]  # [snd, rcv, B]
        tn_cur = (
            is_tn
            & (mb.xfer_tgt.to(I32)[:, None, :] == ids[None, :, None])
            & (mb.req_term[:, None, :] == term[None, :, :])
        )
        xfer_elect = tn_cur.any(0) & alive & (role != LEADER)
        if rcf:
            xfer_elect = xfer_elect & member_b  # non-voters never campaign
        if not cfg.xfer_election:
            # TEST-ONLY mutant: the target takes leadership directly, a coup.
            coup = xfer_elect
            term = term + coup.to(I32)
            role = torch.where(coup, LEADER, role)
            leader_id = torch.where(coup, ids2, leader_id)
            xfer_elect = torch.zeros_like(coup)

    # ---- phase 4: responses ---------------------------------------------------
    vresp = resp_in & (mb.resp_kind == RESP_VOTE)
    new_votes = (
        vresp
        & (mb.v_to.to(I32)[None, :, :] == ids2[:, None, :])
        & (mb.resp_term[None, :, :] == term[:, None, :])
        & (role == CANDIDATE)[:, None, :]
    )
    votes = votes | bitplane.pack(new_votes, axis=1)
    win = (role == CANDIDATE) & packed_quorum(votes) & alive
    if rcf:
        win = win & member_b  # a removed node cannot win on banked votes
    if xfr and not cfg.xfer_election:
        win = win | coup  # mutant coups ride the fresh-leader bookkeeping
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
        pre_win = (role == PRECANDIDATE) & packed_quorum(votes) & alive
        if rcf:
            pre_win = pre_win & member_b
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
    # Under the durability gate a leader's own slot is its durable length.
    self_len = dur_mid.to(idt) if dacks else len_i
    match_with_self = torch.where(eye3, self_len[:, None, :], match_index).to(I32)
    if rcf:
        # Per-leader quorum match under the leader's own member rows: the
        # maj-th largest of its members' matches, the min of both
        # configurations while joint.
        mws = match_with_self
        ge_m = mws[:, None, :, :] >= mws[:, :, None, :]  # [i, j(cand), k, B]

        def masked_qmatch(mask_b, maj):
            cnt = (ge_m & mask_b[:, None, :, :]).sum(2)  # [N, N, B]
            ok = (cnt >= maj[:, None, :]) & mask_b
            return torch.where(ok, mws, 0).amax(1)

        qm_old = masked_qmatch(bitplane.unpack(m_old, n, axis=1), maj_old)
        qm_new = masked_qmatch(bitplane.unpack(m_new, n, axis=1), maj_new)
        quorum_match = torch.where(joint, torch.minimum(qm_old, qm_new), qm_old)
    else:
        # The quorum-th largest match per leader: an order statistic, so any
        # exact method equals the JAX counting forms.
        quorum_match = torch.sort(match_with_self, dim=1, descending=True).values[
            :, cfg.quorum - 1, :
        ]
    quorum_term = term_at(log_term_arr, quorum_match)
    commit = torch.where(
        is_leader & alive & (quorum_match > commit) & (quorum_term == term),
        quorum_match,
        commit,
    )

    # ---- phase 5.2: transfer keep/accept, ReadIndex and lease reads ----------
    if xfr:
        tgt_oh_x = ids[None, :, None] == s.xfer_to.clamp(0, n - 1)[:, None, :]
        age_t = torch.where(tgt_oh_x, ack_age.to(I32), 0).sum(1)
        keep_x = is_leader & (s.xfer_to != NIL) & (age_t <= cfg.ack_timeout_ticks)
        xfer_to = torch.where(keep_x, s.xfer_to, NIL)
        t_x = inp.transfer_cmd  # [B]
        ld_ok_x = is_leader & alive
        if rcf:
            ld_ok_x = ld_ok_x & member_b
            # The target must be a voter of the leader's own target config.
            t_voter = ((m_new & bitplane.one_bit(t_x, n)[None]) != 0).any(1)
        else:
            t_voter = torch.ones_like(ld_ok_x)
        ldx = torch.where(ld_ok_x, ids2, n).amin(0)
        can_x = (
            (t_x != NIL)[None, :]
            & t_voter
            & (ids2 == ldx[None, :])
            & ld_ok_x
            & (t_x[None, :] != ids2)
            & (xfer_to == NIL)
        )
        xfer_to = torch.where(can_x, t_x[None, :], xfer_to)
        xfer_pend = xfer_to != NIL
    zb = torch.zeros((b,), dtype=I32, device=dev)
    viol_read_stale = torch.zeros((b,), dtype=torch.bool, device=dev)
    if rdx:
        pend0 = s.read_idx > 0
        keep_r = is_leader & pend0
        read_acks = torch.where(keep_r[:, None, :], s.read_acks | bitplane.pack(aresp, axis=1), 0)
        if cfg.read_confirm:
            serve = keep_r & alive & packed_quorum(read_acks | eye_p3)
        else:
            serve = keep_r & alive  # TEST-ONLY mutant: no confirmation round
        if rdl:  # the lease fast path on the global-tick ack_age plane
            fresh_p = bitplane.pack(ack_age <= lease_window(cfg), axis=1)
            lease_ok = packed_quorum(fresh_p | eye_p3)
            if xfr:
                lease_ok = lease_ok & ~xfer_pend  # the transfer handoff covers reads
            serve = serve | (keep_r & alive & lease_ok)
        lat_r = (s.now[None, :] + 1 - s.read_tick).clamp(min=1)
        reads_served = serve.sum(0).to(I32)
        read_lat_sum = torch.where(serve, lat_r, 0).sum(0).to(I32)
        bins_r = torch.arange(LAT_HIST_BINS, dtype=I32, device=dev)[None, :, None]
        bin_r = log_ops.log2_bin(lat_r, LAT_HIST_BINS)
        read_hist = ((bins_r == bin_r[:, None, :]) & serve[:, None, :]).sum(0).to(I32)
        cur_committed = term_at(log_term_arr, commit) == term
        can_cap = (inp.read_cmd != NIL)[None, :] & is_leader & alive & ~pend0
        if cfg.read_confirm:
            can_cap = can_cap & cur_committed
        if xfr:
            can_cap = can_cap & ~xfer_pend
        low_cap = torch.where(can_cap, ids2, n).amin(0)
        cap_r = can_cap & (ids2 == low_cap[None, :])
        cleared = serve | (pend0 & ~keep_r)
        read_idx = torch.where(cap_r, commit + 1, torch.where(cleared, 0, s.read_idx))
        read_tick = torch.where(
            cap_r, (s.now + 1)[None, :], torch.where(cleared, 0, s.read_tick)
        )
        read_acks = torch.where((cap_r | serve)[:, None, :], 0, read_acks)
        if rdl:  # the staleness anchor and its device invariant
            fr_now = torch.maximum(s.lat_frontier, commit.amax(0))
            read_fr = torch.where(cap_r, fr_now[None, :], torch.where(cleared, 0, s.read_fr))
            if cfg.check_invariants:
                viol_read_stale = (serve & (s.read_idx - 1 < s.read_fr)).any(0)
    else:
        reads_served, read_lat_sum = zb, zb.clone()
        read_hist = torch.zeros((LAT_HIST_BINS, b), dtype=I32, device=dev)

    # ---- offer->commit latency ----------------------------------------------
    if track:
        sl = torch.arange(cap, dtype=I32, device=dev)[None, :, None]
        abs1 = base[:, None, :] + (sl - base[:, None, :]) % cap + 1 if comp else sl + 1
        newly = (abs1 > s.lat_frontier[None, None, :]) & (abs1 <= commit[:, None, :])
        cli = (log_tick_arr >= 1) & (log_tick_arr <= s.now[None, None, :])
        lm = (is_leader & alive)[:, None, :] & newly & cli
        lats = torch.where(lm, s.now[None, None, :] - log_tick_arr + 1, 0)
        lat_sum, lat_cnt, cmax = gfolds([(lats.sum((0, 1)).to(I32), "sum"),
                                         (lm.sum((0, 1)).to(I32), "sum"),
                                         (commit.amax(0), "max")])
        is_maxc = commit == cmax[None, :]
        (hnode,) = gfolds([(torch.where(is_maxc, ids2, n).amin(0), "min")])
        crossed = (ids2 == hnode[None, :])[:, None, :] & newly & cli
        bin_ = log_ops.log2_bin(lats, LAT_HIST_BINS)
        bins = torch.arange(LAT_HIST_BINS, dtype=I32, device=dev)[None, None, :, None]
        n_crossed, lat_hist = gfolds([
            (crossed.sum((0, 1)).to(I32), "sum"),
            (((bins == bin_[:, :, None, :]) & lm[:, :, None, :]).sum((0, 1)).to(I32), "sum")])
        lat_excluded = (n_crossed - lat_cnt).clamp(min=0)
        lat_frontier = torch.maximum(s.lat_frontier, cmax)
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
        if rcf:  # fold the compacted span's config entries into the snapshot context
            bmold, bpend, bepoch = cfglog.fold_span(
                cfg, log_cfg_arr, base_mid, base2, bmold, bpend, bepoch
            )
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

    # ---- phase 6: no-op, config entry, client injection, redirect routing -----
    # One append per node per tick, at priority no-op > config > client.
    if comp:
        reserve = max(1, cfg.compact_margin // 2)
        has_slot = log_len - base < cap
        noop = win & has_slot
        room = log_len - base < cap - reserve
        (noop_blocked,) = gfolds([((win & ~has_slot).sum(0).to(I32), "sum")])
    else:
        noop = torch.zeros_like(is_leader)
        room = log_len - base < cap
        noop_blocked = torch.zeros_like(s.now)
    if rcf:
        # Joint entry on the admin's toggle, final entry once the governing
        # joint entry commits on the leader; judged on the leader's own
        # tick-start configuration.
        t_r = inp.reconfig_cmd
        tbit = bitplane.one_bit(t_r, n)  # [W, B]; all zero for NIL
        toggled = m_new ^ tbit[None]
        ld_ok = is_leader & alive & member_b & room & ~noop
        ldj = torch.where(ld_ok & ~joint, ids2, n).amin(0)
        accept_j = (
            (t_r != NIL)[None, :]
            & (ids2 == ldj[None, :])
            & ld_ok
            & ~joint
            & (bitplane.count(tbit, axis=0) > 0)[None, :]
            & (bitplane.count(toggled, axis=1) >= 2)
        )
        if cfg.joint_consensus:
            pvbits = bitplane.unpack(m_old ^ m_new, n, axis=1)  # [N, N, B]
            pend_v = torch.where(pvbits, ids[None, :, None], n).amin(1)  # the open toggle
            accept_f = ld_ok & joint & (commit >= s.cfg_pend)
            cfg_code = torch.where(
                accept_j, t_r[None, :] + 1, torch.where(accept_f, -(pend_v + 1), 0)
            ).to(I32)
            cfg_write = accept_j | accept_f
        else:  # TEST-ONLY mutant: a single-server change, one entry
            cfg_code = torch.where(accept_j, t_r[None, :] + 1, 0).to(I32)
            cfg_write = accept_j
    node_ok = is_leader & alive & room & ~noop
    if rcf:
        node_ok = node_ok & ~cfg_write  # the slot holds a config entry
    if xfr:
        node_ok = node_ok & ~xfer_pend  # the transfer's lease handoff
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
        wval_cl = inp.client_cmd[None, :].expand(nl, b)
        wtick_cl = (s.now + 1)[None, :].expand(nl, b)
        cmds_cnt = gfolds([(client_ok.any(0), "any")])[0].to(I32)
        client_pend, client_dst, client_tick = s.client_pend, s.client_dst, s.client_tick
    do_write = noop | client_ok
    wval = torch.where(noop, NOOP, wval_cl)
    wtick = torch.where(noop, 0, wtick_cl)  # no-op entries carry stamp 0
    if rcf:  # config entries carry value 0 and stamp 0; the command rides log_cfg
        do_write = do_write | cfg_write
        wval = torch.where(cfg_write, 0, wval)
        wtick = torch.where(cfg_write, 0, wtick)
    inj_pos = torch.where(do_write, log_len % cap if comp else log_len, cap)
    inj_oh = torch.arange(cap, dtype=I32, device=dev)[None, :, None] == inj_pos[:, None, :]
    log_term_arr = torch.where(inj_oh, term[:, None, :], log_term_arr)
    log_val_arr = torch.where(inj_oh, wval[:, None, :], log_val_arr)
    if track:
        log_tick_arr = torch.where(inj_oh, wtick[:, None, :], log_tick_arr)
    if rcf:  # every append writes the config plane (0 for non-config entries)
        log_cfg_arr = torch.where(
            inj_oh, torch.where(cfg_write, cfg_code, 0)[:, None, :], log_cfg_arr
        )
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

    def campaign(start, role, term, voted_for, leader_id, votes, deadline, bump):
        """Start a real election at `start` (or a probe when not `bump`)."""
        if bump:
            term = term + start.to(I32)
            voted_for = torch.where(start, ids2, voted_for)
        role = torch.where(start, CANDIDATE if bump else PRECANDIDATE, role)
        leader_id = torch.where(start, NIL, leader_id)
        votes = torch.where(start[:, None, :], eye_p3, votes)
        deadline = torch.where(start, clock + inp.timeout_draw, deadline)
        return role, term, voted_for, leader_id, votes, deadline

    if pv:
        # Expiry starts a pre-vote probe; real elections start at promotions.
        start_prevote = expired & ~is_leader
        if rcf:
            start_prevote = start_prevote & member_b  # non-voters never campaign
        if xfr:
            start_prevote = start_prevote & ~xfer_elect  # the TimeoutNow bypass
        role, term, voted_for, leader_id, votes, deadline = campaign(
            start_prevote, role, term, voted_for, leader_id, votes, deadline, False
        )
        start_election = pre_win
        if xfr:
            # A TimeoutNow election: a real one without the pre-quorum (a
            # phase-4 win may have promoted the target this very tick).
            xe = xfer_elect & ~pre_win & ~is_leader
            role, term, voted_for, leader_id, votes, deadline = campaign(
                xe, role, term, voted_for, leader_id, votes, deadline, True
            )
            start_election = pre_win | xe
        rv_like = start_election | start_prevote
    else:
        start_election = expired & ~is_leader
        if rcf:
            start_election = start_election & member_b
        if xfr:
            xe = xfer_elect & ~is_leader
            start_election = start_election | xe
        role, term, voted_for, leader_id, votes, deadline = campaign(
            start_election, role, term, voted_for, leader_id, votes, deadline, True
        )
        rv_like = start_election

    # ---- phase 7.5: fsync flush and the durability gate ------------------------
    if dur:
        fs_fire = inp.fsync_fire & alive  # dead disks never flush
        dur2_len, dur2_term, dur2_vote = storage_plane.flush(
            fs_fire, dur_mid, s.dur_term, s.dur_vote, log_len, term, voted_for
        )
    if dacks:
        # Acks name only fsynced entries; a grant is sent once durable, and a
        # flush that newly covers an earlier grant sends it late.
        out_a_match = torch.minimum(out_a_match.to(I32), dur2_len).to(idt)
        covered0 = storage_plane.covered(s.dur_term, s.dur_vote, term, voted_for)
        covered2 = storage_plane.covered(dur2_term, dur2_vote, term, voted_for)
        grant_to = torch.where(covered2, voted_for, NIL).to(ndt)
        late_grant = covered2 & ~covered0 & ~granted_any

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
    if xfr:
        # TimeoutNow replaces the heartbeat once the target has caught up.
        tgt_oh8 = ids[None, :, None] == xfer_to.clamp(0, n - 1)[:, None, :]
        t_match = torch.where(tgt_oh8, match_index.to(I32), 0).sum(1)
        # The TEST-ONLY xfer_election mutant fires without waiting.
        caught = (t_match >= log_len) if cfg.xfer_election else torch.ones_like(send_append)
        fire = send_append & (xfer_to != NIL) & caught
        out_req_type = torch.where(fire, REQ_TIMEOUT_NOW, out_req_type).to(I32)
        out_xfer_tgt = torch.where(fire, xfer_to, NIL).to(ndt)
    else:
        out_xfer_tgt = mb.xfer_tgt
    if xfr and (rcf or rdl):  # written only where a denial gate reads it
        out_req_disrupt = xe.to(torch.int8)
    else:
        out_req_disrupt = mb.req_disrupt
    len32 = len_i.to(I32)  # the phase-4 (pre-injection) length
    prev_out = torch.minimum((next_index.to(I32) - 1).clamp(min=0), len32[:, None, :])
    responsive = ack_age <= cfg.ack_timeout_ticks
    if comp:
        # Absolute indices: the two-pass min (responsive peers, else all peers).
        ws_resp = torch.where(pad_self | ~responsive, BIG, prev_out).amin(1)
        ws_all = torch.where(pad_self, BIG, prev_out).amin(1)
        ws = torch.where(ws_resp == BIG, ws_all, ws_resp)
    else:
        k_ = cap + 1
        # Pad peers ride the self lane: a win resets their ack ages too.
        # (~responsive) * k_ keeps the select int32: a where of two Python
        # scalars would build an int64 plane.
        enc = prev_out + torch.where(pad_self, 2 * k_, (~responsive).to(I32) * k_)
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
    out_ent_cfg = torch.where(ship_used, window(log_cfg_arr, ws, e), 0) if rcf else mb.ent_cfg
    # The kinds as int8 products (the leaf's dtype): a where of two Python
    # scalars would build int64 planes.
    out_resp_kind = is_rv.to(torch.int8) * RESP_VOTE + is_ae.to(torch.int8) * RESP_APPEND
    if pv:
        out_resp_kind = out_resp_kind + is_pv.to(torch.int8) * RESP_PREVOTE
        if sh is None:
            out_pv_grant = bitplane.pack(pv_grant, axis=1)  # [cand, W(bit = voter), B]
        else:  # writer-major: local voter rows, candidate bits (_gather_mailbox)
            out_pv_grant = bitplane.pack(pv_grant.transpose(0, 1), axis=1)
    else:
        out_pv_grant = mb.pv_grant
    if dacks:  # the late RESP_VOTE, only on an edge with no other response
        vfc = voted_for.clamp(0, n - 1)
        late_edge = (ids2[:, :, None] == vfc[None, :, :]) & late_grant[None, :, :]
        out_resp_kind = torch.where(late_edge & (out_resp_kind == 0), RESP_VOTE, out_resp_kind)
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
        xfer_tgt=out_xfer_tgt,
        req_disrupt=out_req_disrupt,
        ent_cfg=out_ent_cfg,
        req_off=out_req_off,
        # Sharded carries are writer-major: the [receiver, responder] plane
        # is stored transposed, responder rows local (_gather_mailbox).
        resp_kind=(out_resp_kind if sh is None else out_resp_kind.transpose(0, 1)).to(torch.int8),
        pv_grant=out_pv_grant,
        v_to=grant_to,
        a_ok_to=out_a_ok_to,
        a_match=out_a_match,
        a_hint=out_a_hint,
        resp_term=term,
    )
    if comp and rcf:  # the snapshot config context rides the AppendEntries header
        new_mb = new_mb._replace(
            req_base_mold=torch.where(send_append[:, None, :], bmold, 0),
            req_base_pend=torch.where(send_append, bpend, z),
            req_base_epoch=torch.where(send_append, bepoch, z),
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
        dur_len=dur2_len if dur else s.dur_len,
        dur_term=dur2_term if dur else s.dur_term,
        dur_vote=dur2_vote if dur else s.dur_vote,
        clock=clock,
        deadline=deadline,
        heard_clock=heard,
        log_cfg=log_cfg_arr,
        client_pend=client_pend,
        client_dst=client_dst,
        client_tick=client_tick,
        lat_frontier=lat_frontier,
        now=s.now + 1,
        mailbox=new_mb,
    )
    # ---- end of tick: each node's configuration from its own log ---------------
    if rcf:
        d_mold, d_mnew, d_pend, d_epoch, d_hi = cfglog.derive(
            cfg, log_cfg_arr, log_len, base, bmold, bpend, bepoch, commit=commit
        )
        if not cfg.truncation_rollback:
            # TEST-ONLY mutant: a truncation that dropped config entries
            # keeps the stale tick-start configuration.
            rolled = d_epoch < s.cfg_epoch
            d_mold = torch.where(rolled[:, None, :], s.member_old, d_mold)
            d_mnew = torch.where(rolled[:, None, :], s.member_new, d_mnew)
            d_pend = torch.where(rolled, s.cfg_pend, d_pend)
            d_epoch = torch.where(rolled, s.cfg_epoch, d_epoch)
        # A removed leader steps down once its removal commits on it; a
        # removed candidate stops campaigning.
        self_in = (((d_mold | d_mnew) & eye_p3) != 0).any(1)
        is_cand = (role == CANDIDATE) | (role == PRECANDIDATE)
        demote = ~self_in & (((role == LEADER) & (commit >= d_hi)) | is_cand)
        new_state = new_state._replace(
            role=torch.where(demote, FOLLOWER, role),
            leader_id=torch.where(demote, NIL, leader_id),
            member_old=d_mold,
            member_new=d_mnew,
            cfg_epoch=d_epoch,
            cfg_pend=d_pend,
        )
        if comp:
            new_state = new_state._replace(base_mold=bmold, base_pend=bpend, base_epoch=bepoch)
    if xfr:
        new_state = new_state._replace(xfer_to=xfer_to)
    if rdx:
        new_state = new_state._replace(read_idx=read_idx, read_tick=read_tick, read_acks=read_acks)
        if rdl:
            new_state = new_state._replace(read_fr=read_fr)
    if dur:  # durability lag: the un-fsynced suffix per node
        lag = log_len - dur2_len
        fsync_lag_sum, fsync_lag_max = lag.sum(0).to(I32), lag.amax(0).to(I32)
    else:
        fsync_lag_sum, fsync_lag_max = zb.clone(), zb.clone()
    info = _step_info_b(
        cfg, s, new_state, req_in, resp_in, alive, cmds_cnt, chk_ok,
        lat_sum, lat_cnt, lat_hist, lat_excluded, noop_blocked,
        reads_served, read_lat_sum, read_hist, viol_read_stale,
        fsync_lag_sum, fsync_lag_max, log_matching_due(cfg, s, now), sh,
    )
    # Broadcasts over the transposed request plane leave some results in a
    # permuted layout; the carry is kept contiguous (the kernel requires it).
    return _map(torch.Tensor.contiguous, new_state), _map(torch.Tensor.contiguous, info)


def _step_info_b(
    cfg, old, new, req_in, resp_in, alive, cmds_cnt, chk_ok,
    lat_sum, lat_cnt, lat_hist, lat_excluded, noop_blocked,
    reads_served, read_lat_sum, read_hist, viol_read_stale,
    fsync_lag_sum, fsync_lag_max, lm_due, sh: NodeShardCtx | None = None,
) -> StepInfo:
    """Batched phase 9 (the JAX `_step_info_b`). All outputs [B] (histograms
    [BINS, B]). With `sh`, the per-cluster reductions fold over the shards."""
    n = cfg.n_nodes
    dev = new.role.device
    b = new.role.shape[-1]
    f = torch.zeros((b,), dtype=torch.bool, device=dev)
    z = torch.zeros((b,), dtype=I32, device=dev)
    is_leader = new.role == LEADER
    live_leader = is_leader & alive
    if sh is None:
        ids1 = torch.arange(n, dtype=I32, device=dev)[:, None]
    else:
        ids1 = sh.row0 + torch.arange(sh.nl, dtype=I32, device=dev)[:, None]
    if cfg.check_invariants:
        if sh is None:
            eye3 = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]
            pair_bad = (
                is_leader[:, None, :]
                & is_leader[None, :, :]
                & (new.term[:, None, :] == new.term[None, :, :])
                & ~eye3
            )
        else:
            # One [n_pad, B] gather: leaders encoded by term (terms start at
            # 1, so 0 reads as no leader; pad rows never lead).
            lv = sh.exchange.all_gather(sh.rank, torch.where(is_leader, new.term, 0), 0,
                                        kind="leaders_gather")
            eye_p = torch.eye(sh.n_pad, dtype=torch.bool, device=dev)[:, :, None]
            pair_bad = (lv[:, None, :] > 0) & (lv[:, None, :] == lv[None, :, :]) & ~eye_p
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
    if lm_due and cfg.compaction:
        viol_match, lm_skipped = _ring_log_matching(cfg, new)
    elif lm_due:
        minc = torch.minimum(new.commit_index[:, None, :], new.commit_index[None, :, :])
        differ = (new.log_term[:, None] != new.log_term[None, :]) | (
            new.log_val[:, None] != new.log_val[None, :]
        )  # [N, N, CAP, B]
        slots = torch.arange(cfg.log_capacity, dtype=I32, device=dev)[None, None, :, None]
        viol_match = ((slots < minc[:, :, None, :]) & differ).flatten(0, 2).any(0)
        lm_skipped = z
    else:
        viol_match, lm_skipped = f, z
    # The per-cluster reductions, folded over the shards in one meeting; pad
    # rows (ids >= n) sit at commit 0 forever, so they are out of the min.
    pairs = [(torch.where(live_leader, ids1, n).amin(0), "min"),
             (live_leader.sum(0).to(I32), "sum"),
             (new.term.amax(0), "max"),
             (new.commit_index.amax(0), "max"),
             (torch.where(ids1 < n, new.commit_index, BIG).amin(0), "min"),
             ((req_in.sum((0, 1)) + resp_in.sum((0, 1))).to(I32), "sum")]
    if cfg.check_invariants:
        pairs.append((viol_commit, "any"))
    folds = _local_folds if sh is None else functools.partial(sh.exchange.folds, sh.rank)
    got = folds(pairs)
    leader, n_leaders, max_term, max_commit, min_commit, msgs = got[:6]
    if cfg.check_invariants:
        viol_commit = got[6]
    return StepInfo(
        viol_election_safety=viol_election,
        viol_commit=viol_commit,
        viol_log_matching=viol_match,
        leader=torch.where(leader < n, leader, NIL).to(I32),
        n_leaders=n_leaders,
        max_term=max_term,
        max_commit=max_commit,
        min_commit=min_commit,
        msgs_delivered=msgs,
        cmds_injected=cmds_cnt,
        lat_sum=lat_sum,
        lat_cnt=lat_cnt,
        lat_hist=lat_hist,
        lat_excluded=lat_excluded,
        noop_blocked=noop_blocked,
        lm_skipped_pairs=lm_skipped,
        reads_served=reads_served,
        read_lat_sum=read_lat_sum,
        read_hist=read_hist,
        viol_read_stale=viol_read_stale,
        fsync_lag_sum=fsync_lag_sum,
        fsync_lag_max=fsync_lag_max,
    )


def _ring_log_matching(cfg, new):
    """Log matching on the ring (the JAX `_step_info_b` ring form): a pair of
    nodes is comparable when min(commit) >= max(base). For such a pair, slot s
    of both rings is compared where both slots' absolute 0-based indices lie
    in [max base, min commit), and each node's checksum at the larger base
    (its base_chk plus its entries below that base) must equal the other's.
    Returns (violation [B], incomparable unordered pairs [B] int32)."""
    dev = new.role.device
    abs0, contrib = log_ops.ring_contrib(new.log_term, new.log_val, new.log_base)  # [N, CAP, B]
    bb = new.log_base.to(torch.int64)  # [N, B]
    minc = torch.minimum(new.commit_index[:, None, :], new.commit_index[None, :, :]).to(torch.int64)
    mb = torch.maximum(bb[:, None, :], bb[None, :, :])  # [N, N, B]
    comparable = minc >= mb
    lo, hi = mb[:, :, None, :], minc[:, :, None, :]
    in_i = (abs0[:, None] >= lo) & (abs0[:, None] < hi)  # [N(i), N(j), CAP, B]
    in_j = (abs0[None, :] >= lo) & (abs0[None, :] < hi)
    differ = (new.log_term[:, None] != new.log_term[None, :]) | (
        new.log_val[:, None] != new.log_val[None, :]
    )
    viol_suffix = (comparable[:, :, None, :] & in_i & in_j & differ).flatten(0, 2).any(0)
    below = torch.where(abs0[:, None] < lo, contrib[:, None], torch.zeros((), dtype=torch.int64, device=dev))
    chk_at_mb = ((new.base_chk.to(torch.int64) & bitplane.MASK32)[:, None, :] + below.sum(2)) & bitplane.MASK32
    viol_prefix = (comparable & (chk_at_mb != chk_at_mb.transpose(0, 1))).flatten(0, 1).any(0)
    eye3 = torch.eye(cfg.n_nodes, dtype=torch.bool, device=dev)[:, :, None]
    skipped = ((~comparable & ~eye3).flatten(0, 1).sum(0) // 2).to(I32)
    return viol_suffix | viol_prefix, skipped
