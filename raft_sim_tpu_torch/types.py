"""Struct-of-arrays state for batched Raft cluster simulation (the port of
raft_sim_tpu/types.py).

`Mailbox`, `ClusterState`, `StepInputs` and `StepInfo` keep the JAX package's
field names and order, so leaves line up one to one (raft_sim_tpu_torch/
bridge.py converts between the two). Read the JAX module for what each field
means; this one restates only shapes and dtypes.

Dtypes follow the JAX package's tiers (`index_dtype`, `ack_dtype`,
`node_dtype`), with one carrier change: the JAX uint32 legs (the packed
bit-planes `votes`, `member_*`, `base_mold`, `read_acks`, `pv_grant`,
`req_base_mold`, `deliver_mask`, and the checksums `commit_chk`, `base_chk`,
`req_base_chk`) ride `torch.int32` holding the same bit patterns, because
torch's CPU uint32 lacks add/lt/rshift/sum. `U32_LEAVES` names them; the bridge
views them back as uint32. Under `compact_planes` (ops/tile.py) the packed legs
are uint32 too: `u32_leaves(cfg)` names every uint32 leg of a config.

Public shapes are `[B, ...]`-leading like the JAX package's `init_batch`; the
tick runs batch-minor `[..., B]` (sim/scan.py moves the axis once per run).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.utils import config as config_mod
from raft_sim_tpu_torch.utils import threefry
from raft_sim_tpu_torch.utils.config import (  # noqa: F401  (re-exported)
    ACK_AGE_SAT,
    ACK_AGE_SAT_NARROW,
    MAX_LOG_CAPACITY,
    RaftConfig,
)
from raft_sim_tpu_torch.utils.rng import draw_timeouts

FOLLOWER = 0
CANDIDATE = 1
LEADER = 2
PRECANDIDATE = 3

REQ_NONE = 0
REQ_VOTE = 1
REQ_APPEND = 2
REQ_PREVOTE = 3
REQ_TIMEOUT_NOW = 4

RESP_NONE = 0
RESP_VOTE = 1
RESP_APPEND = 2
RESP_PREVOTE = 3

NIL = -1
LAT_HIST_BINS = 16
NOOP = -2

MAX_INT8_LOG_CAPACITY = config_mod.max_log_capacity_for(127)
MAX_INT8_NODES = config_mod.max_nodes_for(127)

# Leaves whose JAX dtype is uint32 (carried here as int32 bit patterns);
# `cov` is the trace plane's coverage bitmap (trace/ring.py).
U32_LEAVES = frozenset(
    {
        "cov",
        "votes",
        "commit_chk",
        "base_chk",
        "member_old",
        "member_new",
        "base_mold",
        "read_acks",
        "req_base_chk",
        "req_base_mold",
        "pv_grant",
        "deliver_mask",
    }
)


def u32_leaves(cfg: RaftConfig) -> frozenset:
    """Leaves whose JAX dtype is uint32 under `cfg`: U32_LEAVES, and under
    the compacted layout its packed legs (tile.packed_carry_dtypes)."""
    if not cfg.compact_planes:
        return U32_LEAVES
    from raft_sim_tpu_torch.ops import tile

    packed = {f.removeprefix("mb.") for f, dt in tile.packed_carry_dtypes(cfg).items()
              if dt == "uint32"}
    return U32_LEAVES | packed


def ack_dtype(cfg: RaftConfig) -> torch.dtype:
    """Ack-age plane: int8 whenever the saturation ceiling fits it."""
    return torch.int8 if cfg.ack_age_sat < 127 else torch.int16


def index_dtype(cfg: RaftConfig) -> torch.dtype:
    """Per-edge log-index planes and the match/hint wire fields."""
    if cfg.compaction:
        return torch.int32
    return torch.int8 if cfg.log_capacity <= MAX_INT8_LOG_CAPACITY else torch.int16


def node_dtype(cfg: RaftConfig) -> torch.dtype:
    """Node-id wire fields (xfer_tgt/v_to/a_ok_to)."""
    return torch.int8 if cfg.n_nodes <= MAX_INT8_NODES else torch.int16


class Mailbox(NamedTuple):
    req_type: torch.Tensor  # [N(sender)] int32 in [0, 4] (REQ_*): this tick's broadcast, if any
    req_term: torch.Tensor  # [N] int32: sender's term at send time
    req_commit: torch.Tensor  # [N] int32: AE leaderCommit
    req_last_index: torch.Tensor  # [N] int32: RV lastLogIndex
    req_last_term: torch.Tensor  # [N] int32: RV lastLogTerm
    ent_start: torch.Tensor  # [N] int32 in [0, cap]: 1-based index before src's shared window (= prev at j=0)
    ent_prev_term: torch.Tensor  # [N] int32: term of the 1-based entry ent_start (j=0 prev)
    ent_count: torch.Tensor  # [N] int32 in [0, E]: entries shipped = min(log_len - ent_start, E)
    ent_term: torch.Tensor  # [N, E] int32: src's shared entry window (terms)
    ent_val: torch.Tensor  # [N, E] int32: src's shared entry window (values)
    ent_tick: torch.Tensor  # [N, E] int32: src's shared entry window (offer stamps)
    req_base: torch.Tensor  # [N] int32: sender's log_base (snapshot lastIncludedIndex)
    req_base_term: torch.Tensor  # [N] int32: snapshot lastIncludedTerm
    req_base_chk: torch.Tensor  # [N] uint32 (int32 carrier): checksum of the compacted prefix
    xfer_tgt: torch.Tensor  # [N(sender)] int8/int16 (node_dtype) in [NIL, N-1]: TimeoutNow target node (NIL = none)
    req_disrupt: torch.Tensor  # [N(sender)] int8 in [0, 1]: 1 = transfer-sanctioned RequestVote
    ent_cfg: torch.Tensor  # [N, E] int32: src's shared entry window (config commands)
    req_base_mold: torch.Tensor  # [N, W] uint32 (int32 carrier): sender's C_old at its base
    req_base_pend: torch.Tensor  # [N] int32: sender's pending toggle code at base
    req_base_epoch: torch.Tensor  # [N] int32: sender's config-entry count at base
    req_off: torch.Tensor  # [N(sender), N(receiver)] int8 in [-1, E]: AE window offset j; -1 = snapshot
    resp_kind: torch.Tensor  # [N(receiver), N(responder)] int8 in [0, 3] (RESP_*): response type per edge
    pv_grant: torch.Tensor  # [N(receiver), W] uint32 (int32 carrier): packed pre-vote grant bits (bit = responder)
    v_to: torch.Tensor  # [N(responder)] int8/int16 (node_dtype) in [NIL, N]: candidate granted this tick (NIL = none; N = masked no-sender sentinel)
    a_ok_to: torch.Tensor  # [N(responder)] int8/int16 (node_dtype) in [NIL, N]: AE sender acked OK this tick (NIL = none; N = masked no-sender sentinel)
    a_match: torch.Tensor  # [N(responder)] int16/int32 (index_dtype) in [0, cap]: acked index of the successful append
    a_hint: torch.Tensor  # [N(responder)] int16/int32 (index_dtype) in [0, cap]: nack hint (responder's log length)
    resp_term: torch.Tensor  # [N(responder)] int32: responder's term at send time


class ClusterState(NamedTuple):
    role: torch.Tensor  # [N] int32 in [0, 3] (FOLLOWER..PRECANDIDATE)
    term: torch.Tensor  # [N] int32 (starts at 1, core.clj:34)
    voted_for: torch.Tensor  # [N] int32 in [NIL, N] (NIL = none; N = masked no-candidate sentinel)
    leader_id: torch.Tensor  # [N] int32 in [NIL, N] (NIL = unknown; N = masked no-sender sentinel)
    votes: torch.Tensor  # [N, W] uint32 (int32 carrier); bit j of votes[i] = i holds a vote from j
    next_index: torch.Tensor  # [N, N] index_dtype in [1, cap+1]; leader i's next index for peer j
    match_index: torch.Tensor  # [N, N] index_dtype in [0, cap]
    ack_age: torch.Tensor  # [N, N] ack_dtype in [0, sat] (int8/int16)
    commit_index: torch.Tensor  # [N] int32 in [0, cap]
    commit_chk: torch.Tensor  # [N] uint32 (int32 carrier)
    log_base: torch.Tensor  # [N] int32: snapshot lastIncludedIndex
    base_term: torch.Tensor  # [N] int32: snapshot lastIncludedTerm
    base_chk: torch.Tensor  # [N] uint32 (int32 carrier): checksum of entries 1..log_base
    log_term: torch.Tensor  # [N, CAP] int32
    log_val: torch.Tensor  # [N, CAP] int32
    log_tick: torch.Tensor  # [N, CAP] int32
    log_len: torch.Tensor  # [N] int32 in [0, cap]
    dur_len: torch.Tensor  # [N] int32 in [0, cap]: fsynced log prefix length (<= log_len)
    dur_term: torch.Tensor  # [N] int32: term at the last flush (boot: 1)
    dur_vote: torch.Tensor  # [N] int32: votedFor at the last flush (NIL = none)
    clock: torch.Tensor  # [N] int32 local (skewable) clock
    deadline: torch.Tensor  # [N] int32 next timer fire on the local clock
    heard_clock: torch.Tensor  # [N] int32
    member_old: torch.Tensor  # [N, W] uint32 (int32 carrier): node i's C_old from its own log prefix
    member_new: torch.Tensor  # [N, W] uint32 (int32 carrier): node i's C_new (== C_old outside joint)
    cfg_epoch: torch.Tensor  # [N] int32: config entries in node i's prefix (+ base_epoch)
    cfg_pend: torch.Tensor  # [N] int32: abs index of the governing joint entry (0 = none)
    log_cfg: torch.Tensor  # [N, CAP] int32
    base_mold: torch.Tensor  # [N, W] uint32 (int32 carrier): C_old at log_base
    base_pend: torch.Tensor  # [N] int32: pending toggle code at base (0 = none)
    base_epoch: torch.Tensor  # [N] int32: config entries at or below base
    xfer_to: torch.Tensor  # [N] int32 in [NIL, N-1]: pending transfer target (NIL = idle)
    read_idx: torch.Tensor  # [N] int32: pending read's captured index + 1 (0 = none)
    read_tick: torch.Tensor  # [N] int32: offer stamp of the pending read
    read_acks: torch.Tensor  # [N, W] uint32 (int32 carrier): packed acks banked since capture
    read_fr: torch.Tensor  # [N] int32: frontier at the pending read's capture
    client_pend: torch.Tensor  # [K] int32 command values in flight (NIL = free slot)
    client_dst: torch.Tensor  # [K] int32 node each pending command targets
    client_tick: torch.Tensor  # [K] int32 offer stamps of the in-flight commands
    lat_frontier: torch.Tensor  # scalar int32
    now: torch.Tensor  # scalar int32 global tick counter
    mailbox: Mailbox


class StepInputs(NamedTuple):
    deliver_mask: torch.Tensor  # [N, W] uint32 (int32 carrier); bit src of row dst
    skew: torch.Tensor  # [N] int32 in [0, 2] local-clock increment this tick (normally 1)
    timeout_draw: torch.Tensor  # [N] int32 election timeout to use on any timer reset
    client_cmd: torch.Tensor  # scalar int32 command value offered this tick; NIL = none
    client_target: torch.Tensor  # scalar int32 in [0, N-1]
    client_bounce: torch.Tensor  # [K] int32 in [0, N-1]
    alive: torch.Tensor  # [N] bool; False = node crashed this tick (silent, frozen)
    restarted: torch.Tensor  # [N] bool; True = node came back up this tick (volatile wipe)
    reconfig_cmd: torch.Tensor  # scalar int32 in [NIL, N-1]; NIL = none
    transfer_cmd: torch.Tensor  # scalar int32 in [NIL, N-1]; NIL = none
    read_cmd: torch.Tensor  # scalar int32 in [NIL, 1]: 0/1 flag encoded as value; NIL = none
    fsync_fire: torch.Tensor  # [N] bool; True = flush completes this tick
    torn_drop: torch.Tensor  # [N] int32: torn-tail entries dropped at recovery


class StepInfo(NamedTuple):
    viol_election_safety: torch.Tensor  # bool: two leaders share a term
    viol_commit: torch.Tensor  # bool: commit regressed or exceeds log length
    viol_log_matching: torch.Tensor  # bool (False unless cfg.check_log_matching)
    leader: torch.Tensor  # int32: lowest-id current leader, NIL if none
    n_leaders: torch.Tensor  # int32: number of nodes in LEADER role
    max_term: torch.Tensor  # int32
    max_commit: torch.Tensor  # int32
    min_commit: torch.Tensor  # int32
    msgs_delivered: torch.Tensor  # int32: request+response records delivered this tick
    cmds_injected: torch.Tensor  # int32 0/1: an offered command was accepted by a live leader
    lat_sum: torch.Tensor  # int32: sum of commit latencies of entries committed this tick
    lat_cnt: torch.Tensor  # int32: number of client entries committed this tick
    lat_hist: torch.Tensor  # [LAT_HIST_BINS] int32 (zeros unless track_offer_ticks)
    lat_excluded: torch.Tensor  # int32 (zero unless track_offer_ticks)
    noop_blocked: torch.Tensor  # int32: count of win & no-noop-room events this tick
    lm_skipped_pairs: torch.Tensor  # int32: unordered pairs skipped by the check
    reads_served: torch.Tensor  # int32: ReadIndex reads served this tick
    read_lat_sum: torch.Tensor  # int32: summed offer->serve latency of served reads
    read_hist: torch.Tensor  # [LAT_HIST_BINS] int32 (zeros unless read_index)
    viol_read_stale: torch.Tensor  # bool: a stale lease read was served
    fsync_lag_sum: torch.Tensor  # int32: sum over nodes of log_len - dur_len
    fsync_lag_max: torch.Tensor  # int32: max over nodes of log_len - dur_len


def empty_mailbox(cfg: RaftConfig, lead=(), device="cpu") -> Mailbox:
    """The JAX package's empty_mailbox, with optional leading batch dims."""
    n, e = cfg.n_nodes, cfg.max_entries_per_rpc
    w = bitplane.n_words(n)

    def full(shape, value, dtype):
        return torch.full(tuple(lead) + shape, value, dtype=dtype, device=device)

    i = lambda *s: full(s, 0, torch.int32)  # noqa: E731
    return Mailbox(
        req_type=i(n),
        req_term=i(n),
        req_commit=i(n),
        req_last_index=i(n),
        req_last_term=i(n),
        ent_start=i(n),
        ent_prev_term=i(n),
        ent_count=i(n),
        ent_term=i(n, e),
        ent_val=i(n, e),
        ent_tick=i(n, e),
        req_base=i(n),
        req_base_term=i(n),
        req_base_chk=i(n),
        xfer_tgt=full((n,), NIL, node_dtype(cfg)),
        req_disrupt=full((n,), 0, torch.int8),
        ent_cfg=i(n, e),
        req_base_mold=i(n, w),
        req_base_pend=i(n),
        req_base_epoch=i(n),
        req_off=full((n, n), 0, torch.int8),
        resp_kind=full((n, n), 0, torch.int8),
        pv_grant=i(n, w),
        v_to=full((n,), NIL, node_dtype(cfg)),
        a_ok_to=full((n,), NIL, node_dtype(cfg)),
        a_match=full((n,), 0, index_dtype(cfg)),
        a_hint=full((n,), 0, index_dtype(cfg)),
        resp_term=i(n),
    )


def boot_state(cfg: RaftConfig, deadline: torch.Tensor) -> ClusterState:
    """Boot state around `deadline` ([*lead, N] int32): the JAX init_state,
    in the compacted carry form under `compact_planes` (ops/tile.py)."""
    lead = tuple(deadline.shape[:-1])
    dev = deadline.device
    n, cap, k = cfg.n_nodes, cfg.log_capacity, cfg.client_pipeline
    w = bitplane.n_words(n)

    def full(shape, value, dtype=torch.int32):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    def member():
        if cfg.reconfig:
            return bitplane.full_row(n, dev).expand(lead + (n, w)).clone()
        return full((n, w), 0)

    state = ClusterState(
        role=full((n,), FOLLOWER),
        term=full((n,), 1),
        voted_for=full((n,), NIL),
        leader_id=full((n,), NIL),
        votes=full((n, w), 0),
        next_index=full((n, n), 1, index_dtype(cfg)),
        match_index=full((n, n), 0, index_dtype(cfg)),
        ack_age=full((n, n), cfg.ack_age_sat, ack_dtype(cfg)),
        commit_index=full((n,), 0),
        commit_chk=full((n,), 0),
        log_base=full((n,), 0),
        base_term=full((n,), 0),
        base_chk=full((n,), 0),
        log_term=full((n, cap), 0),
        log_val=full((n, cap), 0),
        log_tick=full((n, cap), 0),
        log_len=full((n,), 0),
        dur_len=full((n,), 0),
        dur_term=full((n,), 1),
        dur_vote=full((n,), NIL),
        clock=full((n,), 0),
        deadline=deadline.to(torch.int32),
        heard_clock=full((n,), -cfg.election_min_ticks),
        member_old=member(),
        member_new=member(),
        cfg_epoch=full((n,), 0),
        cfg_pend=full((n,), 0),
        log_cfg=full((n, cap), 0),
        base_mold=member(),
        base_pend=full((n,), 0),
        base_epoch=full((n,), 0),
        xfer_to=full((n,), NIL),
        read_idx=full((n,), 0),
        read_tick=full((n,), 0),
        read_acks=full((n, w), 0),
        read_fr=full((n,), 0),
        client_pend=full((k,), NIL),
        client_dst=full((k,), 0),
        client_tick=full((k,), 0),
        lat_frontier=full((), 0),
        now=full((), 0),
        mailbox=empty_mailbox(cfg, lead, dev),
    )
    if cfg.compact_planes:
        from raft_sim_tpu_torch.ops import tile

        state = tile.pack_state(cfg, state, lead=len(lead))
    return state


def init_state(cfg: RaftConfig, key: torch.Tensor) -> ClusterState:
    """Fresh cluster from one `[2]` key: all followers at term 1, empty logs,
    randomized initial deadlines (the JAX init_state)."""
    return boot_state(cfg, draw_timeouts(cfg, key, cfg.n_nodes))


def init_batch(cfg: RaftConfig, key: torch.Tensor, batch: int) -> ClusterState:
    """[batch, ...] clusters, cluster b keyed by split(key, batch)[b] -- the
    JAX `jax.vmap(init_state)(jax.random.split(key, batch))`."""
    return init_rows(cfg, threefry.split(key, batch))


def init_rows(cfg: RaftConfig, keys: torch.Tensor) -> ClusterState:
    """[b, ...] fresh clusters, cluster i keyed by keys[i], on the keys'
    device: the JAX `vmap(init_state)` over them (a shard's rows of a fleet
    whose keys were split before sharding, parallel/)."""
    return boot_state(cfg, draw_timeouts(cfg, keys, cfg.n_nodes))


def compact_twin(cfg: RaftConfig, on: bool = True) -> RaftConfig:
    """`cfg` with the compacted carry layout toggled (ops/tile.py): the
    trajectory is the same either way, only the carry's physical form moves."""
    return dataclasses.replace(cfg, compact_planes=on)
