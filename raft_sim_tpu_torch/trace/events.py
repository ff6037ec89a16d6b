"""Protocol event extraction: state deltas -> a compact event stream (the port
of raft_sim_tpu/trace/events.py).

Each tick's events come from what the tick already holds -- the state before
and after it, its inputs, its StepInfo -- plus the fault facts StepInputs does
not carry (sim/faults.py `trace_fault_inputs`). The extraction only reads, so
a traced run follows the same trajectory as an untraced one, and it reads the
ClusterState leaves both the plain tick and the Hopper kernel produce, so one
extractor serves both.

Vocabulary (`KINDS`): one small-int code per event kind, numbered as the JAX
package numbers them. Slot m of a tick's candidate table is the static pair
(`slot_nodes(n)[m]`, `slot_kinds(n)[m]`), kind-major: slot order is the
within-tick event order the checker (trace/checker.py) replays, role
transitions before commits, appends and truncations, fault kinds last.
Leaves are batch-minor: `[N, B]` per-node rows in, `[M, B]` slot rows out.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.types import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    NIL,
    PRECANDIDATE,
    ClusterState,
    StepInfo,
    StepInputs,
)
from raft_sim_tpu_torch.utils.config import RaftConfig

# Event kinds; 0 marks an empty ring slot. Detail per kind:
#   role kinds, term   the new term           vote      the candidate voted for
#   commit             the new commit index   append/truncate  the new log length
#   crash              0                      restart   the post-tick term
#   drop               dropped in-edges       violation bitmask (VIOL_*)
#   partition          cut edges after the change (0 = healed)
#   xfer               the transfer target    read_issue/read_serve  the read index
#   cfg_append         config slots written   cfg_apply/cfg_rollback the new cfg_epoch
#   recover_trunc      the recovered log length     fsync  the new dur_len
EV_NONE = 0
EV_FOLLOWER = 1
EV_PRECANDIDATE = 2
EV_CANDIDATE = 3
EV_LEADER = 4
EV_TERM = 5
EV_VOTE = 6
EV_COMMIT = 7
EV_APPEND = 8
EV_TRUNCATE = 9
EV_CRASH = 10
EV_RESTART = 11
EV_DROP = 12
EV_XFER = 13
EV_READ_ISSUE = 14
EV_READ_SERVE = 15
EV_CFG_APPEND = 16
EV_CFG_APPLY = 17
EV_CFG_ROLLBACK = 18
EV_RECOVER_TRUNC = 19
EV_FSYNC = 20
EV_VIOLATION = 21
EV_PARTITION = 22
N_KINDS = 23

KINDS = {
    "follower": EV_FOLLOWER,
    "precandidate": EV_PRECANDIDATE,
    "candidate": EV_CANDIDATE,
    "leader": EV_LEADER,
    "term": EV_TERM,
    "vote": EV_VOTE,
    "commit": EV_COMMIT,
    "append": EV_APPEND,
    "truncate": EV_TRUNCATE,
    "crash": EV_CRASH,
    "restart": EV_RESTART,
    "drop": EV_DROP,
    "violation": EV_VIOLATION,
    "partition": EV_PARTITION,
    "xfer": EV_XFER,
    "read_issue": EV_READ_ISSUE,
    "read_serve": EV_READ_SERVE,
    "cfg_append": EV_CFG_APPEND,
    "cfg_apply": EV_CFG_APPLY,
    "cfg_rollback": EV_CFG_ROLLBACK,
    "fsync": EV_FSYNC,
    "recover_trunc": EV_RECOVER_TRUNC,
}
KIND_NAMES = {v: k for k, v in KINDS.items()}

# Per-node kinds in slot order, then the cluster-scope kinds (node = NIL).
PER_NODE_KINDS = (
    EV_FOLLOWER, EV_PRECANDIDATE, EV_CANDIDATE, EV_LEADER, EV_TERM, EV_VOTE,
    EV_COMMIT, EV_APPEND, EV_TRUNCATE, EV_CRASH, EV_RESTART, EV_DROP,
    EV_XFER, EV_READ_ISSUE, EV_READ_SERVE,
    EV_CFG_APPEND, EV_CFG_APPLY, EV_CFG_ROLLBACK,
    EV_RECOVER_TRUNC, EV_FSYNC,
)
assert PER_NODE_KINDS == tuple(sorted(PER_NODE_KINDS))  # slot order == kind order
CLUSTER_KINDS = (EV_VIOLATION, EV_PARTITION)

# Violation bitmask bits (EV_VIOLATION detail).
VIOL_ELECTION = 1
VIOL_COMMIT = 2
VIOL_LOG_MATCHING = 4

# Coverage role axis: the four roles plus a row for cluster-scope events.
ROLE_DIM = 5
ROLE_CLUSTER = 4
assert {FOLLOWER, CANDIDATE, LEADER, PRECANDIDATE} == {0, 1, 2, 3}


def n_slots(n: int) -> int:
    """Candidate event slots per cluster per tick."""
    return n * len(PER_NODE_KINDS) + len(CLUSTER_KINDS)


def slot_nodes(n: int) -> np.ndarray:
    """[M] int32 node id per slot (NIL for the cluster-scope slots)."""
    per_node = np.tile(np.arange(n, dtype=np.int32), len(PER_NODE_KINDS))
    return np.concatenate([per_node, np.full(len(CLUSTER_KINDS), NIL, np.int32)])


def slot_kinds(n: int) -> np.ndarray:
    """[M] int32 event kind per slot, kind-major: slot order is the within-tick
    event order."""
    per_node = np.repeat(np.asarray(PER_NODE_KINDS, np.int32), n)
    return np.concatenate([per_node, np.asarray(CLUSTER_KINDS, np.int32)])


@functools.lru_cache(maxsize=32)
def slot_table(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(kinds, nodes): the slot tables as [M] int32 tensors on `device`."""
    return (torch.from_numpy(slot_kinds(n)).to(device),
            torch.from_numpy(slot_nodes(n)).to(device))


def kind_rows(n: int, kind: int) -> slice:
    """The slot rows of `kind` (contiguous: the table is kind-major)."""
    idx = np.flatnonzero(slot_kinds(n) == kind)
    return slice(int(idx[0]), int(idx[-1]) + 1) if idx.size else slice(0, 0)


class TickEvents(NamedTuple):
    """One tick's candidate events over the slot table: `flags[m]` whether
    slot m's (node, kind) event happened, `detail[m]` its payload, `role[m]`
    the emitting node's role after the tick (ROLE_CLUSTER for cluster-scope
    slots). Leaves [M, B]."""

    flags: torch.Tensor  # [M, B] bool
    detail: torch.Tensor  # [M, B] int32
    role: torch.Tensor  # [M, B] int32 in [0, ROLE_DIM)


def extract(
    cfg: RaftConfig,
    old: ClusterState,
    new: ClusterState,
    inp: StepInputs,
    info: StepInfo,
    crashed: torch.Tensor,
    cut_now: torch.Tensor,
    cut_prev: torch.Tensor,
) -> TickEvents:
    """This tick's events from the state delta (old -> new, batch-minor), the
    tick's inputs and StepInfo, and the fault facts `crashed` ([N, B] bool:
    the crash edge) and `cut_now`/`cut_prev` ([B] int32: the partition's cut
    edges at now and now - 1)."""
    n = cfg.n_nodes
    i32 = torch.int32
    z32 = torch.zeros_like(new.term)
    no = torch.zeros(new.term.shape, dtype=torch.bool, device=new.term.device)

    def became(role_code):
        return (new.role == role_code) & (old.role != role_code)

    # Incoming drops per receiver: the packed delivery row's popcount (the
    # diagonal self-bit counts, so delivered <= n). Under the compacted
    # layout the word plane ships flat ([N*W, B]): restore the row view.
    dm = inp.deliver_mask
    if cfg.compact_planes:
        dm = dm.reshape((n, -1) + tuple(dm.shape[1:]))
    delivered = bitplane.count(dm, axis=1)  # [N, B]
    dropped = n - delivered
    burst = dropped >= max(1, (n + 1) // 2)

    vote_flag = (new.voted_for != old.voted_for) & (new.voted_for != NIL)
    if cfg.durable_storage:
        # Recovery rewinds votedFor to the durable snapshot on a restart
        # tick: not a grant (a restarted node receives nothing that tick).
        vote_flag = vote_flag & ~inp.restarted
    # Read serve vs cancel: a slot cleared while its holder stays a
    # same-term leader (and did not restart) was served.
    read_serve = ((old.read_idx > 0) & (new.read_idx == 0) & (new.role == LEADER)
                  & (new.term == old.term) & ~inp.restarted)
    if cfg.reconfig:
        chg = (new.log_cfg != old.log_cfg) & (new.log_cfg != 0)  # [N, CAP, B]
        cfg_append, cfg_append_d = chg.any(dim=1), chg.sum(dim=1, dtype=i32)
        cfg_apply, cfg_rollback = new.cfg_epoch > old.cfg_epoch, new.cfg_epoch < old.cfg_epoch
    else:
        cfg_append, cfg_append_d, cfg_apply, cfg_rollback = no, z32, no, no
    if cfg.durable_storage:
        fsync_flag = ((new.dur_len > old.dur_len) | (new.dur_term != old.dur_term)
                      | (new.dur_vote != old.dur_vote))
        rec_trunc = inp.restarted & (new.log_len < old.log_len)
    else:
        fsync_flag, rec_trunc = no, no
    blocks = (
        (became(FOLLOWER), new.term),
        (became(PRECANDIDATE), new.term),
        (became(CANDIDATE), new.term),
        (became(LEADER), new.term),
        (new.term > old.term, new.term),
        (vote_flag, new.voted_for),
        (new.commit_index > old.commit_index, new.commit_index),
        (new.log_len > old.log_len, new.log_len),
        (new.log_len < old.log_len, new.log_len),
        (crashed, z32),
        (inp.restarted, new.term),
        (burst, dropped),
        ((new.xfer_to != old.xfer_to) & (new.xfer_to != NIL), new.xfer_to),
        ((new.read_idx > 0) & (new.read_idx != old.read_idx), new.read_idx - 1),
        (read_serve, old.read_idx - 1),
        (cfg_append, cfg_append_d),
        (cfg_apply, new.cfg_epoch),
        (cfg_rollback, new.cfg_epoch),
        (rec_trunc, new.log_len),
        (fsync_flag, new.dur_len),
    )
    viol_mask = (info.viol_election_safety.to(i32) * VIOL_ELECTION
                 + info.viol_commit.to(i32) * VIOL_COMMIT
                 + info.viol_log_matching.to(i32) * VIOL_LOG_MATCHING)
    cut_now, cut_prev = cut_now.to(i32), cut_prev.to(i32)
    cluster = ((viol_mask != 0, viol_mask), (cut_now != cut_prev, cut_now))
    flags = torch.cat([f for f, _ in blocks] + [f[None] for f, _ in cluster])
    detail = torch.cat([d.to(i32).expand(f.shape) for f, d in blocks]
                       + [d[None] for _, d in cluster])
    role = new.role.to(i32)
    role_rows = torch.cat([role] * len(PER_NODE_KINDS)
                          + [torch.full_like(role[:1], ROLE_CLUSTER)] * len(CLUSTER_KINDS))
    return TickEvents(flags=flags, detail=detail, role=role_rows)


def any_of_kind(cfg: RaftConfig, ev: TickEvents, kind: int) -> torch.Tensor:
    """[B] bool: an event of `kind` fired this tick (the flight recorder's and
    the trace freeze's trigger predicate)."""
    return ev.flags[kind_rows(cfg.n_nodes, kind)].any(dim=0)
