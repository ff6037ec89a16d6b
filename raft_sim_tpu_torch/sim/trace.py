"""Host-side rendering of one cluster's trajectory (the port of
raft_sim_tpu/sim/trace.py): StepInfo stacks as one line per tick, a node's
state as one line, and consecutive states diffed into events (elections,
leaders crowned and deposed, commits, compactions). Input leaves may be
numpy arrays or tensors; the flight recorder's `telemetry.export_cluster`
output renders directly.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from raft_sim_tpu_torch.types import CANDIDATE, FOLLOWER, LEADER, NIL, PRECANDIDATE

ROLE_NAMES = {
    FOLLOWER: "follower",
    CANDIDATE: "candidate",
    LEADER: "leader",
    PRECANDIDATE: "precandidate",
}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def info_lines(infos, every: int = 1) -> Iterator[str]:
    """Stacked StepInfo of one cluster (leading axis = ticks) as one line per
    `every` ticks."""
    f = {name: _np(getattr(infos, name)) for name in infos._fields}
    viol = f["viol_election_safety"] | f["viol_commit"] | f["viol_log_matching"]
    for t in range(0, len(f["leader"]), every):
        leader = int(f["leader"][t])
        yield (
            f"tick {t:>6}  leader={'-' if leader == NIL else leader}"
            f"  n_leaders={int(f['n_leaders'][t])}"
            f"  max_term={int(f['max_term'][t])}"
            f"  commit[{int(f['min_commit'][t])},{int(f['max_commit'][t])}]"
            f"  msgs={int(f['msgs_delivered'][t])}"
            f"  cmds={int(f['cmds_injected'][t])}"
            + ("  VIOLATION" if bool(viol[t]) else "")
        )


def node_line(states, t: int, node: int) -> str:
    """One node's state at tick t of stacked states (one cluster)."""
    g = lambda f: _np(getattr(states, f))[t, node]  # noqa: E731
    role = ROLE_NAMES[int(g("role"))]
    vf, ld = int(g("voted_for")), int(g("leader_id"))
    base = int(g("log_base"))
    return (
        f"  node {node}: {role:<9} term={int(g('term'))}"
        f" voted_for={'-' if vf == NIL else vf}"
        f" leader={'-' if ld == NIL else ld}"
        f" commit={int(g('commit_index'))} log_len={int(g('log_len'))}"
        + (f" base={base}" if base else "")
        + f" clock={int(g('clock'))}/{int(g('deadline'))}"
    )


def events(states) -> Iterator[tuple[int, str]]:
    """Consecutive stacked states of one cluster diffed into (tick, event)."""
    role = _np(states.role)
    term = _np(states.term)
    commit = _np(states.commit_index)
    base = _np(states.log_base)
    n_ticks, n = role.shape
    for t in range(1, n_ticks):
        for i in range(n):
            if role[t, i] == CANDIDATE and role[t - 1, i] != CANDIDATE:
                yield t, f"node {i} starts election for term {term[t, i]}"
            if role[t, i] == LEADER and role[t - 1, i] != LEADER:
                yield t, f"node {i} becomes leader of term {term[t, i]}"
            if role[t, i] != LEADER and role[t - 1, i] == LEADER:
                yield t, f"node {i} steps down (term {term[t - 1, i]} -> {term[t, i]})"
            if commit[t, i] > commit[t - 1, i]:
                yield t, f"node {i} commits through {commit[t, i]}"
            if base[t, i] > base[t - 1, i]:
                yield t, f"node {i} compacts through {base[t, i]}"
