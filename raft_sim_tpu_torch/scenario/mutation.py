"""TEST-ONLY weakened tick variants: the violation hunt's ground truth (the
port of raft_sim_tpu/scenario/mutation.py).

A hunt that never finds anything proves nothing: the kernel may be safe, or
the hunt blind. Each class below is a RaftConfig whose one rule-as-data
property is turned off, so the plain tick (models/raft_batched.py) and the
Hopper kernel (csrc/tick.cuh) run the weakened rule at its site; the search
must drive such a config to a violation within a bounded budget. Never
instantiate these outside tests and demos: nothing in RaftConfig's flags or
in a scenario file reaches them -- only `mutant_config` by name (the
`--mutant` flag of `scenario search` and `run`, and the `mutant` label of a
repro artifact).
"""

from __future__ import annotations

import dataclasses

from raft_sim_tpu_torch.utils.config import RaftConfig


class WeakQuorumConfig(RaftConfig):
    """quorum - 1: floor(N/2) instead of floor(N/2) + 1, so two split-vote
    candidates can both win a term (election safety)."""

    @property
    def quorum(self) -> int:  # type: ignore[override]
        return self.n_nodes // 2


class SingleServerChangeConfig(RaftConfig):
    """A membership change is one log entry that switches the configuration
    wholly at append: no joint phase (needs reconfig_interval > 0)."""

    @property
    def joint_consensus(self) -> bool:  # type: ignore[override]
        return False


class ActOnCommitConfig(RaftConfig):
    """Configurations derived from the committed prefix instead of the
    appended one (needs reconfig_interval > 0)."""

    @property
    def act_on_append(self) -> bool:  # type: ignore[override]
        return False


class IgnoreTruncationRollbackConfig(RaftConfig):
    """A truncation that lost config entries keeps the stale configuration
    (needs reconfig_interval > 0)."""

    @property
    def truncation_rollback(self) -> bool:  # type: ignore[override]
        return False


class StaleReadConfig(RaftConfig):
    """ReadIndex without the confirmation round or the current-term-commit
    capture gate (needs read_interval > 0)."""

    @property
    def read_confirm(self) -> bool:  # type: ignore[override]
        return False


class BlindTransferConfig(RaftConfig):
    """TimeoutNow as a coup: the leader fires without waiting for catch-up
    and the target takes leadership with no vote (needs
    transfer_interval > 0)."""

    @property
    def xfer_election(self) -> bool:  # type: ignore[override]
        return False


class LeaseSkewConfig(RaftConfig):
    """Lease reads served for election_min_ticks + 2 ticks, a window safe
    only on unskewed clocks (needs read_lease_ticks > 0)."""

    @property
    def lease_skew_safe(self) -> bool:  # type: ignore[override]
        return False


class AckBeforeFsyncConfig(RaftConfig):
    """Acks and vote grants expose volatile state, and a leader's own slot
    in the commit quorum is its log length (needs fsync_interval > 0)."""

    @property
    def durable_acks(self) -> bool:  # type: ignore[override]
        return False


class VolatileVoteConfig(RaftConfig):
    """Crash recovery forgets votedFor (needs fsync_interval > 0)."""

    @property
    def persist_vote(self) -> bool:  # type: ignore[override]
        return False


MUTANTS = {
    "weak-quorum": WeakQuorumConfig,
    "single-server-change": SingleServerChangeConfig,
    "joint-bypass": SingleServerChangeConfig,  # the older name of the same weakening
    "act-on-commit": ActOnCommitConfig,
    "ignore-truncation-rollback": IgnoreTruncationRollbackConfig,
    "stale-read": StaleReadConfig,
    "blind-transfer": BlindTransferConfig,
    "lease-skew": LeaseSkewConfig,
    "ack-before-fsync": AckBeforeFsyncConfig,
    "volatile-vote": VolatileVoteConfig,
}


def mutant_config(name: str, cfg: RaftConfig) -> RaftConfig:
    """`cfg` rebuilt under the named mutant class (same field values)."""
    if name not in MUTANTS:
        raise ValueError(f"unknown mutant {name!r} (have {sorted(MUTANTS)})")
    return MUTANTS[name](**dataclasses.asdict(cfg))
