"""The durability rules as elementwise selects over per-node tensors (any
shape; the plain tick passes [N, B]). The port of raft_sim_tpu/storage/plane.py;
the package docstring states the rules."""

from __future__ import annotations

import torch

from raft_sim_tpu_torch.types import NIL
from raft_sim_tpu_torch.utils.config import RaftConfig


def recovered_log_len(dur_len: torch.Tensor, log_len: torch.Tensor,
                      torn_drop: torch.Tensor) -> torch.Tensor:
    """Entries a restart keeps: the fsynced prefix is a floor, the rest
    survives less the torn tail."""
    return torch.maximum(dur_len, log_len - torn_drop)


def recover(cfg: RaftConfig, rs, torn_drop, dur_len, dur_term, dur_vote, term, voted_for,
            log_len):
    """Crash recovery on restarting nodes (`rs`): the post-recovery (term,
    voted_for, log_len), rewound to the durable snapshot. With the TEST-ONLY
    hook `persist_vote` off, recovery forgets votedFor."""
    rec_len = recovered_log_len(dur_len, log_len, torn_drop)
    vote = dur_vote if cfg.persist_vote else torch.full_like(dur_vote, NIL)
    return (
        torch.where(rs, dur_term, term),
        torch.where(rs, vote, voted_for),
        torch.where(rs, rec_len, log_len),
    )


def covered(dur_term, dur_vote, term, voted_for) -> torch.Tensor:
    """True where the live (term, votedFor) is durably recorded: a vote grant
    is exposed only while covered. A NIL votedFor is never covered."""
    return (dur_term == term) & (dur_vote == voted_for) & (voted_for != NIL)


def flush(fs_fire, dur_mid, dur_term, dur_vote, log_len, term, voted_for):
    """The flush (phase 7.5): where `fs_fire`, the durable snapshot snaps to
    the node's final log length, term and vote; elsewhere it carries
    (`dur_mid`: the truncation-clamped watermark). Returns the post-flush
    (dur_len, dur_term, dur_vote)."""
    return (
        torch.where(fs_fire, log_len, dur_mid),
        torch.where(fs_fire, term, dur_term),
        torch.where(fs_fire, voted_for, dur_vote),
    )
