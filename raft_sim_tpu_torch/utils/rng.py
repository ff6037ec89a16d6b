"""Shared randomness helpers (the port of raft_sim_tpu/utils/rng.py)."""

from __future__ import annotations

import torch

from raft_sim_tpu_torch.utils import threefry
from raft_sim_tpu_torch.utils.config import RaftConfig


def draw_timeouts(cfg: RaftConfig, key: torch.Tensor, n: int) -> torch.Tensor:
    """Randomized election timeouts in ticks, one per node (the reference's
    5000 + rand(5000) ms, core.clj:174): `[..., 2]` keys -> `[..., n]` int32."""
    return threefry.randint(
        key,
        (n,),
        cfg.election_min_ticks,
        cfg.election_min_ticks + cfg.election_range_ticks,
    )
