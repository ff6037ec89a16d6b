"""raft_sim_tpu_torch: the batched Raft cluster simulator in PyTorch, with the
tick as a hand-written CUDA kernel for Hopper (sm_90a).

A port of the JAX package `raft_sim_tpu`, which stays the reference: the same
configs, the same threefry streams, and every leaf of every tick equal to the
JAX package's on the same seed (tests/test_torch_*.py). This package imports
torch and numpy only -- never jax, and nothing of raft_sim_tpu.

Main path: `sim.scan.simulate(cfg, seed, batch, n_ticks, device="cuda")` on
presets config1-config6, config6r, config3p, config4c, config7 (N=101),
config8, config9 and config10 -- the kernel takes any N from 2 to 255;
long runs: `driver.Session` (chunked runs, checkpoints in the JAX package's
file format, the apply-log stream, windowed telemetry, single offered
commands and reads); the standing fleet: `serve.ServeSession` (streamed
commands and reads in, telemetry windows and commit deltas out, tenants);
CLI: `python -m raft_sim_tpu_torch run --preset ...` (with --chunk, --save,
--resume, --apply-log, --telemetry-dir and one flag per RaftConfig field),
`python -m raft_sim_tpu_torch serve`, and `python -m raft_sim_tpu_torch
bench` for the bench rows (bench.py).
"""

from raft_sim_tpu_torch.types import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    NIL,
    ClusterState,
    Mailbox,
    StepInfo,
    StepInputs,
    init_batch,
    init_state,
)
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

__all__ = [
    "CANDIDATE",
    "FOLLOWER",
    "LEADER",
    "NIL",
    "ClusterState",
    "Mailbox",
    "PRESETS",
    "RaftConfig",
    "StepInfo",
    "StepInputs",
    "init_batch",
    "init_state",
]
