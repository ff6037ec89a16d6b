"""The multi-device tier (the port of raft_sim_tpu/parallel/): the
cluster-axis mesh (mesh.py), node-axis sharding of giant-N clusters
(nodeshard.py) and the exchange behind it (comm.py)."""

from raft_sim_tpu_torch.parallel.mesh import (
    AXIS,
    FleetSummary,
    gather_metrics,
    init_distributed,
    make_mesh,
    simulate_sharded,
    simulate_windowed_sharded,
    summarize,
)
from raft_sim_tpu_torch.parallel.nodeshard import (
    NODE_AXIS,
    check_shardable,
    make_node_mesh,
    simulate_node_sharded,
    simulate_node_sharded_windowed,
    unshard_state,
)

__all__ = [
    "AXIS",
    "FleetSummary",
    "NODE_AXIS",
    "check_shardable",
    "gather_metrics",
    "init_distributed",
    "make_mesh",
    "make_node_mesh",
    "simulate_node_sharded",
    "simulate_node_sharded_windowed",
    "simulate_sharded",
    "simulate_windowed_sharded",
    "summarize",
    "unshard_state",
]
