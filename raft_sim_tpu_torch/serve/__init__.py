"""The standing-fleet serve plane (the port of raft_sim_tpu/serve/):

  ingest.py  -- host command sources packed into per-chunk offer planes
  loop.py    -- the served chunk and the overlapped ServeSession loop
  deltas.py  -- commit-delta extraction on the device (the apply/ack stream)
  tenancy.py -- tenants over slices of the fleet's cluster range
"""

from raft_sim_tpu_torch.serve.deltas import DeltaStream, extract
from raft_sim_tpu_torch.serve.ingest import CommandSource, jsonl_commands, pack_chunk, pack_plane
from raft_sim_tpu_torch.serve.loop import ServeSession, serve_config, simulate_serve
from raft_sim_tpu_torch.serve.tenancy import Tenant, TenantRouter

__all__ = [
    "CommandSource",
    "DeltaStream",
    "ServeSession",
    "Tenant",
    "TenantRouter",
    "extract",
    "jsonl_commands",
    "pack_chunk",
    "pack_plane",
    "serve_config",
    "simulate_serve",
]
