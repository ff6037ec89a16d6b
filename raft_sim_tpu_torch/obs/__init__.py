"""Runtime performance observability (the port of raft_sim_tpu/obs/): the
chunk timer woven into every standing loop (sim/chunked, the telemetry
loop, serve/loop, scenario search and the farm), streaming perf.jsonl rows
into the telemetry sink. Host-side only: with it armed no tick changes; with
it off the loops are as they were.

`obs/reconcile.py`, which joins perf rows to the JAX package's TPU cost-model
pins, is not part of the port: those pins are no yardstick for the card.
"""

from raft_sim_tpu_torch.obs.timer import ChunkTimer, device_live_bytes, summarize_rows

__all__ = ["ChunkTimer", "device_live_bytes", "summarize_rows"]
