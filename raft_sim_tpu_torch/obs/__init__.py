"""Runtime performance observability (the port of raft_sim_tpu/obs/): the
chunk timer woven into every standing loop (sim/chunked, the telemetry
loop, serve/loop, scenario search and the farm), streaming perf.jsonl rows
into the telemetry sink, and `reconcile`, the join of what a run measured
(bench rows, perf.jsonl) against the card's roofline for the tick kernel's
own traffic (`tick_engine.traffic_bytes`), with CPU, smoke, scenario,
non-production, other-layout and multi-device rows marked non-anchor.
Host-side only: with the timer armed no tick changes; with it off the loops
are as they were.
"""

from raft_sim_tpu_torch.obs.reconcile import (
    load_pins,
    reconcile_matrix,
    reconcile_perf_dir,
    reconcile_row,
)
from raft_sim_tpu_torch.obs.timer import ChunkTimer, device_live_bytes, summarize_rows

__all__ = [
    "ChunkTimer",
    "device_live_bytes",
    "load_pins",
    "reconcile_matrix",
    "reconcile_perf_dir",
    "reconcile_row",
    "summarize_rows",
]
