"""Protocol trace plane: per-cluster Raft event histories, the whole-history
safety checker and transition coverage (the port of raft_sim_tpu/trace).

  events.py   event extraction from the tick's state delta, inputs and
              StepInfo (role transitions, terms, votes, commits, appends,
              truncations, fault, reconfiguration and storage events); it
              reads, so a traced run follows the untraced trajectory.
  ring.py     the per-cluster event buffer a telemetry window fills and
              exports, with an optional freeze kind, and the packed
              transition-coverage bitmap.
  history.py  per-cluster timelines from the exported windows or a sink
              directory, with an explicit completeness verdict.
  checker.py  the six safety properties over a complete history, with named
              witnesses, and `python -m raft_sim_tpu_torch.trace.checker DIR`.

Everything is gated by `cfg.track_trace`: a telemetry run that asks for
events without it is refused (sim/telemetry.py). The extraction, ring and
coverage fold are plain tensor ops around the tick, on the tick's device.
"""

from raft_sim_tpu_torch.trace.events import KIND_NAMES, KINDS, N_KINDS
from raft_sim_tpu_torch.trace.ring import TracePersist, TraceSpec, TraceWin

__all__ = [
    "KINDS",
    "KIND_NAMES",
    "N_KINDS",
    "TraceSpec",
    "TraceWin",
    "TracePersist",
]
