"""Fleet health plane: streaming SLIs, burn-rate alerts, triage, evidence
(the port of raft_sim_tpu/health/).

The closed loop over the repo's observability streams: spec.py declares the
SLOs, sli.py computes the indicators from window counters + perf rows,
burn.py runs the multi-window multi-burn-rate state machines, triage.py
names the worst-K clusters, evidence.py freezes the forensics, and
monitor.py is the streaming evaluator every standing loop
(run/soak/serve/farm) folds into its sink path. Host-side only by
construction: an armed run's trajectory is the unarmed one's.
"""

from raft_sim_tpu_torch.health.burn import ALERT_STATES, BURN_INF, BurnEngine
from raft_sim_tpu_torch.health.evidence import (
    EVIDENCE_SCHEMA,
    validate_bundle,
    write_bundle,
)
from raft_sim_tpu_torch.health.monitor import HealthMonitor, HealthWriter
from raft_sim_tpu_torch.health.spec import (
    DEFAULT_SPEC,
    HEALTH_SPEC_SCHEMA,
    load_spec,
    validate_spec,
)

__all__ = [
    "ALERT_STATES",
    "BURN_INF",
    "BurnEngine",
    "DEFAULT_SPEC",
    "EVIDENCE_SCHEMA",
    "HEALTH_SPEC_SCHEMA",
    "HealthMonitor",
    "HealthWriter",
    "load_spec",
    "validate_bundle",
    "validate_spec",
    "write_bundle",
]
