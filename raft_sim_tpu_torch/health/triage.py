"""Fleet anomaly triage: name the clusters behind a firing alert (the port of
raft_sim_tpu/health/triage.py).

The batch axis IS the fleet, so every windowed counter already has a
per-cluster breakdown riding the telemetry stream -- triage is a robust
outlier scan over it, not new instrumentation. Scores are modified z-scores
against the fleet median (median/MAD with the 1.4826 normal-consistency
factor), so one sick cluster in a healthy fleet scores enormous while a
fleet-wide burn scores everyone ~0 -- in which case the worst-K are still
named (an alert must always point somewhere), just without the outlier
label. Deterministic: ties break toward the larger raw metric, then the
lower cluster id.
"""

from __future__ import annotations

import numpy as np

# Robust scores are clamped here so a zero-MAD fleet (every cluster clean but
# one) stays JSON-representable instead of overflowing to inf.
SCORE_CLAMP = 1e6


def outlier_clusters(
    values,
    worst_k: int,
    score_threshold: float,
    cluster_base: int = 0,
) -> list[dict]:
    """Rank the clusters with a nonzero bad-metric by robust score; return at
    most `worst_k` rows {cluster, value, score, outlier}. `cluster_base`
    shifts local indices to fleet-global ids (tenant slices, farm members).
    [] when no cluster has a nonzero metric (a perf-plane alert, or a metric
    that cleared between detection and triage)."""
    x = np.asarray(values, dtype=np.float64)
    if x.size == 0:
        return []
    candidates = np.flatnonzero(x > 0)
    if not candidates.size:
        return []
    med = float(np.median(x))
    mad = float(np.median(np.abs(x - med)))
    scores = np.clip((x - med) / (1.4826 * mad + 1e-9), -SCORE_CLAMP, SCORE_CLAMP)
    order = sorted(
        (int(i) for i in candidates),
        key=lambda i: (-scores[i], -x[i], i),
    )
    return [
        {
            "cluster": cluster_base + i,
            "value": float(x[i]),
            "score": round(float(scores[i]), 3),
            "outlier": bool(scores[i] >= score_threshold),
        }
        for i in order[:worst_k]
    ]
