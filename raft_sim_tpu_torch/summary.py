"""Host-side fleet rollup of a batched RunMetrics (the port of
raft_sim_tpu/parallel/mesh.py `FleetSummary` / `summarize`).

The per-cluster metrics are a few int32s per cluster, so this is a copy to the
host and a numpy reduction; no mesh is involved. Fields and formulas are the
JAX package's (read its FleetSummary docstring for each one's meaning).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from raft_sim_tpu_torch.sim import scan


class FleetSummary(NamedTuple):
    n_clusters: int
    total_violations: int
    n_stable: int
    p50_stable_tick: float | None
    max_term: int
    total_msgs: int
    total_cmds: int
    p50_commit_latency: float | None
    lat_p50: float | None
    lat_p95: float | None
    lat_p99: float | None
    lat_excluded: int
    noop_blocked: int
    lm_skipped_pairs: int
    multi_leader: int
    reads_served: int
    read_p50: float | None
    read_p95: float | None
    read_p99: float | None
    fsync_lag_total: int
    fsync_lag_max: int
    fsync_lag_p50: float | None
    fsync_lag_p95: float | None


def _hist_percentile(hist, q: float) -> float | None:
    """The q-quantile from a summed log2-bin histogram (bin k = [2^k, 2^(k+1)),
    linear inside the hit bin, clamped to the lower edge of the first nonempty
    bin). None for an empty histogram."""
    total = int(hist.sum())
    if total == 0:
        return None
    need = q * total
    cum = 0
    for k, c in enumerate(int(x) for x in hist):
        if c and cum + c >= need:
            lo, hi = float(1 << k), float(1 << (k + 1))
            if cum == 0:
                return lo
            return lo + (need - cum) / c * (hi - lo)
        cum += c
    return float(1 << len(hist))


def _latency_rollup(m: dict) -> dict:
    committed = m["lat_cnt"] > 0
    p50_lat = (
        float(np.median(m["lat_sum"][committed] / m["lat_cnt"][committed]))
        if np.any(committed)
        else None
    )
    hist = np.sum(np.asarray(m["lat_hist"], dtype=np.int64), axis=0)
    rhist = np.sum(np.asarray(m["read_hist"], dtype=np.int64), axis=0)
    return {
        "p50_commit_latency": p50_lat,
        "lat_p50": _hist_percentile(hist, 0.50),
        "lat_p95": _hist_percentile(hist, 0.95),
        "lat_p99": _hist_percentile(hist, 0.99),
        "lat_excluded": int(np.sum(m["lat_excluded"], dtype=np.int64)),
        "reads_served": int(np.sum(m["reads_served"], dtype=np.int64)),
        "read_p50": _hist_percentile(rhist, 0.50),
        "read_p95": _hist_percentile(rhist, 0.95),
        "read_p99": _hist_percentile(rhist, 0.99),
    }


def _fsync_lag_rollup(m: dict) -> dict:
    ticks = np.asarray(m["ticks"], dtype=np.int64)
    ran = ticks > 0
    if np.any(ran):
        mean_lag = np.asarray(m["fsync_lag_sum"], np.int64)[ran] / ticks[ran]
        p50 = float(np.percentile(mean_lag, 50))
        p95 = float(np.percentile(mean_lag, 95))
    else:
        p50 = p95 = None
    return {
        "fsync_lag_total": int(np.sum(m["fsync_lag_sum"], dtype=np.int64)),
        "fsync_lag_max": int(np.max(m["fsync_lag_max"])),
        "fsync_lag_p50": p50,
        "fsync_lag_p95": p95,
    }


def summarize(metrics: scan.RunMetrics) -> FleetSummary:
    """Fleet-level rollup of a [B]-leading RunMetrics."""
    m = {f: getattr(metrics, f).cpu().numpy() for f in metrics._fields}
    stable = scan.stable_leader_ticks(metrics).cpu().numpy()
    reached = stable[stable < scan.NEVER]
    p50 = float(np.median(reached)) if reached.size else None
    return FleetSummary(
        n_clusters=int(m["ticks"].shape[0]),
        total_violations=int(np.sum(m["violations"])),
        n_stable=int(reached.size),
        p50_stable_tick=p50,
        max_term=int(np.max(m["max_term"])),
        total_msgs=int(np.sum(m["total_msgs"], dtype=np.int64)),
        total_cmds=int(np.sum(m["total_cmds"], dtype=np.int64)),
        noop_blocked=int(np.sum(m["noop_blocked"], dtype=np.int64)),
        lm_skipped_pairs=int(np.sum(m["lm_skipped_pairs"], dtype=np.int64)),
        multi_leader=int(np.sum(m["multi_leader"], dtype=np.int64)),
        **_fsync_lag_rollup(m),
        **_latency_rollup(m),
    )
