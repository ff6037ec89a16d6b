"""SLI math: fold one evaluation period's window units into indicator values
(the port of raft_sim_tpu/health/sli.py, line for line).

The inputs are WINDOW UNITS -- per-window dicts of per-cluster numpy arrays
(sim/telemetry.py `window_cluster_counters` for the windowed loops; the plain
run_chunked path synthesizes one unit per chunk from metric deltas) -- plus
the period's perf.jsonl rows. Everything is host-side numpy over counters the
device already exported: no trajectory impact.

Latency objectives count "good" events straight off the log2-binned
histograms: bin k holds latencies in [2^k, 2^(k+1)), so every bin whose
UPPER edge is <= the threshold is wholly good and partial bins count bad --
an exact threshold at powers of two, conservative elsewhere. Percentiles use
the same lower-edge-clamped linear interpolation as the JAX package's mesh
report.
"""

from __future__ import annotations

import numpy as np

from raft_sim_tpu_torch.types import LAT_HIST_BINS


def hist_percentile(hist, q: float) -> float | None:
    """q-quantile estimate from a log2-binned latency histogram (bin k =
    [2^k, 2^(k+1))): linear interpolation within the hit bin, clamped to the
    lower edge when the bin is the first nonempty one. None on an empty
    histogram. The JAX package's mesh report uses the same estimator, so the
    two never disagree on a percentile."""
    hist = np.asarray(hist, dtype=np.int64)
    total = int(hist.sum())
    if total == 0:
        return None
    need = q * total
    cum = 0
    for k in range(len(hist)):
        c = int(hist[k])
        if c and cum + c >= need:
            lo, hi = float(1 << k), float(1 << (k + 1))
            if cum == 0:
                return lo
            return lo + (need - cum) / c * (hi - lo)
        cum += c
    return float(1 << len(hist))


def fast_bins(threshold_ticks: int) -> int:
    """Number of leading histogram bins wholly under the threshold: bins
    0..n-1 cover [1, 2^n), so latency < threshold exactly when the threshold
    is a power of two, conservatively (partial bin counts bad) otherwise."""
    n = 0
    while n < LAT_HIST_BINS and (1 << (n + 1)) <= threshold_ticks:
        n += 1
    return n


def _sum_field(units: list[dict], key: str) -> np.ndarray:
    """Per-cluster sum of an int counter across the period's units."""
    return np.sum([u[key] for u in units], axis=0, dtype=np.int64)


def compute_slis(spec: dict, units: list[dict], perf_rows: list[dict]) -> dict:
    """Evaluate every objective over one period. Returns
        {"slis":     {name: indicator values (floats/ints, JSON-able)},
         "errs":     {name: bad-event fraction in [0, 1]},
         "budgets":  {name: error budget (0 = page on any error)},
         "percluster": {name: [B] triage metric or None (no cluster axis)}}
    `errs`/`budgets` feed burn.BurnEngine; `percluster` feeds triage."""
    batch = len(units[0]["violations"])
    n = len(units)
    steady = [r for r in perf_rows if not r.get("warmup")]
    slis: dict = {}
    errs: dict = {}
    budgets: dict = {}
    percluster: dict = {}
    for name, obj in spec["objectives"].items():
        kind = obj["sli"]
        if kind == "availability":
            leaderless = _sum_field(units, "leaderless")  # [B] window counts
            bad = int(leaderless.sum())
            total = batch * n
            err = bad / total
            slis[name] = {
                "availability": round(1.0 - err, 6),
                "leaderless_cluster_windows": bad,
            }
            errs[name] = err
            budgets[name] = 1.0 - obj["target"]
            percluster[name] = leaderless.astype(np.float64)
        elif kind == "commit_latency":
            hist = _sum_field(units, "lat_hist")  # [B, BINS]
            nb = fast_bins(obj["threshold_ticks"])
            fast = hist[:, :nb].sum(axis=1)
            slow = hist.sum(axis=1) - fast
            total = int(hist.sum())
            fleet = hist.sum(axis=0)
            slis[name] = {
                "p50": hist_percentile(fleet, 0.50),
                "p95": hist_percentile(fleet, 0.95),
                "p99": hist_percentile(fleet, 0.99),
                "measured": total,
                "slow": int(slow.sum()),
            }
            errs[name] = (int(slow.sum()) / total) if total else 0.0
            budgets[name] = 1.0 - obj["target"]
            percluster[name] = slow.astype(np.float64)
        elif kind == "read_staleness":
            hist = _sum_field(units, "read_hist")
            nb = fast_bins(obj["stale_after_ticks"])
            fresh = hist[:, :nb].sum(axis=1)
            stale = hist.sum(axis=1) - fresh
            total = int(hist.sum())
            fleet = hist.sum(axis=0)
            slis[name] = {
                "p99": hist_percentile(fleet, 0.99),
                "measured": total,
                "stale": int(stale.sum()),
            }
            errs[name] = (int(stale.sum()) / total) if total else 0.0
            budgets[name] = 1.0 - obj["target"]
            percluster[name] = stale.astype(np.float64)
        elif kind == "throughput":
            ops = _sum_field(units, "cmds") + _sum_field(units, "reads")  # [B]
            per_window = int(ops.sum()) / n
            floor = obj["min_ops_per_window"]
            slis[name] = {"ops_per_window": round(per_window, 3), "floor": floor}
            errs[name] = 1.0 if (floor > 0 and per_window < floor) else 0.0
            budgets[name] = obj["budget"]
            # Triage metric: each cluster's deficit vs the fleet mean -- the
            # clusters dragging the floor down, not the busiest ones.
            mean = ops.sum() / batch
            percluster[name] = np.maximum(mean - ops, 0.0).astype(np.float64)
        elif kind == "safety":
            viol = _sum_field(units, "violations")
            bad = int(viol.sum())
            slis[name] = {"violations": bad}
            errs[name] = 1.0 if bad else 0.0
            budgets[name] = 0.0
            percluster[name] = viol.astype(np.float64)
        elif kind == "device_wait_share":
            wall = sum(r["wall_s"] for r in steady)
            wait = sum(r["device_wait_s"] for r in steady)
            share = (wait / wall) if wall > 0 else None
            floor = obj["min_share"]
            slis[name] = {
                "share": round(share, 6) if share is not None else None,
                "steady_chunks": len(steady),
            }
            errs[name] = (
                1.0 if (share is not None and floor > 0 and share < floor)
                else 0.0
            )
            budgets[name] = obj["budget"]
            percluster[name] = None  # runtime SLI: no cluster axis
        elif kind == "recompiles":
            bad = sum(1 for r in steady if r.get("recompiled"))
            slis[name] = {"recompiled_chunks": bad, "steady_chunks": len(steady)}
            errs[name] = 1.0 if bad else 0.0
            budgets[name] = 0.0
            percluster[name] = None
        elif kind == "durability_lag":
            # Storage-plane durability debt (window units fsync_lag_sum/max):
            # the page signal is the WORST instantaneous per-node lag in the
            # period vs the ceiling -- a disk stalled behind its log is a
            # local fact, so the fleet mean would hide exactly the cluster
            # that matters. The mean rides along as the trend readout.
            lagmax = np.max([u["fsync_lag_max"] for u in units], axis=0)  # [B]
            lag_sum = _sum_field(units, "fsync_lag_sum")
            ticks = sum(int(u["ticks"]) for u in units)
            ceiling = obj["max_lag"]
            worst = int(lagmax.max())
            slis[name] = {
                "max_lag": worst,
                "lag_per_tick": round(float(lag_sum.sum()) / ticks, 3)
                if ticks else None,
                "ceiling": ceiling,
            }
            errs[name] = 1.0 if (ceiling > 0 and worst > ceiling) else 0.0
            budgets[name] = obj["budget"]
            percluster[name] = lagmax.astype(np.float64)
        else:  # pragma: no cover - load_spec validates kinds
            raise ValueError(f"unknown sli kind {kind!r}")
    return {
        "slis": slis, "errs": errs, "budgets": budgets,
        "percluster": percluster,
    }
