"""HealthMonitor: the streaming evaluator every standing loop folds in (the
port of raft_sim_tpu/health/monitor.py).

One monitor watches one SCOPE -- the whole fleet, one tenant's cluster
slice, or a farm generation stream -- and consumes exactly what the loop's
sink path already exports: stacked WindowRecords (windowed loops; tensors
on the card are copied to the host once, at the edge), cumulative
RunMetrics deltas (the plain chunked loop), and the ChunkTimer's perf rows.
Every `eval_windows` window units it computes the SLIs (sli.py), advances the
burn-rate state machines (burn.py), appends one health.jsonl line, and on
each alert transition appends an alerts.jsonl line -- firing transitions
triage the culprit clusters (triage.py) and freeze an evidence bundle
(evidence.py) with whatever the loop's `capture` hook can snapshot (live
flight rings, run refs).

Bit-exactness contract: a monitor only ever READS host copies of device
outputs the loop had already fetched (or fetches its own read-only copy on
the plain path). It never touches the carry and never changes a launch --
an instrumented run's trajectory is byte-identical to a plain run's.
Multiple monitors (serve's fleet + per-tenant set) share one HealthWriter so
the streams stay single-file with a `scope` column, per-scope eval indices
contiguous (telemetry_sink.validate checks this).
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from raft_sim_tpu_torch.health import burn as burn_mod
from raft_sim_tpu_torch.health import evidence as evidence_mod
from raft_sim_tpu_torch.health import sli as sli_mod
from raft_sim_tpu_torch.health import triage as triage_mod
from raft_sim_tpu_torch.health.spec import load_spec


class HealthWriter:
    """Appender for one directory's health.jsonl / alerts.jsonl + the
    evidence_NNNN allocator. Creating one truncates the streams and removes
    stale evidence dirs (telemetry-sink discipline: a rebuilt run must not
    inherit another run's alerts). append_health/append_alert are the
    streams' single writers: monitors sharing one directory share one
    HealthWriter, as ServeSession's per-tenant monitors do."""

    def __init__(self, directory: str):
        import json

        self._json = json
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.health_path = os.path.join(directory, "health.jsonl")
        self.alerts_path = os.path.join(directory, "alerts.jsonl")
        open(self.health_path, "w").close()
        open(self.alerts_path, "w").close()
        for name in sorted(os.listdir(directory)):
            p = os.path.join(directory, name)
            if name.startswith("evidence_") and os.path.isdir(p):
                shutil.rmtree(p)
        self._evidence_n = 0

    def append_health(self, row: dict) -> None:
        with open(self.health_path, "a") as f:
            f.write(self._json.dumps(row) + "\n")

    def append_alert(self, row: dict) -> None:
        with open(self.alerts_path, "a") as f:
            f.write(self._json.dumps(row) + "\n")

    def next_evidence_dir(self) -> str:
        path = os.path.join(self.directory, f"evidence_{self._evidence_n:04d}")
        self._evidence_n += 1
        return path


# RunMetrics counters that are additive across ticks: the plain chunked
# loop's per-chunk deltas of these reconstruct window-unit counters.
_ADDITIVE = (
    "violations", "total_cmds", "reads_served", "lat_sum", "lat_cnt",
    "lat_hist", "read_hist", "fsync_lag_sum",
)

# The per-cluster arrays of a window unit (everything except start/ticks).
UNIT_ARRAYS = (
    "violations", "leaderless", "cmds", "reads", "lat_sum", "lat_cnt",
    "lat_hist", "read_hist", "fsync_lag_sum", "fsync_lag_max",
)


def slice_units(units: list[dict], lo: int, hi: int) -> list[dict]:
    """A tenant's [lo, hi) cluster-slice view of window units -- numpy views,
    no copies: the serve loop computes units once per chunk and fans them
    out, the same single-fetch discipline as its window export."""
    out = []
    for u in units:
        v = dict(u)
        for k in UNIT_ARRAYS:
            v[k] = u[k][lo:hi]
        out.append(v)
    return out


class HealthMonitor:
    """Streaming SLO evaluation for one scope (class docstring above).

    `perf` is an obs.ChunkTimer whose rows are consumed incrementally at each
    eval (the runtime SLIs); `capture` is the loop's evidence hook, called on
    each firing transition as capture(alert, clusters) -> {"flights":
    {cluster: (ticks, StepInfo)}, "refs": {...}} -- both optional."""

    def __init__(
        self,
        spec,
        *,
        batch: int,
        writer: HealthWriter,
        scope: str = "fleet",
        cluster_base: int = 0,
        perf=None,
        capture=None,
    ):
        self.spec = load_spec(spec) if not isinstance(spec, dict) else spec
        self.batch = int(batch)
        self.writer = writer
        self.scope = scope
        self.cluster_base = int(cluster_base)
        self.perf = perf
        self.capture = capture
        self.engine = burn_mod.BurnEngine(self.spec)
        self.alerts: list[dict] = []
        self._units: list[dict] = []
        self._eval = 0
        self._windows_seen = 0
        self._perf_seen = 0
        self._cum: dict | None = None
        self._prev_done = 0
        self._tick_base = 0  # absolute offset across begin_run() calls

    # ------------------------------------------------------------ observers

    def observe_records(self, records) -> None:
        """Feed one chunk's stacked WindowRecord (leaves [B, n_windows,
        ...]): numpy leaves as the loop already fetched them, or tensors,
        copied to the host here in one go."""
        from raft_sim_tpu_torch.sim import telemetry

        self.observe_units(telemetry.window_cluster_counters(records))

    def observe_units(self, units: list[dict]) -> None:
        """Feed pre-split window units (telemetry.window_cluster_counters
        output) -- the serve loop splits once and fans the SAME units to the
        fleet monitor and each tenant's slice_units view."""
        self._units.extend(units)
        self._drain()

    def begin_run(self) -> None:
        """Plain-path epoch mark: each `run_chunked` call restarts its
        cumulative metrics and tick counter from zero, so the delta baseline
        must restart with it (and the absolute window offset carries on).
        Call before every run_chunked whose callback feeds observe_chunk."""
        self._tick_base += self._prev_done
        self._prev_done = 0
        self._cum = None

    def observe_chunk(self, done: int, metrics) -> None:
        """Feed the plain chunked loop's cumulative RunMetrics: per-chunk
        deltas of the additive counters become one window unit per chunk
        (the chunk is this path's window). Availability is coarser here --
        with no per-window fold, `leaderless` marks clusters that have never
        elected AT ALL (first_leader_tick still NEVER), the recoverable
        signal without touching traced code."""
        from raft_sim_tpu_torch.sim import telemetry
        from raft_sim_tpu_torch.utils import device as device_mod

        if isinstance(metrics.ticks, torch.Tensor):
            # One host copy of the whole tree, not a sync per field.
            metrics = device_mod.host_numpy(*device_mod.to_host_async(metrics))
        cum = {
            f: np.asarray(getattr(metrics, f)).astype(np.int64)
            for f in _ADDITIVE
        }
        first = np.asarray(metrics.first_leader_tick)
        prev = self._cum or {f: np.zeros_like(v) for f, v in cum.items()}
        delta = {f: cum[f] - prev[f] for f in _ADDITIVE}
        self._units.append({
            "start": self._tick_base + self._prev_done,
            "ticks": int(done) - self._prev_done,
            "violations": delta["violations"],
            "leaderless": first == telemetry.NEVER,
            "cmds": delta["total_cmds"],
            "reads": delta["reads_served"],
            "lat_sum": delta["lat_sum"],
            "lat_cnt": delta["lat_cnt"],
            "lat_hist": delta["lat_hist"],
            "read_hist": delta["read_hist"],
            "fsync_lag_sum": delta["fsync_lag_sum"],
            # RunMetrics.fsync_lag_max is a RUNNING max, so its delta is
            # meaningless; the chunk window reports the cumulative max --
            # conservative (a lag spike stays visible in every later chunk),
            # matching this path's coarser leaderless semantics above.
            "fsync_lag_max": np.asarray(metrics.fsync_lag_max).astype(np.int64),
        })
        self._cum = cum
        self._prev_done = int(done)
        self._drain()

    # ------------------------------------------------------------ evaluation

    def _drain(self) -> None:
        e = self.spec["eval_windows"]
        while len(self._units) >= e:
            self._evaluate(self._units[:e])
            del self._units[:e]

    def _evaluate(self, units: list[dict]) -> None:
        rows: list[dict] = []
        if self.perf is not None:
            rows = list(self.perf.rows[self._perf_seen:])
            self._perf_seen = len(self.perf.rows)
        out = sli_mod.compute_slis(self.spec, units, rows)
        transitions = self.engine.update(out["errs"], out["budgets"])
        health_row = {
            "eval": self._eval,
            "scope": self.scope,
            "window_start": int(units[0]["start"]),
            "windows": len(units),
            "ticks": int(sum(u["ticks"] for u in units)),
            "slis": out["slis"],
            "burn": {
                name: self.engine.burns(name, out["budgets"][name])
                for name in self.spec["objectives"]
            },
            "status": self.engine.status(),
        }
        self.writer.append_health(health_row)
        for tr in transitions:
            name = tr["objective"]
            worst: list[dict] = []
            pc = out["percluster"].get(name)
            if pc is not None:
                worst = triage_mod.outlier_clusters(
                    pc, self.spec["worst_k"], self.spec["outlier_score"],
                    self.cluster_base,
                )
            alert = {
                "eval": self._eval,
                "scope": self.scope,
                **tr,
                "worst_clusters": worst,
                "evidence": None,
            }
            if tr["state"] == "firing":
                clusters = [w["cluster"] for w in worst]
                path = self.writer.next_evidence_dir()
                alert["evidence"] = os.path.basename(path)
                cap = {}
                if self.capture is not None:
                    cap = self.capture(alert, clusters) or {}
                evidence_mod.write_bundle(
                    path,
                    alert=alert,
                    objective=self.spec["objectives"][name],
                    window_rows=evidence_mod.window_rows_for(
                        units, clusters, self._windows_seen, self.cluster_base,
                    ),
                    perf_rows=rows,
                    flights=cap.get("flights"),
                    refs=cap.get("refs"),
                )
            self.writer.append_alert(alert)
            self.alerts.append(alert)
        self._windows_seen += len(units)
        self._eval += 1

    # -------------------------------------------------------------- surface

    @property
    def status(self) -> str:
        return self.engine.status()

    def status_line(self) -> str:
        """The live one-liner `driver serve` prints: scope, eval count, worst
        state, and which (objective, rule) pairs are firing."""
        s = self.engine.status()
        line = f"health[{self.scope}] eval {self._eval}: {s}"
        firing = self.engine.firing()
        if firing:
            line += " (" + ", ".join(f"{o}/{r}" for o, r in firing) + ")"
        return line

    def finalize(self) -> dict:
        """Evaluate any partial trailing period, then return the rollup the
        loops fold into their summaries."""
        if self._units:
            self._evaluate(self._units)
            self._units = []
        return {
            "scope": self.scope,
            "evals": self._eval,
            "status": self.engine.status(),
            "alerts": len(self.alerts),
            "fired_objectives": sorted({
                a["objective"] for a in self.alerts if a["state"] == "firing"
            }),
        }
