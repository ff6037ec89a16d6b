"""Host-side telemetry sink: the schema'd on-disk record of a run (the port of
raft_sim_tpu/utils/telemetry_sink.py). The files are the JAX package's,
line for line:

    <dir>/manifest.json      run identity: schema version, full config and its
                             hash, seed, batch, window and ring sizes, and the
                             software that wrote it
    <dir>/windows.jsonl      one line per telemetry window, fleet-aggregated
                             (sim/telemetry.py WindowRecord)
    <dir>/flight_<c>.jsonl   the flight recorder's last K ticks of cluster c
                             (violating clusters only): every StepInfo field
    <dir>/summary.json       the end-of-run FleetSummary rollup plus extras

    <dir>/trace_meta.json    the trace stream's self-description (kinds, depth,
                             coverage geometry, freeze kind), when tracing
    <dir>/trace.jsonl        one line per protocol event {w, c, t, node, k, d},
                             window-major, then cluster, then slot order
    <dir>/trace_windows.jsonl  one line per trace window: emitted, retained and
                             dropped events, the per-cluster drop map and the
                             fleet's best coverage popcount

    <dir>/perf.jsonl         per-chunk runtime attribution rows (obs/timer.py
                             ChunkTimer), when armed: the one stream with
                             clock readings (floats) in it
    <dir>/health.jsonl       one line per SLO evaluation period per scope
                             (health/monitor.py), when armed
    <dir>/alerts.jsonl       one line per burn-rate alert transition, with
                             the triaged clusters and, on firing, the
                             evidence_NNNN bundle it froze
    <dir>/evidence_NNNN/     a firing alert's forensics (health/evidence.py)

Every line is JSON with integer-exact values, so two runs diff as text and
`validate()` checks a directory without a schema library. The JAX package's
`validate()` accepts the port's directories: the manifest carries every
field it requires, with `jax_version` null (the port imports no jax),
`torch_version` beside it, and the device type (`cuda` or `cpu`) as
`backend`. `validate_multichip` checks the multi-device proof artifact
(`multichip-v2`, written by `python -m raft_sim_tpu_torch.multihost_check
--out P`), as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch

from raft_sim_tpu_torch.types import LAT_HIST_BINS, StepInfo
from raft_sim_tpu_torch.utils.config import RaftConfig

# The JAX package's schema version; its validate() refuses any other.
TELEMETRY_SCHEMA_VERSION = 4

_NEVER = 2**31 - 1  # a "never happened" tick becomes JSON null

WINDOW_FIELDS = (
    "window", "start", "ticks", "violations", "violating_clusters", "msgs", "cmds",
    "max_term", "max_commit", "lat_sum", "lat_cnt", "lat_excluded", "noop_blocked",
    "lm_skipped_pairs", "multi_leader", "reads", "read_lat_sum", "fsync_lag_sum",
    "fsync_lag_max",
)

MANIFEST_FIELDS = (
    "schema_version", "source", "created_unix", "config", "config_hash", "seed", "batch",
    "window", "ring", "jax_version", "backend",
)

# Per-line required fields of perf.jsonl (obs/timer.py ChunkTimer rows):
# ints, bools and non-negative float seconds; live_bytes is int or null (no
# count on the CPU) and jit_cache a {probe: int} map.
PERF_INT_FIELDS = ("chunk", "ticks")
PERF_BOOL_FIELDS = ("warmup", "recompiled")
PERF_FLOAT_FIELDS = ("wall_s", "dispatch_s", "host_s", "device_wait_s", "gap_s")

# Per-line required fields of health.jsonl / alerts.jsonl (health/monitor.py).
# `eval` indices are contiguous per scope; status and state values are the
# burn engine's lifecycle words.
HEALTH_INT_FIELDS = ("eval", "window_start", "windows", "ticks")
HEALTH_STATUSES = ("ok", "pending", "firing")
ALERT_FLOAT_FIELDS = ("burn_short", "burn_long")
ALERT_STATES = ("ok", "pending", "firing", "resolved")

# Streams a new sink removes, so a rebuilt run inherits none of them (the
# armed planes re-create theirs).
STALE_STREAMS = ("summary.json", "perf.jsonl", "health.jsonl", "alerts.jsonl", "trace.jsonl",
                 "trace_windows.jsonl", "trace_meta.json")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def window_lines(records, first_index: int) -> list[dict]:
    """A stacked WindowRecord (public layout: leaves [B, n_windows, ...]) as
    windows.jsonl line dicts numbered from `first_index`. The one
    aggregation: the fleet sink and the per-tenant streams
    (serve/tenancy.py) both call it."""
    start = _np(records.start)
    fv = _np(records.first_viol_tick).astype(np.int64)
    m = {f: _np(getattr(records.metrics, f)) for f in records.metrics._fields}
    i64 = lambda f: m[f].astype(np.int64)  # noqa: E731
    lines = []
    for w in range(start.shape[1]):
        viol = m["violations"][:, w]
        fvw = int(fv[:, w].min())
        lines.append({
            "window": first_index + w,
            "start": int(start[0, w]),
            "ticks": int(m["ticks"][0, w]),
            "violations": int(viol.sum()),
            "violating_clusters": int((viol > 0).sum()),
            "first_viol_tick": None if fvw == _NEVER else fvw,
            "msgs": int(i64("total_msgs")[:, w].sum()),
            "cmds": int(i64("total_cmds")[:, w].sum()),
            "max_term": int(m["max_term"][:, w].max()),
            "max_commit": int(m["max_commit"][:, w].max()),
            "lat_sum": int(i64("lat_sum")[:, w].sum()),
            "lat_cnt": int(i64("lat_cnt")[:, w].sum()),
            "lat_excluded": int(i64("lat_excluded")[:, w].sum()),
            "noop_blocked": int(i64("noop_blocked")[:, w].sum()),
            "lm_skipped_pairs": int(i64("lm_skipped_pairs")[:, w].sum()),
            "multi_leader": int(i64("multi_leader")[:, w].sum()),
            "reads": int(i64("reads_served")[:, w].sum()),
            "read_lat_sum": int(i64("read_lat_sum")[:, w].sum()),
            "fsync_lag_sum": int(i64("fsync_lag_sum")[:, w].sum()),
            "fsync_lag_max": int(m["fsync_lag_max"][:, w].max()),
            "lat_hist": [int(x) for x in i64("lat_hist")[:, w].sum(axis=0)],
            "read_hist": [int(x) for x in i64("read_hist")[:, w].sum(axis=0)],
        })
    return lines


def flight_lines(ticks, infos: StepInfo) -> list[dict]:
    """One cluster's flight-recorder export (telemetry.export_cluster) as
    line dicts: one per captured tick, every StepInfo field."""
    fields = {f: _np(getattr(infos, f)) for f in infos._fields}
    lines = []
    for i, t in enumerate(_np(ticks)):
        row = {"tick": int(t)}
        for name, arr in fields.items():
            v = arr[i]
            row[name] = (
                [int(x) for x in v] if v.ndim else (int(v) if v.dtype != bool else bool(v))
            )
        lines.append(row)
    return lines


def config_hash(cfg: RaftConfig) -> str:
    """Short hash of the full config (key-sorted JSON): the manifest's
    comparability key, equal to the JAX package's for the same config."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class TelemetrySink:
    """Writer half of the schema. Creating a sink writes the manifest and
    truncates the directory's streams at once, so a crashed run still leaves
    a valid directory, and a rebuilt run never inherits an old run's
    flights, rollup or other streams. `backend` is the device type the run
    takes ("cuda" or "cpu")."""

    def __init__(self, directory: str, cfg: RaftConfig, *, seed: int, batch: int, window: int,
                 ring: int, source: str = "driver", backend: str = "cuda"):
        self.directory = directory
        self.cfg = cfg
        self.window = window
        self.ring = ring
        self._n_windows = 0
        os.makedirs(directory, exist_ok=True)
        manifest = {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "source": source,
            "created_unix": int(time.time()),
            "config": dataclasses.asdict(cfg),
            "config_hash": config_hash(cfg),
            "seed": int(seed),
            "batch": int(batch),
            "window": int(window),
            "ring": int(ring),
            "jax_version": None,
            "torch_version": torch.__version__,
            "backend": str(backend),
        }
        with open(self._path("manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")
        open(self._path("windows.jsonl"), "w").close()
        for name in os.listdir(directory):
            p = os.path.join(directory, name)
            if name.startswith("evidence_") and os.path.isdir(p):
                shutil.rmtree(p)
            elif (name.startswith("flight_") and name.endswith(".jsonl")) or (
                name in STALE_STREAMS
            ):
                os.remove(p)
        self._n_trace_windows = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def append_windows(self, records) -> int:
        """Fleet-aggregate a stacked WindowRecord (public layout) and append
        one line per window; returns the lines written."""
        lines = window_lines(records, self._n_windows)
        with open(self._path("windows.jsonl"), "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
        self._n_windows += len(lines)
        return len(lines)

    def append_perf(self, rows: list[dict]) -> int:
        """Append chunk-timer rows (obs/timer.py) to perf.jsonl; returns the
        lines written."""
        with open(self._path("perf.jsonl"), "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        return len(rows)

    def write_trace_meta(self, spec) -> str:
        """The trace stream's self-description (a trace.TraceSpec), written
        when tracing is armed, so trace.jsonl decodes on its own."""
        from raft_sim_tpu_torch.trace import KINDS
        from raft_sim_tpu_torch.trace.ring import COV_BITS, COV_WORDS

        path = self._path("trace_meta.json")
        doc = {
            "trace_schema": 1,
            "kinds": dict(KINDS),
            "depth": int(spec.depth),
            "coverage": bool(spec.coverage),
            "coverage_bits": COV_BITS,
            "coverage_words": COV_WORDS,
            "freeze_kind": int(spec.freeze_kind),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    def append_trace(self, tracewins) -> int:
        """Append one chunk's stacked trace windows (a batch-minor
        TraceWindowOut, leaves [n_windows, ..., B], on any device) as
        trace.jsonl event lines and trace_windows.jsonl rows; returns the
        windows appended. Events go window-major, then cluster, then slot
        order, so each cluster's ticks never decrease."""
        from raft_sim_tpu_torch.ops.bitplane import np_popcount_u32
        from raft_sim_tpu_torch.trace.history import iter_window_events
        from raft_sim_tpu_torch.utils import device as device_mod

        host = device_mod.host_numpy(*device_mod.to_host_async(tracewins))
        n = host.win.n  # [W, B]
        n_windows = n.shape[0]
        depth = host.win.ev_kind.shape[1]
        kept = np.minimum(n, depth)
        dropped = n - kept
        # The fleet's best per-cluster coverage popcount at each window's end.
        cov_per = np.max(np_popcount_u32(host.cov).sum(axis=1), axis=-1)
        per_window: dict[int, list] = {w: [] for w in range(n_windows)}
        for w, c, evs in iter_window_events(host):
            per_window[w].append((c, evs))
        with open(self._path("trace.jsonl"), "a") as f:
            for w in range(n_windows):
                widx = self._n_trace_windows + w
                for c, evs in per_window[w]:
                    for e in evs:
                        f.write(json.dumps({"w": widx, "c": int(c), "t": e.tick, "node": e.node,
                                            "k": e.kind, "d": e.detail}) + "\n")
        with open(self._path("trace_windows.jsonl"), "a") as f:
            for w in range(n_windows):
                row = {
                    "window": self._n_trace_windows + w,
                    "emitted": int(n[w].sum()),
                    "retained": int(kept[w].sum()),
                    "dropped": int(dropped[w].sum()),
                    "dropped_by_cluster": {str(c): int(d) for c, d in enumerate(dropped[w])
                                           if d > 0},
                    "cov_bits_max": int(cov_per[w]),
                }
                f.write(json.dumps(row) + "\n")
        self._n_trace_windows += n_windows
        return n_windows

    def write_flight(self, cluster: int, ticks, infos: StepInfo) -> str:
        """Write one cluster's flight recording as flight_<cluster>.jsonl."""
        path = self._path(f"flight_{cluster}.jsonl")
        with open(path, "w") as f:
            for row in flight_lines(ticks, infos):
                f.write(json.dumps(row) + "\n")
        return path

    def write_summary(self, summary: dict) -> str:
        """End-of-run rollup (FleetSummary._asdict() plus caller extras)."""
        path = self._path("summary.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
        return path


def _validate_windows(path: str) -> list[str]:
    errors = []
    prev_idx, prev_end = -1, None
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"windows.jsonl:{ln}: not JSON: {ex}")
                continue
            for k in WINDOW_FIELDS:
                if not isinstance(row.get(k), int):
                    errors.append(f"windows.jsonl:{ln}: field {k!r} missing or non-int")
            fv = row.get("first_viol_tick")
            if fv is not None and not isinstance(fv, int):
                errors.append(f"windows.jsonl:{ln}: first_viol_tick must be int or null")
            for hk in ("lat_hist", "read_hist"):
                hist = row.get(hk)
                if (not isinstance(hist, list) or len(hist) != LAT_HIST_BINS
                        or not all(isinstance(x, int) and x >= 0 for x in hist)):
                    errors.append(
                        f"windows.jsonl:{ln}: {hk} must be {LAT_HIST_BINS} non-negative ints")
            if isinstance(row.get("window"), int):
                if row["window"] != prev_idx + 1:
                    errors.append(
                        f"windows.jsonl:{ln}: window index {row['window']} "
                        f"(expected {prev_idx + 1})")
                prev_idx = row["window"]
            if isinstance(row.get("start"), int) and isinstance(row.get("ticks"), int):
                if row["ticks"] < 1:
                    errors.append(f"windows.jsonl:{ln}: ticks must be >= 1")
                # Gaps are legal (ticks stepped outside run(), e.g. by
                # Session.offer, are not windowed); overlaps are not.
                if prev_end is not None and row["start"] < prev_end:
                    errors.append(
                        f"windows.jsonl:{ln}: start {row['start']} overlaps previous window "
                        f"(ends at {prev_end})")
                prev_end = row["start"] + row["ticks"]
    return errors


def _bad_number(v) -> bool:
    return not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0


def perf_row_errors(row: dict, where: str) -> list[str]:
    """The field problems of one perf.jsonl row (`where`: "perf.jsonl:<line>")."""
    errors = [f"{where}: field {k!r} missing or non-int" for k in _int_fields(row, PERF_INT_FIELDS)]
    errors += [f"{where}: field {k!r} missing or non-bool" for k in PERF_BOOL_FIELDS
               if not isinstance(row.get(k), bool)]
    errors += [f"{where}: field {k!r} missing or not a non-negative number"
               for k in PERF_FLOAT_FIELDS if _bad_number(row.get(k))]
    return errors


def _validate_perf(path: str) -> list[str]:
    errors = []
    prev_chunk = -1
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"perf.jsonl:{ln}: not JSON: {ex}")
                continue
            errors += perf_row_errors(row, f"perf.jsonl:{ln}")
            lb = row.get("live_bytes")
            if lb is not None and (not isinstance(lb, int) or isinstance(lb, bool)):
                errors.append(f"perf.jsonl:{ln}: live_bytes must be int or null")
            jc = row.get("jit_cache")
            if not isinstance(jc, dict) or not all(
                    isinstance(k, str) and isinstance(v, int) and not isinstance(v, bool)
                    for k, v in jc.items()):
                errors.append(f"perf.jsonl:{ln}: jit_cache must map entry points to int sizes")
            if isinstance(row.get("chunk"), int):
                if row["chunk"] != prev_chunk + 1:
                    errors.append(f"perf.jsonl:{ln}: chunk index {row['chunk']} "
                                  f"(expected {prev_chunk + 1})")
                prev_chunk = row["chunk"]
    return errors


def _int_fields(row: dict, keys) -> list[str]:
    """The keys of `row` that are missing, not ints, or True (the JAX
    validate()'s rule)."""
    return [k for k in keys if not isinstance(row.get(k), int) or row.get(k) is True]


def _validate_trace(directory: str) -> list[str]:
    """The trace stream's checks (when trace.jsonl is present): the meta file
    and its kinds map, every event line's int fields and kind range, each
    cluster's ticks never decreasing, and contiguous trace window rows."""
    trace_path = os.path.join(directory, "trace.jsonl")
    if not os.path.isfile(trace_path):
        return []
    errors = []
    meta_path = os.path.join(directory, "trace_meta.json")
    n_kinds = None
    if not os.path.isfile(meta_path):
        errors.append("trace.jsonl present but trace_meta.json missing")
    else:
        try:
            with open(meta_path) as f:
                kinds = json.load(f).get("kinds")
            if not isinstance(kinds, dict) or not kinds:
                errors.append("trace_meta.json: missing kinds map")
            else:
                n_kinds = max(kinds.values()) + 1
        except (OSError, json.JSONDecodeError) as ex:
            errors.append(f"trace_meta.json unreadable: {ex}")
    last_tick: dict[int, int] = {}
    with open(trace_path) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"trace.jsonl:{ln}: not JSON: {ex}")
                continue
            bad = _int_fields(row, ("w", "c", "t", "node", "k", "d"))
            if bad:
                errors.append(f"trace.jsonl:{ln}: fields {bad} missing or non-int")
                continue
            if n_kinds is not None and not 1 <= row["k"] < n_kinds:
                errors.append(f"trace.jsonl:{ln}: kind {row['k']} outside [1, {n_kinds})")
            c = row["c"]
            if row["t"] < last_tick.get(c, -1):
                errors.append(f"trace.jsonl:{ln}: cluster {c} tick {row['t']} regresses "
                              "(stream truncated or reordered)")
            last_tick[c] = max(last_tick.get(c, -1), row["t"])
    tw_path = os.path.join(directory, "trace_windows.jsonl")
    if not os.path.isfile(tw_path):
        errors.append("trace.jsonl present but trace_windows.jsonl missing")
        return errors
    prev = -1
    with open(tw_path) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"trace_windows.jsonl:{ln}: not JSON: {ex}")
                continue
            for k in _int_fields(row, ("window", "emitted", "retained", "dropped")):
                errors.append(f"trace_windows.jsonl:{ln}: field {k!r} missing or non-int")
            if not isinstance(row.get("dropped_by_cluster"), dict):
                errors.append(f"trace_windows.jsonl:{ln}: dropped_by_cluster must be a map")
            if isinstance(row.get("window"), int):
                if row["window"] != prev + 1:
                    errors.append(f"trace_windows.jsonl:{ln}: window index {row['window']} "
                                  f"(expected {prev + 1})")
                prev = row["window"]
    return errors


def validate(directory: str) -> list[str]:
    """Check a telemetry directory against the schema: the manifest, the
    window, perf and trace streams, every flight file and the health plane's
    files (`validate_health_files`). Returns the problems found ([] =
    valid)."""
    man_path = os.path.join(directory, "manifest.json")
    if not os.path.isfile(man_path):
        return [f"missing manifest.json in {directory}"]
    try:
        with open(man_path) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        return [f"manifest.json unreadable: {ex}"]
    errors = [f"manifest.json: missing field {k!r}" for k in MANIFEST_FIELDS if k not in man]
    if man.get("schema_version") != TELEMETRY_SCHEMA_VERSION:
        errors.append(
            f"manifest.json: schema_version {man.get('schema_version')!r}, "
            f"expected {TELEMETRY_SCHEMA_VERSION}")
    if "config" in man:
        try:
            cfg = RaftConfig(**man["config"])
            if "config_hash" in man and config_hash(cfg) != man["config_hash"]:
                errors.append("manifest.json: config_hash does not match config")
        except (TypeError, AssertionError) as ex:
            errors.append(f"manifest.json: config does not load: {ex}")

    win_path = os.path.join(directory, "windows.jsonl")
    if not os.path.isfile(win_path):
        errors.append("missing windows.jsonl")
        return errors
    errors += _validate_windows(win_path)

    perf_path = os.path.join(directory, "perf.jsonl")
    if os.path.isfile(perf_path):
        errors += _validate_perf(perf_path)
    errors += _validate_trace(directory)
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("flight_") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(directory, name)) as f:
            for ln, raw in enumerate(f, 1):
                try:
                    row = json.loads(raw)
                except json.JSONDecodeError as ex:
                    errors.append(f"{name}:{ln}: not JSON: {ex}")
                    continue
                missing = [k for k in ("tick", *StepInfo._fields) if k not in row]
                if missing:
                    errors.append(f"{name}:{ln}: missing fields {missing}")
    return errors + validate_health_files(directory)


def _validate_health(path: str) -> list[str]:
    errors = []
    prev_eval: dict[str, int] = {}
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"health.jsonl:{ln}: not JSON: {ex}")
                continue
            errors += [f"health.jsonl:{ln}: field {k!r} missing or non-int"
                       for k in _int_fields(row, HEALTH_INT_FIELDS)]
            scope = row.get("scope")
            if not isinstance(scope, str) or not scope:
                errors.append(f"health.jsonl:{ln}: scope missing")
                scope = "?"
            if row.get("status") not in HEALTH_STATUSES:
                errors.append(f"health.jsonl:{ln}: status {row.get('status')!r} "
                              f"(have: {', '.join(HEALTH_STATUSES)})")
            for k in ("slis", "burn"):
                if not isinstance(row.get(k), dict):
                    errors.append(f"health.jsonl:{ln}: {k} must be a map")
            if isinstance(row.get("eval"), int):
                want = prev_eval.get(scope, -1) + 1
                if row["eval"] != want:
                    errors.append(f"health.jsonl:{ln}: scope {scope!r} eval {row['eval']} "
                                  f"(expected {want})")
                prev_eval[scope] = row["eval"]
    return errors


def _validate_alerts(directory: str, path: str) -> tuple[list[str], list[str]]:
    """(problems, evidence dirs named) of alerts.jsonl."""
    errors, named = [], []
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"alerts.jsonl:{ln}: not JSON: {ex}")
                continue
            if _int_fields(row, ("eval",)):
                errors.append(f"alerts.jsonl:{ln}: field 'eval' missing or non-int")
            for k in ("scope", "objective", "rule"):
                if not isinstance(row.get(k), str) or not row.get(k):
                    errors.append(f"alerts.jsonl:{ln}: field {k!r} missing")
            if row.get("state") not in ALERT_STATES:
                errors.append(f"alerts.jsonl:{ln}: state {row.get('state')!r} "
                              f"(have: {', '.join(ALERT_STATES)})")
            errors += [f"alerts.jsonl:{ln}: field {k!r} missing or not a non-negative number"
                       for k in ALERT_FLOAT_FIELDS if _bad_number(row.get(k))]
            wc = row.get("worst_clusters")
            if not isinstance(wc, list) or not all(
                    isinstance(w, dict) and isinstance(w.get("cluster"), int) for w in wc):
                errors.append(f"alerts.jsonl:{ln}: worst_clusters must be a list of "
                              "{cluster, value, score} maps")
            ev = row.get("evidence")
            if ev is not None:
                if not isinstance(ev, str):
                    errors.append(f"alerts.jsonl:{ln}: evidence must be a dir name or null")
                else:
                    named.append(ev)
                    if not os.path.isdir(os.path.join(directory, ev)):
                        errors.append(f"alerts.jsonl:{ln}: evidence dir {ev} missing")
            if row.get("state") == "firing" and ev is None:
                errors.append(f"alerts.jsonl:{ln}: firing alert carries no evidence")
    return errors, named


def validate_health_files(directory: str) -> list[str]:
    """Check a directory's health.jsonl, alerts.jsonl and evidence bundles
    ([] = valid, also when there are none). Farm out-dirs, which carry the
    farm manifest and no telemetry manifest, check theirs through it too
    (farm/core.py validate_farm_dir)."""
    from raft_sim_tpu_torch.health.evidence import validate_bundle

    errors = []
    health_path = os.path.join(directory, "health.jsonl")
    alerts_path = os.path.join(directory, "alerts.jsonl")
    if os.path.isfile(health_path):
        if not os.path.isfile(alerts_path):
            errors.append("health.jsonl present but alerts.jsonl missing")
        errors += _validate_health(health_path)
    named: list[str] = []
    if os.path.isfile(alerts_path):
        alert_errors, named = _validate_alerts(directory, alerts_path)
        errors += alert_errors
    for name in sorted(os.listdir(directory)):
        if name.startswith("evidence_") and os.path.isdir(os.path.join(directory, name)):
            errors += validate_bundle(os.path.join(directory, name))
            if name not in named:
                errors.append(f"{name}: evidence bundle not named by any alerts.jsonl row")
    return errors


# --------------------------------------------------------------- multichip
# The multi-device proof artifact (raft_sim_tpu_torch/multihost_check.py
# --out): one diffable row. `throughput_ticks_per_s` is cluster-ticks/s of
# the sharded run on the machine that ran it; `per_device_bytes_per_tick`
# the bytes one shard's slice moves a tick; `parity_hash` the sha256 of the
# gathered metrics' JSON, equal across the multi-process run and the
# single-process reference when (and only when) the trajectories matched.
MULTICHIP_SCHEMA = "multichip-v2"
MULTICHIP_INT_FIELDS = ("n_devices", "n_processes", "batch", "ticks", "violations")
MULTICHIP_BOOL_FIELDS = ("match",)
MULTICHIP_FLOAT_FIELDS = ("throughput_ticks_per_s", "per_device_bytes_per_tick")
MULTICHIP_STR_FIELDS = ("schema", "platform", "parity_hash")


def validate_multichip(path: str) -> list[str]:
    """Schema-check a multichip artifact ([] = valid). A legacy rc-only stub
    (no "schema" key) is reported as legacy, not passed."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        return [f"{path}: unreadable: {ex}"]
    if "schema" not in doc:
        return [f"{path}: legacy rc-only stub (pre-{MULTICHIP_SCHEMA}); regenerate with "
                "python -m raft_sim_tpu_torch.multihost_check --out"]
    errors = []
    if doc.get("schema") != MULTICHIP_SCHEMA:
        errors.append(f"{path}: schema {doc.get('schema')!r}, expected {MULTICHIP_SCHEMA}")
    for k in MULTICHIP_INT_FIELDS:
        if not isinstance(doc.get(k), int) or doc.get(k) is True:
            errors.append(f"{path}: field {k!r} missing or non-int")
    for k in MULTICHIP_BOOL_FIELDS:
        if not isinstance(doc.get(k), bool):
            errors.append(f"{path}: field {k!r} missing or non-bool")
    for k in MULTICHIP_FLOAT_FIELDS:
        v = doc.get(k)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            errors.append(f"{path}: field {k!r} missing or not a non-negative number")
    for k in MULTICHIP_STR_FIELDS:
        if not isinstance(doc.get(k), str) or not doc.get(k):
            errors.append(f"{path}: field {k!r} missing or empty")
    ph = doc.get("parity_hash")
    if isinstance(ph, str) and len(ph) != 64:
        errors.append(f"{path}: parity_hash must be a sha256 hex digest")
    return errors


def read_windows(directory: str) -> list[dict]:
    """Load windows.jsonl as a list of dicts (validation is separate)."""
    with open(os.path.join(directory, "windows.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)
