"""Host-side telemetry sink: the schema'd on-disk record of a run (the port of
raft_sim_tpu/utils/telemetry_sink.py: the manifest, window, flight and
summary half). The files are the JAX package's, line for line:

    <dir>/manifest.json      run identity: schema version, full config and its
                             hash, seed, batch, window and ring sizes, and the
                             software that wrote it
    <dir>/windows.jsonl      one line per telemetry window, fleet-aggregated
                             (sim/telemetry.py WindowRecord)
    <dir>/flight_<c>.jsonl   the flight recorder's last K ticks of cluster c
                             (violating clusters only): every StepInfo field
    <dir>/summary.json       the end-of-run FleetSummary rollup plus extras

Every line is JSON with integer-exact values, so two runs diff as text and
`validate()` checks a directory without a schema library. The JAX package's
`validate()` accepts the port's directories: the manifest carries every
field it requires, with `jax_version` null (the port imports no jax),
`torch_version` beside it, and the device type (`cuda` or `cpu`) as
`backend`. The trace, perf and health streams are not written by the port
yet (ROADMAP items 14 and 18); this `validate()` reports such a file as
unchecked rather than passing it.
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

# Streams of the JAX sink the port neither writes nor checks yet.
UNCHECKED_STREAMS = {
    "trace.jsonl": "ROADMAP item 14", "trace_windows.jsonl": "ROADMAP item 14",
    "trace_meta.json": "ROADMAP item 14", "perf.jsonl": "ROADMAP item 18",
    "health.jsonl": "ROADMAP item 18", "alerts.jsonl": "ROADMAP item 18",
}


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
                name == "summary.json" or name in UNCHECKED_STREAMS
            ):
                os.remove(p)

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


def validate(directory: str) -> list[str]:
    """Check a telemetry directory against the schema: the manifest, the
    window stream and every flight file. Returns the problems found ([] =
    valid). A stream the port does not check yet (trace, perf, health) is
    reported, never passed over."""
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

    for name in sorted(os.listdir(directory)):
        if name in UNCHECKED_STREAMS:
            errors.append(f"{name}: not checked by this package yet ({UNCHECKED_STREAMS[name]})")
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
    return errors


def read_windows(directory: str) -> list[dict]:
    """Load windows.jsonl as a list of dicts (validation is separate)."""
    with open(os.path.join(directory, "windows.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)
