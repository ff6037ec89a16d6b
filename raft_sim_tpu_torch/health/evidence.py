"""Evidence bundles: a firing alert captures its own forensics (the port of
raft_sim_tpu/health/evidence.py; the files are the JAX package's, byte for
byte).

The repo's post-hoc planes (flight recorder, protocol traces, perf rows)
answer "what happened" only if someone was already recording the right
cluster. A firing alert closes that loop: the monitor snapshots the live
flight-recorder ring for each named cluster (host-side ring read -- the
device carry is untouched), gathers the evaluation period's per-cluster
window rows and perf rows, and freezes them under the telemetry directory:

    evidence_NNNN/
      alert.json        the alert row + its objective spec + run refs
                        (config_hash/seed/checkpoint) + a file inventory
      windows.jsonl     per-(cluster, window) counters for the named
                        clusters over the firing eval period
      perf.jsonl        the period's runtime attribution rows, verbatim
      flight_<c>.jsonl  per-tick StepInfo snapshot of cluster c's ring at
                        alert time (same line schema as the sink's
                        violation flights -- metrics_report renders both)

validate_bundle is the dependency-free schema check, folded into
telemetry_sink.validate for any evidence dir an alert names.
"""

from __future__ import annotations

import json
import os

import numpy as np

EVIDENCE_SCHEMA = "health-evidence-v1"

# Required integer fields of an evidence windows.jsonl row (per cluster per
# window -- unlike the sink's fleet-aggregated stream, these keep the
# cluster axis: the whole point is per-culprit forensics).
EVIDENCE_WINDOW_FIELDS = (
    "window", "start", "ticks", "cluster", "violations", "cmds", "reads",
    "lat_cnt", "lat_sum", "fsync_lag_sum", "fsync_lag_max",
)


def window_rows_for(units: list[dict], clusters: list[int],
                    first_window: int, cluster_base: int = 0) -> list[dict]:
    """Per-(cluster, window) evidence rows for the named clusters out of one
    eval period's window units (cluster ids are fleet-global; units are
    indexed locally from cluster_base)."""
    rows = []
    for w, u in enumerate(units):
        for c in clusters:
            i = c - cluster_base
            if not 0 <= i < len(u["violations"]):
                continue
            rows.append({
                "window": first_window + w,
                "start": int(u["start"]),
                "ticks": int(u["ticks"]),
                "cluster": int(c),
                "violations": int(u["violations"][i]),
                "leaderless": bool(u["leaderless"][i]),
                "cmds": int(u["cmds"][i]),
                "reads": int(u["reads"][i]),
                "lat_cnt": int(u["lat_cnt"][i]),
                "lat_sum": int(u["lat_sum"][i]),
                "lat_hist": [int(x) for x in np.asarray(u["lat_hist"][i])],
                "fsync_lag_sum": int(u["fsync_lag_sum"][i]),
                "fsync_lag_max": int(u["fsync_lag_max"][i]),
            })
    return rows


def write_bundle(
    directory: str,
    alert: dict,
    objective: dict,
    window_rows: list[dict],
    perf_rows: list[dict],
    flights: dict | None = None,
    refs: dict | None = None,
) -> str:
    """Write one bundle. `flights` maps global cluster id -> (ticks, StepInfo)
    as returned by telemetry.export_cluster; `refs` carries run identity
    (config_hash, seed, checkpoint path...). Returns the directory.

    Everything handed in must already be HOST data: the capture hooks copy
    the rings they name (telemetry.export_cluster) at capture time."""
    from raft_sim_tpu_torch.utils.telemetry_sink import flight_lines

    os.makedirs(directory, exist_ok=True)
    files = ["alert.json", "windows.jsonl", "perf.jsonl"]
    with open(os.path.join(directory, "windows.jsonl"), "w") as f:
        for row in window_rows:
            f.write(json.dumps(row) + "\n")
    with open(os.path.join(directory, "perf.jsonl"), "w") as f:
        for row in perf_rows:
            f.write(json.dumps(row) + "\n")
    for c, (ticks, infos) in sorted((flights or {}).items()):
        name = f"flight_{c}.jsonl"
        with open(os.path.join(directory, name), "w") as f:
            for line in flight_lines(ticks, infos):
                f.write(json.dumps(line) + "\n")
        files.append(name)
    doc = {
        "schema": EVIDENCE_SCHEMA,
        "alert": alert,
        "objective": objective,
        "refs": refs or {},
        "files": sorted(files),
    }
    with open(os.path.join(directory, "alert.json"), "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return directory


def validate_bundle(directory: str) -> list[str]:
    """Schema-check one evidence bundle ([] = valid): alert.json identity,
    the file inventory actually on disk, windows.jsonl field types, and
    flight files carrying full StepInfo rows."""
    from raft_sim_tpu_torch.types import StepInfo

    errors = []
    base = os.path.basename(directory.rstrip(os.sep))
    path = os.path.join(directory, "alert.json")
    if not os.path.isfile(path):
        return [f"{base}: missing alert.json"]
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        return [f"{base}/alert.json unreadable: {ex}"]
    if doc.get("schema") != EVIDENCE_SCHEMA:
        errors.append(
            f"{base}/alert.json: schema {doc.get('schema')!r}, expected "
            f"{EVIDENCE_SCHEMA}"
        )
    alert = doc.get("alert")
    if not isinstance(alert, dict):
        errors.append(f"{base}/alert.json: alert must be a map")
        alert = {}
    for k in ("objective", "rule", "state", "scope"):
        if not isinstance(alert.get(k), str) or not alert.get(k):
            errors.append(f"{base}/alert.json: alert.{k} missing")
    if not isinstance(doc.get("objective"), dict):
        errors.append(f"{base}/alert.json: objective spec missing")
    files = doc.get("files")
    if not isinstance(files, list):
        errors.append(f"{base}/alert.json: files inventory missing")
        files = []
    for name in files:
        if not os.path.isfile(os.path.join(directory, name)):
            errors.append(f"{base}: inventoried file {name} missing on disk")
    win_path = os.path.join(directory, "windows.jsonl")
    if os.path.isfile(win_path):
        with open(win_path) as f:
            for ln, raw in enumerate(f, 1):
                try:
                    row = json.loads(raw)
                except json.JSONDecodeError as ex:
                    errors.append(f"{base}/windows.jsonl:{ln}: not JSON: {ex}")
                    continue
                for k in EVIDENCE_WINDOW_FIELDS:
                    if not isinstance(row.get(k), int) or row.get(k) is True:
                        errors.append(
                            f"{base}/windows.jsonl:{ln}: field {k!r} missing "
                            "or non-int"
                        )
                if not isinstance(row.get("leaderless"), bool):
                    errors.append(
                        f"{base}/windows.jsonl:{ln}: leaderless must be bool"
                    )
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("flight_") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(directory, name)) as f:
            for ln, raw in enumerate(f, 1):
                try:
                    row = json.loads(raw)
                except json.JSONDecodeError as ex:
                    errors.append(f"{base}/{name}:{ln}: not JSON: {ex}")
                    continue
                missing = [
                    k for k in ("tick", *StepInfo._fields) if k not in row
                ]
                if missing:
                    errors.append(f"{base}/{name}:{ln}: missing fields {missing}")
    return errors
