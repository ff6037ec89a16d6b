"""Declarative SLO specs: what "healthy" means, as data (the port of
raft_sim_tpu/health/spec.py: the same schema, default spec and messages).

A spec is a plain JSON document (schema `health-slo-v1`) naming objectives
over the SLIs the fleet already exports -- the telemetry windows' per-cluster
counters (sim/telemetry.py) and the perf.jsonl runtime rows (obs/timer.py).
Nothing here touches traced code: the health plane consumes streams the loops
were already producing, so an instrumented run is bit-exact vs a plain one.

    {
      "schema": "health-slo-v1",
      "eval_windows": 2,          # telemetry windows per evaluation period
      "worst_k": 3,               # clusters named per firing alert (triage)
      "outlier_score": 3.0,       # robust-score threshold for "outlier" label
      "resolve_evals": 2,         # clean evals before firing -> resolved
      "objectives": { name: {"sli": kind, ...params} },
      "rules":      [ {"name", "short", "long", "burn"} ]   # burn-rate pairs
    }

Objective params by SLI kind (sli.py computes them):

    availability       target           good = 1 - leaderless-window fraction
    commit_latency     threshold_ticks, target
                                        good = commits acked in < threshold
    read_staleness     stale_after_ticks, target
                                        good = reads served in < threshold
    throughput         min_ops_per_window, budget
                                        binary: ops/window under the floor
                                        burns `budget` (floor 0 = disabled)
    safety             (none)           budget 0: ANY violation is an
                                        instant max-burn page
    device_wait_share  min_share, budget
                                        binary: device-wait share of wall
                                        under the floor = the loop is host-
                                        starved (floor 0 = disabled; CPU
                                        images have no meaningful share)
    recompiles         (none)           budget 0: a steady-state chunk that
                                        recompiled is an instant page (the
                                        chunk timer's watchdog as an alert)
    durability_lag     max_lag, budget  binary: any window where a node's
                                        fsync lag (log entries not yet
                                        durable, storage plane) exceeded the
                                        ceiling burns `budget` (ceiling 0 =
                                        disabled; all-zero lag when the
                                        plane is off)

Ratio objectives burn error budget `1 - target`; binary objectives carry an
explicit `budget` (the tolerated trip fraction); budget-0 objectives page on
the first bad eval. Per-objective overrides: `pending_evals` (consecutive met
evals before pending -> firing; default 1, i.e. fire on the 2nd), and
`resolve_evals`. Burn-rate semantics live in burn.py.
"""

from __future__ import annotations

import copy
import json

HEALTH_SPEC_SCHEMA = "health-slo-v1"

SLI_KINDS = (
    "availability",
    "commit_latency",
    "read_staleness",
    "throughput",
    "safety",
    "device_wait_share",
    "recompiles",
    "durability_lag",
)

# The default spec is deliberately quiet on a healthy run of ANY preset:
# the latency/availability targets sit well under what every config tier
# sustains, and the floors that would need per-preset tuning (throughput,
# device-wait share) ship disabled (0) -- a spec file turns them on.
DEFAULT_SPEC = {
    "schema": HEALTH_SPEC_SCHEMA,
    "eval_windows": 2,
    "worst_k": 3,
    "outlier_score": 3.0,
    "resolve_evals": 2,
    "objectives": {
        "availability": {"sli": "availability", "target": 0.9},
        "commit_latency": {
            "sli": "commit_latency", "threshold_ticks": 16, "target": 0.99,
        },
        "read_staleness": {
            "sli": "read_staleness", "stale_after_ticks": 16, "target": 0.99,
        },
        "throughput": {
            "sli": "throughput", "min_ops_per_window": 0, "budget": 0.25,
        },
        "safety": {"sli": "safety", "pending_evals": 0},
        "device_wait": {
            "sli": "device_wait_share", "min_share": 0.0, "budget": 0.25,
        },
        "recompile": {"sli": "recompiles", "pending_evals": 0},
        "durability": {"sli": "durability_lag", "max_lag": 0, "budget": 0.25},
    },
    # Google SRE Workbook ch.5 shape: a fast pair that pages on a steep burn
    # within ~2 eval periods, and a slow pair that catches a 1x bleed over a
    # longer horizon. Windows are counted in EVAL PERIODS, not wall time --
    # the fleet's clock is the telemetry window.
    "rules": [
        {"name": "fast", "short": 1, "long": 2, "burn": 6.0},
        {"name": "slow", "short": 2, "long": 8, "burn": 1.0},
    ],
}


def validate_spec(spec) -> list[str]:
    """Schema-check a spec document ([] = valid): same dependency-free style
    as telemetry_sink.validate -- the schema IS this function."""
    errors = []
    if not isinstance(spec, dict):
        return ["spec must be a JSON object"]
    if spec.get("schema") != HEALTH_SPEC_SCHEMA:
        errors.append(
            f"schema {spec.get('schema')!r}, expected {HEALTH_SPEC_SCHEMA}"
        )
    for k in ("eval_windows", "worst_k", "resolve_evals"):
        v = spec.get(k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            errors.append(f"{k} must be an int >= 1")
    v = spec.get("outlier_score")
    if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
        errors.append("outlier_score must be a positive number")
    objectives = spec.get("objectives")
    if not isinstance(objectives, dict) or not objectives:
        errors.append("objectives must be a non-empty map")
        objectives = {}
    for name, obj in objectives.items():
        if not isinstance(obj, dict):
            errors.append(f"objective {name!r} must be a map")
            continue
        kind = obj.get("sli")
        if kind not in SLI_KINDS:
            errors.append(
                f"objective {name!r}: sli {kind!r} (have: {', '.join(SLI_KINDS)})"
            )
            continue
        if kind in ("availability", "commit_latency", "read_staleness"):
            t = obj.get("target")
            if not isinstance(t, (int, float)) or isinstance(t, bool) \
                    or not 0 <= t < 1:
                errors.append(
                    f"objective {name!r}: target must be a number in [0, 1)"
                )
        if kind in ("commit_latency",) and not _pos_int(obj.get("threshold_ticks")):
            errors.append(f"objective {name!r}: threshold_ticks must be int >= 1")
        if kind in ("read_staleness",) and not _pos_int(obj.get("stale_after_ticks")):
            errors.append(f"objective {name!r}: stale_after_ticks must be int >= 1")
        if kind in ("throughput", "device_wait_share", "durability_lag"):
            b = obj.get("budget")
            if not isinstance(b, (int, float)) or isinstance(b, bool) or not 0 < b <= 1:
                errors.append(f"objective {name!r}: budget must be in (0, 1]")
        if kind == "durability_lag":
            ml = obj.get("max_lag")
            if not isinstance(ml, int) or isinstance(ml, bool) or ml < 0:
                errors.append(f"objective {name!r}: max_lag must be int >= 0")
        pe = obj.get("pending_evals")
        if pe is not None and (not isinstance(pe, int) or isinstance(pe, bool) or pe < 0):
            errors.append(f"objective {name!r}: pending_evals must be int >= 0")
    rules = spec.get("rules")
    if not isinstance(rules, list) or not rules:
        errors.append("rules must be a non-empty list")
        rules = []
    names = set()
    for i, r in enumerate(rules):
        if not isinstance(r, dict):
            errors.append(f"rules[{i}] must be a map")
            continue
        if not isinstance(r.get("name"), str) or not r.get("name"):
            errors.append(f"rules[{i}]: name missing")
        elif r["name"] in names:
            errors.append(f"rules[{i}]: duplicate rule name {r['name']!r}")
        else:
            names.add(r["name"])
        if not _pos_int(r.get("short")) or not _pos_int(r.get("long")):
            errors.append(f"rules[{i}]: short/long must be ints >= 1")
        elif r["short"] > r["long"]:
            errors.append(
                f"rules[{i}]: short window {r['short']} > long window "
                f"{r['long']} -- the fast confirmation must be the shorter one"
            )
        b = r.get("burn")
        if not isinstance(b, (int, float)) or isinstance(b, bool) or b <= 0:
            errors.append(f"rules[{i}]: burn must be a positive number")
    return errors


def _pos_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def load_spec(arg: str | dict | None = None) -> dict:
    """Resolve a --health argument to a validated spec dict: None/"default"
    -> a copy of DEFAULT_SPEC; a path -> its JSON; a dict -> itself (tests).
    Raises ValueError naming every schema problem, so a bad spec fails at
    arm time, not mid-soak."""
    if arg is None or arg == "default":
        spec = copy.deepcopy(DEFAULT_SPEC)
    elif isinstance(arg, dict):
        spec = arg
    else:
        with open(arg) as f:
            spec = json.load(f)
    errors = validate_spec(spec)
    if errors:
        raise ValueError(
            "invalid health spec: " + "; ".join(errors)
        )
    return spec
