"""Findings schema and waiver engine of the port's analyzer (the port of
the JAX package's analysis/findings.py).

A *finding* is one rule violation, anchored either to a source line
(`path:line`, the source passes) or to an audited program (`path` like
`ops:config5/step_b`, line 0). Intentional exceptions live in this
package's own waiver file (`analysis/waivers.json`): each entry names the
rule, the path, an optional `contains` substring of the message, and a
one-line justification. `python -m raft_sim_tpu_torch check` exits nonzero
on any unwaived finding; waived findings stay in the JSON report with their
justification. A report records the torch version the analyzer ran under
(`torch_version`) where the JAX one records `jax_version`.
"""

from __future__ import annotations

import dataclasses
import json
import os

FINDINGS_SCHEMA_VERSION = 1

# Required fields of one serialized finding (validate() enforces).
FINDING_FIELDS = ("rule", "path", "line", "message", "waived", "waiver_reason")

# Required fields of a waiver entry. `contains` is optional.
WAIVER_FIELDS = ("rule", "path", "reason")


@dataclasses.dataclass
class Finding:
    """One rule violation. `line` 0 = not anchored to a source line."""

    rule: str
    path: str
    message: str
    line: int = 0
    waived: bool = False
    waiver_reason: str = ""

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": int(self.line),
            "message": self.message,
            "waived": bool(self.waived),
            "waiver_reason": self.waiver_reason,
        }

    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path


def load_waivers(path: str) -> tuple[list[dict], list[str]]:
    """Read a waiver file; returns (entries, problems). A missing file is an
    empty waiver set; a malformed one is all problems -- a typo'd waiver
    must fail loudly, not silently stop waiving."""
    if not os.path.isfile(path):
        return [], []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        return [], [f"{path}: unreadable: {ex}"]
    problems = []
    if doc.get("schema_version") != FINDINGS_SCHEMA_VERSION:
        problems.append(
            f"{path}: schema_version {doc.get('schema_version')!r}, "
            f"expected {FINDINGS_SCHEMA_VERSION}"
        )
    entries = doc.get("waivers")
    if not isinstance(entries, list):
        return [], problems + [f"{path}: 'waivers' must be a list"]
    ok = []
    for i, w in enumerate(entries):
        if not isinstance(w, dict):
            problems.append(f"{path}: waiver[{i}]: must be an object, got {type(w).__name__}")
            continue
        for k in WAIVER_FIELDS:
            if not isinstance(w.get(k), str) or not w.get(k):
                problems.append(f"{path}: waiver[{i}]: field {k!r} missing or empty")
        if "contains" in w and not isinstance(w["contains"], str):
            problems.append(f"{path}: waiver[{i}]: 'contains' must be a string")
        ok.append(w)
    return ok, problems


def apply_waivers(findings: list[Finding], waivers: list[dict]) -> list[dict]:
    """Mark findings matched by a waiver (rule and path equal, and the
    optional `contains` substring in the message). Returns the waiver entries
    that matched nothing: stale waivers are surfaced, so the file cannot
    silently accumulate dead exceptions."""
    used = [False] * len(waivers)
    for f in findings:
        for i, w in enumerate(waivers):
            if w.get("rule") != f.rule or w.get("path") != f.path:
                continue
            if w.get("contains") and w["contains"] not in f.message:
                continue
            f.waived = True
            f.waiver_reason = w.get("reason", "")
            used[i] = True
            break
    return [w for w, u in zip(waivers, used) if not u]


def report(findings: list[Finding], *, unused_waivers=(), extras=None) -> dict:
    """The full JSON report document."""
    import torch

    unwaived = [f for f in findings if not f.waived]
    doc = {
        "schema_version": FINDINGS_SCHEMA_VERSION,
        "torch_version": torch.__version__,
        "n_findings": len(findings),
        "n_unwaived": len(unwaived),
        "n_waived": len(findings) - len(unwaived),
        "unused_waivers": list(unused_waivers),
        "findings": [f.to_json() for f in findings],
    }
    if extras:
        doc.update(extras)
    return doc


def validate(doc: dict) -> list[str]:
    """Check a report document against the schema. Returns human-readable
    problems ([] = valid)."""
    errors = []
    if doc.get("schema_version") != FINDINGS_SCHEMA_VERSION:
        errors.append(
            f"schema_version {doc.get('schema_version')!r}, "
            f"expected {FINDINGS_SCHEMA_VERSION}"
        )
    for k in ("n_findings", "n_unwaived", "n_waived"):
        if not isinstance(doc.get(k), int):
            errors.append(f"field {k!r} missing or non-int")
    rows = doc.get("findings")
    if not isinstance(rows, list):
        return errors + ["'findings' must be a list"]
    for i, row in enumerate(rows):
        for k in FINDING_FIELDS:
            if k not in row:
                errors.append(f"findings[{i}]: missing field {k!r}")
        if not isinstance(row.get("line"), int):
            errors.append(f"findings[{i}]: 'line' must be an int")
        if not isinstance(row.get("waived"), bool):
            errors.append(f"findings[{i}]: 'waived' must be a bool")
    if isinstance(doc.get("n_findings"), int) and doc["n_findings"] != len(rows):
        errors.append("n_findings does not match len(findings)")
    if isinstance(doc.get("n_unwaived"), int):
        actual = sum(1 for r in rows if not r.get("waived", False))
        if doc["n_unwaived"] != actual:
            errors.append("n_unwaived does not match the findings list")
    return errors


def dedupe(findings: list[Finding]) -> list[Finding]:
    """The findings without repeats (same rule, path, line and message)."""
    seen, out = set(), []
    for f in findings:
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
