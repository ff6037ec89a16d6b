"""Render and diff telemetry runs (the port of tools/metrics_report.py, the
host sink's consumer).

Reads the schema the sink writes (utils/telemetry_sink.py; `run
--telemetry-dir`, `bench --telemetry-dir`, `serve --sink`), which both
packages write byte for byte, and renders it: a run header from the
manifest, the run totals re-summed from the integer window stream, a tail
of the window table, and flight recordings through `sim/trace.info_lines`.
On the same directory its text equals the JAX tool's. `--diff` compares two
runs -- two telemetry directories, or a telemetry directory against a bench
document (the port's `bench --out`, or a BENCH_*.json) -- on their quality
fields; throughput is compared only between runs of one backend.

    python -m raft_sim_tpu_torch.metrics_report out/telemetry             # summary table
    python -m raft_sim_tpu_torch.metrics_report out/telemetry --validate  # schema check
    python -m raft_sim_tpu_torch.metrics_report out/telemetry --flight 7  # a recording
    python -m raft_sim_tpu_torch.metrics_report out/telemetry --trace     # protocol trace
    python -m raft_sim_tpu_torch.metrics_report out/telemetry --health    # SLOs, alerts
    python -m raft_sim_tpu_torch.metrics_report out/telemetry --perf      # chunk timer
    python -m raft_sim_tpu_torch.metrics_report --perf measurement.json   # the bench's pass
    python -m raft_sim_tpu_torch.metrics_report --multichip check.json    # multihost_check
    python -m raft_sim_tpu_torch.metrics_report --diff out/a out/b

`--perf` reconciles against the card's roofline for K1's bytes
(obs/reconcile.py); `--perf FILE` renders the port's measurement-pass
document (`bench --measurement-pass --out FILE`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

from raft_sim_tpu_torch.summary import _hist_percentile
from raft_sim_tpu_torch.types import LAT_HIST_BINS, StepInfo
from raft_sim_tpu_torch.utils import telemetry_sink as sink

# Throughput fields: compared only between runs of one backend.
THROUGHPUT = ("cluster_ticks_per_s", "steady_ticks_per_s", "repeat_cv",
              "predicted_roofline_ticks_per_s", "roofline_headroom")


def bench_matrix(doc: dict) -> dict:
    """Matrix rows of a bench document: `parsed` of a captured-stdout
    wrapper ({n, cmd, rc, tail, parsed}), else a top-level `matrix`, else
    the whole rows that survive in a byte-truncated `tail`."""
    parsed = doc.get("parsed")
    if isinstance(parsed, dict) and isinstance(parsed.get("matrix"), dict):
        return dict(parsed["matrix"])
    if isinstance(doc.get("matrix"), dict):
        return dict(doc["matrix"])
    dec = json.JSONDecoder()
    tail = doc.get("tail") or ""
    rows = {}
    for mt in re.finditer(r'"(config[A-Za-z0-9_]*)":\s*\{', tail):
        try:
            row, _ = dec.raw_decode(tail[mt.end() - 1:])
        except json.JSONDecodeError:
            continue
        if isinstance(row, dict) and "cluster_ticks_per_s" in row:
            rows[mt.group(1)] = row
    return rows


def _merge_windows(rows: list[dict]) -> dict:
    """Fold the window stream back into run totals (exact: the stream carries
    integer sums, so re-summing is lossless)."""
    if not rows:
        return {}
    hist = np.zeros(LAT_HIST_BINS, np.int64)
    rhist = np.zeros(LAT_HIST_BINS, np.int64)
    tot = {k: 0 for k in ("violations", "msgs", "cmds", "lat_sum", "lat_cnt",
                          "lat_excluded", "noop_blocked", "lm_skipped_pairs",
                          "multi_leader", "reads", "read_lat_sum", "ticks")}
    first_viol = None
    mx = {"max_term": 0, "max_commit": 0}
    for r in rows:
        for k in tot:
            if k in ("reads", "read_lat_sum"):
                # Only the v3 read-class keys may be absent (pre-v3 lines,
                # BENCH_r* rows); a missing CORE key is corruption and must
                # keep raising, not merge as zero.
                tot[k] += r.get(k, 0)
            else:
                tot[k] += r[k]
        for k in mx:
            mx[k] = max(mx[k], r[k])
        hist += np.asarray(r["lat_hist"], np.int64)
        # Pre-v3 window lines carry no read traffic class: treat as zero.
        rhist += np.asarray(r.get("read_hist", [0] * LAT_HIST_BINS), np.int64)
        if first_viol is None and r.get("first_viol_tick") is not None:
            first_viol = r["first_viol_tick"]
    out = tot | mx
    out["first_viol_tick"] = first_viol
    out["lat_p50"] = _hist_percentile(hist, 0.50)
    out["lat_p95"] = _hist_percentile(hist, 0.95)
    out["lat_p99"] = _hist_percentile(hist, 0.99)
    out["mean_commit_latency"] = (
        round(tot["lat_sum"] / tot["lat_cnt"], 3) if tot["lat_cnt"] else None
    )
    out["read_p50"] = _hist_percentile(rhist, 0.50)
    out["read_p99"] = _hist_percentile(rhist, 0.99)
    out["mean_read_latency"] = (
        round(tot["read_lat_sum"] / tot["reads"], 3) if tot["reads"] else None
    )
    return out


def load_run(path: str, config: str | None = None) -> tuple[str, dict]:
    """(label, comparable-metrics dict) from a telemetry directory OR a bench
    JSON artifact (BENCH_*.json / `python bench.py` stdout saved to a file).
    For bench artifacts, `config` picks the matrix row (default: the headline
    workload)."""
    if os.path.isdir(path):
        # Same gate as the report path: a crash-truncated or malformed
        # directory gets the INVALID listing, not a raw traceback.
        errors = sink.validate(path)
        if errors:
            raise SystemExit(
                f"{path}: invalid telemetry directory:\n  " + "\n  ".join(errors)
            )
        man = sink.read_manifest(path)
        totals = _merge_windows(sink.read_windows(path))
        summary_path = os.path.join(path, "summary.json")
        if os.path.isfile(summary_path):
            # End-of-run rollup keys (p50_stable_tick, ...) that the window
            # stream alone cannot provide; window-derived totals win on clash.
            with open(summary_path) as f:
                totals = json.load(f) | totals
        label = (
            f"{path} [{man.get('source', '?')}: batch={man.get('batch')} "
            f"seed={man.get('seed')} cfg={man.get('config_hash', '?')[:8]}]"
        )
        return label, {**totals, "_backend": man.get("backend")}
    with open(path) as f:
        data = json.load(f)
    if "matrix" not in data and ("tail" in data or "parsed" in data):
        # BENCH_r*.json wrapper: a capture of bench.py's stdout ({n, cmd, rc,
        # tail, parsed}); the bench JSON line is `parsed` when present, else
        # embedded in the tail text -- which is a BYTE-truncated capture, so
        # recover whatever complete matrix rows survive in it.
        if data.get("parsed"):
            data = data["parsed"]
        else:
            rows = bench_matrix(data)
            if not rows:
                raise SystemExit(f"{path}: bench wrapper carries no recoverable rows")
            data = {"matrix": rows, "workload": None}
    if "matrix" in data:  # bench artifact
        name = config or data.get("workload") or next(iter(data["matrix"]))
        if name not in data["matrix"]:
            raise SystemExit(f"{path}: no matrix row {name!r} "
                             f"(have {sorted(data['matrix'])})")
        row = dict(data["matrix"][name])
        label = f"{path} [bench row {name}]"
        # Align bench field names with the telemetry totals where they mean
        # the same thing.
        row["cmds"] = row.pop("total_cmds", None)
        # Rows without a backend field come from the JAX bench's TPU runs.
        row["_backend"] = row.get("backend") or "tpu"
        return label, row
    raise SystemExit(f"{path}: neither a telemetry directory nor a bench artifact")


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:,.3f}".rstrip("0").rstrip(".")
    return f"{v:,}"


def report(directory: str, n_windows: int, out=None) -> None:
    man = sink.read_manifest(directory)
    rows = sink.read_windows(directory)
    totals = _merge_windows(rows)
    cfg = man.get("config", {})
    print(
        f"telemetry run: {directory}\n"
        f"  source={man.get('source')} schema=v{man.get('schema_version')} "
        f"backend={man.get('backend')} jax={man.get('jax_version')}\n"
        f"  config {man.get('config_hash')}: N={cfg.get('n_nodes')} "
        f"CAP={cfg.get('log_capacity')} batch={man.get('batch')} "
        f"seed={man.get('seed')} window={man.get('window')} "
        f"ring={man.get('ring')}",
        file=out,
    )
    if not rows:
        print("  (no windows recorded)", file=out)
        return
    print(f"\n  {len(rows)} windows, {totals['ticks']} ticks per cluster", file=out)
    keys = ("violations", "first_viol_tick", "msgs", "cmds", "max_commit",
            "mean_commit_latency", "lat_p50", "lat_p95", "lat_p99",
            "lat_excluded", "noop_blocked", "lm_skipped_pairs", "multi_leader",
            "reads", "mean_read_latency", "read_p50", "read_p99")
    for k in keys:
        print(f"  {k:22} {_fmt(totals.get(k)):>14}", file=out)

    tail = rows[-n_windows:]
    print(f"\n  last {len(tail)} windows:", file=out)
    cols = ("window", "start", "ticks", "violations", "msgs", "cmds",
            "lat_cnt", "lat_excluded")
    print("  " + " ".join(f"{c:>12}" for c in cols), file=out)
    for r in tail:
        print("  " + " ".join(f"{_fmt(r[c]):>12}" for c in cols), file=out)

    flights = sorted(
        f for f in os.listdir(directory)
        if f.startswith("flight_") and f.endswith(".jsonl")
    )
    if flights:
        print(
            f"\n  flight recordings: {', '.join(flights)} "
            f"(render with --flight <cluster>)",
            file=out,
        )


def render_flight(directory: str, cluster: int, out=None) -> None:
    """Rebuild the stacked StepInfo from a flight_<c>.jsonl and render it with
    the same decoder the live trace path uses (sim/trace.info_lines)."""
    from raft_sim_tpu_torch.sim import trace

    path = os.path.join(directory, f"flight_{cluster}.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if not rows:
        print(f"{path}: empty recording", file=out)
        return
    infos = StepInfo(*(np.asarray([r[f] for r in rows]) for f in StepInfo._fields))
    ticks = [r["tick"] for r in rows]
    print(f"flight recorder, cluster {cluster}: ticks {ticks[0]}..{ticks[-1]} "
          f"({len(rows)} captured; frozen at the first violation)", file=out)
    for t, line in zip(ticks, trace.info_lines(infos)):
        # info_lines numbers from 0 within the stack; re-anchor at the
        # recorder's absolute ticks.
        print(f"tick {t:>8}  {line[line.index('leader='):]}", file=out)


def report_trace(directory: str, clusters=None, limit: int = 40,
                 perfetto: str | None = None, out=None) -> None:
    """Render a directory's protocol trace (trace.jsonl) as per-cluster
    timelines, run the whole-history checker over it, and optionally export
    Chrome-trace/Perfetto JSON (`perfetto` path): one process per cluster,
    one track per node, instant events named by kind -- opens in
    ui.perfetto.dev next to the --profile captures (PR 8)."""
    from raft_sim_tpu_torch.trace import checker as tchecker
    from raft_sim_tpu_torch.trace import history as thistory

    hist = thistory.load(directory)
    if not hist.events:
        raise SystemExit(
            f"{directory}: no trace.jsonl events (run with --trace to record)"
        )
    total = sum(len(v) for v in hist.events.values())
    dropped = sum(hist.dropped.values())
    print(
        f"protocol trace: {directory}\n"
        f"  {total} events, {len(hist.events)} clusters, "
        f"{hist.n_windows} windows, {dropped} dropped"
        + ("" if hist.complete else "  [INCOMPLETE]"),
        file=out,
    )
    sel = sorted(hist.events) if clusters is None else list(clusters)
    for c in sel:
        evs = hist.events.get(c, [])
        if not evs:
            continue
        print(f"\n  cluster {c}: {len(evs)} events"
              + (f" ({hist.dropped.get(c, 0)} dropped)" if hist.dropped.get(c) else ""),
              file=out)
        lines = list(thistory.timeline_lines(hist, c))
        shown = lines if limit is None or len(lines) <= limit else lines[:limit]
        for line in shown:
            print(f"    {line}", file=out)
        if len(lines) > len(shown):
            print(f"    ... {len(lines) - len(shown)} more "
                  f"(--trace-limit 0 for all)", file=out)
    rep = tchecker.check_history(hist)
    print("\n  history checks:", file=out)
    for name, r in rep.results.items():
        verdict = {True: "ok", False: "VIOLATED", None: "undecided"}[r.ok]
        print(f"    {name:<22} {verdict}" + (f"  ({r.note})" if r.note else ""),
              file=out)
    if perfetto:
        doc = thistory.chrome_trace(hist, clusters=sel)
        with open(perfetto, "w") as f:
            json.dump(doc, f)
        print(f"\n  perfetto trace written: {perfetto} "
              f"({len(doc['traceEvents'])} events; open in ui.perfetto.dev)",
              file=out)


def report_perf_dir(directory: str, out=None) -> None:
    """Render a telemetry directory's perf.jsonl (obs.ChunkTimer rows): the
    per-chunk attribution table, the steady-state rollup, and the
    reconciliation of measured throughput against the card's roofline for
    K1's bytes."""
    from raft_sim_tpu_torch.obs import reconcile

    rows = reconcile.read_perf(directory)
    if not rows:
        raise SystemExit(
            f"{directory}: no perf.jsonl (run with --perf to record one)"
        )
    res = reconcile.reconcile_perf_dir(directory)
    s = res["summary"]
    print(f"perf stream: {directory} ({len(rows)} chunks, "
          f"{s['steady_chunks']} steady)", file=out)
    cols = ("chunk", "ticks", "wall_s", "dispatch_s", "host_s",
            "device_wait_s", "gap_s")
    print("  " + " ".join(f"{c:>13}" for c in cols) + "  flags", file=out)
    for r in rows:
        flags = "warmup" if r.get("warmup") else ""
        if r.get("recompiled"):
            flags += " RECOMPILED"
        print("  " + " ".join(f"{_fmt(r[c]):>13}" for c in cols)
              + f"  {flags}", file=out)
    print("\n  steady state:", file=out)
    for k in ("steady_ticks", "steady_wall_s", "steady_cluster_ticks_per_s",
              "device_wait_s", "host_gap_s", "host_gap_frac",
              "live_bytes_peak", "recompiled_after_warmup"):
        v = s.get(k)
        v = str(v) if isinstance(v, bool) else _fmt(v)
        print(f"  {k:28} {v:>14}", file=out)
    for name, size in (s.get("jit_cache_final") or {}).items():
        print(f"  kernel cache {name:28} {size}", file=out)
    _print_reconciliation([res["reconciliation"]], out=out)


def _print_reconciliation(rows: list[dict], out=None) -> None:
    print("\n  measured vs predicted (K1's bytes over the card's HBM peak):", file=out)
    cols = ("config", "measured_ticks_per_s", "predicted_roofline_ticks_per_s",
            "roofline_fraction", "achieved_bytes_per_s", "anchor")
    hdr = ("config", "measured t/s", "predicted t/s", "roofline frac",
           "achieved B/s", "anchor")
    print("  " + " ".join(f"{h:>16}" for h in hdr), file=out)
    for r in rows:
        vals = []
        for c in cols:
            v = r.get(c)
            if c == "anchor":
                vals.append("ANCHOR" if v else "non-anchor")
            elif isinstance(v, str):
                vals.append(v)
            else:
                vals.append(_fmt(v))
        print("  " + " ".join(f"{v:>16}" for v in vals), file=out)
    for r in rows:
        for reason in r.get("non_anchor_reasons", []):
            print(f"    {r['config']}: non-anchor: {reason}", file=out)
        for note in r.get("notes", []):
            print(f"    {r['config']}: note: {note}", file=out)


def report_measurement(path: str, out=None) -> None:
    """Render the port's measurement-pass document (`bench
    --measurement-pass --out`): the measured-vs-predicted table, the A/B
    ratios, the mesh-scaling leg and the legs left out."""
    from raft_sim_tpu_torch.bench import MEASUREMENT_SCHEMA

    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != MEASUREMENT_SCHEMA:
        raise SystemExit(f"{path}: not a measurement-pass document of the port "
                         f"(schema {doc.get('schema')!r})")
    print(f"measurement pass: {path}\n"
          f"  backend={doc.get('backend')} device={doc.get('device', '-')} "
          f"torch={doc.get('torch_version')} smoke={doc.get('smoke')} "
          f"repeats={doc.get('repeats')} ticks_cut={doc.get('ticks_cut')}", file=out)
    if doc.get("nvidia_smi"):
        print(f"  card: {doc['nvidia_smi']}", file=out)
    rec = doc.get("reconciliation") or {}
    print(f"  prices: {rec.get('pins_source')}", file=out)
    _print_reconciliation(rec.get("rows", []), out=out)
    for note in rec.get("notes", []):
        print(f"  note: {note}", file=out)

    print("\n  A/B deltas:", file=out)
    ab = doc.get("ab") or {}
    for key in ("fault_lattice", "serve_offer_plane", "layout_dense_vs_compact", "durability",
                "transfer_during_joint"):
        arm = ab.get(key) or {}
        print(f"  {key:24} on/off throughput ratio: "
              f"{_fmt(arm.get('on_over_off_ticks_per_s'))} ({arm.get('label', '')})", file=out)
        for note in arm.get("notes", []):
            print(f"    note: {note}", file=out)

    mesh = doc.get("mesh_scaling") or {}
    rows = mesh.get("rows") or {}
    if rows:
        print(f"\n  mesh scaling: {mesh.get('label', '')}", file=out)
        cols = ("shards", "devices", "batch", "ticks", "wall s", "cluster t/s", "speedup",
                "violations", "anchor")
        print("  " + " ".join(f"{c:>12}" for c in cols), file=out)
        for k, r in rows.items():
            vals = (r["n_devices"], r.get("devices_used"), r["batch"], r["ticks"], r["wall_s"],
                    r["cluster_ticks_per_s"], (mesh.get("speedup_vs_1dev") or {}).get(k),
                    r.get("violations"))
            print("  " + " ".join(f"{_fmt(v):>12}" for v in vals)
                  + f" {'ANCHOR' if r.get('anchor') else 'non-anchor':>12}", file=out)
        for note in mesh.get("notes", []):
            print(f"    note: {note}", file=out)
    for key, note in (doc.get("left_out") or {}).items():
        print(f"  {key}: {note}", file=out)


def report_health(directory: str, out=None) -> None:
    """Render a directory's health plane (health.jsonl + alerts.jsonl +
    evidence bundles -- raft_sim_tpu/health, written by any standing loop run
    with health monitoring armed): per-scope SLI rollups, the burn-rate
    state-machine history, each alert transition with its triaged worst
    clusters, and the frozen evidence bundles' inventories."""
    hpath = os.path.join(directory, "health.jsonl")
    if not os.path.isfile(hpath):
        raise SystemExit(
            f"{directory}: no health.jsonl (arm monitoring with --health on "
            "run/serve/scenario farm, or Session.attach_health)"
        )
    with open(hpath) as f:
        health = [json.loads(line) for line in f if line.strip()]
    apath = os.path.join(directory, "alerts.jsonl")
    alerts = []
    if os.path.isfile(apath):
        with open(apath) as f:
            alerts = [json.loads(line) for line in f if line.strip()]

    scopes: dict[str, list[dict]] = {}
    for row in health:
        scopes.setdefault(row["scope"], []).append(row)
    print(f"health plane: {directory}\n"
          f"  {len(health)} evals across {len(scopes)} scopes, "
          f"{len(alerts)} alert transitions", file=out)
    for scope, rows in scopes.items():
        last = rows[-1]
        print(f"\n  scope {scope}: {len(rows)} evals, "
              f"{sum(r['ticks'] for r in rows)} ticks, "
              f"last status {last['status'].upper()}", file=out)
        for k, v in sorted(last.get("slis", {}).items()):
            # One measurement group per objective: render the group's
            # key=value pairs on the objective's line.
            body = " ".join(f"{kk}={_fmt(vv)}" for kk, vv in v.items())
            print(f"    {k:16} {body}", file=out)
        burns = last.get("burn") or {}
        if burns:
            print(f"    {'objective':>16} {'rule':>8} {'burn short':>12} "
                  f"{'burn long':>12}", file=out)
            for obj, by_rule in sorted(burns.items()):
                for rule, (short, long_) in sorted(by_rule.items()):
                    print(f"    {obj:>16} {rule:>8} "
                          f"{_fmt(short):>12} {_fmt(long_):>12}", file=out)

    if alerts:
        print("\n  alert transitions:", file=out)
        cols = ("eval", "scope", "objective", "rule", "state",
                "burn_short", "burn_long")
        print("  " + " ".join(f"{c:>11}" for c in cols)
              + "  worst clusters / evidence", file=out)
        for a in alerts:
            worst = ",".join(
                str(w["cluster"]) + ("*" if w.get("outlier") else "")
                for w in a.get("worst_clusters", [])
            ) or "-"
            ev = a.get("evidence") or ""
            cells = [
                v if isinstance(v, str) else _fmt(v)
                for v in (a.get(c) for c in cols)
            ]
            print("  " + " ".join(f"{v:>11}" for v in cells)
                  + f"  {worst}" + (f" -> {ev}" if ev else ""), file=out)
        print("  (* = robust outlier: modified z-score above the spec "
              "threshold)", file=out)

    bundles = sorted(
        d for d in os.listdir(directory)
        if d.startswith("evidence_")
        and os.path.isdir(os.path.join(directory, d))
    )
    for name in bundles:
        path = os.path.join(directory, name)
        with open(os.path.join(path, "alert.json")) as f:
            doc = json.load(f)
        al = doc.get("alert") or {}
        print(f"\n  evidence bundle {name}: "
              f"{al.get('scope')}/{al.get('objective')}/{al.get('rule')} "
              f"at eval {al.get('eval')}", file=out)
        for fname in doc.get("files", []):
            size = os.path.getsize(os.path.join(path, fname))
            print(f"    {fname:24} {size:>10,} bytes", file=out)
        refs = doc.get("refs") or {}
        if refs:
            print("    refs: "
                  + " ".join(f"{k}={v}" for k, v in sorted(refs.items())),
                  file=out)


def report_multichip(paths: list[str], out=None) -> None:
    """Render multichip-v2 documents (`multihost_check --out` of either
    package; telemetry_sink.validate_multichip) as a table: one row per
    document -- parity verdict, shape, sharded vs reference throughput and
    the per-device byte price. Rc-only stubs (before multichip-v2) are
    listed as such, never skipped."""
    cols = ("artifact", "match", "dev x proc", "batch", "ticks",
            "sharded t/s", "reference t/s", "overhead", "B/tick/dev")
    print("multichip proof artifacts:", file=out)
    print("  " + " ".join(f"{c:>14}" for c in cols), file=out)
    notes = []
    for path in paths:
        name = os.path.basename(path)
        errors = sink.validate_multichip(path)
        with open(path) as f:
            doc = json.load(f)
        if "schema" not in doc:
            print(f"  {name:>14}" + f"{'(legacy rc-only stub)':>29}"
                  + f"{_fmt(doc.get('n_devices')) + ' dev':>15}"
                  + f"{'rc=' + _fmt(doc.get('rc')):>15}", file=out)
            notes.append(f"{name}: legacy stub -- regenerate with multihost_check --out")
            continue
        if errors:
            for e in errors:
                notes.append(f"INVALID: {e}")
            continue
        ratio = (
            round(doc["reference_ticks_per_s"] / doc["throughput_ticks_per_s"], 3)
            if doc["throughput_ticks_per_s"] and
            doc.get("reference_ticks_per_s") else None
        )
        vals = (
            name, "MATCH" if doc["match"] else "MISMATCH",
            f"{doc['n_devices']}x{doc['n_processes']}", _fmt(doc["batch"]),
            _fmt(doc["ticks"]), _fmt(doc["throughput_ticks_per_s"]),
            _fmt(doc.get("reference_ticks_per_s")), _fmt(ratio),
            _fmt(doc["per_device_bytes_per_tick"]),
        )
        print("  " + " ".join(f"{v:>14}" for v in vals), file=out)
        notes.append(
            f"{name}: platform={doc['platform']} "
            f"violations={doc['violations']} "
            f"parity={doc['parity_hash'][:12]}..."
            + (" (cpu rows never anchor the roofline)"
               if doc["platform"] == "cpu" else "")
        )
    for n in notes:
        print(f"  {n}", file=out)


def diff(path_a: str, path_b: str, config: str | None, out=None) -> None:
    """The two runs' quality fields side by side with their deltas. The
    throughput fields are compared only between runs of one backend: a
    ratio of a card run to a TPU or CPU run means nothing."""
    label_a, a = load_run(path_a, config)
    label_b, b = load_run(path_b, config)
    backends = (a.pop("_backend", None), b.pop("_backend", None))
    cross = backends[0] != backends[1]
    keys = [k for k in (
        "violations", "cmds", "msgs", "max_commit", "p50_stable_tick",
        "cluster_ticks_per_s", "steady_ticks_per_s", "repeat_cv",
        "predicted_roofline_ticks_per_s",
        "roofline_headroom", "mean_commit_latency", "p50_commit_latency",
        "lat_p50", "lat_p95", "lat_p99", "lat_excluded", "noop_blocked",
        "lm_skipped_pairs", "multi_leader",
    ) if k in a or k in b]
    print(f"A: {label_a}\nB: {label_b}\n", file=out)
    print(f"{'metric':22} {'A':>14} {'B':>14} {'delta':>14}", file=out)
    for k in keys:
        va, vb = a.get(k), b.get(k)
        if cross and k in THROUGHPUT:
            d = "refused"
        elif isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            d = _fmt(round(vb - va, 6))
        else:
            d = "-"
        print(f"{k:22} {_fmt(va):>14} {_fmt(vb):>14} {d:>14}", file=out)
    if cross and any(k in THROUGHPUT for k in keys):
        print(f"\nthroughput not compared across backends (A: {backends[0]}, B: "
              f"{backends[1]})", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch.metrics_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="telemetry directory (or two with --diff)")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the directory and exit (nonzero on errors)")
    ap.add_argument("--diff", action="store_true",
                    help="compare two runs (telemetry dirs or bench JSON files)")
    ap.add_argument("--config", default=None,
                    help="matrix row to read from a bench artifact (default: headline)")
    ap.add_argument("--windows", type=int, default=8,
                    help="window-table rows to show (default 8)")
    ap.add_argument("--flight", type=int, default=None, metavar="CLUSTER",
                    help="render flight_<CLUSTER>.jsonl via trace.info_lines")
    ap.add_argument("--perf", action="store_true",
                    help="runtime-perf report: a telemetry directory's "
                         "perf.jsonl (chunk attribution + reconciliation "
                         "against the card's roofline for K1's bytes) or the "
                         "port's measurement-pass document (measured-vs-"
                         "predicted table, A/B ratios, mesh scaling)")
    ap.add_argument("--trace", action="store_true",
                    help="protocol-trace report: per-cluster event timelines "
                         "from trace.jsonl plus the whole-history checker "
                         "verdicts (raft_sim_tpu_torch/trace)")
    ap.add_argument("--health", action="store_true",
                    help="health-plane report: per-scope SLI rollups and "
                         "burn-rate history from health.jsonl, alert "
                         "transitions with triaged worst clusters from "
                         "alerts.jsonl, and evidence-bundle inventories "
                         "(raft_sim_tpu_torch/health; any directory a "
                         "monitored run streamed into)")
    ap.add_argument("--multichip", action="store_true",
                    help="render multichip-v2 documents (multihost_check "
                         "--out) as a table: parity verdict, sharded vs "
                         "reference throughput, per-device byte price")
    ap.add_argument("--trace-cluster", type=int, action="append", default=None,
                    metavar="C", help="restrict --trace to cluster C (repeatable)")
    ap.add_argument("--trace-limit", type=int, default=40,
                    help="timeline lines shown per cluster (0 = all; default 40)")
    ap.add_argument("--perfetto", metavar="OUT.json", default=None,
                    help="with --trace: also export the timelines as "
                         "Chrome-trace/Perfetto JSON (one track per node, "
                         "events named by kind; open in ui.perfetto.dev)")
    args = ap.parse_args(argv)

    if args.multichip:
        if not args.paths:
            ap.error("--multichip needs at least one multichip-v2 document path")
        report_multichip(args.paths)
        return 0

    if args.health:
        if len(args.paths) != 1:
            ap.error("--health needs exactly one directory")
        # validate_health_files alone, not the full sink gate: farm out-dirs
        # carry health streams without being telemetry directories.
        errors = sink.validate_health_files(args.paths[0])
        if errors:
            for e in errors:
                print(f"INVALID: {e}", file=sys.stderr)
            return 1
        report_health(args.paths[0])
        return 0

    if args.trace:
        if len(args.paths) != 1:
            ap.error("--trace needs exactly one telemetry directory")
        errors = sink.validate(args.paths[0])
        if errors:
            for e in errors:
                print(f"INVALID: {e}", file=sys.stderr)
            return 1
        report_trace(
            args.paths[0], clusters=args.trace_cluster,
            limit=args.trace_limit or None, perfetto=args.perfetto,
        )
        return 0

    if args.perf:
        if len(args.paths) != 1:
            ap.error("--perf needs exactly one path (telemetry dir or "
                     "measurement-pass document)")
        path = args.paths[0]
        if os.path.isdir(path):
            errors = sink.validate(path)
            if errors:
                for e in errors:
                    print(f"INVALID: {e}", file=sys.stderr)
                return 1
            report_perf_dir(path)
        else:
            report_measurement(path)
        return 0

    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two paths")
        diff(args.paths[0], args.paths[1], args.config)
        return 0
    if len(args.paths) != 1:
        ap.error("need exactly one telemetry directory")
    directory = args.paths[0]
    errors = sink.validate(directory)
    if errors:
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    if args.validate:
        print(f"{directory}: schema v{sink.TELEMETRY_SCHEMA_VERSION} OK")
        return 0
    if args.flight is not None:
        render_flight(directory, args.flight)
        return 0
    report(directory, args.windows)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # report piped into head/less and closed early
        sys.exit(0)
