"""Reconcile measured throughput against the card's roofline for the tick
kernel's traffic (the port of raft_sim_tpu/obs/reconcile.py).

The JAX module prices rows with the TPU cost-model pins, which are no
yardstick for the card. Here every (config, program) is priced from the
port's own count of what K1 (kernels/tick_engine.step_cuda) moves:

    bytes_per_tick      = sum(tick_engine.traffic_bytes(cfg, 1)): every leg
                          the kernel reads once and writes once, per
                          cluster-tick (the `serve_simulate` program: the
                          same count under serve/loop.serve_config)
    roofline ticks/s    = HBM_BYTES_PER_S / bytes_per_tick, the card's HBM
                          peak (CARD) over those bytes
    live set            = the carry's bytes (tick_engine.leaf_specs: the
                          state and mailbox legs) at the row's batch

and a measured row joins them:

    achieved bytes/s    = measured cluster-ticks/s x bytes_per_tick
    roofline fraction   = measured / roofline ticks/s (~1.0: bound by HBM;
                          < 1: headroom; > 1: the working set sat in the
                          card's L2, or the count misses no bytes it should)
    live occupancy      = device bytes observed at chunk boundaries / the
                          live set

The anchor flag keeps the JAX rules: a row may rebase the roofline only when
it was measured on the card, at the preset's production batch and carry
layout, on one device, not under --smoke and not through the scenario input
path (`non_anchor_reasons`). A CPU row is reconciled but never anchors.

The output keys are the JAX module's, but for `pins_source`, which names
what the prices come from in place of the JAX `pins_jax_version` and
`pins_anchor_source`; `bytes_per_tick_padded` keeps its JAX name and holds
K1's bytes (the card pads no tile).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import torch

from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

# The card the roofline is priced for, and its HBM peak (the H100 SXM's
# 3.35 TB/s, as PERF.md prices every bound).
CARD = "NVIDIA H100 80GB HBM3 (SXM)"
HBM_BYTES_PER_S = 3.35e12
PINS_SOURCE = (f"kernels/tick_engine.traffic_bytes (K1's bytes per cluster-tick) over the "
               f"{CARD} HBM peak of 3.35 TB/s")
PROGRAMS = ("simulate", "serve_simulate")


def layout_of(cfg: RaftConfig) -> str:
    """The carry layout a row is measured under: "compact" (ops/tile.py,
    cfg.compact_planes) or "dense"."""
    return "compact" if cfg.compact_planes else "dense"


def program_config(cfg: RaftConfig, program: str) -> RaftConfig:
    """The config a program ticks: `simulate` the preset's, `serve_simulate`
    its serve-mode variant."""
    if program == "serve_simulate":
        from raft_sim_tpu_torch.serve.loop import serve_config

        return serve_config(cfg)
    if program != "simulate":
        raise ValueError(f"unknown program {program!r} (have {PROGRAMS})")
    return cfg


def bytes_per_tick(cfg: RaftConfig) -> int:
    """K1's bytes read and written per cluster-tick under `cfg`."""
    from raft_sim_tpu_torch.kernels.tick_engine import traffic_bytes

    return sum(traffic_bytes(cfg, 1))


def live_bytes(cfg: RaftConfig, batch: int) -> int:
    """The carry's bytes (every state and mailbox leg) at `batch` clusters."""
    from raft_sim_tpu_torch.kernels.tick_engine import leaf_specs

    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for (group, _), (shape, dtype) in leaf_specs(cfg, batch).items()
               if group in ("state", "mailbox"))


def price(cfg: RaftConfig) -> dict:
    """One program's prices: K1's bytes per cluster-tick and the card's
    roofline for them."""
    b = bytes_per_tick(cfg)
    return {
        "bytes_per_tick_padded": b,
        "implied_hbm_bytes_per_s": HBM_BYTES_PER_S,
        "roofline_ticks_per_s": round(HBM_BYTES_PER_S / b, 1),
    }


def load_pins(configs=None) -> dict:
    """The prices of every (preset, program) -- or of the presets named in
    `configs` -- computed from K1's traffic."""
    names = sorted(PRESETS) if configs is None else [c for c in configs if c in PRESETS]
    return {
        "source": PINS_SOURCE,
        "card": CARD,
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "programs": {f"{name}/{prog}": price(program_config(PRESETS[name][0], prog))
                     for name in names for prog in PROGRAMS},
    }


def _measured(row: dict) -> tuple[float | None, str]:
    """(cluster-ticks/s, source) from a bench row: the warmup-excluded steady
    value when the row carries one, else the best-of-repeats headline."""
    v = row.get("steady_ticks_per_s")
    if v:
        return float(v), "steady"
    v = row.get("cluster_ticks_per_s")
    if v:
        return float(v), "legacy-best"
    return None, "missing"


def non_anchor_reasons(config_name: str, row: dict, backend: str | None) -> list[str]:
    """Why this measured row must NOT rebase the roofline ([] = eligible):
    the JAX rules and messages, the layout keyed on the port's own
    `compact_planes`."""
    reasons = []
    if backend is None:
        reasons.append("backend unrecorded: treated non-anchor (pre-r06 row)")
    elif backend == "cpu":
        reasons.append("cpu backend: a CPU run can never rebase the roofline")
    if row.get("smoke"):
        reasons.append("--smoke row")
    if row.get("scenario"):
        reasons.append(f"scenario input path ({row['scenario']})")
    prod = PRESETS.get(config_name)
    if prod and row.get("batch") is not None and row["batch"] != prod[1]:
        reasons.append(f"batch {row['batch']} != production {prod[1]}")
    if prod is not None:
        # A row measured under one carry layout never rebases the other
        # layout's roofline; rows without the field are dense.
        row_layout = row.get("layout") or "dense"
        if row_layout != layout_of(prod[0]):
            reasons.append(
                f"{row_layout} layout row vs the preset's {layout_of(prod[0])} layout: a "
                "layout A/B row can never rebase the other layout's roofline")
    # The prices are per device: a row measured across D devices reports
    # aggregate throughput no single-device roofline may be rebased onto.
    if (row.get("n_devices") or 1) != 1:
        reasons.append(
            f"row measured across {row['n_devices']} devices: aggregate mesh throughput can "
            "never rebase the single-device roofline")
    if prod is None:
        reasons.append(f"{config_name!r} is not a preset: no pins to rebase")
    return reasons


def reconcile_row(config_name: str, row: dict, pins: dict,
                  default_backend: str | None = None,
                  observed_live_bytes: int | None = None,
                  program: str = "simulate") -> dict:
    """Join one measured bench row against its config's prices (`simulate`
    for the tick matrix; the serve-throughput row passes `serve_simulate`,
    priced under the serve-mode config). The live set is priced at the
    row's batch."""
    backend = row.get("backend") or default_backend
    measured, source = _measured(row)
    pin = (pins.get("programs") or {}).get(f"{config_name}/{program}") or {}
    prod = PRESETS.get(config_name)
    live_pin = None
    if pin:
        live_pin = live_bytes(program_config(prod[0], program),
                              int(row.get("batch") or prod[1]))
    notes = []
    out = {
        "config": config_name,
        "backend": backend,
        "measured_ticks_per_s": measured,
        "measured_source": source,
        "repeat_cv": row.get("repeat_cv"),
        "predicted_roofline_ticks_per_s": pin.get("roofline_ticks_per_s"),
        "bytes_per_tick_padded": pin.get("bytes_per_tick_padded"),
        "achieved_bytes_per_s": None,
        "roofline_fraction": None,
        "implied_hbm_bytes_per_s": pin.get("implied_hbm_bytes_per_s"),
        "live_peak_pin": live_pin,
        "observed_live_bytes": observed_live_bytes,
        "live_occupancy_vs_pin": None,
    }
    if source == "legacy-best":
        notes.append("measured from the best-of-repeats field (the row carries no steady "
                     "statistics)")
    if not pin:
        notes.append(f"no price for {config_name}/{program}: measurements only")
    if measured and pin.get("bytes_per_tick_padded"):
        out["achieved_bytes_per_s"] = round(measured * pin["bytes_per_tick_padded"], 1)
    if measured and pin.get("roofline_ticks_per_s"):
        frac = measured / pin["roofline_ticks_per_s"]
        # Four significant digits: a CPU row sits orders of magnitude below
        # the card's roofline, where four decimals would round it to 0.
        out["roofline_fraction"] = float(f"{frac:.4g}")
        if frac > 1.0:
            notes.append("measured above the HBM roofline: the working set sat in the card's "
                         "L2, or traffic_bytes counts bytes the kernel does not move")
    if observed_live_bytes is not None and live_pin:
        out["live_occupancy_vs_pin"] = round(observed_live_bytes / live_pin, 3)
        notes.append("the live set counts the state and mailbox carry alone: the occupancy "
                     "ratio also holds the inputs, metrics and the allocator's cache")
    reasons = non_anchor_reasons(config_name, row, backend)
    out["anchor"] = not reasons
    out["non_anchor_reasons"] = reasons
    out["notes"] = notes
    return out


def reconcile_matrix(doc: dict, pins: dict | None = None,
                     default_backend: str | None = None) -> dict:
    """Reconcile every row of a bench matrix document ({"matrix": {...}},
    `bench --out`'s form) against the prices (computed for the matrix's
    presets when `pins` is None)."""
    matrix = doc.get("matrix") or {}
    if pins is None:
        pins = load_pins(configs=list(matrix))
    notes = []
    rows = [reconcile_row(name, row, pins, default_backend=default_backend)
            for name, row in sorted(matrix.items()) if isinstance(row, dict)]
    anchored = [r["config"] for r in rows if r["anchor"]]
    if not anchored:
        notes.append("no anchor-eligible rows: this document must not rebase the roofline")
    return {
        "pins_source": pins.get("source"),
        "anchor_eligible": anchored,
        "rows": rows,
        "notes": notes,
    }


def _preset_name(config_dict: dict) -> str | None:
    """The preset a manifest's full config dict is (the prices are keyed by
    preset name)."""
    for name, (cfg, _batch) in PRESETS.items():
        if dataclasses.asdict(cfg) == config_dict:
            return name
    return None


def reconcile_perf_dir(directory: str, pins: dict | None = None) -> dict:
    """Reconcile a directory's perf.jsonl stream: steady-state throughput
    recomputed from the rows themselves, joined against the directory
    config's prices. A telemetry directory names its config in
    manifest.json; a farm out-dir in farm_manifest.json, and then the
    backend and device count come from the rows (a mesh-sharded hunt is
    non-anchor like any multi-device row). A CPU perf run reconciles but
    never anchors."""
    from raft_sim_tpu_torch.obs.timer import summarize_rows
    from raft_sim_tpu_torch.utils import telemetry_sink

    rows = read_perf(directory)
    if not rows:
        raise ValueError(f"{directory}: no perf.jsonl rows to reconcile")
    farm_path = os.path.join(directory, "farm_manifest.json")
    if os.path.isfile(os.path.join(directory, "manifest.json")):
        man = telemetry_sink.read_manifest(directory)
        batch = int(man.get("batch", 1))
        label = man.get("source", "run")
        config_dict = man.get("config") or {}
        backend = man.get("backend")
        farm = False
    elif os.path.isfile(farm_path):
        with open(farm_path) as f:
            man = json.load(f)
        batch = int(man.get("population", 1))
        label = "farm"
        # The farm manifest keeps the non-default fields only.
        try:
            config_dict = dataclasses.asdict(RaftConfig(**(man.get("config") or {})))
        except (TypeError, AssertionError, ValueError):
            config_dict = {}
        backend = next((r["backend"] for r in reversed(rows) if r.get("backend")), None)
        farm = True
    else:
        raise ValueError(f"{directory}: neither manifest.json nor farm_manifest.json -- not a "
                         "reconcilable perf directory")
    summary = summarize_rows(rows, label=label, batch=batch)
    name = _preset_name(config_dict)
    n_devices = max((r["n_devices"] for r in rows if isinstance(r.get("n_devices"), int)),
                    default=1)
    pseudo = {
        "steady_ticks_per_s": summary["steady_cluster_ticks_per_s"],
        "batch": batch,
        "backend": backend,
        "n_devices": n_devices,
    }
    if pins is None:
        pins = load_pins(configs=[name] if name else [])
    rec = reconcile_row(name or "custom", pseudo, pins, default_backend=backend,
                        observed_live_bytes=summary["live_bytes_peak"])
    if name is None:
        rec["notes"].append("manifest config matches no preset: no prices to join against")
    if farm:
        rec["notes"].append("farm out-dir: one row per CE generation (whole-portfolio "
                            "evaluations), batch = the portfolio population")
    rec["notes"].append("measured through the chunked loop (a sync a chunk), not the bench's "
                        "one-call run: the same tick, a little more host traffic -- compare "
                        "fractions, not absolutes, against bench rows")
    return {"summary": summary, "reconciliation": rec}


def read_perf(directory: str) -> list[dict]:
    """The perf.jsonl rows of a telemetry directory ([] when absent)."""
    path = os.path.join(directory, "perf.jsonl")
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
