"""The port's bench: cluster-ticks/s and the quality rollup, one row per preset
(the port of bench.py `bench` and its matrix sizing rules).

    python -m raft_sim_tpu_torch bench                    # the matrix, on the card
    python -m raft_sim_tpu_torch bench --preset config2   # one row
    python -m raft_sim_tpu_torch bench --smoke --device cpu
    python -m raft_sim_tpu_torch bench --preset config2 --scenario P.json --telemetry-dir D

A row keeps the reference's discipline and field names. Quality runs use the
fixed seeds 0..quality_seeds-1 and pool their per-cluster metrics through
`summary.summarize`, so the quality fields equal the JAX bench's on the same
seeds and sizes. Timed repeats use time-salted seeds; each is timed to a host
copy of `metrics.ticks` after `torch.cuda.synchronize`, and the steady-state
statistics leave out the first repeat. Throughput means something only from a
card run (`backend: "cuda"`, with the card's name and power limit as
`nvidia-smi` prints them).

With `telemetry_dir` the seed-0 quality run goes through the windowed
telemetry loop and its windows land in `telemetry_dir/<config_name>/` in the
sink's schema (source "bench"), with `summary.json` of seed 0 alone. With
`scenario` (a nemesis program, scenario/program.py) every run takes the
scenario input path, the program's genome broadcast over the fleet, and the
row is marked `"scenario"`. `"layout"` is the config's carry layout
("compact" under `compact_planes`, ops/tile.py).

The serve-throughput row (`serve_bench`, `--serve`, and `<serve preset>-serve`
in the matrix) runs a multi-tenant `ServeSession` under saturating load and
counts commands+reads/s, the service's unit of work.

Not ported yet: the measurement pass and its mesh leg, the serve row's
per-chunk `perf` rollup (ROADMAP item 18a), and the roofline-pin fields and
the serve row's `reconciliation` (the JAX cost model's TPU prices are no
yardstick for the card).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.summary import summarize
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

NORTH_STAR = 1_000_000.0  # cluster-ticks/s, the BASELINE north star

# Ticks per timed run and the smoke shrink, as bench.py sizes its matrix.
MATRIX_TICKS = {
    "config1": 10_000,
    "config9": 500,
    "config2": 2_000,
    "config3": 500,
    "config3p": 500,
    "config4": 300,
    "config4c": 300,
    "config5": 200,
    "config5c": 200,
    "config6": 5_000,
    "config6r": 5_000,
}
SMOKE_BATCH = {
    "config2": 64,
    "config8": 64,
    "config10": 64,
    "config9": 64,
    "config3": 512,
    "config3p": 512,
    "config4": 256,
    "config4c": 256,
    "config5": 16,
    "config5c": 16,
    "config6": 64,
    "config6r": 64,
}
SMOKE_TICKS = {"config1": 1_000, "config6": 1_000, "config6r": 1_000}

# The reference matrix (bench.py main); NOT_PORTED names any row the port
# cannot run yet (none since the compacted layout, config5c's, was ported).
MATRIX = (
    "config1", "config2", "config3", "config3p", "config4", "config4c",
    "config5", "config5c", "config6", "config6r",
)
NOT_PORTED: dict[str, str] = {}
SERVE_PRESET = "config9"  # the serve row's read-carrying preset (bench.py main)
# bench.py's TPU artifacts; cost_model reads these names.
_RESERVED_OUT = re.compile(r"BENCH_r\d+\.json")


def _matrix_sizing(name: str, smoke: bool) -> tuple[int, int]:
    """(batch, ticks) for one matrix row under the standard sizing rules."""
    _, preset_batch = PRESETS[name]
    batch = SMOKE_BATCH.get(name, min(preset_batch, 256)) if smoke else preset_batch
    ticks = SMOKE_TICKS[name] if smoke and name in SMOKE_TICKS else MATRIX_TICKS.get(name, 300)
    return batch, ticks


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _telemetry_window(ticks: int) -> int:
    """A window that divides the run (bench.py's): the finest of a few round
    divisors, else one whole-run window."""
    for d in (16, 10, 8, 5, 4, 2):
        if ticks % d == 0:
            return ticks // d
    return ticks


def _pool(runs: list[scan.RunMetrics]) -> scan.RunMetrics:
    """Per-cluster metrics of several runs as one [sum of batches] RunMetrics."""
    return scan.RunMetrics(*(torch.cat([getattr(m, f).cpu() for m in runs])
                             for f in scan.RunMetrics._fields))


def bench(cfg: RaftConfig, batch: int, ticks: int, repeats: int = 3,
          quality_seeds: int = 3, telemetry_dir: str | None = None,
          config_name: str = "custom", scenario=None, smoke: bool = False,
          device="cuda") -> dict:
    """One bench row for `cfg` (named `config_name` in the row): quality over
    the fixed seeds, throughput over `repeats` time-salted runs (the first
    also pays the kernel build and warm-up). `telemetry_dir` writes the
    seed-0 quality run's windows; `scenario` (a ScenarioProgram) runs every
    run on the scenario input path."""
    dev = device_mod.resolve(device)
    on_card = dev.type == "cuda"
    g, seg_len = None, 1
    if scenario is not None:
        from raft_sim_tpu_torch.scenario import genome as genome_mod

        g = genome_mod.to_device(genome_mod.broadcast(scenario.genome, batch), dev)
        seg_len = scenario.seg_len

    def sim(seed):
        if g is None:
            return scan.simulate(cfg, seed, batch, ticks, device=dev)
        return scan.simulate_scenario(cfg, seed, batch, ticks, g, seg_len, device=dev)

    pooled = []
    for qs in range(quality_seeds):
        if qs == 0 and telemetry_dir is not None:
            from raft_sim_tpu_torch.sim import telemetry
            from raft_sim_tpu_torch.utils.telemetry_sink import TelemetrySink

            window = _telemetry_window(ticks)
            sink = TelemetrySink(os.path.join(telemetry_dir, config_name), cfg, seed=qs,
                                 batch=batch, window=window, ring=0, source="bench",
                                 backend=dev.type)
            _, m, records, _ = telemetry.simulate_windowed(cfg, qs, batch, ticks, window,
                                                           genome=g, seg_len=seg_len, device=dev)
            sink.append_windows(records)
        else:
            m = sim(qs)[1]
        pooled.append(m)
    q_metrics = _pool(pooled)

    seed_base = int(time.time_ns() % ((1 << 31) - 1 - repeats))
    walls = []
    for r in range(1, repeats + 1):
        t0 = time.perf_counter()
        _, metrics = sim(seed_base + r)
        if on_card:
            torch.cuda.synchronize(dev)
        metrics.ticks.cpu().numpy()  # a host copy: the data is there
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    steady_walls = walls[1:] if len(walls) > 1 else walls
    steady_mean = float(np.mean(steady_walls))
    steady_cv = (
        round(float(np.std(steady_walls) / steady_mean), 4)
        if len(steady_walls) > 1 and steady_mean > 0
        else (0.0 if len(steady_walls) > 1 else None)
    )

    s = summarize(q_metrics)
    if telemetry_dir is not None:
        # summary.json describes the run the windows do: seed 0 alone.
        sink.write_summary(summarize(_pool(pooled[:1]))._asdict())
    value = batch * ticks / best
    row = {
        "cluster_ticks_per_s": round(value, 1),
        "vs_baseline": round(value / NORTH_STAR, 3),
        "legacy": ["cluster_ticks_per_s", "wall_s", "vs_baseline"],
        "steady_ticks_per_s": round(batch * ticks / steady_mean, 1),
        "repeat_walls_s": [round(w, 4) for w in walls],
        "repeat_cv": steady_cv,
        "backend": dev.type,
        "layout": "compact" if cfg.compact_planes else "dense",
        "batch": batch,
        "n_nodes": cfg.n_nodes,
        "ticks": ticks,
        "wall_s": round(best, 3),
        "p50_stable_tick": s.p50_stable_tick,
        "pct_stable": round(100.0 * s.n_stable / s.n_clusters, 1),
        "p50_commit_latency": s.p50_commit_latency,
        "lat_p50": s.lat_p50,
        "lat_p95": s.lat_p95,
        "lat_p99": s.lat_p99,
        "lat_excluded": s.lat_excluded,
        "total_cmds": s.total_cmds,
        "violations": s.total_violations,
        "noop_blocked": s.noop_blocked,
        "lm_skipped_pairs": s.lm_skipped_pairs,
        "multi_leader": s.multi_leader,
        "quality_seeds": quality_seeds,
        "preset": config_name,
    }
    if on_card:
        row["device"] = torch.cuda.get_device_name(dev)
        row["nvidia_smi"] = card_line()
    if smoke:
        row["smoke"] = True
    if scenario is not None:
        row["scenario"] = scenario.name
    return row


def serve_tenants(batch: int, tenants_n: int = 4, reads: bool = True) -> list:
    """The serve row's load: `tenants_n` tenants split the fleet evenly; each
    offers one distinct command per (tick, cluster) slot for ever and (with
    `reads`) demands more reads than a run can serve, offered one per
    cluster every other tick."""
    import itertools

    from raft_sim_tpu_torch.serve import Tenant
    from raft_sim_tpu_torch.serve.tenancy import split_even

    sizes = split_even(batch, tenants_n)
    counter = itertools.count(1)
    return [
        Tenant(f"t{i}", sizes[i], source=(next(counter) for _ in itertools.repeat(0)),
               reads=10**9 if reads else 0, read_every=2)
        for i in range(tenants_n)
    ]


def serve_row(sess, stats: dict, preset: str, tenants_n: int, smoke: bool) -> dict:
    """The serve-throughput row of a finished ServeSession run (`stats` from
    its serve()). `steady_ticks_per_s` leaves out the first serving chunk
    (its wall runs from the loop's start to its sync)."""
    wall = stats["wall_s"]
    syncs = sess.sync_times
    steady_s = syncs[-1] - syncs[0] if len(syncs) > 1 else 0.0
    row = {
        "kind": "serve-throughput",
        "unit": "commands+reads/s",
        "config": preset,
        "backend": sess.device.type,
        "smoke": bool(smoke),
        "batch": sess.batch,
        "tenants": tenants_n,
        "chunk": sess.chunk,
        "window": sess.window,
        "chunks": stats["chunks"],
        "ticks": stats["ticks"],
        "commands_acked": stats["commands_acked"],
        "reads_served": stats["reads_served"],
        "ops_done": stats["ops_done"],
        "ops_per_s": round(stats["ops_done"] / wall, 1) if wall else None,
        "commands_per_s": round(stats["commands_acked"] / wall, 1) if wall else None,
        "reads_per_s": round(stats["reads_served"] / wall, 1) if wall else None,
        "violations": stats["violations"],
        "steady_ticks_per_s": (round(sess.batch * sess.chunk * (len(syncs) - 1) / steady_s, 1)
                               if steady_s > 0 else None),
        "wall_s": wall,
        "perf": None,
        "reconciliation": None,
    }
    if sess.device.type == "cuda":
        row["device"] = torch.cuda.get_device_name(sess.device)
        row["nvidia_smi"] = card_line()
        row["extract_ms_per_round"] = (sum(sess.extract_ms) / len(sess.extract_ms)
                                       if sess.extract_ms else None)
    return row


def serve_bench(preset: str = SERVE_PRESET, batch: int | None = None, chunks: int = 8,
                chunk: int = 256, window: int = 64, tenants_n: int = 4, smoke: bool = False,
                device="cuda") -> dict:
    """The serve-throughput row: a `serve_tenants` load on `preset` at its
    batch (64 under `smoke`), one warmup chunk, then `chunks` serving
    chunks, counted in commands+reads/s."""
    from raft_sim_tpu_torch.serve import ServeSession

    cfg, preset_batch = PRESETS[preset]
    if batch is None:
        batch = min(preset_batch, 64) if smoke else preset_batch
    if not cfg.read_index:
        raise ValueError(f"serve bench needs a read-carrying preset, got {preset}")
    sess = ServeSession(cfg, batch=batch, seed=0, chunk=chunk, window=window, sink=None,
                        warmup_ticks=chunk, tenants=serve_tenants(batch, tenants_n),
                        device=device)
    return serve_row(sess, sess.serve(chunks=chunks), preset, tenants_n, smoke)


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="bench one preset instead of the matrix")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats per row; the first is left out of "
                         "steady_ticks_per_s (default 3)")
    ap.add_argument("--smoke", action="store_true",
                    help="the matrix at small batches (CPU-sized)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the whole document to PATH and print a one-line "
                         "headline (BENCH_r<N>.json names are refused)")
    ap.add_argument("--serve", action="store_true",
                    help="bench only the serve-throughput row (commands+reads/s)")
    ap.add_argument("--serve-preset", default=SERVE_PRESET, metavar="NAME",
                    choices=sorted(PRESETS),
                    help=f"read-carrying preset the serve row runs (default {SERVE_PRESET})")
    ap.add_argument("--serve-chunks", type=int, default=8,
                    help="serving chunks of the serve row (default 8)")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="write each row's seed-0 quality run as telemetry windows under "
                         "DIR/<preset>/ (the sink's schema, source 'bench')")
    ap.add_argument("--scenario", default=None, metavar="FILE",
                    help="run the row on the scenario input path under this nemesis "
                         "program (scenario/program.py schema); needs --preset")
    ap.add_argument("--device", default="cuda")


def run(ap: argparse.ArgumentParser, args) -> int:
    if args.out and _RESERVED_OUT.fullmatch(os.path.basename(args.out)):
        ap.error(f"--out {args.out}: BENCH_r<N>.json files are the JAX package's "
                 "TPU artifacts; name the port's document otherwise")
    if args.serve:
        print(json.dumps(serve_bench(args.serve_preset, batch=args.batch,
                                     chunks=args.serve_chunks, smoke=args.smoke,
                                     device=args.device)))
        return 0
    scenario = None
    if args.scenario:
        if not args.preset:
            ap.error("--scenario requires --preset (one labeled row)")
        from raft_sim_tpu_torch.scenario import program as program_mod

        scenario = program_mod.load(args.scenario, PRESETS[args.preset][0])
    names = [args.preset] if args.preset else list(MATRIX)
    matrix = {}
    for name in names:
        batch, ticks = _matrix_sizing(name, args.smoke)
        batch, ticks = args.batch or batch, args.ticks or ticks
        print(f"bench {name}: batch={batch} ticks={ticks}...", file=sys.stderr)
        matrix[name] = bench(PRESETS[name][0], batch, ticks, args.repeats,
                             telemetry_dir=args.telemetry_dir, config_name=name,
                             scenario=scenario, smoke=args.smoke, device=args.device)
    if not args.preset:
        # The standing serve-throughput row rides every full-matrix run.
        print(f"bench {args.serve_preset}-serve: serve-throughput row...", file=sys.stderr)
        matrix[f"{args.serve_preset}-serve"] = serve_bench(
            args.serve_preset, chunks=args.serve_chunks, smoke=args.smoke, device=args.device)
    headline_name = "config3" if "config3" in matrix else names[0]
    headline = matrix[headline_name]
    doc = {
        "metric": "cluster-ticks/sec/chip",
        "value": headline["cluster_ticks_per_s"],
        "unit": "cluster-ticks/s",
        "vs_baseline": headline["vs_baseline"],
        "workload": headline_name,
        "matrix": matrix,
        "not_ported": NOT_PORTED,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        per_cfg = " ".join(
            f"{n}={r['cluster_ticks_per_s']:g}" if "cluster_ticks_per_s" in r
            else f"{n}={r['ops_per_s'] or 0:g}ops/s"
            for n, r in matrix.items())
        print(f"{headline_name} {headline['cluster_ticks_per_s']:g} cluster-ticks/s "
              f"({headline['vs_baseline']}x north star) | {per_cfg} | full matrix: {args.out}")
    else:
        print(json.dumps(doc))
    return 0
