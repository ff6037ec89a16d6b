"""The port's bench (raft_sim_tpu_torch/bench.py) against the JAX package's
bench.py: the sizing tables and rules are equal, the quality fields of a row
equal the JAX `bench.bench` row's on the same seeds and sizes (CPU, small
size), and the CLI prints one document and refuses the TPU artifact names.

Tolerance: exact equality of every quality field (they are integer counts and
quantiles of integer histograms, computed by the same formulas).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench as jbench
import raft_sim_tpu as rst
from raft_sim_tpu_torch import bench as tbench
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

QUALITY_FIELDS = (
    "p50_stable_tick", "pct_stable", "p50_commit_latency", "lat_p50", "lat_p95", "lat_p99",
    "lat_excluded", "total_cmds", "violations", "noop_blocked", "lm_skipped_pairs",
    "multi_leader", "batch", "n_nodes", "ticks", "quality_seeds", "layout",
)


def test_sizing_tables_match_bench_py():
    assert tbench.NORTH_STAR == jbench.NORTH_STAR
    assert tbench.MATRIX_TICKS == jbench.MATRIX_TICKS
    assert tbench.SMOKE_BATCH == jbench.SMOKE_BATCH
    assert tbench.SMOKE_TICKS == jbench.SMOKE_TICKS
    assert sorted(tconfig.PRESETS) == sorted(rst.PRESETS)
    for name in rst.PRESETS:
        for smoke in (False, True):
            assert tbench._matrix_sizing(name, smoke) == jbench._matrix_sizing(name, smoke)


def test_matrix_is_the_reference_matrix_less_the_unported_rows():
    """No row is left unported: the matrix is the reference's, config5c (the
    compacted layout) included."""
    assert tbench.NOT_PORTED == {}
    assert tbench.MATRIX == tuple(jbench.MATRIX_CONFIGS)
    assert "config5c" in tbench.MATRIX


@pytest.mark.parametrize("name", ["config2", "config10"])
def test_bench_quality_matches_jax(name):
    jcfg, _ = rst.PRESETS[name]
    tcfg, _ = tconfig.PRESETS[name]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = jbench.bench(jcfg, 8, 60, repeats=1, quality_seeds=2, config_name=name)
    got = tbench.bench(tcfg, 8, 60, repeats=1, quality_seeds=2, config_name=name, device="cpu")
    assert {k: got[k] for k in QUALITY_FIELDS} == {k: want[k] for k in QUALITY_FIELDS}
    assert got["total_cmds"] > 0 and got["violations"] == 0
    assert got["backend"] == "cpu" and got["repeat_cv"] is None and len(got["repeat_walls_s"]) == 1
    assert set(want) - set(got) <= {"predicted_roofline_ticks_per_s", "roofline_headroom"}


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "raft_sim_tpu_torch", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )


def test_cli_bench_prints_one_document():
    proc = _run_cli("bench", "--preset", "config2", "--smoke", "--ticks", "40", "--repeats", "1",
                    "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    row = doc["matrix"]["config2"]
    assert doc["workload"] == "config2" and doc["value"] == row["cluster_ticks_per_s"]
    assert row["smoke"] is True and row["batch"] == 64 and row["ticks"] == 40
    assert doc["not_ported"] == {} and row["layout"] == "dense"


def test_cli_bench_refuses_bench_artifact_names(tmp_path):
    out = tmp_path / "BENCH_r01.json"
    proc = _run_cli("bench", "--preset", "config2", "--out", str(out), "--device", "cpu")
    assert proc.returncode == 2 and "BENCH_r" in proc.stderr
    assert not out.exists()


def test_serve_row_matches_bench_py():
    """The config9-serve row at a small size (16 clusters, 4 tenants, chunks
    of 32, one warmup chunk, 3 serving chunks): its work counts equal
    bench.py's `serve_bench` row's, and so do the counts of its chunk-timer
    rollup (`perf`), and its reconciliation's anchor verdict; no matrix row
    stays unported."""
    kw = dict(batch=16, chunks=3, chunk=32, window=16, tenants_n=4, smoke=True)
    want = jbench.serve_bench("config9", **kw)
    got = tbench.serve_bench("config9", device="cpu", **kw)
    counts = ("kind", "unit", "config", "smoke", "batch", "tenants", "chunk", "window", "chunks",
              "ticks", "commands_acked", "reads_served", "ops_done", "violations")
    assert {k: got[k] for k in counts} == {k: want[k] for k in counts}
    assert got["commands_acked"] > 0 and got["reads_served"] > 0 and got["violations"] == 0
    assert got["backend"] == "cpu"
    # The reconciliation, priced on K1's bytes under the serve config: the
    # JAX row's keys and anchor verdict (a CPU smoke row never anchors).
    rec, jrec = got["reconciliation"], want["reconciliation"]
    assert set(rec) == set(jrec) and rec["anchor"] is jrec["anchor"] is False
    assert rec["non_anchor_reasons"] == jrec["non_anchor_reasons"]
    assert rec["bytes_per_tick_padded"] > 0 and rec["roofline_fraction"] > 0
    # The chunk timer's rollup: its counts equal the JAX row's.
    keep = ("label", "batch", "chunks", "steady_chunks", "steady_ticks",
            "recompiled_after_warmup")
    assert {k: got["perf"][k] for k in keep} == {k: want["perf"][k] for k in keep}
    assert got["ops_per_s"] > 0 and got["steady_ticks_per_s"] > 0
    assert set(want) - set(got) == set() and set(got) - set(want) == {"wall_s"}
    assert list(tbench.NOT_PORTED) == []


# The manifest keys that name the run's stack or moment, not its content.
_STACK_KEYS = ("created_unix", "jax_version", "torch_version", "backend")


def _manifest(path):
    doc = json.loads((path / "manifest.json").read_text())
    return {k: v for k, v in doc.items() if k not in _STACK_KEYS}


def test_bench_telemetry_dir_matches_jax(tmp_path):
    """`bench(..., telemetry_dir=)`: the seed-0 quality run's windows.jsonl
    and summary.json byte for byte as the JAX bench writes them, the manifest
    equal but for the stack's own keys, and the row's quality fields equal."""
    jcfg, tcfg = rst.PRESETS["config2"][0], tconfig.PRESETS["config2"][0]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    want = jbench.bench(jcfg, 8, 60, repeats=1, quality_seeds=2, telemetry_dir=str(jdir),
                        config_name="config2")
    got = tbench.bench(tcfg, 8, 60, repeats=1, quality_seeds=2, telemetry_dir=str(tdir),
                       config_name="config2", device="cpu")
    assert {k: got[k] for k in QUALITY_FIELDS} == {k: want[k] for k in QUALITY_FIELDS}
    j, t = jdir / "config2", tdir / "config2"
    assert sorted(p.name for p in t.iterdir()) == sorted(p.name for p in j.iterdir())
    for name in ("windows.jsonl", "summary.json"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    assert _manifest(t) == _manifest(j) and _manifest(t)["source"] == "bench"
    assert len((t / "windows.jsonl").read_text().splitlines()) == 10  # 60 ticks / 6


def _program_doc():
    return {"name": "calm-storm", "seg_len": 20,
            "segments": [{"client_interval": 8},
                         {"client_interval": 8, "drop_prob": 0.3, "partition_period": 10,
                          "partition_prob": 0.5, "crash_prob": 0.2, "crash_down_ticks": 6}]}


def test_bench_scenario_matches_jax():
    """`bench(..., scenario=)`: every run on the scenario input path; the
    quality fields and the "scenario" mark equal the JAX bench's."""
    from raft_sim_tpu.scenario import program as jprogram
    from raft_sim_tpu_torch.scenario import program as tprogram

    jcfg, tcfg = rst.PRESETS["config2"][0], tconfig.PRESETS["config2"][0]
    want = jbench.bench(jcfg, 8, 60, repeats=1, quality_seeds=2, config_name="config2",
                        scenario=jprogram.from_dict(_program_doc(), jcfg))
    got = tbench.bench(tcfg, 8, 60, repeats=1, quality_seeds=2, config_name="config2",
                       scenario=tprogram.from_dict(_program_doc(), tcfg), device="cpu")
    assert {k: got[k] for k in QUALITY_FIELDS} == {k: want[k] for k in QUALITY_FIELDS}
    assert got["scenario"] == want["scenario"] == "calm-storm"


def test_bench_config5c_row_matches_jax_and_config5():
    """The compacted layout's row at a smoke size: its quality equals the
    JAX bench's config5c row and the port's config5 row (the layout is
    physical only), and it says "layout": "compact"."""
    got = tbench.bench(tconfig.PRESETS["config5c"][0], 4, 40, repeats=1, quality_seeds=2,
                       config_name="config5c", smoke=True, device="cpu")
    want = jbench.bench(rst.PRESETS["config5c"][0], 4, 40, repeats=1, quality_seeds=2,
                        config_name="config5c", smoke=True)
    dense = tbench.bench(tconfig.PRESETS["config5"][0], 4, 40, repeats=1, quality_seeds=2,
                         config_name="config5", smoke=True, device="cpu")
    assert {k: got[k] for k in QUALITY_FIELDS} == {k: want[k] for k in QUALITY_FIELDS}
    assert got["layout"] == want["layout"] == "compact" and dense["layout"] == "dense"
    same = [k for k in QUALITY_FIELDS if k != "layout"]
    assert {k: got[k] for k in same} == {k: dense[k] for k in same}


def test_cli_bench_takes_telemetry_scenario_and_serve_preset(tmp_path):
    """--telemetry-dir, --scenario (with --preset) and --serve-preset reach
    the row; --scenario without --preset is a usage error."""
    prog = tmp_path / "prog.json"
    prog.write_text(json.dumps(_program_doc()))
    tel = tmp_path / "tel"
    proc = _run_cli("bench", "--preset", "config2", "--smoke", "--batch", "4", "--ticks", "40",
                    "--repeats", "1", "--device", "cpu", "--telemetry-dir", str(tel),
                    "--scenario", str(prog), "--serve-preset", "config9")
    assert proc.returncode == 0, proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-1])["matrix"]["config2"]
    assert row["scenario"] == "calm-storm" and row["batch"] == 4
    assert (tel / "config2" / "windows.jsonl").exists()
    assert (tel / "config2" / "summary.json").exists()
    proc = _run_cli("bench", "--scenario", str(prog), "--device", "cpu")
    assert proc.returncode == 2 and "--scenario requires --preset" in proc.stderr
