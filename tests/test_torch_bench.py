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
    assert tbench.MATRIX == tuple(n for n in jbench.MATRIX_CONFIGS if n not in tbench.NOT_PORTED)
    assert "config5c" in tbench.NOT_PORTED


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
    assert "config5c" in doc["not_ported"]


def test_cli_bench_refuses_bench_artifact_names(tmp_path):
    out = tmp_path / "BENCH_r01.json"
    proc = _run_cli("bench", "--preset", "config2", "--out", str(out), "--device", "cpu")
    assert proc.returncode == 2 and "BENCH_r" in proc.stderr
    assert not out.exists()


def test_serve_row_matches_bench_py():
    """The config9-serve row at a small size (16 clusters, 4 tenants, chunks
    of 32, one warmup chunk, 3 serving chunks): its work counts equal
    bench.py's `serve_bench` row's; only config5c stays unported."""
    kw = dict(batch=16, chunks=3, chunk=32, window=16, tenants_n=4, smoke=True)
    want = jbench.serve_bench("config9", **kw)
    got = tbench.serve_bench("config9", device="cpu", **kw)
    counts = ("kind", "unit", "config", "smoke", "batch", "tenants", "chunk", "window", "chunks",
              "ticks", "commands_acked", "reads_served", "ops_done", "violations")
    assert {k: got[k] for k in counts} == {k: want[k] for k in counts}
    assert got["commands_acked"] > 0 and got["reads_served"] > 0 and got["violations"] == 0
    assert got["backend"] == "cpu" and got["perf"] is None and got["reconciliation"] is None
    assert got["ops_per_s"] > 0 and got["steady_ticks_per_s"] > 0
    assert set(want) - set(got) == set() and set(got) - set(want) == {"wall_s"}
    assert list(tbench.NOT_PORTED) == ["config5c"]
