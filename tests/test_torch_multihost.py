"""The port's multi-process proof (raft_sim_tpu_torch/multihost_check.py) on
the CPU: two processes join a localhost gloo group, each runs its half of a
global 8-shard cluster mesh, and process 0's gathered metrics must equal a
single-process 8-shard run bit for bit -- and the JAX package's
`simulate_sharded` on its 8 virtual devices (the artifact's parity hash is
the sha256 of the metrics' JSON, computed the same way from both).

Also the multichip-v2 check (`telemetry_sink.validate_multichip`): it
accepts the repo's MULTICHIP_r06.json and the port's artifact, and reports
MULTICHIP_r01.json as a legacy stub, as the JAX package's check does.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

import raft_sim_tpu as rst
from raft_sim_tpu.parallel import make_mesh as jmake_mesh
from raft_sim_tpu.parallel import simulate_sharded as jsimulate_sharded
from raft_sim_tpu.utils.telemetry_sink import validate_multichip as jvalidate_multichip
from raft_sim_tpu_torch import multihost_check
from raft_sim_tpu_torch.utils.telemetry_sink import validate_multichip

REPO = Path(__file__).resolve().parent.parent


def test_multichip_artifact_schema():
    assert validate_multichip(str(REPO / "MULTICHIP_r06.json")) == []
    errs = validate_multichip(str(REPO / "MULTICHIP_r01.json"))
    assert errs and "legacy" in errs[0], errs


def test_two_process_cluster_matches_single_process(tmp_path):
    out = tmp_path / "multichip.json"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "raft_sim_tpu_torch.multihost_check", "--device", "cpu",
         "--out", str(out), "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["match"] is True
    assert verdict["n_processes"] == 2 and verdict["global_devices"] == 8
    assert verdict["violations"] == 0
    # The workload did real work on the global mesh.
    assert verdict["summary"]["total_cmds"] > 0
    assert verdict["summary"]["p50_commit_latency"] is not None
    assert validate_multichip(str(out)) == [] and jvalidate_multichip(str(out)) == []
    doc = json.loads(out.read_text())
    assert doc["n_devices"] == 8 and doc["platform"] == "cpu" and doc["match"] is True

    # The same (cfg, seed, batch, ticks) in the JAX package on 8 devices.
    _, m = jsimulate_sharded(rst.RaftConfig(**multihost_check.CFG_KW), multihost_check.SEED,
                             multihost_check.BATCH, multihost_check.TICKS, jmake_mesh(8))
    m = jax.device_get(m)
    fields = {f: np.asarray(v).tolist() for f, v in zip(m._fields, m)}
    want = hashlib.sha256(json.dumps(fields, sort_keys=True).encode()).hexdigest()
    assert doc["parity_hash"] == want
