"""The port's cluster-axis mesh (raft_sim_tpu_torch/parallel/mesh.py) and the
sharded Session (`Session(devices=)`, `run --devices`) on the CPU, against
the port's unsharded runs and the JAX package's sharded ones.

The CPU tests put several shards on the one `cpu` device (an explicit device
list may repeat a device), where the JAX package runs on the 8 virtual
devices of tests/conftest.py. Inputs come from one seed in both packages.

Tolerance: exact equality (value, dtype, shape) of every ClusterState,
RunMetrics and WindowRecord leaf, and of every trace leg -- the simulator
is integer-only -- and equal FleetSummary dicts.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.parallel import make_mesh as jmake_mesh
from raft_sim_tpu.parallel import mesh as jmesh
from raft_sim_tpu.parallel import simulate_sharded as jsimulate_sharded
from raft_sim_tpu.parallel import summarize as jsummarize
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.driver import Session
from raft_sim_tpu_torch.parallel import mesh as tmesh
from raft_sim_tpu_torch.scenario import genome as tgenome
from raft_sim_tpu_torch.scenario import search as tsearch
from raft_sim_tpu_torch.sim import scan, telemetry
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8
CFG_KW = dict(n_nodes=5, client_interval=8)
FAULTS_KW = dict(n_nodes=5, drop_prob=0.2)
# The round-4 surface: the compaction ring with snapshot catch-up and the
# redirect client, under drop and crash churn.
RING_KW = dict(n_nodes=5, log_capacity=8, compact_margin=4, client_interval=2,
               client_redirect=True, drop_prob=0.2, crash_prob=0.4, crash_period=16,
               crash_down_ticks=8)
SEED, BATCH, TICKS = 3, 8, 64


def _same(a, b, what):
    d = bridge.first_difference(a, b)
    assert d is None, f"{what}: {d}"


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's sharded runs on its 8 virtual devices."""
    mesh = jmake_mesh()
    f, m = jsimulate_sharded(rst.RaftConfig(**CFG_KW), SEED, BATCH, TICKS, mesh)
    _, mf = jsimulate_sharded(rst.RaftConfig(**FAULTS_KW), 1, BATCH, TICKS, mesh)
    return jax.device_get(f), jax.device_get(m), jsummarize(mf)


def test_mesh_shapes_and_errors():
    """An explicit list may repeat a device; asking for more than it holds
    raises the JAX message; with no card the default mesh names the fix."""
    mesh = tmesh.make_mesh(devices=CPU8)
    assert mesh.size == 8 and mesh.shape == {"clusters": 8}
    assert tmesh.make_mesh(3, devices=CPU8).size == 3
    with pytest.raises(ValueError, match="requested 9 devices, only 8 available"):
        tmesh.make_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            tmesh.make_mesh()
    with pytest.raises(ValueError, match="batch 12 must divide over 8 devices"):
        tmesh.simulate_sharded(tconfig.RaftConfig(**CFG_KW), 0, 12, 4, mesh)


def test_sharded_matches_unsharded_and_jax(jax_runs):
    """8 CPU shards == the port's unsharded `simulate` == the JAX package's
    `simulate_sharded` on 8 virtual devices, final state and metrics."""
    cfg = tconfig.RaftConfig(**CFG_KW)
    fs, ms = tmesh.simulate_sharded(cfg, SEED, BATCH, TICKS, tmesh.make_mesh(devices=CPU8))
    fd, md = scan.simulate(cfg, SEED, BATCH, TICKS, device="cpu")
    _same(fs, fd, "state vs unsharded")
    _same(ms, md, "metrics vs unsharded")
    jf, jm, _ = jax_runs
    _same(fs, jf, "state vs JAX")
    _same(ms, jm, "metrics vs JAX")
    assert int(ms.max_commit.max()) > 0


@pytest.mark.parametrize("shards", [2, 3, 6])
def test_shard_count_invariance_on_the_ring(shards):
    """Compaction, snapshot catch-up and the redirect client under churn:
    the same trajectory at every shard count (6 clusters over 2, 3, 6)."""
    cfg = tconfig.RaftConfig(**RING_KW)
    fs, ms = tmesh.simulate_sharded(cfg, 5, 6, 96, tmesh.make_mesh(devices=["cpu"] * shards))
    fd, md = scan.simulate(cfg, 5, 6, 96, device="cpu")
    _same(fs, fd, "state")
    _same(ms, md, "metrics")
    assert int(fs.log_base.max()) > 0  # the ring compacted


def test_windowed_sharded_matches_unsharded():
    """The farm's evaluator: a traced genome fleet over 4 shards equals the
    unsharded windowed run -- state, metrics, window records and every trace
    leg (batch-minor, gathered along the cluster axis)."""
    from raft_sim_tpu_torch.trace.ring import TraceSpec

    cfg = dataclasses.replace(tconfig.RaftConfig(**RING_KW), track_trace=True)
    knobs = tsearch.default_knobs(cfg)
    xs = np.random.default_rng(4).random((8, len(knobs)))
    g, _ = tsearch._population_genome(cfg, knobs, xs)
    tgenome.validate(cfg, g)
    spec = TraceSpec(depth=8, coverage=True)
    got = tmesh.simulate_windowed_sharded(cfg, 2, 8, 64, 32, tmesh.make_mesh(devices=["cpu"] * 4),
                                          genome=g, trace=spec)
    want = telemetry.simulate_windowed(cfg, 2, 8, 64, 32, genome=g, trace=spec, device="cpu")
    assert got[3] is None and want[3] is None
    for i, what in ((0, "state"), (1, "metrics"), (2, "records"), (4, "trace windows"),
                    (5, "trace persist")):
        _same(got[i], want[i], what)


def test_windowed_sharded_matches_jax():
    """The evaluator over 8 CPU shards against the JAX package's
    `simulate_windowed_sharded` on its 8 virtual devices: state, metrics and
    window records (untraced, no genome)."""
    cfg = tconfig.RaftConfig(**CFG_KW)
    got = tmesh.simulate_windowed_sharded(cfg, SEED, BATCH, TICKS, 32,
                                          tmesh.make_mesh(devices=CPU8))
    want = jax.device_get(jmesh.simulate_windowed_sharded(rst.RaftConfig(**CFG_KW), SEED, BATCH,
                                                          TICKS, 32, jmake_mesh()))
    assert got[3] is None and want[3] is None
    for i, what in enumerate(("state", "metrics", "records")):
        _same(got[i], want[i], what)


def test_summarize_under_faults(jax_runs):
    """The fleet rollup of a sharded run under 20% drop equals the JAX
    package's over its 8 devices."""
    cfg = tconfig.RaftConfig(**FAULTS_KW)
    _, ms = tmesh.simulate_sharded(cfg, 1, BATCH, TICKS, tmesh.make_mesh(devices=CPU8))
    s = tmesh.summarize(ms)
    assert s._asdict() == jax_runs[2]._asdict()
    assert s.n_clusters == BATCH and s.total_violations == 0 and s.n_stable > BATCH // 2
    assert tmesh.gather_metrics(ms) is ms  # one process: nothing to gather


def test_session_sharded_matches_unsharded(tmp_path):
    """Session(devices=4) == Session() over chunks: each shard's state stays
    a slice of its own; the gathered state, metrics and summary are equal.
    A checkpoint does not depend on the layout: restored onto 2 shards and
    run on, it equals the unsharded session run on."""
    cfg = tconfig.RaftConfig(n_nodes=5, client_interval=8, drop_prob=0.1)
    a = Session(cfg, batch=8, seed=7, device="cpu")
    b = Session(cfg, batch=8, seed=7, device="cpu", devices=4)
    assert len(b._state) == 4 and all(s.role.shape[0] == 2 for s in b._state)
    a.run(100, chunk=32)
    b.run(100, chunk=32)
    _same(b.state, a.state, "state")
    _same(b.metrics, a.metrics, "metrics")
    assert a.summary() == b.summary()
    path = b.save(str(tmp_path / "ck"))
    c = Session.restore(path, device="cpu", devices=2)
    assert len(c._state) == 2
    c.run(40, chunk=16)
    a.run(40, chunk=16)
    _same(c.state, a.state, "restored state")
    _same(c.metrics, a.metrics, "restored metrics")
    c.reset()
    assert len(c._state) == 2 and c.now == 0


def _untimed(row):
    """A health row without what the host's clock measures (the device-wait
    SLI and its burn, wall times)."""
    if isinstance(row, dict):
        return {k: _untimed(v) for k, v in row.items()
                if k != "device_wait" and "time" not in k and "wall" not in k}
    return row


def test_session_sharded_plain_path_planes(tmp_path):
    """A sharded Session's run takes the unsharded plain chunked path
    (chunked.run_chunked over the shards): the apply log, the chunk timer
    and the health plane see the gathered fleet, so the apply log files and
    the health rows (but for what the clock measures) equal the unsharded
    session's, a perf row a chunk."""
    cfg = tconfig.RaftConfig(n_nodes=5, client_interval=4, drop_prob=0.1)
    out = {}
    for name, devices in (("one", None), ("four", 4)):
        s = Session(cfg, batch=8, seed=2, device="cpu", devices=devices)
        s.attach_apply_log(str(tmp_path / name / "apply"), cluster=5)
        s.attach_perf()
        s.attach_health("default", str(tmp_path / name / "health"))
        s.run(64, chunk=16)
        files = sorted((tmp_path / name / "apply").iterdir())
        health = [json.loads(ln) for ln in (tmp_path / name / "health" / "health.jsonl")
                  .read_text().splitlines()]
        out[name] = ({f.name: f.read_text() for f in files}, len(s.perf.rows),
                     [_untimed(row) for row in health])
    assert out["one"][0] and out["one"][0] == out["four"][0]
    assert out["one"][1] == out["four"][1] == 4
    assert out["one"][2] and out["one"][2] == out["four"][2]


def test_session_sharding_errors(tmp_path):
    """The JAX `_apply_sharding` errors; a sharded Session refuses nothing
    the unsharded one takes: the telemetry sink attaches and an offer
    returns the unsharded session's dict (tests/test_torch_sharded_planes.py
    holds the files and dicts against the JAX package)."""
    cfg = tconfig.RaftConfig(n_nodes=5)
    with pytest.raises(ValueError, match="devices must be >= 1, got 0"):
        Session(cfg, batch=4, device="cpu", devices=0)
    with pytest.raises(ValueError, match="batch 4 must divide over 3 devices"):
        Session(cfg, batch=4, device="cpu", devices=3)
    assert Session(cfg, batch=4, device="cpu", devices=1)._mesh is None
    offers = []
    for devices in (None, 2):
        s = Session(cfg, batch=4, device="cpu", devices=devices)
        s.attach_telemetry(str(tmp_path / f"tel{devices}"))
        s.run(16, chunk=16)
        offers.append(s.offer(5, wait=8))
    assert offers[0] == offers[1]


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "raft_sim_tpu_torch", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)


def test_run_devices_cli(tmp_path):
    """`run --devices 4` prints the unsharded run's summary and saves the
    same checkpoint; `--devices 3` on a batch of 8 is a usage error (exit
    2), on a fresh run and on --resume alike."""
    base = ("run", "--device", "cpu", "--n-nodes", "5", "--client-interval", "4", "--batch", "8",
            "--ticks", "48", "--chunk", "16")
    outs = []
    for extra, name in (((), "one"), (("--devices", "4"), "four")):
        proc = _run_cli(*base, *extra, "--save", str(tmp_path / name))
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        for k in ("wall_s", "cluster_ticks_per_s"):
            out.pop(k)
        outs.append(out)
    assert outs[0] == outs[1]
    with np.load(tmp_path / "one.npz") as x, np.load(tmp_path / "four.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    bad = _run_cli(*base, "--devices", "3")
    assert bad.returncode == 2 and "batch 8 must divide over 3 devices" in bad.stderr
    bad = _run_cli("run", "--device", "cpu", "--resume", str(tmp_path / "one.npz"), "--ticks",
                   "8", "--devices", "3")
    assert bad.returncode == 2 and "batch 8 must divide over 3 devices" in bad.stderr
