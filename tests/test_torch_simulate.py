"""The port's main path end to end on the CPU: `simulate` (init from the seed,
input draws, tick, metric fold) against the JAX package's `scan.simulate`, the
fleet summary against `parallel.summarize`, the CLI, and the device rules.

Tolerance: exact equality of the final ClusterState and every RunMetrics leaf
(value, dtype, shape), and equal FleetSummary values.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.parallel import summarize as jsummarize
from raft_sim_tpu.sim import scan as jscan
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.sim import scan as tscan
from raft_sim_tpu_torch.summary import summarize as tsummarize
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

CASES = [
    # (preset, batch, ticks): small B and T; config1 at its own batch of 1.
    pytest.param("config1", 1, 100, id="config1"),
    pytest.param("config2", 8, 100, id="config2"),
    pytest.param("config3", 8, 80, id="config3"),
    pytest.param("config4", 8, 100, id="config4"),
    pytest.param("config5", 4, 64, id="config5"),
    # Slice 2: crash schedules, the compacting ring (wrapped by tick ~130),
    # the redirect client and PreVote.
    pytest.param("config6", 4, 200, id="config6"),
    pytest.param("config6r", 4, 200, id="config6r"),
    pytest.param("config3p", 8, 80, id="config3p"),
    # Slice 3: config8 past its first transfers (61, 122) and membership
    # toggle (97); config9's lease reads until its CAP=64 ring wraps.
    pytest.param("config8", 4, 128, id="config8"),
    pytest.param("config9", 4, 320, id="config9"),
    # Slice 4: config10's fsync cadence, recovery and durability gate under
    # crash churn (its first crash windows end at ticks 64 and 128).
    pytest.param("config10", 4, 200, id="config10"),
    # config4c (config4's faults with a client, CAP=64) and config7 (N=101:
    # four packed words a row, a client every 4 ticks under drop).
    pytest.param("config4c", 4, 100, id="config4c"),
    pytest.param("config7", 3, 40, id="config7"),
    # Slice 7: config6 with log matching on its ring every tick, which
    # counts incomparable pairs (lm_skipped_pairs).
    pytest.param("config6-lm", 4, 200, id="config6-lm"),
]


@pytest.mark.parametrize("name,batch,ticks", CASES)
def test_simulate_matches_jax(name, batch, ticks):
    lm = name.endswith("-lm")
    jcfg, _ = rst.PRESETS[name.removesuffix("-lm")]
    tcfg, _ = tconfig.PRESETS[name.removesuffix("-lm")]
    if lm:
        jcfg = dataclasses.replace(jcfg, check_log_matching=True)
        tcfg = dataclasses.replace(tcfg, check_log_matching=True)
    want_s, want_m = jax.device_get(jscan.simulate(jcfg, 7, batch, ticks))
    got_s, got_m = tscan.simulate(tcfg, 7, batch, ticks, device="cpu")
    assert bridge.first_difference(want_s, got_s) is None
    assert bridge.first_difference(want_m, got_m) is None
    summary = tsummarize(got_m)
    assert summary._asdict() == jsummarize(want_m)._asdict()
    assert int(got_m.violations.sum()) == 0
    if tcfg.read_index:  # the read quantiles were computed from real reads
        assert summary.reads_served > 0 and summary.read_p99 is not None
    if tcfg.durable_storage:  # the fsync-lag rollup was computed from real lag
        assert summary.fsync_lag_total > 0 and summary.fsync_lag_p95 is not None
    if tcfg.compaction:  # every cluster's ring wrapped
        assert int(got_s.log_base.amin()) > 0 and int(got_m.max_commit.amin()) > tcfg.log_capacity
    if lm:  # the ring form met incomparable pairs
        assert summary.lm_skipped_pairs > 0


def test_summarize_matches_jax_with_latency_traffic():
    """A run with client traffic exercises every latency readout."""
    jcfg = rst.RaftConfig(n_nodes=5, log_capacity=64, client_interval=2, drop_prob=0.1)
    tcfg = tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    _, want_m = jax.device_get(jscan.simulate(jcfg, 3, 12, 120))
    _, got_m = tscan.simulate(tcfg, 3, 12, 120, device="cpu")
    want = jsummarize(want_m)._asdict()
    got = tsummarize(got_m)._asdict()
    assert got == want
    assert want["lat_p99"] is not None and want["total_cmds"] > 0


def test_stable_leader_ticks_matches_jax():
    jcfg, _ = rst.PRESETS["config4"]
    tcfg, _ = tconfig.PRESETS["config4"]
    _, want_m = jscan.simulate(jcfg, 1, 6, 60)
    _, got_m = tscan.simulate(tcfg, 1, 6, 60, device="cpu")
    assert jax.device_get(jscan.stable_leader_ticks(want_m)).tolist() == (
        tscan.stable_leader_ticks(got_m).tolist()
    )


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "raft_sim_tpu_torch", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )


def test_cli_run_on_cpu():
    import json

    proc = _run_cli("run", "--preset", "config2", "--batch", "8", "--ticks", "50", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n_clusters"] == 8 and out["total_violations"] == 0 and out["device"] == "cpu"


def test_cli_presets():
    proc = _run_cli("presets")
    assert proc.returncode == 0, proc.stderr
    assert "config5: batch=10000" in proc.stdout


def test_default_device_raises_without_a_card(tmp_path):
    """The entry points default to the card and never drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg, _ = tconfig.PRESETS["config2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscan.simulate(cfg, 0, 2, 3)
    proc = _run_cli("run", "--preset", "config2", "--batch", "2", "--ticks", "3")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    # The long-horizon path: a Session, a checkpoint load and `run --resume`.
    from raft_sim_tpu_torch.driver import Session
    from raft_sim_tpu_torch.utils import checkpoint

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(cfg, batch=2)
    path = Session(cfg, batch=2, device="cpu").save(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.restore(path)
    proc = _run_cli("run", "--resume", path, "--ticks", "3")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


@pytest.mark.parametrize(
    "kw,gate",
    [(dict(track_trace=True), "track_trace"), (dict(compact_planes=True), "compact_planes")],
    ids=lambda x: x if isinstance(x, str) else None,
)
def test_simulate_unsupported_gate_raises(kw, gate):
    """Both gates, once refused, are taken. A plain run under track_trace is
    the untraced run; under compact_planes the final state, unpacked
    (ops/tile.py), and the metrics are the dense run's."""
    from raft_sim_tpu_torch.ops import tile

    cfg = tconfig.RaftConfig(**kw)
    want = tscan.simulate(tconfig.RaftConfig(), 0, 2, 3, device="cpu")
    got = tscan.simulate(cfg, 0, 2, 3, device="cpu")
    final = tile.unpack_state(cfg, got[0], lead=1) if gate == "compact_planes" else got[0]
    assert bridge.first_difference(want[0], final) is None
    assert bridge.first_difference(want[1], got[1]) is None


@pytest.mark.parametrize("name,gate", [("config9", "serve_reads"), ("config2", "serve_ingest")],
                         ids=["serve_reads", "serve_ingest"])
def test_simulate_takes_serve_gates(name, gate):
    """The serve gates on top of a preset's own cadences: `simulate` equals
    the JAX package's, and the cadences still run (reads served, commands
    committed with their latency tracked)."""
    jcfg = dataclasses.replace(rst.PRESETS[name][0], **{gate: True})
    tcfg = dataclasses.replace(tconfig.PRESETS[name][0], **{gate: True})
    want_s, want_m = jax.device_get(jscan.simulate(jcfg, 5, 6, 120))
    got_s, got_m = tscan.simulate(tcfg, 5, 6, 120, device="cpu")
    assert bridge.first_difference(want_s, got_s) is None
    assert bridge.first_difference(want_m, got_m) is None
    assert int(got_m.lat_cnt.sum()) > 0
    assert int(got_m.reads_served.sum()) > 0 or gate != "serve_reads"


def test_tick_batch_minor_matches_jax():
    """tick_batch_minor's state, metrics and StepInfo equal the JAX
    package's, tick by tick for 8 ticks with client traffic, from the same
    mid-run state carried across by the bridge."""
    from raft_sim_tpu.models import raft_batched as jrb
    from raft_sim_tpu_torch import types as ttypes
    from raft_sim_tpu_torch.models import raft_batched as trb
    from raft_sim_tpu_torch.utils import threefry

    jcfg, _ = rst.PRESETS["config2"]
    tcfg, _ = tconfig.PRESETS["config2"]
    B, T = 4, 30
    state, _ = jscan.simulate(jcfg, 2, B, T)
    keys = jax.random.split(jax.random.split(jax.random.key(2))[1], B)
    s_t = jrb.to_batch_minor(state)
    m_t = jrb.to_batch_minor(jscan.init_metrics_batch(B))
    ps = trb.to_batch_minor(bridge.to_port(jax.device_get(state), ttypes.ClusterState))
    pm = trb.to_batch_minor(tscan.init_metrics_batch(B))
    tkeys = threefry.split(threefry.split(threefry.key(2), 2)[1], B)
    injected = 0
    for t in range(T, T + 8):
        s_t, m_t, j_info = jscan.tick_batch_minor(jcfg, s_t, keys, m_t)
        want = jax.device_get((s_t, m_t, j_info))
        got = tscan.tick_batch_minor(tcfg, ps, tkeys, pm, t)
        for w, g in zip(want, got):
            assert bridge.first_difference(w, g) is None
        ps, pm, info = got
        injected += int(info.cmds_injected.sum())
    assert injected > 0
