"""The port's health plane (raft_sim_tpu_torch/health/: specs, SLIs, burn
rates, triage, evidence, the monitor) and its wiring through Session and
ServeSession, against the JAX package's, on the CPU at small sizes.

The host-side parts run on the JAX tests' fixed inputs in both packages and
must agree exactly. End to end, a Session with a telemetry sink, a flight
ring of 8 and the default spec runs the scenario tier's kitchen-sink config
(drop 0.2, partitions, crashes) at 16 x 192, window 32, where commit latency
burns and alerts fire: health.jsonl, alerts.jsonl and every evidence bundle
(alert.json, windows.jsonl, flight_<c>.jsonl) are byte-equal with JAX's, and
the trajectory equals the unmonitored one. The plain chunked path and a
2-tenant served config9 session give the JAX rows too.

Tolerance: exact equality. The only fields left out are the SLIs derived
from clock readings: `slis.device_wait.share` (the device-wait share of a
perf-armed session).
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu import driver as jdriver
from raft_sim_tpu import health as jhealth
from raft_sim_tpu.health import burn as jburn
from raft_sim_tpu.health import evidence as jevidence
from raft_sim_tpu.health import sli as jsli
from raft_sim_tpu.health import triage as jtriage
from raft_sim_tpu.obs import ChunkTimer as JTimer
from raft_sim_tpu.serve import loop as jloop
from raft_sim_tpu.serve import tenancy as jten
from raft_sim_tpu.utils import telemetry_sink as jsink
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import driver as tdriver
from raft_sim_tpu_torch import health as thealth
from raft_sim_tpu_torch.health import burn as tburn
from raft_sim_tpu_torch.health import evidence as tevidence
from raft_sim_tpu_torch.health import sli as tsli
from raft_sim_tpu_torch.health import triage as ttriage
from raft_sim_tpu_torch.obs import ChunkTimer as TTimer
from raft_sim_tpu_torch.serve import loop as tloop
from raft_sim_tpu_torch.serve import tenancy as tten
from raft_sim_tpu_torch.types import LAT_HIST_BINS
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import telemetry_sink as tsink

torch.set_num_threads(1)

SINK_KW = dict(n_nodes=5, log_capacity=8, client_interval=4, drop_prob=0.2,
               partition_period=16, partition_prob=0.3, crash_prob=0.3, crash_period=32,
               crash_down_ticks=8, clock_skew_prob=0.1)
HB, HT, HW, HCHUNK = 16, 192, 32, 64


def _spec(**overrides):
    spec = {
        "schema": "health-slo-v1", "eval_windows": 1, "worst_k": 3, "outlier_score": 3.0,
        "resolve_evals": 2,
        "objectives": {"availability": {"sli": "availability", "target": 0.9}},
        "rules": [{"name": "fast", "short": 1, "long": 2, "burn": 6.0}],
    }
    spec.update(overrides)
    return spec


def _unit(batch=4, start=0, ticks=16, **fields):
    u = {
        "start": start, "ticks": ticks,
        "violations": np.zeros(batch, np.int64), "leaderless": np.zeros(batch, bool),
        "cmds": np.zeros(batch, np.int64), "reads": np.zeros(batch, np.int64),
        "lat_sum": np.zeros(batch, np.int64), "lat_cnt": np.zeros(batch, np.int64),
        "lat_hist": np.zeros((batch, LAT_HIST_BINS), np.int64),
        "read_hist": np.zeros((batch, LAT_HIST_BINS), np.int64),
        "fsync_lag_sum": np.zeros(batch, np.int64), "fsync_lag_max": np.zeros(batch, np.int64),
    }
    u.update(fields)
    return u


def _plain(x):
    """Numpy arrays as lists, recursively: a comparable form of SLI output."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return [x.dtype.str, x.tolist()]
    return x


def _tree_bytes(directory: str, names=None) -> dict:
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), directory)
            if names is None or rel in names or rel.startswith("evidence_"):
                with open(os.path.join(root, name), "rb") as f:
                    out[rel] = f.read()
    return out


# ----------------------------------------------------------- host-side parts


SPEC_MUTATIONS = [
    lambda s: s.update(schema="nope"),
    lambda s: s.update(eval_windows=0),
    lambda s: s.update(outlier_score=-1),
    lambda s: s.update(objectives={}),
    lambda s: s["objectives"].update(bad={"sli": "made_up"}),
    lambda s: s["objectives"].update(bad={"sli": "availability", "target": 1.0}),
    lambda s: s["objectives"].update(bad={"sli": "commit_latency", "target": 0.9}),
    lambda s: s["objectives"].update(bad={"sli": "throughput", "min_ops_per_window": 1,
                                          "budget": 0}),
    lambda s: s["objectives"]["availability"].update(pending_evals=-1),
    lambda s: s.update(rules=[]),
    lambda s: s.update(rules=[{"name": "r", "short": 4, "long": 2, "burn": 1.0}]),
    lambda s: s.update(rules=[{"name": "r", "short": 1, "long": 2, "burn": 1.0},
                              {"name": "r", "short": 1, "long": 2, "burn": 2.0}]),
    lambda s: s["objectives"].update(bad={"sli": "durability_lag", "max_lag": -1,
                                          "budget": 0.5}),
]


@pytest.mark.parametrize("i", range(len(SPEC_MUTATIONS)))
def test_validate_spec_matches_jax(i):
    spec = copy.deepcopy(_spec())
    SPEC_MUTATIONS[i](spec)
    errors = thealth.validate_spec(spec)
    assert errors and errors == jhealth.validate_spec(spec)
    with pytest.raises(ValueError) as got:
        thealth.load_spec(spec)
    with pytest.raises(ValueError) as want:
        jhealth.load_spec(spec)
    assert str(got.value) == str(want.value)


def test_default_spec_matches_jax(tmp_path):
    assert thealth.DEFAULT_SPEC == jhealth.DEFAULT_SPEC
    assert thealth.HEALTH_SPEC_SCHEMA == jhealth.HEALTH_SPEC_SCHEMA
    assert thealth.validate_spec(thealth.DEFAULT_SPEC) == []
    spec = thealth.load_spec("default")
    spec["eval_windows"] = 99  # a caller's copy, not the default itself
    assert thealth.DEFAULT_SPEC["eval_windows"] == 2
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(_spec(worst_k=5)))
    assert thealth.load_spec(str(path)) == jhealth.load_spec(str(path))
    assert tburn.ALERT_STATES == jburn.ALERT_STATES and tburn.BURN_INF == jburn.BURN_INF


def test_hist_percentile_and_fast_bins_match_jax():
    rng = np.random.default_rng(7)
    hists = [np.zeros(LAT_HIST_BINS, np.int64)] + [
        rng.integers(0, 20, size=LAT_HIST_BINS) * (rng.random(LAT_HIST_BINS) < 0.4)
        for _ in range(40)]
    for h in hists:
        for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert tsli.hist_percentile(h, q) == jsli.hist_percentile(h, q)
    for t in range(1, 1 << 18, 7):
        assert tsli.fast_bins(t) == jsli.fast_bins(t)


def _slis_case(kind: str):
    if kind == "quiet":
        spec = _spec(objectives={
            "commit_latency": {"sli": "commit_latency", "threshold_ticks": 16, "target": 0.99},
            "throughput": {"sli": "throughput", "min_ops_per_window": 0, "budget": 0.25},
            "device_wait": {"sli": "device_wait_share", "min_share": 0.0, "budget": 0.25},
        })
        return spec, [_unit()], []
    spec = _spec(objectives={
        "availability": {"sli": "availability", "target": 0.9},
        "commit_latency": {"sli": "commit_latency", "threshold_ticks": 16, "target": 0.99},
        "read_staleness": {"sli": "read_staleness", "stale_after_ticks": 4, "target": 0.99},
        "throughput": {"sli": "throughput", "min_ops_per_window": 100, "budget": 0.25},
        "safety": {"sli": "safety", "pending_evals": 0},
        "device_wait": {"sli": "device_wait_share", "min_share": 0.5, "budget": 0.25},
        "recompile": {"sli": "recompiles", "pending_evals": 0},
        "durability": {"sli": "durability_lag", "max_lag": 3, "budget": 0.25},
    })
    lat0 = np.zeros((4, LAT_HIST_BINS), np.int64)
    lat0[0, 1], lat0[0, 5] = 10, 2
    lat1 = np.zeros((4, LAT_HIST_BINS), np.int64)
    lat1[1, 3] = 4
    reads0 = np.zeros((4, LAT_HIST_BINS), np.int64)
    reads0[2, 0], reads0[2, 2] = 5, 3
    units = [
        _unit(start=0, leaderless=np.array([True, False, False, False]), lat_hist=lat0,
              read_hist=reads0, cmds=np.array([10, 2, 0, 0]), reads=np.array([0, 0, 8, 0]),
              fsync_lag_max=np.array([0, 5, 1, 0]), fsync_lag_sum=np.array([0, 40, 3, 0])),
        _unit(start=16, leaderless=np.array([True, True, False, False]), lat_hist=lat1,
              cmds=np.array([0, 0, 4, 0]), violations=np.array([0, 0, 0, 5])),
    ]
    perf = [{"wall_s": 9.0, "device_wait_s": 9.0, "warmup": True},
            {"wall_s": 1.0, "device_wait_s": 0.2},
            {"wall_s": 1.0, "device_wait_s": 0.4, "recompiled": True}]
    return spec, units, perf


@pytest.mark.parametrize("kind", ["rollup", "quiet"])
def test_compute_slis_matches_jax(kind):
    spec, units, perf = _slis_case(kind)
    got = tsli.compute_slis(spec, units, perf)
    assert _plain(got) == _plain(jsli.compute_slis(spec, units, perf))


BURN_STREAMS = {
    "clean": (_spec(), [0.0] * 6),
    "burst-resolve": (_spec(), [1.0, 1.0, 0.0, 0.0, 0.0]),
    "blip": (_spec(), [1.0, 0.0, 1.0, 0.0]),
    "safety": (_spec(objectives={"availability": {"sli": "availability", "target": 0.9,
                                                  "pending_evals": 0}}), [0.0, 0.5, 0.5, 0.0]),
    "long-gate": (_spec(rules=[{"name": "slow", "short": 1, "long": 4, "burn": 6.0}]),
                  [0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0]),
    "two-rules": (copy.deepcopy(jhealth.DEFAULT_SPEC), None),
}


@pytest.mark.parametrize("name", sorted(BURN_STREAMS))
def test_burn_engine_matches_jax(name):
    spec, stream = BURN_STREAMS[name]
    objs = list(spec["objectives"])
    if stream is None:
        stream = list(np.random.default_rng(3).random(12) * (np.arange(12) % 5 < 3))
    engines = [tburn.BurnEngine(spec), jburn.BurnEngine(spec)]
    budgets = {o: (0.0 if o in ("safety", "recompile") else 0.1) for o in objs}
    for err in stream:
        errs = {o: err for o in objs}
        got, want = (e.update(errs, budgets) for e in engines)
        assert got == want
        assert engines[0].status() == engines[1].status()
        assert engines[0].firing() == engines[1].firing()
        assert [engines[0].burns(o, budgets[o]) for o in objs] == [
            engines[1].burns(o, budgets[o]) for o in objs]


@pytest.mark.parametrize("values,k,base", [
    ([], 3, 0), ([0.0, 0.0, 0.0], 3, 0), ([0.0, 0.0, 9.0, 0.0], 3, 0),
    ([5.0, 5.0, 3.0, 0.0], 2, 0), ([4.0, 4.0, 4.0, 4.0], 3, 0), ([0.0, 7.0], 3, 10),
    (list(np.random.default_rng(1).integers(0, 9, 40).astype(float)), 5, 100),
])
def test_outlier_clusters_matches_jax(values, k, base):
    assert (ttriage.outlier_clusters(values, k, 3.0, cluster_base=base)
            == jtriage.outlier_clusters(values, k, 3.0, cluster_base=base))


def _drive_monitor(pkg, d):
    """A scripted incident on synthetic units: pending -> firing (evidence
    with a flight snapshot from the capture hook) -> resolved."""
    health, sink_mod = pkg
    from raft_sim_tpu_torch.types import StepInfo

    infos = StepInfo(*(np.arange(2 * (LAT_HIST_BINS if f.endswith("_hist") else 1)).reshape(
        (2, LAT_HIST_BINS) if f.endswith("_hist") else (2,)).astype(
            bool if f.startswith("viol") else np.int32) for f in StepInfo._fields))

    def capture(alert, clusters):
        return {"flights": {c: (np.array([7, 8]), infos) for c in clusters}, "refs": {"seed": 0}}

    mon = health.HealthMonitor(_spec(resolve_evals=1, worst_k=2), batch=4,
                               writer=health.HealthWriter(d), scope="fleet", capture=capture)
    sick = _unit(leaderless=np.array([True, True, True, False]))
    lines = []
    for u in (sick, sick, _unit()):
        mon.observe_units([u])
        lines.append(mon.status_line())
    return mon.finalize(), lines, sink_mod.validate_health_files(d)


def test_monitor_and_evidence_match_jax(tmp_path):
    """One monitor through a scripted incident in each package: the rollup,
    the status lines, health.jsonl, alerts.jsonl and the evidence bundle
    (flight files included) are equal, byte for byte where they are files."""
    got = _drive_monitor((thealth, tsink), str(tmp_path / "port"))
    want = _drive_monitor((jhealth, jsink), str(tmp_path / "jax"))
    assert got == want and got[2] == [] and got[0]["fired_objectives"] == ["availability"]
    assert _tree_bytes(str(tmp_path / "port")) == _tree_bytes(str(tmp_path / "jax"))
    assert tevidence.EVIDENCE_SCHEMA == jevidence.EVIDENCE_SCHEMA
    assert tevidence.validate_bundle(str(tmp_path / "port" / "evidence_0000")) == []


def test_validate_health_files_negatives_match_jax(tmp_path):
    d = str(tmp_path)
    rows = [{"eval": 0, "scope": "fleet", "window_start": 0, "windows": 1, "ticks": 16,
             "slis": {}, "burn": {}, "status": "ok"},
            {"eval": 2, "scope": "fleet", "window_start": 16, "windows": 1, "ticks": 16,
             "slis": {}, "burn": [], "status": "on-fire"}]
    with open(os.path.join(d, "health.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    assert tsink.validate_health_files(d) == jsink.validate_health_files(d)
    alerts = [{"eval": 0, "scope": "fleet", "objective": "a", "rule": "fast",
               "state": "firing", "burn_short": 9.0, "burn_long": 9.0, "worst_clusters": [],
               "evidence": None},
              {"eval": 1, "scope": "fleet", "objective": "a", "rule": "fast", "state": "gone",
               "burn_short": -1, "burn_long": 0.0, "worst_clusters": [{"c": 1}],
               "evidence": "evidence_0007"}]
    with open(os.path.join(d, "alerts.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in alerts)
    os.mkdir(os.path.join(d, "evidence_0003"))
    got = tsink.validate_health_files(d)
    assert len(got) >= 6 and got == jsink.validate_health_files(d)


def test_observe_chunk_and_begin_run_match_jax():
    """The plain-path delta fold on cumulative metrics (numpy, and port
    tensors copied to the host in one go) gives the JAX monitor's units."""
    from raft_sim_tpu_torch.sim import telemetry as ttel

    class _Writer:
        def append_health(self, row):
            pass

        def append_alert(self, row):
            pass

    def metrics(cmds, viol, first, tensor):
        z = np.zeros(2, np.int32)
        zh = np.zeros((2, LAT_HIST_BINS), np.int32)
        leaves = dict(violations=np.array(viol, np.int32), total_cmds=np.array(cmds, np.int32),
                      reads_served=z, lat_sum=z, lat_cnt=z, lat_hist=zh, read_hist=zh,
                      fsync_lag_sum=z, fsync_lag_max=np.array(viol, np.int32),
                      first_leader_tick=np.array(first, np.int32), ticks=z)
        if tensor:
            from raft_sim_tpu_torch.sim.scan import RunMetrics

            full = {f: torch.zeros(2, dtype=torch.int32) for f in RunMetrics._fields}
            full.update({k: torch.from_numpy(v) for k, v in leaves.items()})
            return RunMetrics(**full)
        return SimpleNamespace(**leaves)

    steps = [(16, [5, 0], [0, 0], [3, ttel.NEVER]), (32, [8, 1], [0, 2], [3, 40]), None,
             (16, [2, 2], [0, 0], [3, 40])]
    units = []
    for pkg, tensor in ((thealth, True), (jhealth, False)):
        mon = pkg.HealthMonitor(_spec(eval_windows=100), batch=2, writer=_Writer())
        mon.begin_run()
        for st in steps:
            if st is None:
                mon.begin_run()
            else:
                mon.observe_chunk(st[0], metrics(*st[1:], tensor))
        units.append([_plain(u) for u in mon._units])
    assert units[0] == units[1] and len(units[0]) == 3


# ------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The kitchen-sink config at 16 x 192 (window 32, ring 8, chunks of
    64): JAX armed, the port armed and the port unarmed."""
    base = tmp_path_factory.mktemp("health")
    out = {}
    for name, mod, cfg, kw, armed in (
            ("jax", jdriver, rst.RaftConfig(**SINK_KW), {}, True),
            ("port", tdriver, tconfig.RaftConfig(**SINK_KW), {"device": "cpu"}, True),
            ("plain", tdriver, tconfig.RaftConfig(**SINK_KW), {"device": "cpu"}, False)):
        s = mod.Session(cfg, batch=HB, seed=0, **kw)
        d = str(base / name)
        s.attach_telemetry(d, window=HW, ring=8)
        if armed:
            s.attach_health()
        s.run(HT, chunk=HCHUNK)
        out[name] = (s, d, s.health.finalize() if armed else None)
    return out


def test_session_health_files_match_jax(sessions):
    (_, jd, jroll), (_, td, troll) = sessions["jax"], sessions["port"]
    assert troll == jroll and troll["fired_objectives"] and troll["alerts"] > 0
    names = ("health.jsonl", "alerts.jsonl", "windows.jsonl")
    got = _tree_bytes(td, names)
    assert got == _tree_bytes(jd, names)
    assert any(k.startswith("evidence_") and "/flight_" in k for k in got)
    assert tsink.validate(td) == [] and jsink.validate(td) == []


def test_session_health_is_inert(sessions):
    (armed, ad, _), (plain, pd, _) = sessions["port"], sessions["plain"]
    assert bridge.first_difference(plain.state, armed.state) is None
    assert bridge.first_difference(plain.metrics, armed.metrics) is None
    with open(os.path.join(ad, "windows.jsonl"), "rb") as fa, \
            open(os.path.join(pd, "windows.jsonl"), "rb") as fp:
        assert fa.read() == fp.read()
    # reset() re-arms a truncated health plane.
    armed.reset()
    assert open(os.path.join(ad, "health.jsonl")).read() == "" and armed.health is not None
    assert not any(n.startswith("evidence_") for n in os.listdir(ad))


def test_plain_path_health_matches_jax(tmp_path):
    """A health-armed plain chunked Session (no sink: the chunk is the
    window) across two run() calls (the begin_run seam) gives JAX's health
    and alert lines and JAX's final state."""
    runs = {}
    for name, mod, cfg, kw in (("jax", jdriver, rst.RaftConfig(**SINK_KW), {}),
                               ("port", tdriver, tconfig.RaftConfig(**SINK_KW), {"device": "cpu"})):
        s = mod.Session(cfg, batch=8, seed=3, **kw)
        s.attach_health(directory=str(tmp_path / name))
        s.run(64, chunk=16)
        s.run(32, chunk=16)
        runs[name] = s
    names = ("health.jsonl", "alerts.jsonl")
    assert _tree_bytes(str(tmp_path / "port"), names) == _tree_bytes(str(tmp_path / "jax"), names)
    assert runs["port"].health.finalize() == runs["jax"].health.finalize()
    assert bridge.first_difference(jax.device_get(runs["jax"].state), runs["port"].state) is None
    assert tsink.validate_health_files(str(tmp_path / "port")) == []


def _serve(pkg, cfg, d, timer_cls, ten_mod, **kw):
    sink_mod = jsink if pkg is jloop else tsink
    extra = {} if pkg is jloop else {"backend": "cpu"}
    sink = sink_mod.TelemetrySink(d, pkg.serve_config(cfg), seed=1, batch=8, window=16,
                                  ring=0, source="serve", **extra)
    tenants = [ten_mod.Tenant("a", 4, source=iter(range(1, 300)), reads=40),
               ten_mod.Tenant("b", 4, source=iter(range(500, 800)), reads=40)]
    perf = timer_cls(label="serve", batch=8, sink=sink)
    sess = pkg.ServeSession(cfg, batch=8, seed=1, chunk=32, window=16, sink=sink,
                            warmup_ticks=32, perf=perf, tenants=tenants, health="default", **kw)
    return sess.serve(chunks=2)


def _health_rows(d):
    rows = [json.loads(line) for line in open(os.path.join(d, "health.jsonl"))]
    for r in rows:
        r["slis"]["device_wait"].pop("share")
    return rows


def test_serve_session_health_matches_jax(tmp_path):
    """ServeSession(perf=, health=) at config9 served, 2 tenants, 8 clusters,
    a warmup and 2 chunks of 32: the fleet and tenant scopes' health and
    alert rows equal JAX's (the device-wait share left out), and
    stats["perf"] and stats["health"] are filled."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jstats = _serve(jloop, rst.PRESETS["config9"][0], jd, JTimer, jten)
    tstats = _serve(tloop, tconfig.PRESETS["config9"][0], td, TTimer, tten, device="cpu")
    got, want = _health_rows(td), _health_rows(jd)
    assert got == want and {r["scope"] for r in got} == {"fleet", "tenant:a", "tenant:b"}
    assert open(os.path.join(td, "alerts.jsonl")).read() == open(
        os.path.join(jd, "alerts.jsonl")).read()
    assert tstats["health"] == jstats["health"]
    keep = ("chunks", "steady_chunks", "steady_ticks", "batch", "label",
            "recompiled_after_warmup")
    assert {k: tstats["perf"][k] for k in keep} == {k: jstats["perf"][k] for k in keep}
    perf = [json.loads(line) for line in open(os.path.join(td, "perf.jsonl"))]
    assert [r["warmup"] for r in perf] == [True, True, False]
    assert all("export_s" in r and "pack_s" in r for r in perf[1:])
    assert tsink.validate(td) == [] and jsink.validate(td) == []
