"""The port's telemetry (raft_sim_tpu_torch/sim/telemetry.py, sim/trace.py,
utils/telemetry_sink.py and Session's telemetry path) against the JAX
package's, on the CPU at small sizes: the same seeds give the same window
records, final state, metrics and flight recorder; the records merge into
the run's metrics; the sink's files are the JAX sink's, byte for byte
(windows, flights) or field for field (the manifest, less the fields that
name the software and the time), and each package's validate() accepts the
other's directory.

Tolerance: exact equality of every leaf (value, dtype, shape) and of every
line written.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.sim import telemetry as jtel
from raft_sim_tpu.sim import trace as jtrace
from raft_sim_tpu.types import StepInfo as JStepInfo
from raft_sim_tpu.utils import telemetry_sink as jsink
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.driver import Session
from raft_sim_tpu_torch.sim import scan as tscan
from raft_sim_tpu_torch.sim import telemetry as ttel
from raft_sim_tpu_torch.sim import trace as ttrace
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import telemetry_sink as tsink

torch.set_num_threads(1)

B, T, W, K = 8, 64, 16, 8
# Fields of the manifest that name the writing software or the time.
SOFTWARE_FIELDS = {"created_unix", "jax_version", "torch_version", "backend"}


@pytest.fixture(scope="module", params=["config2", "config9"])
def windowed(request):
    """(name, JAX result, port result) of simulate_windowed at B x T,
    window W, ring K, seed 3."""
    name = request.param
    want = jax.device_get(jtel.simulate_windowed(rst.PRESETS[name][0], 3, B, T, W, K))
    got = ttel.simulate_windowed(tconfig.PRESETS[name][0], 3, B, T, W, K, device="cpu")
    return name, want, got


def test_simulate_windowed_matches_jax(windowed):
    name, want, got = windowed
    for part, w, g in zip(("state", "metrics", "records", "recorder"), want, got):
        assert bridge.first_difference(w, g) is None, part
    records = got[2]
    assert tuple(records.start.shape) == (B, T // W)
    assert int(records.metrics.total_cmds.sum()) > 0
    assert bool((records.first_viol_tick == ttel.NEVER).all())  # a clean run


def test_windows_merge_into_the_runs_metrics(windowed):
    """The window algebra: merged records == the windowed run's metrics ==
    plain `simulate`'s, exactly."""
    name, _, (state, metrics, records, _) = windowed
    assert bridge.first_difference(metrics, ttel.reduce_records(records)) is None
    s2, m2 = tscan.simulate(tconfig.PRESETS[name][0], 3, B, T, device="cpu")
    assert bridge.first_difference(m2, metrics) is None
    assert bridge.first_difference(s2, state) is None


def test_window_cluster_counters_match_jax(windowed):
    _, want, got = windowed
    w_units = jtel.window_cluster_counters(want[2])
    g_units = ttel.window_cluster_counters(got[2])
    assert len(w_units) == len(g_units) == T // W
    for w, g in zip(w_units, g_units):
        assert w.keys() == g.keys()
        for k in w:
            assert np.array_equal(np.asarray(w[k]), np.asarray(g[k])), k


@pytest.mark.parametrize("name", ["config2", "config9"])
def test_run_chunked_telemetry_matches_jax(name):
    """72 ticks in chunks of 32 with windows of 16 (a final short window of
    8), the recorder carried across chunks: each chunk's records, the final
    state, the merged metrics and the recorder equal the JAX loop's."""
    jcfg, tcfg = rst.PRESETS[name][0], tconfig.PRESETS[name][0]
    root = jax.random.key(4)
    k_init, k_run = jax.random.split(root)
    jstate = rst.init_batch(jcfg, k_init, B)
    jkeys = jax.random.split(k_run, B)
    jrecs, trecs = [], []
    want = jtel.run_chunked_telemetry(
        jcfg, jstate, jkeys, 72, 16, jtel.init_recorder(jcfg, K, B), chunk=32,
        callback=lambda d, s, m, r: jrecs.append((d, jax.device_get(r))) and False)
    tstate, tkeys = tscan.seed_fleet(tcfg, 4, B, "cpu")
    got = ttel.run_chunked_telemetry(
        tcfg, tstate, tkeys, 72, 16, ttel.init_recorder(tcfg, K, B), chunk=32,
        callback=lambda d, s, m, r: trecs.append((d, r)) and False)
    assert [d for d, _ in jrecs] == [d for d, _ in trecs] == [32, 64, 72]
    for (_, w), (_, g) in zip(jrecs, trecs):
        assert bridge.first_difference(w, g) is None
    for w, g in zip(jax.device_get(want), got):
        assert bridge.first_difference(w, g) is None
    assert int(trecs[-1][1].metrics.ticks[0, 0]) == 8


def _fuzzed_recorder(pkg, seed):
    """A recorder after 11 ticks of random StepInfo (numpy-made) and a
    random trigger, through `pkg`'s _record: some clusters freeze early,
    some wrap the ring, some stay unfrozen."""
    rng = np.random.default_rng(seed)
    ring = 4
    jax_side = pkg is jtel
    rec = (jtel.init_recorder(rst.RaftConfig(), ring, 5) if jax_side
           else ttel.init_recorder(tconfig.RaftConfig(), ring, 5))
    for t in range(11):
        leaves = {}
        for f in JStepInfo._fields:
            mid = (ttypes.LAT_HIST_BINS,) if f.endswith("_hist") else ()
            if f.startswith("viol"):
                leaves[f] = rng.random(mid + (5,)) < 0.05
            else:
                leaves[f] = rng.integers(0, 1000, mid + (5,)).astype(np.int32)
        trig = rng.random(5) < 0.15
        now = np.full(5, t, np.int32)
        if jax_side:
            info = JStepInfo(**{k: jax.numpy.asarray(v) for k, v in leaves.items()})
            rec = jtel._record(rec, info, jax.numpy.asarray(now), ring, jax.numpy.asarray(trig))
        else:
            info = ttypes.StepInfo(**{k: torch.from_numpy(v) for k, v in leaves.items()})
            rec = ttel._record(rec, info, torch.from_numpy(now), ring, torch.from_numpy(trig))
    return rec


def test_flight_recorder_and_exports_match_jax(tmp_path):
    """_record's ring, latch and export (export_cluster, flight_lines,
    write_flight, trace.info_lines) equal the JAX package's on a recorder
    with frozen, wrapped and unfrozen clusters."""
    want = jax.device_get(_fuzzed_recorder(jtel, 1))
    got = _fuzzed_recorder(ttel, 1)
    assert bridge.first_difference(want, got) is None
    frozen = np.asarray(want.frozen)
    assert frozen.any() and not frozen.all()
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    js = jsink.TelemetrySink(str(jdir), rst.RaftConfig(), seed=0, batch=5, window=4, ring=4)
    ts = tsink.TelemetrySink(str(tdir), tconfig.RaftConfig(), seed=0, batch=5, window=4, ring=4,
                             backend="cpu")
    for c in range(5):
        wt, wi = jtel.export_cluster(want, c)
        gt, gi = ttel.export_cluster(got, c)
        assert np.array_equal(wt, gt)
        assert bridge.first_difference(wi, gi) is None
        assert jsink.flight_lines(wt, wi) == tsink.flight_lines(gt, gi)
        assert list(jtrace.info_lines(wi)) == list(ttrace.info_lines(gi))
        js.write_flight(c, wt, wi)
        ts.write_flight(c, gt, gi)
        name = f"flight_{c}.jsonl"
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes()


def test_trace_rendering_matches_jax():
    """node_line and events over stacked states of one cluster (the ticks
    of a config6 run: elections, commits, compactions)."""
    from raft_sim_tpu_torch.sim import chunked

    tcfg = tconfig.PRESETS["config6"][0]
    state, keys = tscan.seed_fleet(tcfg, 2, 1, "cpu")
    states = [state]
    chunked.run_chunked(tcfg, state, keys, 160, chunk=20,
                        callback=lambda d, s, m: states.append(s) and False)
    stacked = ttypes.ClusterState(*(
        torch.cat([getattr(s, f) for s in states]) if f != "mailbox" else None
        for f in ttypes.ClusterState._fields))
    numpy_states = stacked._replace(mailbox=None)
    numpy_states = type(numpy_states)(*(
        None if x is None else x.numpy() for x in numpy_states))
    assert list(ttrace.events(stacked)) == list(jtrace.events(numpy_states))
    assert any("becomes leader" in e for _, e in ttrace.events(stacked))
    for t in range(len(states)):
        for node in range(tcfg.n_nodes):
            assert ttrace.node_line(stacked, t, node) == jtrace.node_line(numpy_states, t, node)


def _sinks(tmp_path, name):
    jcfg, tcfg = rst.PRESETS[name][0], tconfig.PRESETS[name][0]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js = jsink.TelemetrySink(str(jdir), jcfg, seed=3, batch=B, window=W, ring=K)
    ts = tsink.TelemetrySink(str(tdir), tcfg, seed=3, batch=B, window=W, ring=K, backend="cpu")
    return js, ts, jdir, tdir


def test_sink_files_match_jax(tmp_path, windowed):
    """windows.jsonl byte-equal, the manifest equal but for the software and
    time fields, the summary equal; each validate() accepts both dirs."""
    name, want, got = windowed
    js, ts, jdir, tdir = _sinks(tmp_path, name)
    for half in (slice(0, 2), slice(2, 4)):  # two appends: the index continues
        js.append_windows(jax.tree.map(lambda x: x[:, half], want[2]))
        ts.append_windows(ttel.WindowRecord(
            start=got[2].start[:, half], first_viol_tick=got[2].first_viol_tick[:, half],
            metrics=tscan.RunMetrics(*(x[:, half] for x in got[2].metrics))))
    assert (jdir / "windows.jsonl").read_bytes() == (tdir / "windows.jsonl").read_bytes()
    jm, tm = jsink.read_manifest(str(jdir)), tsink.read_manifest(str(tdir))
    assert {k: v for k, v in jm.items() if k not in SOFTWARE_FIELDS} == {
        k: v for k, v in tm.items() if k not in SOFTWARE_FIELDS}
    assert tm["jax_version"] is None and tm["backend"] == "cpu" and tm["torch_version"]
    from raft_sim_tpu.parallel import summarize as jsummarize
    from raft_sim_tpu_torch.summary import summarize as tsummarize

    js.write_summary(jsummarize(want[1])._asdict())
    ts.write_summary(tsummarize(got[1])._asdict())
    assert (jdir / "summary.json").read_bytes() == (tdir / "summary.json").read_bytes()
    for d in (jdir, tdir):
        assert jsink.validate(str(d)) == []
        assert tsink.validate(str(d)) == []
    assert tsink.read_windows(str(tdir)) == jsink.read_windows(str(jdir))


def test_validate_reports_what_is_wrong(tmp_path):
    """A damaged window line, a config that no longer matches its hash, a
    trace stream without its meta file, and a stream the port does not check
    yet (perf) are each reported."""
    _, ts, _, tdir = _sinks(tmp_path, "config2")
    assert tsink.validate(str(tdir)) == []
    with open(tdir / "windows.jsonl", "a") as f:
        f.write(json.dumps({"window": 3, "start": 0, "ticks": 0}) + "\n")
    man = json.loads((tdir / "manifest.json").read_text())
    man["config"]["n_nodes"] = 7
    (tdir / "manifest.json").write_text(json.dumps(man))
    (tdir / "trace.jsonl").write_text("")
    (tdir / "perf.jsonl").write_text("")
    errors = tsink.validate(str(tdir))
    assert any("window index 3" in e for e in errors)
    assert any("ticks must be >= 1" in e for e in errors)
    assert any("config_hash does not match" in e for e in errors)
    assert any("trace_meta.json missing" in e for e in errors)
    assert any("perf.jsonl: not checked" in e for e in errors)


def test_session_telemetry_matches_jax_session(tmp_path):
    """Session.attach_telemetry -> run (chunks of 24, windows of 16: a short
    window closes each call) -> finalize_telemetry, then reset: the files
    equal the JAX Session's, and the re-attached sink starts over."""
    from raft_sim_tpu.driver import Session as JSession

    jcfg, tcfg = rst.PRESETS["config9"][0], tconfig.PRESETS["config9"][0]
    js, ts = JSession(jcfg, batch=4, seed=2), Session(tcfg, batch=4, seed=2, device="cpu")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js.attach_telemetry(str(jdir), window=16, ring=4)
    ts.attach_telemetry(str(tdir), window=16, ring=4)
    for sess in (js, ts):
        sess.run(40, chunk=24)
        sess.run(30, chunk=24)
    jfin, tfin = js.finalize_telemetry(), ts.finalize_telemetry()
    assert {k: v for k, v in jfin.items() if k != "summary"} == {
        k: v for k, v in tfin.items() if k != "summary"}
    for f in ("windows.jsonl", "summary.json"):
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    assert bridge.first_difference(jax.device_get(js.state), ts.state) is None
    assert bridge.first_difference(jax.device_get(js._tel_rec), ts._tel_rec) is None
    assert jsink.validate(str(tdir)) == []
    ts.reset()
    assert (tdir / "windows.jsonl").read_text() == "" and not (tdir / "summary.json").exists()


def test_unported_telemetry_options_raise():
    """perf attribution is refused by name. The trace plane, refused until it
    was ported, is taken on a track_trace config (a traced window comes out)
    and refused as JAX refuses it without the gate."""
    from raft_sim_tpu_torch.trace.ring import TraceSpec

    cfg = tconfig.PRESETS["config2"][0]
    with pytest.raises(ValueError, match="track_trace"):
        ttel.simulate_windowed(cfg, 0, 2, 16, 16, trace=TraceSpec(depth=8), device="cpu")
    traced = ttel.simulate_windowed(dataclasses.replace(cfg, track_trace=True), 0, 2, 16, 16,
                                    trace=TraceSpec(depth=8), device="cpu")
    assert len(traced) == 6 and tuple(traced[4].win.ev_kind.shape) == (1, 8, 2)
    state, keys = tscan.seed_fleet(cfg, 0, 2, "cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        ttel.run_chunked_telemetry(cfg, state, keys, 16, 16, perf=object())
    with pytest.raises(ValueError, match="divide"):
        ttel.run_batch_minor_telemetry(cfg, state, keys, 20, 16)


def test_telemetry_loops_take_a_genome():
    """The scenario input path through the telemetry loops (refused before
    the scenario slice): simulate_windowed with a homogeneous genome is the
    scalar run, and run_batch_minor_telemetry and run_chunked_telemetry with
    a two-segment genome agree with each other. tests/test_torch_scenario.py
    holds them to the JAX package."""
    from raft_sim_tpu_torch.scenario import genome as tgenome

    cfg = tconfig.PRESETS["config2"][0]
    g = tgenome.broadcast(tgenome.from_config(cfg), B)
    got = ttel.simulate_windowed(cfg, 3, B, T, W, genome=g, device="cpu")
    want = ttel.simulate_windowed(cfg, 3, B, T, W, device="cpu")
    for part, w, x in zip(("state", "metrics", "records"), want, got):
        assert bridge.first_difference(w, x) is None, part
    two = tgenome.broadcast(tgenome.from_segments([
        tgenome.segment(drop_prob=0.5, client_interval=8), tgenome.segment(client_interval=8)]), B)
    state, keys = tscan.seed_fleet(cfg, 3, B, "cpu")
    s1, m1, r1, _ = ttel.run_batch_minor_telemetry(cfg, state, keys, T, W, genome=two, seg_len=32)
    s2, m2, _ = ttel.run_chunked_telemetry(cfg, state, keys, T, W, chunk=32, genome=two,
                                           seg_len=32)
    assert bridge.first_difference(s1, s2) is None and bridge.first_difference(m1, m2) is None
    assert bridge.first_difference(m1, ttel.reduce_records(r1)) is None
    assert bridge.first_difference(s1, got[0]) is not None  # the genome changed the run
