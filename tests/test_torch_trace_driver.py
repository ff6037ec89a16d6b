"""The trace plane through the port's entry points (raft_sim_tpu_torch/
driver.py `Session.attach_trace`/`run`/`finalize_telemetry`/`trace`, the
`run --trace*` flags, scenario/search.py's coverage fitness and guided
proposals) against the JAX package's, on the CPU at small sizes: a traced
Session writes the JAX Session's files byte for byte (trace files, windows,
flights frozen on an event trigger, the summary with its trace rollup) and a
reset starts them over; offers are refused while a trace is armed; finalize
reports frozen and exported flights; `Session.trace` is the JAX one; the CLI
runs a traced fleet whose directory the checker passes; and a coverage hunt
equals JAX's generation by generation, under both proposals.

Tolerance: exact equality of every leaf, file byte and JSON field.
"""

import json
import os

import jax
import pytest
import torch

from raft_sim_tpu import driver as jdriver
from raft_sim_tpu.scenario import search as jsearch
from raft_sim_tpu.utils.config import RaftConfig as JConfig
from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import driver as tdriver
from raft_sim_tpu_torch.scenario import search as tsearch
from raft_sim_tpu_torch.sim import telemetry as ttel
from raft_sim_tpu_torch.trace import checker as tchecker
from raft_sim_tpu_torch.utils import telemetry_sink as tsink
from raft_sim_tpu_torch.utils.config import RaftConfig

torch.set_num_threads(1)

KW = dict(n_nodes=5, client_interval=4, drop_prob=0.2, crash_prob=0.2, crash_period=32,
          crash_down_ticks=8, partition_period=16, partition_prob=0.3, track_trace=True)
TRACE_FILES = ("trace.jsonl", "trace_windows.jsonl", "trace_meta.json")


def test_traced_session_matches_jax_session(tmp_path):
    """attach_telemetry + attach_trace (depth 64, the recorder frozen on the
    first leader) -> run(32) + run(40) in chunks of 32 with windows of 16 ->
    finalize: every file but the manifest equals the JAX Session's, the JAX
    validate() accepts the port's directory, the state and the trace carry
    are JAX's, and reset() starts the trace stream over."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    js = jdriver.Session(JConfig(**KW), batch=4, seed=3)
    ts = tdriver.Session(RaftConfig(**KW), batch=4, seed=3, device="cpu")
    for sess, d in ((js, jdir), (ts, tdir)):
        sess.attach_telemetry(str(d), window=16, ring=4)
        sess.attach_trace(depth=64, trigger="leader")
        sess.run(32, chunk=32)
        sess.run(40, chunk=32)
    jfin, tfin = js.finalize_telemetry(), ts.finalize_telemetry()
    assert {k: v for k, v in jfin.items() if k != "summary"} == {
        k: v for k, v in tfin.items() if k != "summary"}
    assert tfin["flights"]  # the leader trigger froze recorders
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and set(TRACE_FILES) <= set(names)
    for f in names:
        if f != "manifest.json":
            assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    assert "trace" in json.loads((tdir / "summary.json").read_text())
    from raft_sim_tpu.utils import telemetry_sink as jsink

    assert jsink.validate(str(tdir)) == [] and tsink.validate(str(tdir)) == []
    assert bridge.first_difference(jax.device_get(js.state), ts.state) is None
    assert bridge.first_difference(jax.device_get(js._trace_persist), ts._trace_persist) is None
    from raft_sim_tpu.trace import checker as jchecker

    assert tchecker.check_directory(str(tdir)).to_dict() == jchecker.check_directory(
        str(jdir)).to_dict()
    meta = (tdir / "trace_meta.json").read_bytes()
    ts.reset()
    assert (tdir / "trace_meta.json").read_bytes() == meta
    assert not (tdir / "trace.jsonl").exists() and ts._trace_persist is None


def test_attach_trace_needs_the_gate_and_a_sink(tmp_path):
    plain = tdriver.Session(RaftConfig(n_nodes=5), batch=2, device="cpu")
    plain.attach_telemetry(str(tmp_path / "a"), window=16, ring=0)
    with pytest.raises(ValueError, match="track_trace"):
        plain.attach_trace()
    sess = tdriver.Session(RaftConfig(**KW), batch=2, device="cpu")
    with pytest.raises(RuntimeError, match="telemetry"):
        sess.attach_trace()
    sess.attach_telemetry(str(tmp_path / "b"), window=16, ring=0)
    with pytest.raises(ValueError, match="unknown freeze event kind"):
        sess.attach_trace(freeze="nonsense")


def test_offer_refused_while_trace_armed(tmp_path):
    """offer()/offer_read() ticks run outside the windowed loop: with a trace
    armed they would leave holes the checker cannot see, so both refuse."""
    cfg = RaftConfig(n_nodes=5, read_interval=4, track_trace=True)
    sess = tdriver.Session(cfg, batch=2, seed=0, device="cpu")
    sess.attach_telemetry(str(tmp_path / "tel"), window=32, ring=0)
    sess.attach_trace(depth=16)
    with pytest.raises(RuntimeError, match="trace"):
        sess.offer(42)
    with pytest.raises(RuntimeError, match="trace"):
        sess.offer_read()
    assert sess.now == 0


def test_finalize_telemetry_reports_frozen_vs_exported(tmp_path):
    cfg = RaftConfig(**{**KW, "track_trace": False})
    sess = tdriver.Session(cfg, batch=4, seed=0, device="cpu")
    sess.attach_telemetry(str(tmp_path / "tel"), window=32, ring=4)
    rec = ttel.init_recorder(cfg, 4, 4)
    sess._tel_rec = rec._replace(frozen=torch.ones((4,), dtype=torch.bool))
    out = sess.finalize_telemetry(max_flights=2)
    assert out["flights_frozen"] == 4 and out["flights_exported"] == 2
    assert out["flights"] == [0, 1]
    summary = json.loads(open(out["summary"]).read())
    assert summary["flights_frozen"] == 4 and summary["flights_exported"] == 2
    assert "trace" not in summary


def test_session_trace_matches_jax():
    """Session.trace: one cluster's per-tick StepInfo and states, the JAX
    Session.trace's leaf for leaf, without advancing the session."""
    cfg = dict(KW, track_trace=False)
    js = jdriver.Session(JConfig(**cfg), batch=3, seed=4)
    ts = tdriver.Session(RaftConfig(**cfg), batch=3, seed=4, device="cpu")
    want = jax.device_get(js.trace(40, cluster=2))
    got = ts.trace(40, cluster=2)
    assert bridge.first_difference(want[0], got[0]) is None
    assert bridge.first_difference(want[1], got[1]) is None
    assert ts.now == 0 and int(ts.state.now.max()) == 0
    with pytest.raises(IndexError):
        ts.trace(4, cluster=3)


def test_run_cli_trace(tmp_path, capsys):
    """`run --trace` writes a directory both validate()s accept and the
    checker passes; --trace-trigger alone arms it too; --trace-events and
    --trace-ticks print one cluster's trajectory; the misuses are usage
    errors."""
    d = str(tmp_path / "tel")
    argv = ["run", "--device", "cpu", "--preset", "config2", "--batch", "3", "--ticks", "64",
            "--telemetry-dir", d, "--telemetry-window", "32"]
    assert cli.main([*argv, "--trace", "--trace-depth", "128"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_clusters"] == 3 and out["total_violations"] == 0
    assert tsink.validate(d) == []
    assert tchecker.main([d]) == 0
    summary = json.loads(open(os.path.join(d, "summary.json")).read())
    assert summary["trace"]["events_emitted"] > 0
    assert cli.main([*argv, "--trace-trigger", "leader"]) == 0
    assert json.loads(open(os.path.join(d, "trace_meta.json")).read())["depth"] == 128
    capsys.readouterr()
    assert cli.main(["run", "--device", "cpu", "--preset", "config2", "--batch", "2",
                     "--ticks", "30", "--trace-events", "--trace-cluster", "1"]) == 0
    assert "becomes leader" in capsys.readouterr().out
    assert cli.main(["run", "--device", "cpu", "--preset", "config2", "--batch", "2",
                     "--trace-ticks", "5"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 5
    for bad in (["--trace"], ["--trace-freeze", "leader"],
                ["--trace", "--telemetry-dir", d, "--trace-freeze", "nonsense"],
                ["--trace-ticks", "4", "--telemetry-dir", d]):
        with pytest.raises(SystemExit):
            cli.main(["run", "--device", "cpu", "--preset", "config2", "--batch", "2", *bad])
    with pytest.raises(SystemExit):
        cli.main(["run", "--device", "cpu", "--resume", "x.npz", "--trace",
                  "--telemetry-dir", d])


@pytest.mark.parametrize("proposal", ["gaussian", "coverage-guided"])
def test_coverage_search_matches_jax_per_generation(proposal):
    """Coverage fitness (and guided proposals over it) on a small config: the
    generation log -- seeds, fitness, best genome, new and total coverage
    bits -- equals JAX's generation by generation, the seen set only grows,
    and the hunt is deterministic."""
    kw = dict(generations=3, population=8, ticks=64, window=32, fitness="coverage",
              trace_depth=16, stop_on_hit=False, proposal=proposal)
    want = jsearch.search(JConfig(n_nodes=5, client_interval=8), jsearch.SearchSpec(**kw))
    got = tsearch.search(RaftConfig(n_nodes=5, client_interval=8), tsearch.SearchSpec(**kw),
                         device="cpu")
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    totals = [g["cov_total_bits"] for g in got.generations]
    assert totals == sorted(totals) and got.generations[0]["cov_new_bits"] > 0
    again = tsearch.search(RaftConfig(n_nodes=5, client_interval=8), tsearch.SearchSpec(**kw),
                           device="cpu")
    assert again.to_json() == got.to_json()
