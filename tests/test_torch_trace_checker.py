"""The port's whole-history checker and the trace files (raft_sim_tpu_torch/
trace/checker.py, history.py, utils/telemetry_sink.py) against the JAX
package's, on the CPU at a small size: a weak-quorum fleet's traced run
equals JAX's and its history is rejected naming election safety with the
two same-term leader events as witness; the sink's trace.jsonl,
trace_windows.jsonl and trace_meta.json equal the JAX sink's byte for byte,
each package's validate() accepts them and the history loads back to the
one built in memory; both validate()s and both loaders flag the same
truncated and out-of-order streams; the checker's synthetic negatives give
the JAX checker's reports; the timeline and Chrome-trace renderings are
JAX's; and `python -m raft_sim_tpu_torch.trace.checker` exits 0, 1 or 2 as
the JAX CLI does.

Tolerance: exact equality of every leaf, report field and file byte.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from raft_sim_tpu.scenario.mutation import mutant_config as jmutant_config
from raft_sim_tpu.sim import telemetry as jtel
from raft_sim_tpu.trace import checker as jchecker
from raft_sim_tpu.trace import history as jhistory
from raft_sim_tpu.trace.ring import TraceSpec as JSpec
from raft_sim_tpu.utils import telemetry_sink as jsink
from raft_sim_tpu.utils.config import RaftConfig as JConfig
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.scenario.mutation import mutant_config
from raft_sim_tpu_torch.sim import telemetry as ttel
from raft_sim_tpu_torch.trace import checker as tchecker
from raft_sim_tpu_torch.trace import events as tev
from raft_sim_tpu_torch.trace import history as thistory
from raft_sim_tpu_torch.trace.ring import TraceSpec
from raft_sim_tpu_torch.types import NIL
from raft_sim_tpu_torch.utils import telemetry_sink as tsink
from raft_sim_tpu_torch.utils.config import RaftConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_nodes=5, drop_prob=0.35, track_trace=True)
SEED, BATCH, TICKS, WINDOW, DEPTH = 0, 8, 128, 32, 256


@functools.lru_cache(maxsize=1)
def mutant_runs():
    """(JAX, port) traced runs of the weak-quorum mutant."""
    jcfg = jmutant_config("weak-quorum", JConfig(**KW))
    want = jax.device_get(jtel.simulate_windowed(jcfg, SEED, BATCH, TICKS, WINDOW, 0, None, 1,
                                                 JSpec(depth=DEPTH)))
    got = ttel.simulate_windowed(mutant_config("weak-quorum", RaftConfig(**KW)), SEED, BATCH,
                                 TICKS, WINDOW, trace=TraceSpec(depth=DEPTH), device="cpu")
    return want, got


def test_weak_quorum_history_rejected_with_witness():
    want, got = mutant_runs()
    assert want[3] is None and got[3] is None  # no flight recorder
    for part, w, g in zip(("state", "metrics", "records", "windows", "persist"),
                          want[:3] + want[4:], got[:3] + got[4:]):
        assert bridge.first_difference(w, g) is None, part
    assert int(got[1].violations.sum()) > 0  # the device flags agree
    hist = thistory.from_device(got[4])
    assert hist.complete
    rep = tchecker.check_history(hist)
    assert rep.to_dict() == jchecker.check_history(jhistory.from_device(want[4])).to_dict()
    assert rep.ok is False and "election_safety" in rep.violated
    es = rep.results["election_safety"]
    assert len(es.witness) == 2 and all(w["kind"] == "leader" for w in es.witness)
    assert es.witness[0]["detail"] == es.witness[1]["detail"]
    assert es.witness[0]["node"] != es.witness[1]["node"]


def test_timeline_and_chrome_trace_match_jax():
    """The history renderers: one cluster's timeline lines (every event, and
    every third) and the Chrome-trace export are the JAX module's."""
    want, got = mutant_runs()
    hist, jhist = thistory.from_device(got[4]), jhistory.from_device(want[4])
    for every in (1, 3):
        lines = list(thistory.timeline_lines(hist, 0, every))
        assert lines and lines == list(jhistory.timeline_lines(jhist, 0, every))
    assert thistory.chrome_trace(hist, [0, 2]) == jhistory.chrome_trace(jhist, [0, 2])
    assert thistory.chrome_trace(hist) == jhistory.chrome_trace(jhist)


def test_sink_round_trip_matches_jax_and_validates(tmp_path):
    """Two appends (windows 0-1, then 2-3) into each package's sink: the
    trace files are byte-equal, both validate()s accept both directories,
    the loaded history is the in-memory one, and the checker rejects it the
    same way from the directory as from memory."""
    want, got = mutant_runs()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcfg = jmutant_config("weak-quorum", JConfig(**KW))
    jsk = jsink.TelemetrySink(str(jdir), jcfg, seed=SEED, batch=BATCH, window=WINDOW, ring=0)
    tsk = tsink.TelemetrySink(str(tdir), mutant_config("weak-quorum", RaftConfig(**KW)),
                              seed=SEED, batch=BATCH, window=WINDOW, ring=0, backend="cpu")
    jsk.write_trace_meta(JSpec(depth=DEPTH))
    tsk.write_trace_meta(TraceSpec(depth=DEPTH))
    for sink, traws in ((jsk, want[4]), (tsk, got[4])):
        for a, b in ((0, 2), (2, TICKS // WINDOW)):
            part = type(traws)(win=type(traws.win)(*(x[a:b] for x in traws.win)),
                               cov=traws.cov[a:b])
            assert sink.append_trace(part) == b - a
    for f in ("trace.jsonl", "trace_windows.jsonl", "trace_meta.json"):
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    for d in (jdir, tdir):
        assert jsink.validate(str(d)) == [] and tsink.validate(str(d)) == []
    loaded = thistory.load(str(tdir))
    assert loaded.complete and loaded.events == thistory.from_device(got[4]).events
    assert not any(loaded.dropped.values())
    assert dataclasses.asdict(loaded) == dataclasses.asdict(jhistory.load(str(jdir)))
    rep = tchecker.check_directory(str(tdir))
    assert rep.to_dict() == jchecker.check_directory(str(jdir)).to_dict()
    assert rep.violated == ["election_safety"]


def _write_stream(d, windows, events, manifest_from=None):
    os.makedirs(d, exist_ok=True)
    if manifest_from is not None:
        for f in ("manifest.json", "windows.jsonl", "trace_meta.json"):
            with open(os.path.join(manifest_from, f), "rb") as src, \
                    open(os.path.join(d, f), "wb") as dst:
                dst.write(src.read())
    with open(os.path.join(d, "trace_windows.jsonl"), "w") as f:
        for w in windows:
            f.write(json.dumps({"window": w, "emitted": 1, "retained": 1, "dropped": 0,
                                "dropped_by_cluster": {}}) + "\n")
    with open(os.path.join(d, "trace.jsonl"), "w") as f:
        for row in events:
            f.write(json.dumps(row) + "\n")


def test_truncated_and_out_of_order_streams_flagged(tmp_path):
    """A window index that jumps and a cluster's tick that regresses: both
    loaders report the same problems (incomplete, never a pass), and both
    validate()s report the same errors, with and without a manifest."""
    good = tmp_path / "good"
    sink = tsink.TelemetrySink(str(good), RaftConfig(**KW), seed=0, batch=1, window=16, ring=0,
                               backend="cpu")
    sink.write_trace_meta(TraceSpec(depth=8))
    events = [{"w": 0, "c": 0, "t": 9, "node": 1, "k": tev.EV_LEADER, "d": 2},
              {"w": 2, "c": 0, "t": 4, "node": 1, "k": tev.EV_COMMIT, "d": 1},
              {"w": 2, "c": 0, "t": 5, "node": 1, "k": 99, "d": 1}]
    for name, src in (("bare", None), ("with-manifest", str(good))):
        d = str(tmp_path / name)
        _write_stream(d, [0, 2], events, src)
        hist = thistory.load(d)
        assert hist.problems == jhistory.load(d).problems and not hist.complete
        rep = tchecker.check_history(hist)
        assert not rep.ok and rep.violated == []
        assert all(r.ok is None for r in rep.results.values())
        errors = tsink.validate(d)
        assert errors == jsink.validate(d) and errors
    errors = tsink.validate(str(tmp_path / "with-manifest"))
    assert any("regresses" in e for e in errors) and any("window index 2" in e for e in errors)
    assert any("outside" in e for e in errors)


def _hist(events_by_cluster, module, dropped=None):
    ev = {c: [module.Event(*e) for e in evs] for c, evs in events_by_cluster.items()}
    return module.History(events=ev, emitted={c: len(v) for c, v in ev.items()},
                          dropped=dropped or {c: 0 for c in ev}, n_windows=1, problems=[])


SYNTHETIC = {
    "leader-truncates": ({0: [(5, 1, tev.EV_LEADER, 3), (9, 1, tev.EV_TRUNCATE, 2)]},
                         ["leader_append_only"]),
    "leader-commits-below-frontier": ({0: [(5, 0, tev.EV_LEADER, 3), (8, 0, tev.EV_COMMIT, 10),
                                           (20, 1, tev.EV_LEADER, 4),
                                           (25, 1, tev.EV_COMMIT, 5)]},
                                      ["leader_completeness"]),
    "follower-trails-frontier": ({0: [(5, 0, tev.EV_LEADER, 3), (8, 0, tev.EV_COMMIT, 10),
                                      (12, 1, tev.EV_COMMIT, 5)]}, []),
    "commit-regresses": ({0: [(8, 2, tev.EV_COMMIT, 5), (12, 2, tev.EV_COMMIT, 3)]},
                         ["state_machine_safety"]),
    "commit-regresses-across-restart": ({0: [(8, 2, tev.EV_COMMIT, 5), (10, 2, tev.EV_RESTART, 0),
                                             (12, 2, tev.EV_COMMIT, 3)]}, []),
    "device-log-matching": ({0: [(3, NIL, tev.EV_VIOLATION, tev.VIOL_LOG_MATCHING)]},
                            ["log_matching"]),
    "device-commit": ({0: [(3, NIL, tev.EV_VIOLATION, tev.VIOL_COMMIT)]},
                      ["state_machine_safety"]),
    "double-vote": ({0: [(2, 1, tev.EV_TERM, 2), (2, 1, tev.EV_VOTE, 0), (4, 1, tev.EV_VOTE, 3)]},
                    ["election_safety"]),
    "stale-read-served": ({0: [(5, 0, tev.EV_LEADER, 2), (6, 0, tev.EV_COMMIT, 7),
                               (7, 1, tev.EV_READ_ISSUE, 3), (9, 1, tev.EV_READ_SERVE, 3)]},
                          ["read_linearizability"]),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_checker_synthetic_negatives(name):
    events, violated = SYNTHETIC[name]
    rep = tchecker.check_history(_hist(events, thistory))
    assert rep.to_dict() == jchecker.check_history(_hist(events, jhistory)).to_dict()
    assert rep.violated == violated and rep.ok is (not violated)
    # Incomplete: a witnessed violation stands, a pass is demoted to undecided.
    rep = tchecker.check_history(_hist(events, thistory, dropped={0: 7}))
    assert rep.violated == violated and not rep.ok
    assert all(r.ok is None for n, r in rep.results.items() if n not in violated)
    h = _hist(events, thistory)
    h.freeze_armed = True
    rep = tchecker.check_history(h)
    assert rep.violated == violated and not rep.ok
    if not violated:
        assert "freeze-truncated" in rep.results["election_safety"].note


def test_checker_cli_exit_codes(tmp_path, capsys):
    """0 on a complete clean history, 1 on a violation (the witness printed),
    2 on an incomplete one, as the JAX CLI exits; --json prints the report.
    The violated case runs as `python -m raft_sim_tpu_torch.trace.checker`."""
    base = tmp_path / "base"
    sink = tsink.TelemetrySink(str(base), RaftConfig(**KW), seed=0, batch=1, window=16, ring=0,
                               backend="cpu")
    sink.write_trace_meta(TraceSpec(depth=8))
    leader = {"w": 0, "c": 0, "t": 5, "node": 1, "k": tev.EV_LEADER, "d": 3}
    cases = {
        "clean": ([0], [leader], 0),
        "violated": ([0], [leader, dict(leader, t=9, k=tev.EV_TRUNCATE, d=2)], 1),
        "incomplete": ([0, 2], [leader], 2),
    }
    for name, (windows, events, code) in cases.items():
        d = str(tmp_path / name)
        _write_stream(d, windows, events, str(base))
        assert tchecker.main([d]) == code == jchecker.main([d]), name
        ours, theirs = capsys.readouterr().out.split("election_safety")[1:]
        assert ours == theirs, name
        assert tchecker.main([d, "--json"]) == code
        report = json.loads(capsys.readouterr().out)
        assert report == jchecker.check_directory(d).to_dict()
    proc = subprocess.run([sys.executable, "-m", "raft_sim_tpu_torch.trace.checker",
                           str(tmp_path / "violated")], capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode == 1 and "VIOLATED" in proc.stdout and "witness" in proc.stdout
