"""The port's serve plane (raft_sim_tpu_torch/serve/: ingest, deltas, loop;
Session.offer/offer_read; the `serve` CLI) against the JAX package's, on the
CPU at small sizes. Offer and read planes are made from a numpy seed with
NIL holes and payloads at the int32 extremes (tests/test_torch_cuda.py
`served_planes`) and fed to both packages.

Tolerance: exact equality of every leaf of ClusterState, RunMetrics,
WindowRecord and DeltaBatch, of every delta row and stat (wall times
excepted), and of every line of the stream files.
"""

import dataclasses
import itertools
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
from raft_sim_tpu.serve import deltas as jdeltas
from raft_sim_tpu.serve import ingest as jingest
from raft_sim_tpu.serve import loop as jloop
from raft_sim_tpu.utils import telemetry_sink as jsink
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.serve import deltas as tdeltas
from raft_sim_tpu_torch.serve import ingest as tingest
from raft_sim_tpu_torch.serve import loop as tloop
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import telemetry_sink as tsink
from tests.test_torch_cuda import served_planes

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
B, T, W = 8, 64, 16


def _cfgs(name):
    return jloop.serve_config(rst.PRESETS[name][0]), tloop.serve_config(tconfig.PRESETS[name][0])


@pytest.fixture(scope="module", params=["config2", "config9", "config6r", "config10"])
def served(request):
    """(name, port cfg, JAX result, port result) of simulate_serve under the
    preset's serve_config, B x T, window W, the same planes for both."""
    name = request.param
    jcfg, tcfg = _cfgs(name)
    cmds, reads = served_planes(B, T, 21, jcfg.read_index)
    want = jax.device_get(jloop.simulate_serve(
        jcfg, 6, B, jax.numpy.asarray(cmds), W,
        None if reads is None else jax.numpy.asarray(reads)))
    got = tloop.simulate_serve(tcfg, 6, B, cmds, W, reads, device="cpu")
    return name, tcfg, want, got


def test_serve_config_matches_jax():
    for name in rst.PRESETS:
        jcfg, tcfg = _cfgs(name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg), name
        assert tcfg.serve_ingest and tcfg.client_interval == 0
        assert tcfg.serve_reads == tcfg.read_index and tcfg.read_interval == 0


def test_simulate_serve_matches_jax(served):
    name, tcfg, want, got = served
    for part, w, g in zip(("state", "metrics", "records"), want, got):
        assert bridge.first_difference(w, g) is None, part
    metrics = got[1]
    assert int(metrics.total_cmds.sum()) > 0 and int(metrics.violations.sum()) == 0
    assert int(metrics.reads_served.sum()) > 0 or not tcfg.read_index
    assert int(metrics.lat_cnt.sum()) > 0  # latency rides the offer-tick plane


def test_delta_stream_matches_jax(served):
    """drain at a depth below the chunk's commits (several rounds a
    cluster), then the fixed-round form, then skip_to_now: the rows, the
    watermark and the accounting equal the JAX DeltaStream's."""
    _, _, want, got = served
    for depth in (4, 64):
        js, ts = jdeltas.DeltaStream(B, depth=depth), tdeltas.DeltaStream(B, depth=depth)
        jrows, trows = js.drain(want[0]), ts.drain(got[0])
        assert jrows == trows and jrows
        assert np.array_equal(np.asarray(js.watermark), ts.watermark.numpy())
        assert (js.exported, js.applied, js.gap_entries) == (ts.exported, ts.applied,
                                                              ts.gap_entries)
    js, ts = jdeltas.DeltaStream(B, depth=3), tdeltas.DeltaStream(B, depth=3)
    assert js.finish_rounds(js.begin_rounds(want[0], 2)) == ts.finish_rounds(
        ts.begin_rounds(got[0], 2))
    d = jdeltas.extract(want[0], js.watermark, 5)
    assert bridge.first_difference(jax.device_get(d), tdeltas.extract(got[0], ts.watermark, 5)) is None
    js.skip_to_now(want[0])
    ts.skip_to_now(got[0])
    assert np.array_equal(np.asarray(js.watermark), ts.watermark.numpy())
    assert js.drain(want[0]) == ts.drain(got[0]) == []


def test_delta_stream_reads_the_batch_minor_layout(served):
    _, _, _, got = served
    from raft_sim_tpu_torch.models import raft_batched as trb

    a, b = tdeltas.DeltaStream(B, depth=8), tdeltas.DeltaStream(B, depth=8, batch_minor=True)
    assert a.drain(got[0]) == b.drain(trb.to_batch_minor(got[0]))


def test_delta_stream_compaction_gap_matches_jax():
    """Served config6 (CAP=32 ring), chunks of 64 with an offer in every
    slot, and one extraction round of depth 2 a chunk: the stream falls
    behind node 0's compaction base, and the gap rows equal the JAX ones."""
    jcfg, tcfg = _cfgs("config6")
    n = 6
    root = jax.random.key(8)
    k_init, k_run = jax.random.split(root)
    jstate, jkeys = rst.init_batch(jcfg, k_init, n), jax.random.split(k_run, n)
    from raft_sim_tpu_torch.sim import scan as tscan

    tstate, tkeys = tscan.seed_fleet(tcfg, 8, n, "cpu")
    js, ts = jdeltas.DeltaStream(n, depth=2), tdeltas.DeltaStream(n, depth=2)
    counter = itertools.count(1)
    for k in range(4):
        cmds = np.array([[next(counter) for _ in range(n)] for _ in range(64)], np.int32)
        jstate, _, jrecs = jloop._serve_chunk(jcfg, jstate, jkeys, jax.numpy.asarray(cmds), None, 16)
        tstate, _, trecs = tloop.run_windowed_served(tcfg, tstate, tkeys, cmds, 16, now=64 * k)
        assert bridge.first_difference(jax.device_get(jrecs), trecs) is None
        jrows = js.finish_rounds(js.begin_rounds(jstate, 1))
        assert jrows == ts.finish_rounds(ts.begin_rounds(tstate, 1))
    assert bridge.first_difference(jax.device_get(jstate), tstate) is None
    assert ts.gap_entries > 0 and any(r["gap"] > 0 for r in jrows)
    assert js.drain(jstate) == ts.drain(tstate)


def test_delta_file_helpers_match_jax(tmp_path, served):
    got = served[3]
    rows = tdeltas.DeltaStream(B, depth=4).drain(got[0])
    jp, tp = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    assert jdeltas.append_delta_rows(str(jp), rows) == tdeltas.append_delta_rows(str(tp), rows)
    assert jp.read_bytes() == tp.read_bytes()
    assert tdeltas.validate_deltas(str(tp)) == jdeltas.validate_deltas(str(tp)) == []
    for c in range(B):
        assert tdeltas.applied_values(rows, c) == jdeltas.applied_values(rows, c)
    bad = dict(rows[-1], start=rows[-1]["start"] + 5)
    tdeltas.append_delta_rows(str(tp), [bad])
    assert tdeltas.validate_deltas(str(tp)) == jdeltas.validate_deltas(str(tp)) != []


def test_ingest_matches_jax(tmp_path):
    vals = [1, -3, 2**31 - 1, -(2**31), 0]
    assert np.array_equal(tingest.pack_chunk(vals, 8), jingest.pack_chunk(vals, 8))
    assert np.array_equal(tingest.pack_plane(vals, 3, 2), jingest.pack_plane(vals, 3, 2))
    for bad in (-1, -2, 2**31, -(2**31) - 1):
        with pytest.raises(ValueError):
            tingest.check_value(bad)
        with pytest.raises(ValueError):
            jingest.check_value(bad)
    with pytest.raises(ValueError, match="do not fit"):
        tingest.pack_plane(vals, 2, 2)
    lines = ["7", "", "# note", '{"value": -9, "k": 1}', "  2147483647 "]
    assert [tingest.parse_line(x) for x in lines] == [jingest.parse_line(x) for x in lines]
    for bad in ('{"v": 1}', "1.5", "true"):
        with pytest.raises(ValueError):
            tingest.parse_line(bad)
    path = tmp_path / "src.jsonl"
    path.write_text("\n".join(lines) + "\n")
    assert list(tingest.jsonl_commands(str(path))) == list(jingest.jsonl_commands(str(path)))
    src = tingest.CommandSource(iter([5, 6, 7]))
    assert src.next_values(2) == [5, 6] and not src.exhausted
    assert np.array_equal(src.next_chunk(4), jingest.pack_chunk([7], 4))
    assert src.exhausted and src.offered == 3


def _session(pkg, cfg, sink_dir, **kw):
    sink = None
    if sink_dir is not None:
        sink_mod = jsink if pkg is jloop else tsink
        extra = {} if pkg is jloop else {"backend": "cpu"}
        sink = sink_mod.TelemetrySink(str(sink_dir), pkg.serve_config(cfg), seed=2, batch=B,
                                      window=W, ring=0, source="serve", **extra)
    extra = {} if pkg is jloop else {"device": "cpu"}
    return pkg.ServeSession(cfg, batch=B, seed=2, chunk=32, window=W, delta_depth=8, sink=sink,
                            warmup_ticks=32, **extra, **kw)


@pytest.mark.parametrize("name", ["config2", "config9"])
def test_serve_session_matches_jax(tmp_path, name):
    """The single-source form (each command offered to every cluster) run
    to exhaustion plus drain chunks: stats (wall time excepted), state,
    metrics, delta rows, acks and the sink's files."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    values = [2**31 - 1, -(2**31), 5, 5, -3] + list(range(100, 160))
    js = _session(jloop, rst.PRESETS[name][0], jdir)
    ts = _session(tloop, tconfig.PRESETS[name][0], tdir)
    jstats = js.serve(jingest.CommandSource(iter(values)), drain_chunks=2)
    tstats = ts.serve(tingest.CommandSource(iter(values)), drain_chunks=2)
    jstats.pop("wall_s")
    tstats.pop("wall_s")
    assert jstats == tstats and tstats["commands_acked"] > 0
    assert bridge.first_difference(jax.device_get(js.state), ts.state) is None
    assert bridge.first_difference(jax.device_get(js.metrics), ts.metrics) is None
    assert js.delta_rows == ts.delta_rows
    acked = ts.acked_values(3)
    assert acked == js.acked_values(3) and acked and set(acked) <= set(values)
    for f in ("windows.jsonl", "deltas.jsonl", "tenants.json",
              "tenants/default/windows.jsonl", "tenants/default/deltas.jsonl"):
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    jsum, tsum = (json.loads((d / "summary.json").read_text()) for d in (jdir, tdir))
    jsum.pop("wall_s")
    tsum.pop("wall_s")
    assert jsum == tsum
    assert jsink.validate(str(tdir)) == [] and tsink.validate(str(tdir)) == []
    assert tdeltas.validate_deltas(str(tdir / "deltas.jsonl")) == []


def test_serve_session_refusals():
    """perf= and health=, refused until the chunk timer and the health plane
    were ported, are taken; health without a sink is refused as JAX refuses
    it, and perf's warmup grows over the warmup chunks and the first serving
    chunk by JAX's rule (max(2, ceil(40 / 16) + 1) = 4)."""
    from raft_sim_tpu_torch.obs import ChunkTimer

    cfg = tconfig.PRESETS["config2"][0]
    with pytest.raises(ValueError, match="needs a sink"):
        tloop.ServeSession(cfg, batch=2, chunk=16, window=16, health="default", device="cpu")
    timer = ChunkTimer(batch=2)
    tloop.ServeSession(cfg, batch=2, chunk=16, window=16, warmup_ticks=40, perf=timer,
                       device="cpu")
    assert timer.warmup_chunks == 4 and [r["warmup"] for r in timer.rows] == [True] * 3
    with pytest.raises(ValueError, match="divide"):
        tloop.ServeSession(cfg, batch=2, chunk=30, window=16, device="cpu")
    sess = tloop.ServeSession(cfg, batch=2, chunk=16, window=16, device="cpu")
    with pytest.raises(ValueError, match="needs a source"):
        sess.serve()
    with pytest.raises(ValueError, match="ReadIndex"):
        tloop.simulate_serve(cfg, 0, 2, np.full((16, 2), -1, np.int32), 16,
                             reads=np.ones((16, 2), np.int32), device="cpu")


@pytest.mark.parametrize("name", ["config2", "config10-untracked"])
def test_session_offer_matches_jax(name):
    """Session.offer (acks matched by (value, offer tick + 1) through the
    delta stream; by value alone with the offer-tick plane off) and, on
    config9, Session.offer_read: every result and the final state equal the
    JAX Session's."""
    from raft_sim_tpu.driver import Session as JSession
    from raft_sim_tpu_torch.driver import Session

    jcfg = rst.PRESETS[name.removesuffix("-untracked")][0]
    if name.endswith("-untracked"):
        jcfg = dataclasses.replace(jcfg, client_interval=0)
        assert not jcfg.track_offer_ticks
    tcfg = tconfig.RaftConfig(**dataclasses.asdict(jcfg))
    js, ts = JSession(jcfg, batch=5, seed=4), Session(tcfg, batch=5, seed=4, device="cpu")
    js.run(30, chunk=30)
    ts.run(30, chunk=30)
    for value, wait in ((2**31 - 1, 12), (-(2**31), 0), (7, 12)):
        assert js.offer(value, wait=wait) == ts.offer(value, wait=wait)
    with pytest.raises(ValueError, match="sentinels"):
        ts.offer(-2)
    with pytest.raises(ValueError, match="ReadIndex"):
        ts.offer_read()
    assert bridge.first_difference(jax.device_get(js.state), ts.state) is None
    assert bridge.first_difference(jax.device_get(js.metrics), ts.metrics) is None
    assert ts.now == int(ts.state.now[0]) > 33


def test_session_offer_read_matches_jax():
    from raft_sim_tpu.driver import Session as JSession
    from raft_sim_tpu_torch.driver import Session

    jcfg, tcfg = _cfgs("config9")
    js, ts = JSession(jcfg, batch=5, seed=1), Session(tcfg, batch=5, seed=1, device="cpu")
    js.run(40, chunk=40)
    ts.run(40, chunk=40)
    results = []
    for wait in (0, 6, 6):
        want, got = js.offer_read(wait=wait), ts.offer_read(wait=wait)
        assert want == got
        results.append(got)
    assert js.offer(11, wait=10) == ts.offer(11, wait=10)
    assert sum(r["served"] for r in results) > 0
    assert bridge.first_difference(jax.device_get(js.state), ts.state) is None
    assert bridge.first_difference(jax.device_get(js.metrics), ts.metrics) is None


def test_cli_serve_matches_jax(tmp_path):
    """`serve --device cpu` against the JAX `serve` on one JSONL source (bare
    and {"value": v} lines, int32 extremes), two tenants with read demands:
    deltas.jsonl and windows.jsonl byte-equal, the printed stats equal."""
    rng = np.random.default_rng(0)
    src = tmp_path / "src.jsonl"
    with open(src, "w") as f:
        for i in range(200):
            v = int(rng.choice([rng.integers(-(2**31), -3), rng.integers(0, 2**31 - 1),
                                2**31 - 1, -(2**31)]))
            f.write((json.dumps({"value": v}) if i % 2 else str(v)) + "\n")
    flags = ("--source", str(src), "--preset", "config9", "--batch", "8", "--chunk", "32",
             "--window", "16", "--warmup", "32", "--tenants", "2", "--reads-per-tenant", "40",
             "--delta-depth", "8")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    outs = {}
    for pkg, extra in (("raft_sim_tpu", ("--backend", "cpu")), ("raft_sim_tpu_torch",
                                                                ("--device", "cpu"))):
        proc = subprocess.run([sys.executable, "-m", pkg, "serve", *flags, *extra,
                               "--sink", str(tmp_path / pkg)],
                              capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    for f in ("deltas.jsonl", "windows.jsonl", "tenants/tenant1/deltas.jsonl"):
        assert ((tmp_path / "raft_sim_tpu" / f).read_bytes()
                == (tmp_path / "raft_sim_tpu_torch" / f).read_bytes()), f
    want, got = outs["raft_sim_tpu"], outs["raft_sim_tpu_torch"]
    timed = {"wall_s", "cluster_ticks_per_s", "ops_per_s", "sink", "device"}
    assert {k: v for k, v in want.items() if k not in timed} == {
        k: v for k, v in got.items() if k not in timed}
    assert got["commands_acked"] == 200 and got["reads_served"] >= 80 and got["device"] == "cpu"
