"""The port's chunk timer (raft_sim_tpu_torch/obs/timer.py) and the loops it
is woven into, against the JAX package's, on the CPU at small sizes.

Properties held:
  - the timer is inert: `run --perf` equals the same run without it (final
    state and metrics through --save, windows.jsonl byte for byte), and so
    does a `--profile` run, which writes a trace file;
  - perf rows carry the JAX timer's integer and bool fields for the same
    chunking (chunk, ticks, warmup, recompiled) and a non-empty jit_cache
    map, and both packages' validate() accept the port's perf.jsonl;
  - summarize_rows, the recompile watchdog and validate()'s perf checks
    equal the JAX functions on the same rows;
  - search(perf=) writes one row a generation and hunts as without it.

Tolerance: exact equality; only clock readings (the *_s fields) differ by
nature and are left out.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu import driver as jdriver
from raft_sim_tpu.obs import timer as jtimer
from raft_sim_tpu.utils import telemetry_sink as jsink
from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.obs import timer as ttimer
from raft_sim_tpu_torch.scenario import search as tsearch
from raft_sim_tpu_torch.utils import checkpoint as tcheckpoint
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import telemetry_sink as tsink

torch.set_num_threads(1)

B, TICKS, CHUNK = 8, 128, 32
RUN = ["run", "--device", "cpu", "--preset", "config2", "--batch", str(B), "--ticks",
       str(TICKS), "--chunk", str(CHUNK), "--telemetry-window", str(CHUNK),
       "--telemetry-ring", "0"]
INT_BOOL = ("chunk", "ticks", "warmup", "recompiled")


def _cli(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`run` armed (--perf) and plain, each with a telemetry dir and a
    checkpoint, and the JAX Session's timer rows for the same chunking."""
    base = tmp_path_factory.mktemp("obs")
    out = {}
    for name, extra in (("armed", ["--perf"]), ("plain", [])):
        d = str(base / name)
        out[name] = (d, _cli([*RUN, "--telemetry-dir", d, "--save", d + ".npz", *extra]))
    js = jdriver.Session(rst.PRESETS["config2"][0], batch=B, seed=0)
    js.attach_telemetry(str(base / "jax"), window=CHUNK, ring=0)
    js.attach_perf()
    js.run(TICKS, chunk=CHUNK)
    out["jax_rows"] = js.perf.rows
    return out


def _rows(d):
    with open(os.path.join(d, "perf.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_perf_run_equals_unarmed_run(runs):
    (ad, armed), (pd, plain) = runs["armed"], runs["plain"]
    _, s_a, k_a, m_a, *_ = tcheckpoint.load(ad + ".npz", "cpu")
    _, s_p, k_p, m_p, *_ = tcheckpoint.load(pd + ".npz", "cpu")
    assert bridge.first_difference(s_p, s_a) is None
    assert bridge.first_difference(m_p, m_a) is None
    with open(os.path.join(ad, "windows.jsonl"), "rb") as fa, \
            open(os.path.join(pd, "windows.jsonl"), "rb") as fp:
        assert fa.read() == fp.read()
    clocks = ("wall_s", "cluster_ticks_per_s", "perf")
    assert {k: v for k, v in armed.items() if k not in clocks} == {
        k: v for k, v in plain.items() if k not in clocks}
    assert not os.path.exists(os.path.join(pd, "perf.jsonl"))
    assert tsink.validate(ad) == [] and jsink.validate(ad) == []


def test_perf_rows_match_jax_timer(runs):
    rows, want = _rows(runs["armed"][0]), runs["jax_rows"]
    assert [{k: r[k] for k in INT_BOOL} for r in rows] == [{k: r[k] for k in INT_BOOL}
                                                           for r in want]
    assert len(rows) == TICKS // CHUNK and [r["warmup"] for r in rows] == [True, True, False,
                                                                           False]
    for r, w in zip(rows, want):
        assert isinstance(r["jit_cache"], dict) and r["jit_cache"] and w["jit_cache"]
        assert r["live_bytes"] is None and w["live_bytes"] is None
        assert list(r) == list(w)
    perf = runs["armed"][1]["perf"]
    assert perf == ttimer.summarize_rows(rows, label="run", batch=B)
    assert perf["steady_chunks"] == 2 and not perf["recompiled_after_warmup"]


def _synthetic_rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        wall = float(rng.uniform(0.1, 2.0))
        rows.append({
            "chunk": i, "ticks": int(rng.integers(16, 512)), "warmup": i < 2,
            "wall_s": round(wall, 6), "dispatch_s": round(wall * 0.3, 6),
            "host_s": round(wall * 0.2, 6), "device_wait_s": round(wall * 0.5, 6),
            "gap_s": round(float(rng.uniform(0, 0.1)), 6),
            "live_bytes": None if seed == 0 else int(rng.integers(0, 2**40)),
            "jit_cache": {"a": int(rng.integers(0, 4))}, "recompiled": bool(i == n - 1 and seed),
        })
    return rows


@pytest.mark.parametrize("seed,n,warmup", [(0, 6, None), (1, 5, 2), (2, 1, 0), (3, 0, None)])
def test_summarize_rows_matches_jax(seed, n, warmup):
    rows = _synthetic_rows(seed, n)
    kw = dict(label="x", batch=7, warmup_chunks=warmup)
    assert ttimer.summarize_rows(rows, **kw) == jtimer.summarize_rows(rows, **kw)


def test_watchdog_fires_on_probe_growth():
    """A stub probe that grows at the fourth chunk, after a warmup of two:
    the row and the summary are marked and finish() names the probe, as the
    JAX timer does on the same sequence (the baseline stays the first steady
    sample, so every later chunk above it is marked); growth during warmup
    stays quiet."""
    stream = [1, 3, 3, 5, 5]
    out = {}
    for name, mod in (("port", ttimer), ("jax", jtimer)):
        seq = iter(stream)
        t = mod.ChunkTimer(label="run", batch=2)
        t.add_probe("stub", lambda: next(seq))
        for _ in range(5):
            t.begin(16)
            t.dispatched()
            t.end()
        err = io.StringIO()
        s = t.finish(out=err)
        out[name] = ([{k: r[k] for k in (*INT_BOOL, "jit_cache")} for r in t.rows],
                     s["recompiled_after_warmup"], err.getvalue())
    rows, fired, text = out["port"]
    assert (rows, fired) == out["jax"][:2]
    assert [r["recompiled"] for r in rows] == [False, False, False, True, True]
    assert fired and "perf watchdog [run]" in text and "stub 3->5" in text


@pytest.mark.parametrize("bad", [
    {"chunk": 99, "ticks": -1},
    {"chunk": 4, "ticks": 8, "warmup": 0, "recompiled": False, "wall_s": -1.0, "dispatch_s": 0,
     "host_s": 0, "device_wait_s": 0, "gap_s": 0, "live_bytes": "x", "jit_cache": {"a": True}},
    "not json",
], ids=["missing-fields", "bad-types", "not-json"])
def test_validate_rejects_corrupt_perf_rows(runs, tmp_path, bad):
    d = str(tmp_path / "bad")
    shutil.copytree(runs["armed"][0], d)
    with open(os.path.join(d, "perf.jsonl"), "a") as f:
        f.write((bad if isinstance(bad, str) else json.dumps(bad)) + "\n")
    got = tsink.validate(d)
    assert got and got == jsink.validate(d)


def test_search_perf_writes_a_row_per_generation():
    cfg = tconfig.PRESETS["config2"][0]
    spec = tsearch.SearchSpec(generations=3, population=4, ticks=32, window=32, seed=0,
                              stop_on_hit=False)
    t = ttimer.ChunkTimer(label="search", batch=4)
    res = tsearch.search(cfg, spec, perf=t, device="cpu")
    assert res.to_json() == tsearch.search(cfg, spec, device="cpu").to_json()
    assert [r["chunk"] for r in t.rows] == [0, 1, 2]
    assert all(r["ticks"] == 32 for r in t.rows) and [r["warmup"] for r in t.rows] == [
        True, True, False]


def test_profile_writes_trace_and_equals_unprofiled(tmp_path):
    """`run --profile DIR` writes a torch.profiler trace into DIR and its
    summary equals the unprofiled run's."""
    base = ["run", "--device", "cpu", "--preset", "config2", "--batch", "8", "--ticks", "32",
            "--chunk", "32"]
    d = str(tmp_path / "prof")
    got = _cli([*base, "--profile", d])
    want = _cli(base)
    clocks = ("wall_s", "cluster_ticks_per_s")
    assert {k: v for k, v in got.items() if k not in clocks} == {
        k: v for k, v in want.items() if k not in clocks}
    with open(os.path.join(d, "torch_trace.json")) as f:
        assert json.load(f)["traceEvents"]
