"""A sharded Session's planes (raft_sim_tpu_torch/driver.py `Session(devices=)`
with the telemetry sink, the flight recorder, the trace plane, the chunk
timer, the health monitor and the offers; `run --devices N` with
--telemetry-dir and --trace) against the unsharded port Session and the JAX
package's `Session(devices=k)` on the 8 virtual CPU devices of
tests/conftest.py.

The port's shards are an explicit device list on the one `cpu` device. Both
packages run from the same seed at small sizes (batch 8, 72 ticks over two
run() calls, windows of 16, a 4-deep ring frozen on the first leader event).
The JAX Session runs sharded once a plane, over 4 devices, since each JAX
compile costs seconds where the port's runs cost a fraction; every port
shard count is held against it. The 2-device JAX Session is the one
`run --devices 2` drives in the CLI test.

Tolerance: exact equality of every file byte (the manifest field for field,
less the fields that name the writing software and the time), every offer
dict, every state and metrics leaf and the checker's verdict.
"""

import json
import os

import jax
import pytest
import torch

from raft_sim_tpu import driver as jdriver
from raft_sim_tpu.utils.config import RaftConfig as JConfig
from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import driver as tdriver
from raft_sim_tpu_torch.trace import checker as tchecker
from raft_sim_tpu_torch.utils.config import RaftConfig

torch.set_num_threads(1)

KW = dict(n_nodes=5, client_interval=4, drop_prob=0.2, crash_prob=0.2, crash_period=32,
          crash_down_ticks=8, partition_period=16, partition_prob=0.3, track_trace=True)
OFFER_KW = dict(n_nodes=5, client_interval=8, read_interval=6, drop_prob=0.1)
BATCH, SEED = 8, 3
SHARDS = (None, 2, 4)
# Manifest fields that name the writing software, the time or the device type.
SOFTWARE = ("created_unix", "jax_version", "torch_version", "backend")
# Streams the host's clock writes (perf rows) or that carry it (health rows).
TIMED = ("perf.jsonl", "health.jsonl", "alerts.jsonl")


def _devices(k):
    return None if k is None else ["cpu"] * k


def _files(d) -> dict:
    """{name: bytes} of a telemetry directory, the manifest without its
    software fields, the timed streams left out."""
    out = {}
    for name in sorted(os.listdir(d)):
        if name in TIMED or os.path.isdir(os.path.join(d, name)):
            continue
        data = (d / name).read_bytes()
        if name == "manifest.json":
            man = json.loads(data)
            data = {k: v for k, v in man.items() if k not in SOFTWARE}
        out[name] = data
    return out


def _untimed(row):
    if isinstance(row, dict):
        return {k: _untimed(v) for k, v in row.items()
                if k != "device_wait" and "time" not in k and "wall" not in k}
    return row


def _drive(sess, d, armed: bool):
    sess.attach_telemetry(str(d), window=16, ring=4)
    sess.attach_trace(depth=64, trigger="leader")
    if armed:
        sess.attach_perf()
        sess.attach_health("default")
    sess.run(32, chunk=32)
    sess.run(40, chunk=32)
    return sess.finalize_telemetry()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The traced runs: the port at 1, 2 and 4 shards (perf and health
    armed), the JAX Session at 4 devices."""
    root = tmp_path_factory.mktemp("traced")
    port = {}
    for k in SHARDS:
        d = root / f"port{k}"
        s = tdriver.Session(RaftConfig(**KW), batch=BATCH, seed=SEED, device="cpu",
                            devices=_devices(k))
        port[k] = (s, d, _drive(s, d, armed=True))
    js = jdriver.Session(JConfig(**KW), batch=BATCH, seed=SEED, devices=4)
    return port, (js, root / "jax4", _drive(js, root / "jax4", armed=False))


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_files_equal_unsharded(traced, k):
    """Every file of the k-shard run (windows, trace streams and meta,
    flights, the summary with its trace rollup) equals the unsharded
    run's; the health rows but for what the clock measures, a perf row a
    chunk; the gathered state and trace carry equal too."""
    port, _ = traced
    one, sharded = port[None], port[k]
    assert len(sharded[0]._state) == k
    assert sharded[2]["flights"] and sharded[2] == {**one[2], "summary": sharded[2]["summary"]}
    assert _files(sharded[1]) == _files(one[1])
    assert {"trace.jsonl", "trace_windows.jsonl", "summary.json"} <= set(_files(one[1]))
    health = [[_untimed(json.loads(ln)) for ln in (d / "health.jsonl").read_text().splitlines()]
              for d in (one[1], sharded[1])]
    assert health[0] and health[0] == health[1]
    assert len(sharded[0].perf.rows) == len(one[0].perf.rows) == 3
    assert bridge.first_difference(sharded[0].state, one[0].state) is None
    assert bridge.first_difference(sharded[0]._trace_persist, one[0]._trace_persist) is None


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_files_equal_jax_session(traced, k):
    """The port's k-shard directory equals the JAX Session(devices=4)'s,
    file for file, and the checker gives the JAX verdict."""
    from raft_sim_tpu.trace import checker as jchecker

    port, (js, jdir, jfin) = traced
    ts, tdir, tfin = port[k]
    want = _files(jdir)
    got = {name: data for name, data in _files(tdir).items() if name in want}
    assert got == want and set(want) <= set(_files(tdir))
    assert {k2: v for k2, v in jfin.items() if k2 != "summary"} == {
        k2: v for k2, v in tfin.items() if k2 != "summary"}
    assert bridge.first_difference(jax.device_get(js.state), ts.state) is None
    assert tchecker.check_directory(str(tdir)).to_dict() == jchecker.check_directory(
        str(jdir)).to_dict()


def _offers(sess, d):
    """Offers and reads on a session with a sink attached: the waits run
    through the windowed loop."""
    sess.attach_telemetry(str(d), window=8, ring=0)
    sess.run(32, chunk=16)
    out = [sess.offer(7, wait=16), sess.offer_read(wait=16)]
    sess.run(8, chunk=8)
    out += [sess.offer(9), sess.offer_read(wait=4), sess.offer(11, wait=24)]
    sess.finalize_telemetry()
    return out


@pytest.fixture(scope="module")
def offered(tmp_path_factory):
    root = tmp_path_factory.mktemp("offers")
    port = {}
    for k in SHARDS:
        s = tdriver.Session(RaftConfig(**OFFER_KW), batch=BATCH, seed=5, device="cpu",
                            devices=_devices(k))
        port[k] = (s, root / f"port{k}", _offers(s, root / f"port{k}"))
    js = jdriver.Session(JConfig(**OFFER_KW), batch=BATCH, seed=5, devices=4)
    return port, (js, root / "jax4", _offers(js, root / "jax4"))


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_offers_equal_unsharded_and_jax(offered, k):
    """offer/offer_read on a k-shard Session return the unsharded
    session's dicts and JAX's (Session(devices=4)); states, metrics and
    sink files agree."""
    port, (js, jdir, jout) = offered
    s1, d1, out1 = port[None]
    sk, dk, outk = port[k]
    assert outk == out1 == jout
    assert any(o.get("committed") for o in out1) and any(o.get("served") for o in out1)
    assert bridge.first_difference(sk.state, s1.state) is None
    assert bridge.first_difference(sk.metrics, s1.metrics) is None
    assert bridge.first_difference(jax.device_get(js.metrics), sk.metrics) is None
    assert _files(dk) == _files(d1) == _files(jdir)


def test_run_devices_cli_traced_equals_jax(tmp_path, capsys):
    """`run --devices 2 --telemetry-dir D --trace` (with the trigger, perf
    and health) prints the JAX CLI's summary and writes its files."""
    flags = ["--n-nodes", "5", "--client-interval", "4", "--drop-prob", "0.2", "--batch", "8",
             "--seed", "1", "--ticks", "64", "--chunk", "32", "--devices", "2",
             "--telemetry-window", "16", "--telemetry-ring", "4", "--trace", "--trace-depth",
             "128", "--trace-trigger", "leader", "--health"]
    outs = {}
    for name, main, extra in (("jax", jdriver.main, ["--backend", "cpu"]),
                              ("port", cli.main, ["--device", "cpu", "--perf"])):
        assert main(["run", *flags, *extra, "--telemetry-dir", str(tmp_path / name)]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        outs[name] = {k: v for k, v in json.loads(line).items()
                      if k not in ("wall_s", "cluster_ticks_per_s", "device", "perf", "health")}
    assert outs["jax"] == outs["port"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert (tmp_path / "port" / "perf.jsonl").read_text().count("\n") == 2
    assert tchecker.check_directory(str(tmp_path / "port")).complete
