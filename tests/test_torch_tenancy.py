"""The port's tenancy plane (raft_sim_tpu_torch/serve/tenancy.py) against the
JAX package's, on the CPU at small sizes: the partition, the packed offer and
read planes (weights, broadcast and read-only tenants, read crediting), the
per-tenant files, and a multi-tenant ServeSession whose tenant directories
match the JAX session's file for file.

Tolerance: exact equality of every plane, ledger, stat (wall time excepted)
and file.
"""

import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.serve import loop as jloop
from raft_sim_tpu.serve import tenancy as jten
from raft_sim_tpu.sim import scan as jscan
from raft_sim_tpu.sim import telemetry as jtel
from raft_sim_tpu.utils import telemetry_sink as jsink
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.serve import deltas as tdeltas
from raft_sim_tpu_torch.serve import loop as tloop
from raft_sim_tpu_torch.serve import tenancy as tten
from raft_sim_tpu_torch.sim import scan as tscan
from raft_sim_tpu_torch.sim import telemetry as ttel
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import telemetry_sink as tsink

torch.set_num_threads(1)


@pytest.mark.parametrize("total,n", [(10, 3), (8, 8), (1000, 4), (7, 1)])
def test_split_even_matches_jax(total, n):
    assert tten.split_even(total, n) == jten.split_even(total, n)


@pytest.mark.parametrize("total,n", [(3, 4), (5, 0)])
def test_split_even_refuses_what_jax_refuses(total, n):
    with pytest.raises(ValueError):
        jten.split_even(total, n)
    with pytest.raises(ValueError, match="cannot split"):
        tten.split_even(total, n)


def _tenants(pkg):
    """Weighted, broadcast, read-only and write-only tenants over 10 clusters."""
    return [
        pkg.Tenant("heavy", 4, source=iter(range(1, 500)), reads=30, weight=2),
        pkg.Tenant("bcast", 2, source=iter([-(2**31), 2**31 - 1, 9]), broadcast=True),
        pkg.Tenant("readonly", 3, reads=25, read_every=3),
        pkg.Tenant("light", 1, source=iter(range(1000, 1100)), reads=4),
    ]


def _records(pkg, rng, batch, n_windows):
    """A stacked WindowRecord of random counters (public layout), in `pkg`'s
    types with numpy leaves."""
    scan_mod = jscan if pkg is jten else tscan
    tel_mod = jtel if pkg is jten else ttel
    fields = {}
    for f in scan_mod.RunMetrics._fields:
        mid = (16,) if f.endswith("_hist") else ()
        fields[f] = rng.integers(0, 50, (batch, n_windows) + mid).astype(np.int32)
    fields["ticks"][:] = 16
    start = np.broadcast_to(np.arange(n_windows, dtype=np.int32) * 16, (batch, n_windows)).copy()
    fv = np.where(rng.random((batch, n_windows)) < 0.1, 5, 2**31 - 1).astype(np.int32)
    return tel_mod.WindowRecord(start=start, first_viol_tick=fv,
                                metrics=scan_mod.RunMetrics(**fields))


def test_router_planes_ledgers_and_files_match_jax(tmp_path):
    """Four chunks of pack -> credit_windows -> route_deltas on both
    routers with the same records and rows: every plane, ledger and
    per-tenant file is equal."""
    routers = {pkg: pkg.TenantRouter(_tenants(pkg), 10, True) for pkg in (jten, tten)}
    for pkg, r in routers.items():
        r.attach_dir(str(tmp_path / pkg.__name__))
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for k in range(4):
        jplanes, tplanes = routers[jten].pack(24), routers[tten].pack(24)
        for a, b in zip(jplanes, tplanes):
            assert np.array_equal(a, b), k
        routers[jten].credit_windows(_records(jten, rng_j, 10, 2))
        routers[tten].credit_windows(_records(tten, rng_t, 10, 2))
        rows = [{"cluster": c, "start": 1 + 3 * k, "gap": 0, "values": [c, -2, 7 * k],
                 "ticks": [1, 2, 3]} for c in range(0, 10, 3)]
        routers[jten].route_deltas(rows)
        routers[tten].route_deltas(rows)
    jr, tr = routers[jten], routers[tten]
    assert (jr.offered, jr.reads_offered, jr.reads_served, jr.exhausted) == (
        tr.offered, tr.reads_offered, tr.reads_served, tr.exhausted)
    for a, b in zip(jr.tenants, tr.tenants):
        assert (a.lo, a.hi, a.acked_values, a.delta_rows, a.reads_offered) == (
            b.lo, b.hi, b.acked_values, b.delta_rows, b.reads_offered)
    for pkg, r in routers.items():
        r.write_manifest(str(tmp_path / pkg.__name__ / "tenants.json"))
    _same_tree(tmp_path / jten.__name__, tmp_path / tten.__name__)


def _same_tree(a, b):
    """Directories `a` and `b` hold the same files with the same bytes."""
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                             for r, _, fs in os.walk(d) for f in fs)
    assert files(a) == files(b)
    for f in files(a):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("kw,match", [
    (dict(clusters=0), "needs >= 1 cluster"), (dict(reads=-1), "reads must be"),
    (dict(read_every=0), "read_every"), (dict(weight=1.5), "weight"),
])
def test_tenant_refusals_match_jax(kw, match):
    args = dict(name="t", clusters=2) | kw
    with pytest.raises(ValueError):
        jten.Tenant(**args)
    with pytest.raises(ValueError, match=match):
        tten.Tenant(**args)


def test_router_refusals():
    with pytest.raises(ValueError, match="sum to 3"):
        tten.TenantRouter([tten.Tenant("a", 3)], 4, True)
    with pytest.raises(ValueError, match="duplicate"):
        tten.TenantRouter([tten.Tenant("a", 2), tten.Tenant("a", 2)], 4, True)
    with pytest.raises(ValueError, match="ReadIndex"):
        tten.TenantRouter([tten.Tenant("a", 2, reads=3)], 2, False)


def test_multi_tenant_serve_session_matches_jax(tmp_path):
    """Four tenants over 12 clusters of served config9 (one with weight 2,
    one read-only), chunks of 32: stats, state, metrics and rows equal the
    JAX session's; the sink directories, tenants/<name>/ included, match
    file for file but summary.json's wall time; the JAX validate() accepts
    the port's directory; the tenants' window lines sum to the fleet's."""
    batch = 12
    dirs = {}
    sessions = {}
    for pkg, loop, sink_mod in ((jten, jloop, jsink), (tten, tloop, tsink)):
        counter = itertools.count(1)
        tenants = [
            pkg.Tenant("a", 3, source=(next(counter) for _ in range(400)), reads=60),
            pkg.Tenant("b", 4, source=(next(counter) for _ in range(400)), reads=60, weight=2),
            pkg.Tenant("c", 2, reads=20),
            pkg.Tenant("d", 3, source=[2**31 - 1, -(2**31)] * 20),
        ]
        d = tmp_path / pkg.__name__
        extra = {} if pkg is jten else {"backend": "cpu"}
        cfg = (rst.PRESETS if pkg is jten else tconfig.PRESETS)["config9"][0]
        sink = sink_mod.TelemetrySink(str(d), loop.serve_config(cfg), seed=5, batch=batch,
                                      window=16, ring=0, source="serve", **extra)
        kw = {} if pkg is jten else {"device": "cpu"}
        sess = loop.ServeSession(cfg, batch=batch, seed=5, chunk=32, window=16, delta_depth=8,
                                 sink=sink, warmup_ticks=32, tenants=tenants, **kw)
        stats = sess.serve(chunks=4)
        stats.pop("wall_s")
        sessions[pkg], dirs[pkg] = (sess, stats), d
    (js, jstats), (ts, tstats) = sessions[jten], sessions[tten]
    assert jstats == tstats and tstats["tenants"] == 4
    assert bridge.first_difference(jax.device_get(js.state), ts.state) is None
    assert bridge.first_difference(jax.device_get(js.metrics), ts.metrics) is None
    assert js.delta_rows == ts.delta_rows
    for d in dirs.values():  # summary.json differs only in its wall time
        doc = json.loads((d / "summary.json").read_text())
        doc.pop("wall_s")
        (d / "summary.json").write_text(json.dumps(doc, sort_keys=True))
    man = {pkg: json.loads((d / "manifest.json").read_text()) for pkg, d in dirs.items()}
    for d in dirs.values():
        (d / "manifest.json").unlink()
    _same_tree(dirs[jten], dirs[tten])
    assert {k: v for k, v in man[jten].items() if k not in {"created_unix", "jax_version",
                                                            "backend"}} == {
        k: v for k, v in man[tten].items() if k not in {"created_unix", "jax_version",
                                                        "backend", "torch_version"}}
    tdir = dirs[tten]
    (tdir / "manifest.json").write_text(json.dumps(man[tten]))
    assert jsink.validate(str(tdir)) == [] and tsink.validate(str(tdir)) == []
    fleet = tsink.read_windows(str(tdir))
    names = [t.name for t in ts.router.tenants]
    per = [tsink.read_windows(str(tdir / "tenants" / n)) for n in names]
    for k, line in enumerate(fleet):
        for field in ("cmds", "reads", "msgs", "violations"):
            assert line[field] == sum(p[k][field] for p in per), (k, field)
    for n in names:
        assert tdeltas.validate_deltas(str(tdir / "tenants" / n / "deltas.jsonl")) == []
    ledger = json.loads((tdir / "tenants.json").read_text())
    assert all(ledger[n]["acked"] > 0 for n in ("a", "b", "d"))
    assert all(ledger[n]["reads_served"] > 0 for n in ("a", "b", "c"))
