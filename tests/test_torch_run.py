"""The single-cluster API (raft_sim_tpu_torch/sim/scan.py `run`, `run_batch`)
against the JAX package's `scan.run`/`run_batch`: one unbatched cluster in
each `outs` form (None, stacked StepInfo, StepInfo and states), with a
scenario genome, and a leading batch of clusters, on config2, config6 and
config5c (the compacted carry layout) for 32 ticks.

Tolerance: exact equality (value, dtype, shape), gated-off StepInfo leaves
included; the packed legs compare as uint32 (`types.u32_leaves`).
"""

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.scenario import genome as jgenome
from raft_sim_tpu.sim import scan as jscan
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.scenario import genome as tgenome
from raft_sim_tpu_torch.sim import scan as tscan
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)

T = 32
NAMES = ["config2", "config6", "config5c"]


def _genomes(name):
    """(JAX, port) two-segment genomes of 16 ticks: the preset's client
    cadence under a light drop, then a storm (drop, partitions, crashes)."""
    ci = rst.PRESETS[name][0].client_interval or 4
    segs = [dict(client_interval=ci, drop_prob=0.05),
            dict(client_interval=ci, drop_prob=0.3, partition_period=8, partition_prob=0.5,
                 crash_prob=0.3, crash_down_ticks=6)]
    return (jgenome.from_segments([jgenome.segment(**kw) for kw in segs]),
            tgenome.from_segments([tgenome.segment(**kw) for kw in segs]))


def _check(want, got, u32):
    for w, g in zip(want, got):
        if w is None:
            assert g is None
        elif isinstance(w, tuple) and not hasattr(w, "_fields"):
            for ww, gg in zip(w, g):
                assert bridge.first_difference(ww, gg, u32=u32) is None
        else:
            assert bridge.first_difference(w, g, u32=u32) is None


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("form", ["plain", "trace", "trace_states", "genome"])
def test_run_matches_jax(name, form):
    jcfg, tcfg = rst.PRESETS[name][0], tconfig.PRESETS[name][0]
    kw = {"trace": dict(trace=True), "trace_states": dict(trace_states=True)}.get(form, {})
    jkw, tkw = dict(kw), dict(kw)
    if form == "genome":
        jkw["genome"], tkw["genome"] = _genomes(name)
        jkw["seg_len"] = tkw["seg_len"] = 16
        jkw["trace"] = tkw["trace"] = True
    js = rst.init_state(jcfg, jax.random.key(11))
    ts = ttypes.init_state(tcfg, threefry.key(11))
    want = jax.device_get(jscan.run(jcfg, js, jax.random.key(12), T, **jkw))
    got = tscan.run(tcfg, ts, threefry.key(12), T, **tkw)
    _check(want, got, ttypes.u32_leaves(tcfg))
    if form == "trace_states":
        assert got[2][1].role.shape == (T, tcfg.n_nodes)
    assert int(got[1].ticks) == T


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("trace", [False, True], ids=["plain", "trace"])
def test_run_batch_matches_jax(name, trace):
    """`run_batch` over B=4 clusters, each under its own genome row when
    traced, equals the JAX vmapped `run`."""
    jcfg, tcfg = rst.PRESETS[name][0], tconfig.PRESETS[name][0]
    b = 4
    jkw, tkw = {}, {}
    if trace:
        jg, tg = _genomes(name)
        jkw = dict(genome=jgenome.broadcast(jg, b), seg_len=16)
        tkw = dict(genome=tgenome.broadcast(tg, b), seg_len=16)
    js = rst.init_batch(jcfg, jax.random.key(13), b)
    ts = ttypes.init_batch(tcfg, threefry.key(13), b)
    want = jax.device_get(jscan.run_batch(jcfg, js, jax.random.split(jax.random.key(14), b), T,
                                          trace=trace, **jkw))
    got = tscan.run_batch(tcfg, ts, threefry.split(threefry.key(14), b), T, trace=trace, **tkw)
    _check(want, got, ttypes.u32_leaves(tcfg))
    assert (got[2] is None) == (not trace)
    if trace:
        assert got[2].leader.shape == (b, T)
        assert np.asarray(got[1].ticks).tolist() == [T] * b
