"""The port's plain PyTorch tick (raft_sim_tpu_torch/models/raft_batched.py
`step_b`) against the JAX package's `raft_batched.step_b`, leaf by leaf, for
identical state and inputs along fuzzed multi-tick trajectories -- and once
against the JAX package's Pallas kernel (`step_pallas`, interpret mode, as
tests/test_pallas.py runs it on the CPU).

Each tick, the JAX state and inputs cross to the port through numpy
(raft_sim_tpu_torch/bridge.py), both ticks run, and every leaf of the new
ClusterState and StepInfo must agree. Tolerance: exact equality (value, dtype,
shape) -- the tick is integer-only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.experiments import pallas_engine
from raft_sim_tpu.models import raft_batched as jrb
from raft_sim_tpu.sim import faults as jfaults
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)


def _port_cfg(jcfg):
    return tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _fuzz(inp, rng, p_down):
    """Random crash/restart edges on top of the drawn inputs (phase -1 and
    the liveness gates): a node is down with prob p_down, and a live node
    restarts with prob p_down."""
    alive = rng.random(inp.alive.shape) >= p_down
    restarted = alive & (rng.random(inp.alive.shape) < p_down)
    return inp._replace(alive=jnp.asarray(alive), restarted=jnp.asarray(restarted))


def trajectory(jcfg, batch, ticks, seed, p_down=0.0, step=trb.step_b):
    """Run the JAX tick along a trajectory and hold the port's `step` to it
    every tick. Returns the number of ticks that had a leader somewhere."""
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(seed)
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(seed), batch))
    keys = jax.random.split(jax.random.key(seed + 1), batch)
    jstep = jax.jit(lambda s, i: jrb.step_b(jcfg, s, i))
    draw = jax.jit(
        lambda k, now: jrb.to_batch_minor(jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    )
    led = 0
    for t in range(ticks):
        inp = draw(keys, jnp.int32(t))
        if p_down:
            inp = _fuzz(inp, rng, p_down)
        want_s, want_i = jax.device_get(jstep(st, inp))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = step(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), t
        )
        diff = bridge.first_difference(want_s, got_s) or bridge.first_difference(want_i, got_i)
        assert diff is None, f"tick {t}: {diff}"
        led += int(np.any(np.asarray(want_i.n_leaders) > 0))
        st = jstep(st, inp)[0]
    return led


ROWS = [
    # tests/test_pallas.py's rows.
    pytest.param(rst.RaftConfig(n_nodes=3, log_capacity=8, max_entries_per_rpc=2), 8, 60, 0.0, id="n3-small"),
    pytest.param(rst.RaftConfig(n_nodes=5, client_interval=4, drop_prob=0.2), 8, 60, 0.0, id="n5-faults"),
    pytest.param(rst.PRESETS["config2"][0], 8, 60, 0.0, id="config2"),
    pytest.param(rst.PRESETS["config4"][0], 8, 60, 0.0, id="config4"),
    # N=51 (config5: partitions, log matching every 16 ticks).
    pytest.param(rst.PRESETS["config5"][0], 4, 48, 0.0, id="config5-n51"),
    # Fuzzed crash/restart edges over a tiny log: truncations, capacity
    # clipping, restarts of leaders mid-replication.
    pytest.param(
        rst.RaftConfig(n_nodes=5, log_capacity=6, client_interval=1, drop_prob=0.25, clock_skew_prob=0.2),
        8, 80, 0.08, id="n5-tiny-log-crash-fuzz",
    ),
    pytest.param(
        rst.RaftConfig(n_nodes=4, log_capacity=8, client_interval=2, drop_prob=0.15,
                       partition_period=10, partition_prob=0.7, check_log_matching=True),
        8, 80, 0.05, id="n4-partitions-crash-fuzz",
    ),
    pytest.param(
        dataclasses.replace(rst.PRESETS["config1"][0], log_capacity=64),
        2, 80, 0.03, id="config1-int16-crash-fuzz",
    ),
]


@pytest.mark.parametrize("jcfg,batch,ticks,p_down", ROWS)
def test_plain_step_matches_jax_step_b(jcfg, batch, ticks, p_down):
    led = trajectory(jcfg, batch, ticks, seed=3, p_down=p_down)
    assert led > 0  # the trajectory reached leadership, so phases 4-8 ran


def test_step_cuda_on_cpu_tensors_is_the_plain_step():
    """step_cuda dispatches CPU tensors to the plain tick (no kernel launch)."""
    before = tick_engine.step_cuda.launches
    trajectory(rst.PRESETS["config2"][0], 4, 20, seed=4, step=tick_engine.step_cuda)
    assert tick_engine.step_cuda.launches == before


def test_plain_step_matches_step_pallas_interpret():
    """K1 as the JAX tests run it: step_pallas in interpret mode, one tick
    from a mid-trajectory state (leaders elected, entries in flight)."""
    jcfg = rst.RaftConfig(n_nodes=3, log_capacity=8, max_entries_per_rpc=2, client_interval=2)
    cfg = _port_cfg(jcfg)
    B = 8
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(0), B))
    keys = jax.random.split(jax.random.key(1), B)
    jstep = jax.jit(lambda s, i: jrb.step_b(jcfg, s, i))
    draw = jax.jit(
        lambda k, now: jrb.to_batch_minor(jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    )
    for t in range(30):
        st = jstep(st, draw(keys, jnp.int32(t)))[0]
    inp = draw(keys, jnp.int32(30))
    want_s, want_i = jax.device_get(pallas_engine.step_pallas(jcfg, st, inp, block_b=4, interpret=True))
    s_np, i_np = jax.device_get((st, inp))
    got_s, got_i = trb.step_b(
        cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), 30
    )
    assert int(np.asarray(want_i.n_leaders).sum()) > 0
    assert bridge.first_difference(want_s, got_s) is None
    assert bridge.first_difference(want_i, got_i) is None


@pytest.mark.parametrize(
    "kw,gate",
    [
        (dict(pre_vote=True), "pre_vote"),
        (dict(compact_margin=4, log_capacity=16), "compaction"),
        (dict(client_redirect=True), "client_redirect"),
        (dict(reconfig_interval=10), "reconfig"),
        (dict(transfer_interval=10), "transfer"),
        (dict(read_interval=3), "reads"),
        (dict(fsync_interval=3), "durable_storage"),
        (dict(compact_planes=True), "compact_planes"),
        (dict(track_trace=True), "track_trace"),
        (dict(serve_ingest=True), "serve_ingest"),
    ],
    ids=lambda x: x if isinstance(x, str) else None,
)
def test_unsupported_gates_raise(kw, gate):
    cfg = tconfig.RaftConfig(**kw)
    base = tconfig.RaftConfig()
    s = trb.to_batch_minor(ttypes.init_batch(base, torch.tensor([0, 1]), 2))
    with pytest.raises(NotImplementedError, match=gate):
        trb.step_b(cfg, s, None, 0)
    with pytest.raises(NotImplementedError, match=gate):
        tick_engine.check_supported(cfg)
