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
import functools

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
    if jcfg.compaction:  # the trajectory compacted: log_base moved off 0
        assert int(np.asarray(st.log_base).max()) > 0
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
    # The slice-2 presets under their own crash schedules: config6's ring
    # (CAP=32, client every 4 ticks) wraps after ~130 ticks of commits.
    pytest.param(rst.PRESETS["config6"][0], 8, 160, 0.0, id="config6"),
    pytest.param(rst.PRESETS["config6r"][0], 8, 160, 0.0, id="config6r"),
    pytest.param(rst.PRESETS["config3p"][0], 8, 80, 0.0, id="config3p"),
    # A fast-wrapping ring under crash fuzz: snapshots, keeps and wipes,
    # rebases, the no-op reserve, windows across the wrap.
    pytest.param(
        dataclasses.replace(rst.PRESETS["config6"][0], log_capacity=8, compact_margin=4,
                            max_entries_per_rpc=2, client_interval=2),
        8, 100, 0.06, id="config6-cap8-fast-wrap-crash-fuzz",
    ),
]


@pytest.mark.parametrize("jcfg,batch,ticks,p_down", ROWS)
def test_plain_step_matches_jax_step_b(jcfg, batch, ticks, p_down):
    led = trajectory(jcfg, batch, ticks, seed=3, p_down=p_down)
    assert led > 0  # the trajectory reached leadership, so phases 4-8 ran


def hand_built_cases():
    """One-tick states for the snapshot and rebase edge cases, from the JAX
    package's own compaction tests (tests/test_compaction.py fixtures): the
    JAX ClusterState and StepInputs of one cluster, unbatched."""
    from tests import test_compaction as tc
    from tests.test_handlers import base_state, quiet_inputs

    cfg = tc.CFG
    quiet = quiet_inputs(cfg)
    cases = {}
    s = base_state(cfg)
    s = s._replace(term=s.term.at[1].set(2))
    cases["snapshot-wipe"] = (tc.snap_wire(s, 0, term=2, L=10, Lt=1, Lchk=tc.hist_chk(10)), quiet)
    s = tc.with_ring_log(base_state(cfg), 1, base=4, entries=tc.hist(4, 12), commit=6)
    s = s._replace(term=s.term.at[1].set(2))
    cases["snapshot-keep"] = (tc.snap_wire(s, 0, term=2, L=8, Lt=1, Lchk=tc.hist_chk(8)), quiet)
    ents = tc.hist(0, 6) + [(2, 99), (2, 98)]
    s = tc.with_ring_log(base_state(cfg), 1, base=0, entries=ents, commit=4)
    s = s._replace(term=s.term.at[1].set(3))
    cases["snapshot-wipe-on-conflict"] = (
        tc.snap_wire(s, 0, term=3, L=8, Lt=1, Lchk=tc.hist_chk(8)), quiet)
    s = tc.with_ring_log(base_state(cfg), 1, base=8, entries=tc.hist(8, 10), commit=9)
    s = s._replace(term=s.term.at[1].set(2))
    cases["snapshot-below-base-plain-ack"] = (
        tc.snap_wire(s, 0, term=2, L=6, Lt=1, Lchk=tc.hist_chk(6)), quiet)
    s = tc.with_ring_log(base_state(cfg), 0, base=12,
                         entries=[(3, 200 + i) for i in range(13, 21)], commit=12)
    s = tc.leader(s, 0, term=3)
    s = s._replace(match_index=s.match_index.at[0, 1].set(20).at[0, 2].set(20))
    cases["same-tick-rebase-and-injection"] = (s, quiet._replace(client_cmd=jnp.int32(55)))
    s = tc.with_ring_log(base_state(cfg), 0, base=6, entries=tc.hist(6, 10), commit=10)
    s = tc.leader(s, 0, term=1)
    s = s._replace(next_index=s.next_index.at[0, 1].set(3), deadline=s.deadline.at[0].set(0))
    cases["snapshot-sentinel-below-base"] = (s, quiet)
    s = tc.with_ring_log(base_state(cfg), 0, base=4, entries=tc.hist(4, 11), commit=4)
    cases["client-blocked-by-noop-reserve"] = (
        tc.leader(s, 0, term=1), quiet._replace(client_cmd=jnp.int32(777)))
    return cfg, cases


HAND_BUILT = [
    "snapshot-wipe", "snapshot-keep", "snapshot-wipe-on-conflict",
    "snapshot-below-base-plain-ack", "same-tick-rebase-and-injection",
    "snapshot-sentinel-below-base", "client-blocked-by-noop-reserve",
]


def hand_built_batch(name):
    """(JAX cfg, JAX batch-minor state and inputs, B=1) of one hand-built case."""
    jcfg, cases = hand_built_cases()
    s, inp = cases[name]
    lift = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[..., None], t)  # noqa: E731
    return jcfg, lift(s), lift(inp)


@pytest.mark.parametrize("name", HAND_BUILT)
def test_plain_step_matches_jax_on_hand_built_compaction_states(name):
    """Two ticks from each state: the case itself, then the tick that checks
    the carried checksums it produced."""
    jcfg, st, inp = hand_built_batch(name)
    cfg = _port_cfg(jcfg)
    jstep = _jitted_step_b(jcfg)
    for t in range(2):
        st2, info = jstep(st, inp)
        want_s, want_i = jax.device_get((st2, info))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = trb.step_b(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs)
        )
        diff = bridge.first_difference(want_s, got_s) or bridge.first_difference(want_i, got_i)
        assert diff is None, f"{name} tick {t}: {diff}"
        assert not np.asarray(want_i.viol_commit).any()
        st = st2


@functools.lru_cache(maxsize=None)
def _jitted_step_b(jcfg):
    return jax.jit(lambda s, i: jrb.step_b(jcfg, s, i))


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


def test_plain_step_matches_step_pallas_interpret_compaction_prevote():
    """K1 under the slice-2 gates: step_pallas (interpret mode) with a wrapped
    compacting ring, PreVote, crashes and the redirect client, one tick from
    a mid-trajectory state."""
    jcfg = rst.RaftConfig(n_nodes=5, log_capacity=8, compact_margin=4, max_entries_per_rpc=2,
                          client_interval=2, client_redirect=True, client_pipeline=2,
                          pre_vote=True, drop_prob=0.1, crash_prob=0.3, crash_period=16,
                          crash_down_ticks=4)
    cfg = _port_cfg(jcfg)
    B = 8
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(5), B))
    keys = jax.random.split(jax.random.key(6), B)
    jstep = jax.jit(lambda s, i: jrb.step_b(jcfg, s, i))
    draw = jax.jit(
        lambda k, now: jrb.to_batch_minor(jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    )
    for t in range(40):
        st = jstep(st, draw(keys, jnp.int32(t)))[0]
    assert int(np.asarray(st.log_base).max()) > jcfg.log_capacity  # the ring has wrapped
    inp = draw(keys, jnp.int32(40))
    want_s, want_i = jax.device_get(pallas_engine.step_pallas(jcfg, st, inp, block_b=4, interpret=True))
    s_np, i_np = jax.device_get((st, inp))
    got_s, got_i = trb.step_b(
        cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), 40
    )
    assert bridge.first_difference(want_s, got_s) is None
    assert bridge.first_difference(want_i, got_i) is None


@pytest.mark.parametrize(
    "kw",
    [dict(pre_vote=True), dict(compact_margin=4, log_capacity=16),
     dict(client_redirect=True, client_interval=4, client_pipeline=5)],
    ids=["pre_vote", "compaction", "client_redirect"],
)
def test_slice2_gates_are_accepted(kw):
    """PreVote, compaction and the redirect client run through both the plain
    tick and the kernel's gate check."""
    cfg = tconfig.RaftConfig(**kw)
    assert trb.unsupported_gates(cfg) == []
    tick_engine.check_supported(cfg)
    s = trb.to_batch_minor(ttypes.init_batch(cfg, torch.tensor([0, 1]), 2))
    from raft_sim_tpu_torch.sim import faults as tfaults
    from raft_sim_tpu_torch.utils import threefry

    inp = trb.to_batch_minor(tfaults.make_inputs(cfg, threefry.split(threefry.key(0), 2), 0))
    s2, _ = trb.step_b(cfg, s, inp, 0)
    assert int(s2.now[0]) == 1


@pytest.mark.parametrize(
    "kw,gate",
    [
        (dict(compact_margin=4, log_capacity=16, check_log_matching=True),
         "log matching under compaction"),
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
