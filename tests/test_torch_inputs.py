"""The port's per-tick input draws (raft_sim_tpu_torch/sim/faults.py) against
`jax.vmap(faults.make_inputs)`.

Tolerance: exact equality of every StepInputs leaf (value, dtype, shape; the
packed delivery mask compared as uint32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.sim import faults as jfaults
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.sim import faults as tfaults
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)

ROWS = [
    pytest.param(rst.PRESETS[name][0], id=name)
    for name in ("config1", "config2", "config3", "config4", "config5")
] + [
    # tests/test_oracle_parity.py's no-crash rows.
    pytest.param(rst.RaftConfig(n_nodes=3, log_capacity=8, client_interval=3), id="n3"),
    pytest.param(
        rst.RaftConfig(n_nodes=5, log_capacity=8, max_entries_per_rpc=2, client_interval=2),
        id="n5-narrow-rpc",
    ),
    pytest.param(
        rst.RaftConfig(
            n_nodes=5, log_capacity=6, client_interval=1, drop_prob=0.25, clock_skew_prob=0.2
        ),
        id="n5-faults",
    ),
    pytest.param(
        rst.RaftConfig(
            n_nodes=4, log_capacity=8, client_interval=4, drop_prob=0.15,
            partition_period=10, partition_prob=0.7,
        ),
        id="n4-partitions",
    ),
    pytest.param(rst.RaftConfig(n_nodes=5, drop_prob=1.0, drop_prob_uniform=True), id="drop-1.0-uniform"),
]
TICKS = list(range(0, 40)) + [63, 64, 65, 95, 96, 1000, 2**20 + 3]
ROWS.append(pytest.param(rst.PRESETS["config3p"][0], id="config3p"))
# Crash schedules run in windows of crash_period ticks: every tick of the
# first two windows and into a third, so restarts and window edges are covered.
CRASH_ROWS = [
    pytest.param(rst.PRESETS[name][0], 140, id=name) for name in ("config6", "config6r")
] + [
    # Non-power-of-two randint spans for the window start, the down span and
    # the redirect targets (jax's two-draw algorithm, not a modulo).
    pytest.param(
        rst.RaftConfig(n_nodes=7, crash_prob=0.6, crash_period=37, crash_down_ticks=9,
                       client_interval=3, client_redirect=True, client_pipeline=3),
        80, id="n7-crash-p37-redirect-k3",
    ),
]


# The reconfiguration plane's admin cadences: config8 toggles membership
# every 97 ticks, transfers every 61 and reads every 7; config9 reads every 3.
# 250 ticks cross both admin cadences twice (and tick 0, where only a read is
# offered); the oracle row's 11/13/3 cadences cross many times.
ADMIN_ROWS = [
    pytest.param(rst.PRESETS[name][0], 250, id=name) for name in ("config8", "config9")
] + [
    pytest.param(
        rst.RaftConfig(n_nodes=5, log_capacity=8, client_interval=2, reconfig_interval=11,
                       transfer_interval=13, read_interval=3, drop_prob=0.2, crash_prob=0.4,
                       crash_period=16, crash_down_ticks=8),
        120, id="n5-reconfig-plane",
    ),
]

# The storage plane's disk draws: config10's 3-tick fsync cadence with 20%
# jitter and torn tails of 1..3 entries, the oracle row's 25% jitter, and a
# non-power-of-two span (jax's two-draw randint, not a modulo).
STORAGE_ROWS = [
    pytest.param(rst.PRESETS["config10"][0], 250, id="config10"),
    pytest.param(
        rst.RaftConfig(n_nodes=5, log_capacity=8, client_interval=2, fsync_interval=3,
                       fsync_jitter_prob=0.25, torn_tail_prob=0.3, lost_suffix_span=3,
                       drop_prob=0.2, crash_prob=0.5, crash_period=16, crash_down_ticks=8),
        200, id="n5-durable-crashes",
    ),
    pytest.param(
        rst.RaftConfig(n_nodes=7, log_capacity=16, fsync_interval=5, fsync_jitter_prob=0.5,
                       torn_tail_prob=0.9, lost_suffix_span=7),
        200, id="n7-fsync5-span7",
    ),
]


def _port_cfg(jcfg):
    return tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _check_make_inputs(jcfg, ticks):
    cfg = _port_cfg(jcfg)
    B = 6
    keys = jax.random.split(jax.random.key(21), B)
    tkeys = threefry.split(threefry.key(21), B)
    draw = jax.jit(lambda k, now: jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    restarts = 0
    for now in ticks:
        want = jax.device_get(draw(keys, jnp.int32(now)))
        got = tfaults.make_inputs(cfg, tkeys, now)
        diff = bridge.first_difference(want, got)
        assert diff is None, f"tick {now}: {diff}"
        restarts += int(got.restarted.sum())
    return restarts


@pytest.mark.parametrize("jcfg", ROWS)
def test_make_inputs_matches_jax(jcfg):
    _check_make_inputs(jcfg, TICKS)


@pytest.mark.parametrize("jcfg,n_ticks", CRASH_ROWS)
def test_make_inputs_crash_and_redirect_match_jax(jcfg, n_ticks):
    restarts = _check_make_inputs(jcfg, list(range(n_ticks)) + [1000, 2**20 + 3])
    assert restarts > 0  # the schedule really restarted nodes


@pytest.mark.parametrize("jcfg,n_ticks", ADMIN_ROWS)
def test_make_inputs_admin_commands_match_jax(jcfg, n_ticks):
    cfg = _port_cfg(jcfg)
    _check_make_inputs(jcfg, list(range(n_ticks)) + [1000, 2**20 + 3])
    got = tfaults.make_inputs(cfg, threefry.split(threefry.key(0), 2), cfg.read_interval)
    assert (got.read_cmd == 1).all()  # the read cadence fired


@pytest.mark.parametrize("name", ["config2", "config6r", "config9", "config10"])
def test_make_inputs_served_configs_match_jax(name):
    """Under serve_config (client_interval 0 with the offer-tick plane live,
    the read cadence replaced by serve_reads): no scheduled client command
    or read, and every draw equal to the JAX package's."""
    from raft_sim_tpu.serve.loop import serve_config

    jcfg = serve_config(rst.PRESETS[name][0])
    _check_make_inputs(jcfg, list(range(40)) + [1000])
    got = tfaults.make_inputs(_port_cfg(jcfg), threefry.split(threefry.key(0), 2), 0)
    assert (got.client_cmd == -1).all() and (got.read_cmd == -1).all()


@pytest.mark.parametrize("jcfg,n_ticks", STORAGE_ROWS)
def test_make_inputs_storage_draws_match_jax(jcfg, n_ticks):
    """fsync_fire and torn_drop (with every other leaf) equal JAX's every
    tick; the run drew flushes, jitter stalls and torn tails."""
    cfg = _port_cfg(jcfg)
    _check_make_inputs(jcfg, list(range(n_ticks)) + [1000, 2**20 + 3])
    keys = threefry.split(threefry.key(21), 6)
    draws = [tfaults.make_inputs(cfg, keys, t) for t in range(n_ticks)]
    due = [d for t, d in enumerate(draws) if t % cfg.fsync_interval == 0]
    assert all(not d.fsync_fire.any() for t, d in enumerate(draws) if t % cfg.fsync_interval)
    assert any(d.fsync_fire.any() for d in due) and any((~d.fsync_fire).any() for d in due)
    torn = torch.stack([d.torn_drop for d in draws])
    assert int(torn.max()) == cfg.lost_suffix_span and int(torn[torn > 0].min()) == 1


@pytest.mark.parametrize(
    "kw", [dict(crash_prob=0.2), dict(client_redirect=True, client_interval=4, client_pipeline=3),
           dict(reconfig_interval=10), dict(transfer_interval=10), dict(read_interval=3),
           dict(fsync_interval=3), dict(fsync_interval=5, fsync_jitter_prob=0.1)],
    ids=["crash_prob", "client_redirect", "reconfig", "transfer", "reads", "durable_storage",
         "durable_storage-jitter"],
)
def test_crash_and_redirect_inputs_are_accepted(kw):
    """The crash schedule, the redirect routing, the admin commands and the
    disk draws are drawn, not refused; tick 0 offers no toggle and no
    transfer, and is an fsync cadence tick."""
    cfg = tconfig.RaftConfig(**kw)
    got = tfaults.make_inputs(cfg, threefry.split(threefry.key(0), 2), 0)
    assert got.alive.all() and not got.restarted.any()  # tick 0 is never a restart
    assert got.client_bounce.shape == (2, cfg.client_pipeline)
    assert (got.reconfig_cmd == -1).all() and (got.transfer_cmd == -1).all()
    assert (got.read_cmd == (1 if cfg.read_index else -1)).all()
    assert got.fsync_fire.shape == got.torn_drop.shape == (2, cfg.n_nodes)
    assert bool(got.fsync_fire.any()) == cfg.durable_storage


@pytest.mark.parametrize(
    "kw,gate",
    [(dict(compact_planes=True), "compact_planes")],
    ids=lambda x: x if isinstance(x, str) else None,
)
def test_unported_input_gates_raise(kw, gate):
    """compact_planes, refused until the compacted layout was ported, is
    taken: the delivery mask ships flat ([B, N*W]), the dense words, and
    every other leaf is the dense config's."""
    cfg = tconfig.RaftConfig(**kw)
    keys = threefry.split(threefry.key(0), 2)
    got = tfaults.make_inputs(cfg, keys, 0)
    want = tfaults.make_inputs(dataclasses.replace(cfg, **{gate: False}), keys, 0)
    assert got.deliver_mask.shape == (2, cfg.n_nodes * 1)
    assert torch.equal(got.deliver_mask, want.deliver_mask.reshape(2, -1))
    assert bridge.first_difference(want._replace(deliver_mask=got.deliver_mask), got) is None
