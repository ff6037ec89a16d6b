"""The Hopper draw kernel's own logic (K2) against the JAX package, on the
CPU: the g++ build of csrc/draws.cuh (kernels/draw_engine.py `draw_host`;
tests/test_torch_draws_body.py holds it against the plain draws) directly
against `jax.vmap(raft_sim_tpu.sim.faults.make_inputs)` on config3,
config6, config8, config10 and config7x, the staged side bits with the
facts (`trace_fault_inputs`) at N = 33, 51 and 255 in both worker orders,
and the slice as a whole: the
main path's loop (`scan.tick_batch_minor`) with every tick's draws from
the draw body and every tick from the tick kernel's host body
(`tick_engine.step_host`) against the JAX package's `simulate`.

Tolerance: exact equality of every StepInputs leaf (the packed delivery
mask as uint32 through its int32 carrier), and of the final ClusterState
and every RunMetrics leaf. Skips only where no g++ is installed.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.sim import faults as jfaults
from raft_sim_tpu.sim import scan as jscan
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    return draw_engine.load_host(draw_engine.host_library(gxx))


def _port_cfg(jcfg):
    return tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


@pytest.mark.parametrize("name", ["config3", "config6", "config8", "config10", "config7x"])
def test_draw_body_matches_jax(lib, name):
    """The body against `jax.vmap(raft_sim_tpu.sim.faults.make_inputs)`
    directly, as tests/test_torch_inputs.py holds the plain draws."""
    jcfg = rst.PRESETS[name][0]
    cfg = _port_cfg(jcfg)
    batch = 2 if cfg.n_nodes > 100 else 6
    jkeys = jax.random.split(jax.random.key(21), batch)
    keys = threefry.split(threefry.key(21), batch)
    draw = jax.jit(lambda k, now: jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    ticks = [0, 1, 2, 3, 33, 63, 64, 65, 97, 1000] if cfg.n_nodes <= 100 else [0, 1, 31, 32, 64]
    for t in ticks:
        want = jax.device_get(draw(jkeys, jnp.int32(t)))
        got = trb.from_batch_minor(draw_engine.draw_host(lib, cfg, keys, t))
        diff = bridge.first_difference(want, got)
        assert diff is None, f"tick {t}: {diff}"


@pytest.fixture(scope="module")
def tick_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    return tick_engine.load_host(tick_engine.host_library(gxx))


@pytest.mark.parametrize("name", ["config4", "config6"])
def test_simulate_through_both_host_bodies_matches_jax(lib, tick_lib, name):
    """The slice as a whole: `simulate`'s loop with every tick's draws from
    the draw body and every tick from the tick body equals the JAX
    package's `simulate`, final state and RunMetrics."""
    jcfg, _ = rst.PRESETS[name]
    cfg = tconfig.PRESETS[name][0]
    batch, ticks = 4, 32
    want_s, want_m = jax.device_get(jscan.simulate(jcfg, 7, batch, ticks))
    state, keys = scan.seed_fleet(cfg, 7, batch, torch.device("cpu"))
    s = trb.to_batch_minor(state)
    m = trb.to_batch_minor(scan.init_metrics_batch(batch))

    def draw(c, k, now, genome=None, seg_len=1, facts=False):
        return draw_engine.draw_host(lib, c, k, now, genome, seg_len, facts)

    def step(c, s, inp, now):
        return tick_engine.step_host(tick_lib, c, s, inp, now)

    for t in range(ticks):
        s, m, _ = scan.tick_batch_minor(cfg, s, keys, m, t, step_fn=step, draw_fn=draw)
    assert bridge.first_difference(want_s, trb.from_batch_minor(s)) is None
    assert bridge.first_difference(want_m, trb.from_batch_minor(m)) is None


@pytest.mark.parametrize("order", ["forward", "reverse-poison"])
@pytest.mark.parametrize("n", [33, 51, 255])
def test_staged_side_bits_match_jax_with_facts(lib, n, order):
    """The staged body (a partition's side bits drawn once a row and shared
    through the stage, csrc/draws.cuh `stage_node`) against
    `jax.vmap(make_inputs)` and `jax.vmap(trace_fault_inputs)` under rolling
    partitions, at the card's tile edges (N = 33, 51, 255), forward and in
    reverse with the staging poisoned: every input leaf, the crash edge and
    both cut counts."""
    jcfg = dataclasses.replace(rst.PRESETS["config7"][0], n_nodes=n, partition_period=8,
                               partition_prob=0.5, drop_prob=0.1)
    cfg = _port_cfg(jcfg)
    batch = 3
    jkeys = jax.random.split(jax.random.key(23), batch)
    keys = threefry.split(threefry.key(23), batch)
    draw = jax.jit(lambda k, now: jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    facts = jax.jit(lambda k, now: jax.vmap(
        lambda kk: jfaults.trace_fault_inputs(jcfg, kk, now))(k))
    rev = order != "forward"
    cut = 0
    for t in (0, 1, 7, 8, 9, 16, 17, 33):
        want = jax.device_get(draw(jkeys, jnp.int32(t)))
        want_f = jax.device_get(facts(jkeys, jnp.int32(t)))
        got, got_f = draw_engine.draw_host(lib, cfg, keys, t, facts=True, reverse=rev, poison=rev)
        diff = bridge.first_difference(want, trb.from_batch_minor(got))
        assert diff is None, f"tick {t}: {diff}"
        assert (got_f[0].T.numpy() == want_f[0]).all(), f"tick {t}: crashed"
        assert (got_f[1].numpy() == want_f[1]).all(), f"tick {t}: cut_now"
        assert (got_f[2].numpy() == want_f[2]).all(), f"tick {t}: cut_prev"
        cut += int((got_f[1] > 0).sum())
    assert cut > 0
