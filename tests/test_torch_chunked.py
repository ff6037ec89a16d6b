"""The port's chunked runs (raft_sim_tpu_torch/sim/chunked.py) against the
JAX package's `sim/chunked.py` and against the port's own one-call loop, on
the CPU at small size.

Tolerance: exact equality (value, dtype, shape) of every ClusterState and
RunMetrics leaf -- the simulator is integer-only.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.sim import chunked as jchunked
from raft_sim_tpu.sim import scan as jscan
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.sim import chunked, scan
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)


def _port_cfg(jcfg):
    return tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _start(cfg, seed, batch):
    """The port's (state, keys) of `simulate`'s key derivation, on the CPU."""
    return scan.seed_fleet(cfg, seed, batch, "cpu")


def _jax_start(jcfg, seed, batch):
    k_init, k_run = jax.random.split(jax.random.key(seed))
    return rst.init_batch(jcfg, k_init, batch), jax.random.split(k_run, batch)


@pytest.mark.parametrize(
    "jcfg,ticks",
    [
        pytest.param(rst.PRESETS["config2"][0], 96, id="config2"),
        # config6's ring wraps near tick 130; with log matching on, the ring
        # form runs every tick.
        pytest.param(rst.PRESETS["config6"][0], 160, id="config6"),
        pytest.param(dataclasses.replace(rst.PRESETS["config6"][0], check_log_matching=True), 160,
                     id="config6-lm"),
    ],
)
def test_run_chunked_matches_one_call_and_jax(jcfg, ticks):
    """Chunks of 32 ticks equal one run of `ticks` in the port, and equal the
    JAX package's run_chunked over the same chunks."""
    cfg = _port_cfg(jcfg)
    batch = 4
    state, keys = _start(cfg, 5, batch)
    got_s, got_m = chunked.run_chunked(cfg, state, keys, ticks, chunk=32)
    one_s, one_m = scan.run_batch_minor(cfg, state, keys, ticks)
    assert bridge.first_difference(one_s, got_s) is None
    assert bridge.first_difference(one_m, got_m) is None
    js, jk = _jax_start(jcfg, 5, batch)
    want_s, want_m = jax.device_get(jchunked.run_chunked(jcfg, js, jk, ticks, chunk=32))
    assert bridge.first_difference(want_s, got_s) is None
    assert bridge.first_difference(want_m, got_m) is None
    assert int(got_m.ticks.min()) == ticks


def _random_metrics(rng, batch):
    """A numpy RunMetrics tree of random int32 leaves in the JAX layout."""
    from raft_sim_tpu.types import LAT_HIST_BINS

    def leaf(f):
        shape = (batch, LAT_HIST_BINS) if f.endswith("_hist") else (batch,)
        return rng.integers(-2**20, 2**20, size=shape, dtype=np.int32)

    return jscan.RunMetrics(**{f: leaf(f) for f in jscan.RunMetrics._fields})


def test_merge_metrics_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(3):
        a, b = _random_metrics(rng, 6), _random_metrics(rng, 6)
        want = jax.device_get(jchunked.merge_metrics(a, b))
        got = chunked.merge_metrics(bridge.to_port(a, scan.RunMetrics), bridge.to_port(b, scan.RunMetrics))
        assert bridge.first_difference(want, got) is None


def test_callback_sees_each_chunk_and_stops_the_run():
    """The callback runs after every chunk with the ticks done so far, that
    chunk's state and the merged metrics; returning True ends the run
    there, and the result is the state at that chunk."""
    cfg = tconfig.PRESETS["config2"][0]
    state, keys = _start(cfg, 1, 3)
    seen = []

    def cb(done, s, m):
        seen.append((done, int(s.now[0]), int(m.ticks[0])))
        return done >= 40

    got_s, got_m = chunked.run_chunked(cfg, state, keys, 100, chunk=16, callback=cb)
    assert seen == [(16, 16, 16), (32, 32, 32), (48, 48, 48)]
    want_s, want_m = scan.run_batch_minor(cfg, state, keys, 48)
    assert bridge.first_difference(want_s, got_s) is None
    assert bridge.first_difference(want_m, got_m) is None


def test_callers_state_is_never_written():
    """Every tick is out of place: after a run the caller's state (and keys)
    hold exactly what they held before."""
    cfg = dataclasses.replace(tconfig.PRESETS["config6"][0], check_log_matching=True)
    state, keys = _start(cfg, 2, 3)
    before = bridge.to_numpy(state)
    keys_before = keys.clone()
    final, _ = chunked.run_chunked(cfg, state, keys, 40, chunk=8)
    assert bridge.first_difference(before, state) is None
    assert torch.equal(keys, keys_before)
    assert int(final.now[0]) == 40 and int(state.now[0]) == 0


def test_run_chunked_resumes_from_a_mid_run_state():
    """A run continued from a chunk's state with the host's tick equals the
    uninterrupted run (the merged metrics of both halves included)."""
    cfg = dataclasses.replace(tconfig.PRESETS["config6"][0], check_log_matching=True)
    state, keys = _start(cfg, 3, 3)
    s1, m1 = chunked.run_chunked(cfg, state, keys, 48, chunk=16)
    s2, m2 = chunked.run_chunked(cfg, s1, keys, 48, chunk=20, now=48)
    want_s, want_m = chunked.run_chunked(cfg, state, keys, 96, chunk=96)
    assert bridge.first_difference(want_s, s2) is None
    assert bridge.first_difference(want_m, chunked.merge_metrics(m1, m2)) is None


@pytest.mark.parametrize("loop", ["run_minor", "run_minor_telemetry"])
def test_tick_loops_free_each_replaced_state(loop):
    """The tick loops (scan.run_minor, telemetry.run_minor_telemetry, both
    driving their per-tick generators) keep no reference to the state they
    were given once a tick has replaced it, so a run holds one carry, not
    two: by the third tick the starting state is gone."""
    import gc
    import weakref

    from raft_sim_tpu_torch.kernels import tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import telemetry
    from raft_sim_tpu_torch.trace import ring as tring

    cfg = tconfig.RaftConfig(n_nodes=5, client_interval=4, track_trace=True)
    state, keys = _start(cfg, 0, 4)
    carry = [raft_batched.to_batch_minor(state)]
    start = weakref.ref(carry[0].role)
    freed, calls = [], [0]

    def step(c, s, inp, now):
        calls[0] += 1
        if calls[0] == 3:
            gc.collect()
            freed.append(start() is None)
        return tick_engine.step_cuda(c, s, inp, now)

    if loop == "run_minor":
        scan.run_minor(cfg, carry.pop(), keys, 4, 0, step_fn=step)
    else:
        telemetry.run_minor_telemetry(cfg, carry.pop(), keys, 4, 2, 0, step_fn=step,
                                      trace_spec=tring.TraceSpec(depth=8))
    assert freed == [True]
