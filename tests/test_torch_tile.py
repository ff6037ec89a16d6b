"""The compacted carry layout (raft_sim_tpu_torch/ops/tile.py, cfg.compact_planes)
against the JAX package's ops/tile.py: the packed words at the word
boundaries, the width tables and carry dtypes, the packed boot state, every
tick of `step_b` under the layout (config5c, config7x, the compacting config6
twin, N = 31/32/33/64 twins), the port's compacted trajectory against its
dense one, the flat delivery mask, and compacted checkpoints written by
either package and loaded by the other.

Tolerance: exact equality (value, dtype, shape); the packed legs compare as
uint32 (`types.u32_leaves`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu import types as jtypes
from raft_sim_tpu.models import raft_batched as jrb
from raft_sim_tpu.ops import tile as jtile
from raft_sim_tpu.sim import faults as jfaults
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.ops import tile as ttile
from raft_sim_tpu_torch.sim import faults as tfaults
from raft_sim_tpu_torch.sim import scan as tscan
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)

WORD_NS = [31, 32, 33, 51, 64]


def _port_cfg(jcfg):
    return tconfig.RaftConfig(**dataclasses.asdict(jcfg))


def _fault_cfg(n, **kw):
    """tests/test_tile.py's fault-churn twin at N nodes (dense)."""
    base = dict(n_nodes=n, log_capacity=8, max_entries_per_rpc=2, client_interval=2,
                drop_prob=0.25, crash_prob=0.4, crash_period=16, crash_down_ticks=8)
    if n >= 51:
        base.update(log_capacity=16, partition_period=10, partition_prob=0.5, crash_prob=0.0)
    base.update(kw)
    return rst.RaftConfig(**base)


# (JAX config, batch, ticks): config5c crosses its log-matching ticks 16 and
# 32; config6 compacting (index planes stay dense int32) runs its ring.
COMPACT_ROWS = {
    "config5c": (rst.PRESETS["config5c"][0], 4, 33),
    "config7x": (rst.PRESETS["config7x"][0], 2, 16),
    "config6-compact": (jtypes.compact_twin(rst.PRESETS["config6"][0]), 4, 64),
    **{f"n{n}-compact": (jtypes.compact_twin(_fault_cfg(n)), 2, 24) for n in (31, 32, 33, 64)},
}


@pytest.mark.parametrize("n", WORD_NS)
@pytest.mark.parametrize("batch", [None, 3], ids=["per-cluster", "batch-minor"])
def test_pack_words_match_jax(n, batch):
    """Every bit width of a plane at N nodes: the port's words equal JAX's in
    the [M] and [M, B] layouts, and unpack back to the values."""
    rng = np.random.default_rng(n)
    m = n * n
    for bits in (2, 3, 5, 7, 16):
        shape = (m,) if batch is None else (m, batch)
        vals = rng.integers(0, 1 << bits, size=shape, dtype=np.int32)
        want = np.asarray(jtile.pack_words(jnp.asarray(vals.astype(np.int8 if bits < 8 else np.int32)),
                                           bits))
        got = ttile.pack_words(torch.from_numpy(vals), bits)
        assert got.dtype == torch.int32 and want.dtype == np.uint32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want, err_msg=f"bits {bits}")
        back = ttile.unpack_words(got, bits, m, torch.int32)
        np.testing.assert_array_equal(back.numpy(), vals, err_msg=f"bits {bits}")
        assert ttile.words_for(m, bits) == jtile.words_for(m, bits) == got.shape[0]


@pytest.mark.parametrize("name", ["config5c", "config7x", "config6-compact"])
def test_width_table_and_carry_dtypes_match_jax(name):
    jcfg = COMPACT_ROWS[name][0]
    tcfg = _port_cfg(jcfg)
    assert ttile.pack_width_table(tcfg) == jtile.pack_width_table(jcfg)
    want = {k: np.dtype(v) for k, v in jtile.packed_carry_dtypes(jcfg).items()}
    assert ttile.packed_carry_dtypes(tcfg) == want
    assert ("next_index" in want) == (not jcfg.compaction)
    for f in ("bits_for", "index_bits", "age_bits", "off_bits"):
        arg = 37 if f == "bits_for" else tcfg
        jarg = 37 if f == "bits_for" else jcfg
        assert getattr(ttile, f)(arg) == getattr(jtile, f)(jarg)
    assert ttile.RESP_BITS == jtile.RESP_BITS


@pytest.mark.parametrize("name", ["config5c", "config7x", "config6-compact"])
def test_init_batch_compact_matches_jax(name):
    """The boot state packs under compact_planes, as JAX's init does: every
    leaf equal, packed legs [B, W] as uint32."""
    jcfg = COMPACT_ROWS[name][0]
    tcfg = _port_cfg(jcfg)
    want = jax.device_get(rst.init_batch(jcfg, jax.random.key(4), 3))
    got = ttypes.init_batch(tcfg, threefry.key(4), 3)
    assert bridge.first_difference(want, got, u32=ttypes.u32_leaves(tcfg)) is None
    assert got.ack_age.dim() == 2
    dense = ttypes.init_batch(ttypes.compact_twin(tcfg, on=False), threefry.key(4), 3)
    assert bridge.first_difference(dense, ttile.unpack_state(tcfg, got, lead=1)) is None


@functools.lru_cache(maxsize=None)
def _jax_tick(jcfg):
    step = jax.jit(lambda s, i: jrb.step_b(jcfg, s, i))
    draw = jax.jit(lambda k, now: jrb.to_batch_minor(
        jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k)))
    return step, draw


@pytest.mark.parametrize("name", list(COMPACT_ROWS))
def test_compact_step_b_matches_jax(name):
    """step_b under compact_planes (unpack, dense tick, repack with the
    gated-off legs passed through) equals the JAX step_b every tick, packed
    state and StepInfo."""
    jcfg, batch, ticks = COMPACT_ROWS[name]
    tcfg = _port_cfg(jcfg)
    u32 = ttypes.u32_leaves(tcfg)
    jstep, draw = _jax_tick(jcfg)
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(3), batch))
    keys = jax.random.split(jax.random.key(4), batch)
    led = 0
    for t in range(ticks):
        inp = draw(keys, jnp.int32(t))
        s_np, i_np = jax.device_get((st, inp))
        st, info = jstep(st, inp)
        want_s, want_i = jax.device_get((st, info))
        got_s, got_i = trb.step_b(tcfg, bridge.to_port(s_np, ttypes.ClusterState),
                                  bridge.to_port(i_np, ttypes.StepInputs), t)
        diff = (bridge.first_difference(want_s, got_s, u32=u32)
                or bridge.first_difference(want_i, got_i))
        assert diff is None, f"tick {t}: {diff}"
        led += int(np.asarray(want_i.n_leaders).max() > 0)
    assert led > 0
    # Under compaction the index planes stay dense int32 [N, N, B].
    assert (got_s.next_index.dim() == 3) == tcfg.compaction


@pytest.mark.parametrize("name", ["config5c", "config6-compact", "n33-compact"])
def test_compact_trajectory_unpacks_to_the_dense_one(name):
    """The port's compacted run, unpacked, equals its dense run every tick
    (state and StepInfo); the flat mask is the dense mask's words."""
    jcfg, batch, ticks = COMPACT_ROWS[name]
    ccfg = _port_cfg(jcfg)
    dcfg = ttypes.compact_twin(ccfg, on=False)
    keys = threefry.split(threefry.key(6), batch)
    sc = trb.to_batch_minor(ttypes.init_batch(ccfg, threefry.key(5), batch))
    sd = trb.to_batch_minor(ttypes.init_batch(dcfg, threefry.key(5), batch))
    for t in range(ticks):
        ic = trb.to_batch_minor(tfaults.make_inputs(ccfg, keys, t))
        idn = trb.to_batch_minor(tfaults.make_inputs(dcfg, keys, t))
        assert bridge.first_difference(idn, ttile.unpack_inputs(ccfg, ic)) is None
        sc, info_c = trb.step_b(ccfg, sc, ic, t)
        sd, info_d = trb.step_b(dcfg, sd, idn, t)
        diff = (bridge.first_difference(sd, ttile.unpack_state(ccfg, sc))
                or bridge.first_difference(info_d, info_c))
        assert diff is None, f"tick {t}: {diff}"


@pytest.mark.parametrize("n", WORD_NS)
def test_unpack_inputs_flat_mask_matches_jax(n):
    """make_inputs ships the delivery mask flat under the layout: [B, N*W]
    equal to JAX's words, unpacking to the dense [N, W, B] plane."""
    jcfg = jtypes.compact_twin(_fault_cfg(n, drop_prob=0.3))
    tcfg = _port_cfg(jcfg)
    jkeys = jax.random.split(jax.random.key(7), 3)
    tkeys = threefry.split(threefry.key(7), 3)
    for now in (0, 5):
        want = jax.device_get(jax.vmap(lambda k: jfaults.make_inputs(jcfg, k, jnp.int32(now)))(jkeys))
        got = tfaults.make_inputs(tcfg, tkeys, now)
        assert bridge.first_difference(want, got) is None
        assert got.deliver_mask.shape == (3, n * ((n + 31) // 32))
        dense = tfaults.make_inputs(ttypes.compact_twin(tcfg, on=False), tkeys, now)
        unpacked = ttile.unpack_inputs(tcfg, trb.to_batch_minor(got))
        assert bridge.first_difference(trb.to_batch_minor(dense), unpacked) is None
        assert unpacked.deliver_mask.is_contiguous()


def test_compact_checkpoints_load_in_either_package(tmp_path):
    """config5c checkpoints both ways: the JAX file loads in the port and the
    port's file in JAX, leaf for leaf with JAX's dtypes (packed legs uint32),
    and both files hold the same arrays."""
    from raft_sim_tpu.sim import scan as jscan
    from raft_sim_tpu.utils import checkpoint as jck
    from raft_sim_tpu_torch.utils import checkpoint as tck

    jcfg, tcfg = rst.PRESETS["config5c"][0], tconfig.PRESETS["config5c"][0]
    u32 = ttypes.u32_leaves(tcfg)
    js, jm = jscan.simulate(jcfg, 2, 3, 20)
    jkeys = jax.random.split(jax.random.split(jax.random.key(2))[1], 3)
    jpath = jck.save(str(tmp_path / "jax.npz"), jcfg, js, jkeys, jm, seed=2)
    cfg, ps, pkeys, pm, seed, scen = tck.load(jpath, device="cpu")
    assert cfg == tcfg and seed == 2 and scen is None
    assert bridge.first_difference(jax.device_get(js), ps, u32=u32) is None
    assert bridge.first_difference(jax.device_get(jm), pm) is None
    tpath = tck.save(str(tmp_path / "port.npz"), tcfg, ps, pkeys, pm, seed=2)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            assert zj[f].dtype == zt[f].dtype and np.array_equal(zj[f], zt[f]), f
        assert zt["state_next_index"].dtype == np.uint32
        assert zt["mb_resp_kind"].dtype == np.uint32
    cfg2, js2, _k, jm2, _s, _sc = jck.load(tpath)
    assert cfg2 == jcfg
    assert bridge.first_difference(jax.device_get(js2), ps, u32=u32) is None
    # The resumed port run equals one uninterrupted run.
    s_more, m_more = tscan.run_batch_minor(tcfg, ps, pkeys, 8, now=20)
    s_one, _ = tscan.simulate(tcfg, 2, 3, 28, device="cpu")
    assert bridge.first_difference(s_one, s_more) is None
    assert int(m_more.ticks.min()) == 8


def test_compact_trace_events_and_session_round_trip(tmp_path):
    """A traced config5c run gives the dense config5 run's protocol events
    every tick (the extractor restores the flat mask's row view), and a
    config5c Session saved and restored equals one uninterrupted run."""
    from raft_sim_tpu_torch.driver import Session

    ccfg = dataclasses.replace(tconfig.PRESETS["config5c"][0], track_trace=True)
    dcfg = ttypes.compact_twin(ccfg, on=False)
    states = {}
    for cfg in (ccfg, dcfg):
        s, keys = tscan.seed_fleet(cfg, 3, 2, "cpu")
        states[cfg] = [trb.to_batch_minor(s), trb.to_batch_minor(tscan.init_metrics_batch(2))]
    emitted = 0
    for t in range(24):
        out = {}
        for cfg in (ccfg, dcfg):
            s, m = states[cfg]
            s, m, _, ev = tscan.tick_batch_minor(cfg, s, keys, m, t, events=True)
            states[cfg] = [s, m]
            out[cfg] = ev
        assert bridge.first_difference(out[dcfg], out[ccfg]) is None, f"tick {t}"
        emitted += int(out[ccfg].flags.sum())
    assert emitted > 0
    cfg = tconfig.PRESETS["config5c"][0]
    a = Session(cfg, batch=2, seed=1, device="cpu")
    a.run(16)
    path = a.save(str(tmp_path / "c5c.npz"))
    b = Session.restore(path, device="cpu")
    b.run(8)
    whole = Session(cfg, batch=2, seed=1, device="cpu")
    whole.run(24)
    assert bridge.first_difference(whole.state, b.state) is None
    assert bridge.first_difference(whole.metrics, b.metrics) is None
