"""The port's plain PyTorch tick (raft_sim_tpu_torch/models/raft_batched.py
`step_b`) against the JAX package's `raft_batched.step_b`, leaf by leaf, for
identical state and inputs along fuzzed multi-tick trajectories -- and once
against the JAX package's Pallas kernel (`step_pallas`, interpret mode, as
tests/test_pallas.py runs it on the CPU).

Each tick, the JAX state and inputs cross to the port through numpy
(raft_sim_tpu_torch/bridge.py), both ticks run, and every leaf of the new
ClusterState and StepInfo must agree. Tolerance: exact equality (value, dtype,
shape) -- the tick is integer-only. This file holds the preset and fuzz
trajectories and the gate checks; tests/test_torch_step_fixtures.py holds the
served planes, the hand-built fixture states and the Pallas interpret rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
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


def trajectory(jcfg, batch, ticks, seed, p_down=0.0, step=trb.step_b, planes=None):
    """Run the JAX tick along a trajectory and hold the port's `step` to it
    every tick. `planes` ((cmds, reads), [ticks, batch] int32; reads may be
    None) replace each tick's client command and read offer, as the serve
    loop does. Returns the number of ticks that had a leader somewhere."""
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
        if planes is not None:
            inp = _offer(inp, planes, t)
        s_np, i_np = jax.device_get((st, inp))
        st, info = jstep(st, inp)
        want_s, want_i = jax.device_get((st, info))
        got_s, got_i = step(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), t
        )
        diff = bridge.first_difference(want_s, got_s) or bridge.first_difference(want_i, got_i)
        assert diff is None, f"tick {t}: {diff}"
        led += int(np.any(np.asarray(want_i.n_leaders) > 0))
    if jcfg.compaction:  # the trajectory compacted: log_base moved off 0
        assert int(np.asarray(st.log_base).max()) > 0
    return led


# tests/test_oracle_parity.py's storage rows: the durable plane under crash
# churn, and its PreVote row on the dense layout (JAX pins the compacted
# layout equal to the dense one, tests/test_storage.py).
DURABLE_CRASHES = rst.RaftConfig(
    n_nodes=5, log_capacity=8, client_interval=2, fsync_interval=3, fsync_jitter_prob=0.25,
    torn_tail_prob=0.3, lost_suffix_span=3, drop_prob=0.2, crash_prob=0.5, crash_period=16,
    crash_down_ticks=8,
)
DURABLE_PREVOTE_DENSE = rst.RaftConfig(
    n_nodes=5, log_capacity=8, max_entries_per_rpc=2, client_interval=1, fsync_interval=4,
    fsync_jitter_prob=0.3, torn_tail_prob=0.4, lost_suffix_span=4, pre_vote=True,
    drop_prob=0.25, crash_prob=0.5, crash_period=14, crash_down_ticks=8,
)

RECONFIG_PLANE = rst.RaftConfig(
    n_nodes=5, log_capacity=8, client_interval=2, reconfig_interval=11, transfer_interval=13,
    read_interval=3, drop_prob=0.2, crash_prob=0.4, crash_period=16, crash_down_ticks=8,
)

# config6 on an 8-slot ring with 2-entry windows and an offer every 2 ticks,
# checking log matching every tick: snapshots and incomparable pairs.
RING_LM_CAP8 = dataclasses.replace(
    rst.PRESETS["config6"][0], log_capacity=8, compact_margin=4, max_entries_per_rpc=2,
    client_interval=2, check_log_matching=True,
)

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
    # The slice-3 presets: config8 (joint-consensus membership, TimeoutNow,
    # ReadIndex under drop and crashes) past its first toggle (tick 97) and
    # transfers (61, 122); config9 (lease reads on a compacting ring under
    # drop and skew) until it compacts.
    pytest.param(rst.PRESETS["config8"][0], 8, 128, 0.0, id="config8"),
    pytest.param(rst.PRESETS["config9"][0], 8, 260, 0.0, id="config9"),
    # tests/test_oracle_parity.py's reconfiguration rows: all three
    # extensions under drop and crash churn, then crossed with PreVote and a
    # fast-wrapping ring (the snapshot config context, fold_span).
    pytest.param(RECONFIG_PLANE, 8, 120, 0.0, id="n5-reconfig-plane"),
    pytest.param(
        dataclasses.replace(RECONFIG_PLANE, compact_margin=4, client_interval=1, pre_vote=True),
        8, 120, 0.0, id="n5-reconfig-prevote-compaction",
    ),
    # Crash fuzz on top of the plane, with lease reads and transfers together.
    pytest.param(
        rst.RaftConfig(n_nodes=5, log_capacity=8, client_interval=2, reconfig_interval=7,
                       transfer_interval=5, read_interval=2, read_lease_ticks=3,
                       election_min_ticks=10, election_range_ticks=6, drop_prob=0.2,
                       clock_skew_prob=0.2),
        8, 120, 0.06, id="n5-reconfig-lease-transfer-crash-fuzz",
    ),
    # The storage plane: config10 (fsync every 3 ticks with jitter, torn
    # tails, crash churn), the oracle's two storage rows, and crash fuzz on
    # top (restarts outside the schedule, so recovery runs on many ticks).
    pytest.param(rst.PRESETS["config10"][0], 8, 160, 0.0, id="config10"),
    pytest.param(DURABLE_CRASHES, 8, 128, 0.0, id="n5-durable-crashes"),
    pytest.param(DURABLE_PREVOTE_DENSE, 8, 128, 0.0, id="n5-durable-prevote-dense"),
    pytest.param(DURABLE_CRASHES, 8, 100, 0.08, id="n5-durable-crash-fuzz"),
    # config4c: config4's uniform drop and skew carrying a client on a
    # CAP=64 log with 8-entry windows (a row of the port's bench matrix).
    pytest.param(rst.PRESETS["config4c"][0], 8, 80, 0.0, id="config4c"),
    # Clusters above 64 nodes: config7 (N=101, W=4 packed words), then its
    # mix dense at N=128 (the last int16-node width-4 row) and at N=255
    # (W=8) under rolling partitions, as config7x runs it compacted.
    pytest.param(rst.PRESETS["config7"][0], 3, 40, 0.0, id="config7-n101"),
    pytest.param(dataclasses.replace(rst.PRESETS["config7"][0], n_nodes=128), 2, 24, 0.0,
                 id="config7-mix-n128"),
    pytest.param(dataclasses.replace(rst.PRESETS["config7"][0], n_nodes=255, partition_period=32,
                                     partition_prob=0.25), 2, 24, 0.0, id="config7-mix-n255-partitions"),
    # Log matching on the compacting ring (the ring form, lm_skipped_pairs):
    # config6 and config9 checked every tick and every 4th, and the
    # fast-wrapping 8-slot ring, where followers fall behind the leader's
    # base and many pairs are incomparable.
    *(pytest.param(dataclasses.replace(rst.PRESETS[name][0], check_log_matching=True,
                                       log_matching_interval=k), 4, ticks, 0.0, id=f"{name}-lm-every-{k}")
      for name, ticks in (("config6", 160), ("config9", 260)) for k in (1, 4)),
    pytest.param(RING_LM_CAP8, 4, 120, 0.06, id="config6-cap8-lm-crash-fuzz"),
]


@pytest.mark.parametrize("jcfg,batch,ticks,p_down", ROWS)
def test_plain_step_matches_jax_step_b(jcfg, batch, ticks, p_down):
    led = trajectory(jcfg, batch, ticks, seed=3, p_down=p_down)
    assert led > 0  # the trajectory reached leadership, so phases 4-8 ran

def _offer(inp, planes, t):
    """Batch-minor JAX inputs with row t of the offer planes in place of the
    scheduled client command and read offer."""
    cmds, reads = planes
    inp = inp._replace(client_cmd=jnp.asarray(cmds[t]))
    return inp if reads is None else inp._replace(read_cmd=jnp.asarray(reads[t]))

def test_step_cuda_on_cpu_tensors_is_the_plain_step():
    """step_cuda dispatches CPU tensors to the plain tick (no kernel launch)."""
    before = tick_engine.step_cuda.launches
    trajectory(rst.PRESETS["config2"][0], 4, 20, seed=4, step=tick_engine.step_cuda)
    assert tick_engine.step_cuda.launches == before

LEASE_KW = dict(client_interval=4, read_interval=3, election_min_ticks=12, read_lease_ticks=4)

@pytest.mark.parametrize(
    "kw",
    [dict(pre_vote=True), dict(compact_margin=4, log_capacity=16),
     dict(client_redirect=True, client_interval=4, client_pipeline=5),
     dict(reconfig_interval=10), dict(transfer_interval=10), dict(read_interval=3), LEASE_KW,
     dict(reconfig_interval=10, compact_margin=4, log_capacity=16),
     dict(fsync_interval=3),
     dict(compact_margin=4, log_capacity=16, check_log_matching=True),
     dict(serve_ingest=True), dict(serve_reads=True)],
    ids=["pre_vote", "compaction", "client_redirect", "reconfig", "transfer", "reads", "lease",
         "reconfig-under-compaction", "durable_storage", "log matching under compaction",
         "serve_ingest", "serve_reads"],
)
def test_ported_gates_are_accepted(kw):
    """PreVote, compaction, the redirect client, the reconfiguration plane
    (membership, transfer, reads, leases; membership under compaction), the
    durable storage plane, log matching under compaction and the serve
    gates (offered writes and reads) run through both the plain tick and the
    kernel's gate check."""
    cfg = tconfig.RaftConfig(**kw)
    tick_engine.check_supported(cfg)
    s = trb.to_batch_minor(ttypes.init_batch(cfg, torch.tensor([0, 1]), 2))
    from raft_sim_tpu_torch.sim import faults as tfaults
    from raft_sim_tpu_torch.utils import threefry

    inp = trb.to_batch_minor(tfaults.make_inputs(cfg, threefry.split(threefry.key(0), 2), 0))
    s2, _ = trb.step_b(cfg, s, inp, 0)
    assert int(s2.now[0]) == 1


@dataclasses.dataclass(frozen=True)
class _SingleServerChange(tconfig.RaftConfig):
    """A TEST-ONLY mutant config: membership changes without a joint phase."""

    @property
    def joint_consensus(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class _LeaseSkewUnsafe(tconfig.RaftConfig):
    """A TEST-ONLY mutant config: the lease window ignores clock skew."""

    @property
    def lease_skew_safe(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class _AckBeforeFsync(tconfig.RaftConfig):
    """A TEST-ONLY mutant config: acks and grants expose volatile state."""

    @property
    def durable_acks(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class _VolatileVote(tconfig.RaftConfig):
    """A TEST-ONLY mutant config: recovery forgets votedFor."""

    @property
    def persist_vote(self) -> bool:
        return False


@pytest.mark.parametrize(
    "kw,gate",
    [
        (dict(compact_planes=True), "compact_planes"),
        (dict(track_trace=True), "track_trace"),
    ],
    ids=lambda x: x if isinstance(x, str) else None,
)
def test_unsupported_gates_raise(kw, gate):
    """Both gates, once refused, are taken by the plain tick. track_trace:
    the tick reads nothing of it, so the gated tick equals the ungated one
    and the kernel's check passes. compact_planes: the tick unpacks, steps
    dense and repacks (ops/tile.py), so its state unpacks to the dense
    tick's; the kernel's launch alone still refuses the packed legs, as the
    reference kernel does (step_cuda unpacks before it)."""
    from raft_sim_tpu_torch.ops import tile
    from raft_sim_tpu_torch.sim import faults as tfaults

    cfg = tconfig.RaftConfig(**kw)
    base = tconfig.RaftConfig()
    keys = torch.tensor([[0, 7], [0, 9]])
    s = trb.to_batch_minor(ttypes.init_batch(cfg, torch.tensor([0, 1]), 2))
    inp = trb.to_batch_minor(tfaults.make_inputs(cfg, keys, 0))
    want = trb.step_b(base, trb.to_batch_minor(ttypes.init_batch(base, torch.tensor([0, 1]), 2)),
                      trb.to_batch_minor(tfaults.make_inputs(base, keys, 0)), 0)
    got = trb.step_b(cfg, s, inp, 0)
    if gate == "compact_planes":
        got = (tile.unpack_state(cfg, got[0]), got[1])
        with pytest.raises(NotImplementedError, match=gate):
            tick_engine.check_supported(cfg)
    else:
        tick_engine.check_supported(cfg)
    assert bridge.first_difference(want[0], got[0]) is None
    assert bridge.first_difference(want[1], got[1]) is None


@pytest.mark.parametrize(
    "kw",
    [
        dict(cls=_SingleServerChange, reconfig_interval=10),
        dict(cls=_AckBeforeFsync, fsync_interval=3),
        dict(cls=_VolatileVote, fsync_interval=3),
        dict(cls=_LeaseSkewUnsafe, **LEASE_KW),
    ],
    ids=["joint_consensus", "durable_acks", "persist_vote", "lease_skew_safe"],
)
def test_mutant_hooks_are_accepted(kw):
    """K1-d: a config with a TEST-ONLY mutant hook off runs through the plain
    tick and passes the kernel's gate check (the refusal these configs met
    before the scenario slice); tests/test_torch_mutation.py holds each hook
    to the JAX tick."""
    kw = dict(kw)
    cfg = kw.pop("cls")(**kw)
    tick_engine.check_supported(cfg)
    from raft_sim_tpu_torch.sim import faults as tfaults
    from raft_sim_tpu_torch.utils import threefry

    s = trb.to_batch_minor(ttypes.init_batch(cfg, torch.tensor([0, 1]), 2))
    inp = trb.to_batch_minor(tfaults.make_inputs(cfg, threefry.split(threefry.key(0), 2), 0))
    s2, _ = trb.step_b(cfg, s, inp, 0)
    assert int(s2.now[0]) == 1
