"""The port's plain PyTorch tick (raft_sim_tpu_torch/models/raft_batched.py
`step_b`) against the JAX package's `raft_batched.step_b` on the served
per-cluster offer planes and on the hand-built fixture states of the JAX
package's own compaction, reconfiguration, lease, storage and log-matching
tests -- and against the JAX package's Pallas kernel (`step_pallas`,
interpret mode, as tests/test_pallas.py runs it on the CPU) on mid-run states
of each gate set. tests/test_torch_step.py holds the preset and fuzz
trajectories.

Tolerance: exact equality (value, dtype, shape) -- the tick is integer-only.
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
from raft_sim_tpu_torch.models import raft_batched as trb
from tests.test_torch_step import RING_LM_CAP8, _offer, _port_cfg, trajectory

torch.set_num_threads(1)


@pytest.mark.parametrize("name,batch,ticks,p_down", [
    ("config2", 6, 80, 0.0), ("config9", 5, 200, 0.0), ("config6r", 5, 160, 0.0),
    ("config10", 5, 160, 0.0), ("config8", 4, 120, 0.05),
])
def test_plain_step_matches_jax_step_b_under_served_planes(name, batch, ticks, p_down):
    """serve_ingest/serve_reads (K1-c's gates) in the plain tick: the preset
    under the JAX serve_config -- no client or read cadence, the offer-tick
    plane live -- fed per-cluster planes with NIL holes and int32-edge
    payloads, equals the JAX tick every tick."""
    from raft_sim_tpu.serve.loop import serve_config
    from tests.test_torch_cuda import served_planes

    jcfg = serve_config(rst.PRESETS[name][0])
    assert jcfg.serve_ingest and jcfg.client_interval == 0
    planes = served_planes(batch, ticks, 9, jcfg.read_index)
    assert trajectory(jcfg, batch, ticks, seed=3, p_down=p_down, planes=planes) > 0


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


def reconfig_cases():
    """Short runs from the one-tick states of the JAX package's own
    reconfiguration and lease tests (tests/test_reconfig.py,
    tests/test_lease.py): {name: (JAX cfg, unbatched JAX state, [JAX
    StepInputs per tick])}. The states are built exactly as those tests
    build them."""
    from raft_sim_tpu.types import CANDIDATE, LEADER, REQ_VOTE
    from tests import test_lease as tl
    from tests import test_reconfig as tr

    cases = {}
    full = lambda n, v: jnp.full((n,), v, jnp.int32)  # noqa: E731

    # The log-carried joint lifecycle and the removed leader's stepdown
    # (test_reconfig.py:160): the toggle, then replication, the final entry
    # and the stepdown over 16 quiet ticks.
    n = 5
    cfg = rst.RaftConfig(n_nodes=n, log_capacity=8, reconfig_interval=1000)
    s = rst.init_state(cfg, jax.random.key(0))
    s = s._replace(
        role=s.role.at[0].set(LEADER), term=full(n, 2), leader_id=full(n, 0),
        ack_age=jnp.zeros((n, n), s.ack_age.dtype), deadline=s.deadline.at[0].set(1),
    )
    q = tr._quiet_inputs(cfg)
    cases["joint-lifecycle-and-stepdown"] = (
        cfg, s, [tr._quiet_inputs(cfg, reconfig_cmd=jnp.int32(0))] + [q] * 16)

    # Origination refused while joint, and below two voters (:213).
    n = 3
    cfg = rst.RaftConfig(n_nodes=n, log_capacity=8, reconfig_interval=1000)
    s = rst.init_state(cfg, jax.random.key(0))
    s = s._replace(role=s.role.at[0].set(LEADER), term=full(n, 2),
                   member_new=tr._mask_rows(n, {0, 1}), cfg_pend=full(n, 1000))
    cmd = [tr._quiet_inputs(cfg, reconfig_cmd=jnp.int32(1))]
    cases["refused-while-joint"] = (cfg, s, cmd)
    cases["refused-below-two-voters"] = (
        cfg, s._replace(cfg_pend=full(n, 0), member_old=tr._mask_rows(n, {0, 1})), cmd)

    # A transfer parks, refuses a client command and fires TimeoutNow (:308).
    n = 5
    cfg = rst.RaftConfig(n_nodes=n, log_capacity=8, transfer_interval=1000, client_interval=4)
    s = rst.init_state(cfg, jax.random.key(0))
    s = s._replace(
        role=s.role.at[0].set(LEADER), term=full(n, 2), leader_id=full(n, 0),
        ack_age=jnp.zeros((n, n), s.ack_age.dtype), deadline=s.deadline.at[0].set(1),
    )
    q = tr._quiet_inputs(cfg)
    cases["transfer-fire"] = (
        cfg, s, [tr._quiet_inputs(cfg, transfer_cmd=jnp.int32(3), client_cmd=jnp.int32(77))]
        + [q] * 3)

    # A transfer accepted, fired and won while the joint phase stays open (:337).
    cfg = rst.RaftConfig(n_nodes=n, log_capacity=8, reconfig_interval=1000,
                         transfer_interval=1000, client_interval=4)
    s = rst.init_state(cfg, jax.random.key(0))
    s = s._replace(
        role=s.role.at[0].set(LEADER), term=full(n, 2), leader_id=full(n, 0),
        ack_age=jnp.zeros((n, n), s.ack_age.dtype), deadline=s.deadline.at[0].set(1),
        log_term=s.log_term.at[:, 0].set(1), log_cfg=s.log_cfg.at[:, 0].set(4 + 1),
        log_len=jnp.ones((n,), s.log_len.dtype), match_index=s.match_index.at[0, :].set(1),
        next_index=s.next_index.at[0, :].set(2), member_new=tr._mask_rows(n, {0, 1, 2, 3}),
        cfg_pend=full(n, 1), cfg_epoch=full(n, 1),
    )
    q = tr._quiet_inputs(cfg)
    cases["transfer-during-joint"] = (
        cfg, s, [tr._quiet_inputs(cfg, transfer_cmd=jnp.int32(1))] + [q] * 4)

    # The transfer's sanctioned RequestVote overrides the lease denial; a
    # plain election under the same armed denial gets no grant (:410).
    cfg = rst.RaftConfig(n_nodes=n, log_capacity=8, client_interval=2, read_interval=3,
                         election_min_ticks=12, election_range_ticks=6, read_lease_ticks=4,
                         transfer_interval=1000)
    s = rst.init_state(cfg, jax.random.key(0))
    s = s._replace(
        role=s.role.at[0].set(LEADER), term=full(n, 2), leader_id=full(n, 0),
        ack_age=jnp.zeros((n, n), s.ack_age.dtype), heard_clock=full(n, 0),
        deadline=s.deadline.at[0].set(1),
    )
    q = tr._quiet_inputs(cfg)
    cases["transfer-overrides-lease-denial"] = (
        cfg, s, [tr._quiet_inputs(cfg, transfer_cmd=jnp.int32(2))] + [q] * 3)
    s = s._replace(role=s.role.at[3].set(CANDIDATE), term=s.term.at[3].set(3),
                   voted_for=s.voted_for.at[3].set(3), votes=s.votes.at[3].set(tr._mask(n, {3})),
                   deadline=s.deadline.at[3].set(1))
    cases["plain-election-denied-under-lease"] = (cfg, s, [q] * 3)

    # Read confirmation judged on the tick-start (joint) config at a joint
    # exit (:484).
    cfg = rst.RaftConfig(n_nodes=n, log_capacity=8, reconfig_interval=1000, read_interval=1000)
    s = rst.init_state(cfg, jax.random.key(0))
    s = s._replace(
        role=s.role.at[0].set(LEADER), term=full(n, 2), leader_id=full(n, 0),
        member_old=tr._mask_rows(n, {0, 1, 2, 3}), member_new=tr._mask_rows(n, {0, 1, 2, 3, 4}),
        cfg_pend=full(n, 1), read_idx=s.read_idx.at[0].set(1), read_tick=s.read_tick.at[0].set(1),
        read_acks=s.read_acks.at[0].set(tr._mask(n, {1, 4})),
    )
    cases["tick-start-config-at-joint-exit"] = (cfg, s, [tr._quiet_inputs(cfg)])

    # Leases (test_lease.py:102-161): the one-tick serve, an expired lease,
    # a stale serve and its legal twin, the vote denial and its expiry and
    # restart wipe.
    lcfg = tl.LCFG
    q = tl._quiet_inputs(lcfg)
    read = tl._quiet_inputs(lcfg, read_cmd=jnp.int32(1))
    cases["lease-one-tick-serve"] = (lcfg, tl._leader_state(lcfg), [read, q])
    cases["lease-expired"] = (lcfg, tl._leader_state(lcfg, ack_age_val=50), [read] + [q] * 3)
    base = tl._leader_state(lcfg)
    pending = dict(read_idx=base.read_idx.at[0].set(2), read_tick=base.read_tick.at[0].set(1))
    cases["lease-stale-serve"] = (lcfg, base._replace(**pending, read_fr=base.read_fr.at[0].set(3)), [q])
    cases["lease-legal-serve"] = (lcfg, base._replace(**pending, read_fr=base.read_fr.at[0].set(1)), [q])
    s = rst.init_state(lcfg, jax.random.key(1))
    mb = s.mailbox
    s = s._replace(
        term=full(n, 2), role=s.role.at[1].set(CANDIDATE), deadline=full(n, 10_000),
        heard_clock=full(n, 0),
        mailbox=mb._replace(req_type=mb.req_type.at[1].set(REQ_VOTE),
                            req_term=mb.req_term.at[1].set(2)),
    )
    cases["lease-vote-denial"] = (lcfg, s, [q])
    cases["lease-vote-after-window"] = (lcfg, s._replace(heard_clock=full(n, -50)), [q])
    cases["lease-vote-restart-wipe"] = (
        lcfg, s, [tl._quiet_inputs(lcfg, restarted=jnp.asarray([False, False, True, False, False]))])
    return cases


RECONFIG_CASES = [
    "joint-lifecycle-and-stepdown", "refused-while-joint", "refused-below-two-voters",
    "transfer-fire", "transfer-during-joint", "transfer-overrides-lease-denial",
    "plain-election-denied-under-lease", "tick-start-config-at-joint-exit",
    "lease-one-tick-serve", "lease-expired", "lease-stale-serve", "lease-legal-serve",
    "lease-vote-denial", "lease-vote-after-window", "lease-vote-restart-wipe",
]


@functools.lru_cache(maxsize=1)
def _reconfig_cases():
    return reconfig_cases()


def reconfig_case_batch(name):
    """(JAX cfg, JAX batch-minor state, [JAX batch-minor inputs]) of one case, B=1."""
    jcfg, s, inps = _reconfig_cases()[name]
    lift = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[..., None], t)  # noqa: E731
    return jcfg, lift(s), [lift(i) for i in inps]


@pytest.mark.parametrize("name", RECONFIG_CASES)
def test_plain_step_matches_jax_on_reconfig_and_lease_states(name):
    """The plain tick against JAX `step_b` every tick of each case's run,
    from the JAX state of the tick before."""
    jcfg, st, inps = reconfig_case_batch(name)
    cfg = _port_cfg(jcfg)
    jstep = _jitted_step_b(jcfg)
    for t, inp in enumerate(inps):
        st2, info = jstep(st, inp)
        want_s, want_i = jax.device_get((st2, info))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = trb.step_b(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs)
        )
        diff = bridge.first_difference(want_s, got_s) or bridge.first_difference(want_i, got_i)
        assert diff is None, f"{name} tick {t}: {diff}"
        st = st2


def storage_edge_case(n):
    """The word-edge recovery fixture of tests/test_storage.py at N nodes:
    (JAX cfg, batch-minor JAX state, [batch-minor JAX inputs per tick], B=1).
    Tick 0 forces restarts on the even nodes with torn spans 0..6 against
    logs of (7 i) % 17 entries fsynced to half (no flush, no client offer);
    three drawn ticks follow."""
    from raft_sim_tpu.types import NIL
    from tests.test_storage import _dur_cfg

    cfg = _dur_cfg(n)
    k_init, k_run = jax.random.split(jax.random.key(n))
    s = rst.init_state(cfg, k_init)
    ar = np.arange(n)
    log_len = ((ar * 7) % 17).astype(np.int32)
    s = s._replace(log_len=jnp.asarray(log_len), dur_len=jnp.asarray(log_len // 2))
    inp0 = jfaults.make_inputs(cfg, k_run, s.now)._replace(
        restarted=jnp.asarray(ar % 2 == 0), alive=jnp.ones(n, bool),
        torn_drop=jnp.asarray((ar % 7).astype(np.int32)), fsync_fire=jnp.zeros(n, bool),
        client_cmd=jnp.int32(NIL),
    )
    inps = [inp0] + [jfaults.make_inputs(cfg, k_run, jnp.int32(t)) for t in range(1, 4)]
    lift = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[..., None], t)  # noqa: E731
    return cfg, lift(s), [lift(i) for i in inps]


@pytest.mark.parametrize("n", [31, 32, 33])
def test_plain_step_matches_jax_on_recovery_word_edges(n):
    """Recovery truncates every restarted log to max(dur_len, log_len -
    torn_drop) and rewinds term/vote, at N straddling the packed vote word;
    the plain tick equals JAX step_b on the forced tick and three after."""
    jcfg, st, inps = storage_edge_case(n)
    cfg = _port_cfg(jcfg)
    jstep = _jitted_step_b(jcfg)
    ar = np.arange(n)
    log_len = (ar * 7) % 17
    for t, inp in enumerate(inps):
        want_s, want_i = jax.device_get(jstep(st, inp))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = trb.step_b(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs)
        )
        diff = bridge.first_difference(want_s, got_s) or bridge.first_difference(want_i, got_i)
        assert diff is None, f"N={n} tick {t}: {diff}"
        if t == 0:
            expect = np.where(ar % 2 == 0, np.maximum(log_len // 2, log_len - ar % 7), log_len)
            assert got_s.log_len[:, 0].tolist() == expect.tolist()
            assert got_s.dur_len[:, 0].tolist() == np.minimum(log_len // 2, expect).tolist()
        st = jstep(st, inp)[0]


def ring_lm_cases():
    """One-tick states for ring-form log matching, B=1: tests/test_metrics.py's
    skipped-pair fixture (node 0 compacted past every other node's commit:
    four incomparable pairs), and two planted faults on wrapped rings (CAP=8,
    bases past the capacity) that only the ring form sees: a differing entry
    inside the comparable suffix, and a differing entry below the larger
    base, which only the checksum at that base compares. {name: (JAX cfg,
    batch-minor JAX state, batch-minor quiet inputs, expected StepInfo
    values)}."""
    from tests.test_compaction import CFG as RING_CFG
    from tests.test_compaction import hist, with_ring_log
    from tests.test_handlers import base_state, quiet_inputs

    cfg = dataclasses.replace(RING_CFG, check_log_matching=True)
    lift = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[..., None], t)  # noqa: E731
    quiet = lift(quiet_inputs(cfg))
    cases = {}
    s = base_state(cfg)
    s = with_ring_log(s, 0, base=6, entries=hist(6, 8), commit=8)
    s = with_ring_log(s, 1, base=0, entries=hist(0, 2), commit=2)
    cases["skipped-pairs"] = (cfg, lift(s), quiet, dict(lm_skipped_pairs=4, viol_log_matching=False))
    good = with_ring_log(with_ring_log(base_state(cfg), 0, base=9, entries=hist(9, 14), commit=14),
                         1, base=11, entries=hist(11, 16), commit=14)
    cases["wrapped-rings-agree"] = (cfg, lift(good), quiet, dict(viol_log_matching=False))
    # Node 1's entry 13 (slot 4 of both rings) differs: [max base, min commit)
    # = [11, 14) holds it.
    bad = good._replace(log_val=good.log_val.at[1, 12 % 8].set(4242))
    cases["wrapped-suffix-mismatch"] = (cfg, lift(bad), quiet, dict(viol_log_matching=True))
    # Node 0's entry 10 (absolute 0-based 9, below node 1's base 11) differs:
    # only node 0's checksum at base 11 can see it.
    bad = good._replace(log_val=good.log_val.at[0, 9 % 8].set(4242))
    cases["wrapped-prefix-checksum-mismatch"] = (cfg, lift(bad), quiet, dict(viol_log_matching=True))
    return cases


RING_LM_CASES = ["skipped-pairs", "wrapped-rings-agree", "wrapped-suffix-mismatch",
                 "wrapped-prefix-checksum-mismatch"]


@pytest.mark.parametrize("name", RING_LM_CASES)
def test_plain_step_matches_jax_on_ring_log_matching_states(name):
    """The plain tick against JAX step_b on each fixture, with the JAX
    StepInfo holding the expected verdict and skipped-pair count."""
    jcfg, st, inp, expect = ring_lm_cases()[name]
    want_s, want_i = jax.device_get(_jitted_step_b(jcfg)(st, inp))
    for k, v in expect.items():
        assert getattr(want_i, k).tolist() == [v], (k, getattr(want_i, k))
    s_np, i_np = jax.device_get((st, inp))
    got_s, got_i = trb.step_b(
        _port_cfg(jcfg), bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs)
    )
    diff = bridge.first_difference(want_s, got_s) or bridge.first_difference(want_i, got_i)
    assert diff is None, f"{name}: {diff}"


@pytest.mark.parametrize(
    "jcfg,warm",
    [
        pytest.param(RING_LM_CAP8, 80, id="config6-cap8-lm"),
        pytest.param(dataclasses.replace(rst.PRESETS["config6"][0], check_log_matching=True), 180,
                     id="config6-lm"),
        # Due on the second of the two ticks only (post-tick now 264).
        pytest.param(dataclasses.replace(rst.PRESETS["config9"][0], check_log_matching=True,
                                         log_matching_interval=4), 262, id="config9-lm-every-4"),
    ],
)
def test_plain_step_matches_step_pallas_interpret_ring_log_matching(jcfg, warm):
    """K1-b: step_pallas (interpret mode) with log matching on a wrapped
    ring, two ticks from a mid-run state (on the 8-slot ring, with
    incomparable pairs)."""
    cfg = _port_cfg(jcfg)
    B = 4
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(11), B))
    keys = jax.random.split(jax.random.key(12), B)
    jstep = _jitted_step_b(jcfg)
    draw = jax.jit(
        lambda k, now: jrb.to_batch_minor(jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    )
    for t in range(warm):
        st = jstep(st, draw(keys, jnp.int32(t)))[0]
    assert int(np.asarray(st.log_base).min()) > 0  # every node has compacted
    skipped = 0
    for t in range(warm, warm + 2):
        inp = draw(keys, jnp.int32(t))
        want_s, want_i = jax.device_get(pallas_engine.step_pallas(jcfg, st, inp, block_b=4, interpret=True))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = trb.step_b(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), t
        )
        assert bridge.first_difference(want_s, got_s) is None, t
        assert bridge.first_difference(want_i, got_i) is None, t
        skipped += int(np.asarray(want_i.lm_skipped_pairs).sum())
        st = jstep(st, inp)[0]
    assert skipped > 0 or jcfg is not RING_LM_CAP8

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


def test_plain_step_matches_step_pallas_interpret_served_planes():
    """K1-c as the JAX tests run K1: step_pallas (interpret mode) on a served
    config9 (offered writes and reads, per-cluster planes with holes), two
    ticks from a mid-trajectory state with reads pending."""
    from raft_sim_tpu.serve.loop import serve_config
    from tests.test_torch_cuda import served_planes

    jcfg = serve_config(rst.PRESETS["config9"][0])
    cfg = _port_cfg(jcfg)
    B = 4
    planes = served_planes(B, 62, 13, True)
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(5), B))
    keys = jax.random.split(jax.random.key(6), B)
    jstep = _jitted_step_b(jcfg)
    draw = jax.jit(
        lambda k, now: jrb.to_batch_minor(jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    )
    for t in range(60):
        st = jstep(st, _offer(draw(keys, jnp.int32(t)), planes, t))[0]
    for t in range(60, 62):
        inp = _offer(draw(keys, jnp.int32(t)), planes, t)
        want_s, want_i = jax.device_get(pallas_engine.step_pallas(jcfg, st, inp, block_b=4, interpret=True))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = trb.step_b(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), t
        )
        assert bridge.first_difference(want_s, got_s) is None
        assert bridge.first_difference(want_i, got_i) is None
        st = jstep(st, inp)[0]
    assert int(np.asarray(st.commit_index).max()) > 0


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

def test_plain_step_matches_step_pallas_interpret_reconfig_plane():
    """K1 on the reconfiguration plane: step_pallas (interpret mode) on
    config8, two ticks from a state past the first transfer and membership
    toggle (ticks 61 and 97), with config entries, TimeoutNow and pending
    reads in the logs and mailboxes."""
    jcfg = rst.PRESETS["config8"][0]
    cfg = _port_cfg(jcfg)
    B = 4
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(7), B))
    keys = jax.random.split(jax.random.key(8), B)
    jstep = _jitted_step_b(jcfg)
    draw = jax.jit(
        lambda k, now: jrb.to_batch_minor(jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    )
    for t in range(100):
        st = jstep(st, draw(keys, jnp.int32(t)))[0]
    assert int(np.asarray(st.cfg_epoch).max()) > 0  # a config entry was appended
    for t in range(100, 102):
        inp = draw(keys, jnp.int32(t))
        want_s, want_i = jax.device_get(pallas_engine.step_pallas(jcfg, st, inp, block_b=4, interpret=True))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = trb.step_b(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), t
        )
        assert bridge.first_difference(want_s, got_s) is None, t
        assert bridge.first_difference(want_i, got_i) is None, t
        st = jstep(st, inp)[0]


def test_plain_step_matches_step_pallas_interpret_durable_storage():
    """K1 on the storage plane: step_pallas (interpret mode) on config10, two
    ticks from a mid-run state (flushes, restarts, watermarks behind logs)."""
    jcfg = rst.PRESETS["config10"][0]
    cfg = _port_cfg(jcfg)
    B = 4
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(9), B))
    keys = jax.random.split(jax.random.key(10), B)
    jstep = _jitted_step_b(jcfg)
    draw = jax.jit(
        lambda k, now: jrb.to_batch_minor(jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k))
    )
    for t in range(70):
        st = jstep(st, draw(keys, jnp.int32(t)))[0]
    assert int(np.asarray(st.dur_len).max()) > 0  # flushes completed
    for t in range(70, 72):
        inp = draw(keys, jnp.int32(t))
        want_s, want_i = jax.device_get(pallas_engine.step_pallas(jcfg, st, inp, block_b=4, interpret=True))
        s_np, i_np = jax.device_get((st, inp))
        got_s, got_i = trb.step_b(
            cfg, bridge.to_port(s_np, ttypes.ClusterState), bridge.to_port(i_np, ttypes.StepInputs), t
        )
        assert bridge.first_difference(want_s, got_s) is None, t
        assert bridge.first_difference(want_i, got_i) is None, t
        st = jstep(st, inp)[0]
