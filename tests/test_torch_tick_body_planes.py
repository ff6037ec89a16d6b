"""The Hopper tick kernel's own logic on the CPU (the g++ build of
csrc/tick.cuh through csrc/tick_host.cpp, `tick_engine.step_host`; see
tests/test_torch_tick_body.py) under the planes beyond the plain presets:
served per-cluster offer and read planes (K1-c), the TEST-ONLY mutant hooks
(K1-d), the hand-built compaction, reconfiguration, lease, ring-log-matching
and recovery fixtures of tests/test_torch_step_fixtures.py, and the compacted carry
layout through the `step_host` boundary (unpack, dense body, repack). Each is
held against the plain PyTorch tick.

Tolerance: exact equality of every ClusterState and StepInfo leaf.
Skips only where no g++ is installed.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.scenario.mutation import MUTANTS, mutant_config
from raft_sim_tpu_torch.sim import faults
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry
from tests.test_torch_cuda import MUTANT_ROWS as MUTANT_CONFIGS
from tests.test_torch_cuda import SERVED, mutant_genome, served_inputs, served_planes
from tests.test_torch_step import _port_cfg
from tests.test_torch_step_fixtures import (
    HAND_BUILT,
    RECONFIG_CASES,
    RING_LM_CASES,
    hand_built_batch,
    reconfig_case_batch,
    ring_lm_cases,
    storage_edge_case,
)
from tests.test_torch_tick_body import _fuzz

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    return tick_engine.load_host(tick_engine.host_library(gxx))


@pytest.mark.parametrize("name,batch,ticks", [
    ("config2-served", 5, 96), ("config9-served", 7, 200), ("config6r-served", 5, 160),
    ("config10-served", 5, 160), ("config7-served", 2, 48), ("n129-full-served", 2, 48),
])
def test_tick_body_matches_plain_step_under_served_planes(host_lib, name, batch, ticks):
    """K1-c: the body under served per-cluster offer and read planes (NIL
    holes, int32-edge payloads, client and read cadences off, the offer-tick
    plane live), in both worker orders with the race proxy's poison, equals
    the plain tick every tick."""
    cfg = SERVED[name]
    cmds, reads = served_planes(batch, ticks, 11, cfg.read_index)
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(2), batch))
    keys = threefry.split(threefry.key(3), batch)
    injected = served = 0
    for t in range(ticks):
        inp = served_inputs(cfg, keys, t, cmds, reads)
        want = trb.step_b(cfg, s, inp, t)
        for reverse in (False, True):
            got = tick_engine.step_host(host_lib, cfg, s, inp, t, reverse=reverse, poison=True)
            diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
            assert diff is None, f"tick {t}, {'reverse' if reverse else 'forward'} order: {diff}"
        injected += int(want[1].cmds_injected.sum())
        served += int(want[1].reads_served.sum())
        s = want[0]
    assert injected > 0
    assert served > 0 or not cfg.read_index


@dataclasses.dataclass(frozen=True)
class _AllHooksOff(tconfig.RaftConfig):
    """A TEST-ONLY config with all eight mutant hooks off at once: the wide
    rows run every hook of the mutant body together."""

    joint_consensus = act_on_append = truncation_rollback = read_confirm = property(
        lambda self: False)
    xfer_election = lease_skew_safe = durable_acks = persist_vote = property(lambda self: False)


# K1-d: each registry name on a config that runs its hook's plane (the plain
# tick's rows, tests/test_torch_mutation.py), then every hook at once at the
# wider width tiers: N=65 (width 4) with membership, transfers, reads, leases
# and compaction, N=129 (width 8) with durable storage and transfers.
MUTANT_ROWS = [
    *(pytest.param(name, None, 8, 120, 0.05, id=name) for name in MUTANTS),
    pytest.param("all-hooks", _AllHooksOff(
        n_nodes=65, log_capacity=12, compact_margin=3, max_entries_per_rpc=3, client_interval=2,
        reconfig_interval=5, transfer_interval=7, read_interval=2, read_lease_ticks=2,
        election_min_ticks=8, election_range_ticks=6, drop_prob=0.1, partition_period=16,
        partition_prob=0.3), 2, 60, 0.03, id="all-hooks-n65-reconfig-lease-compaction"),
    pytest.param("all-hooks", _AllHooksOff(
        n_nodes=129, log_capacity=12, client_interval=2, fsync_interval=2, fsync_jitter_prob=0.3,
        torn_tail_prob=0.5, lost_suffix_span=4, transfer_interval=7, election_min_ticks=8,
        election_range_ticks=6, drop_prob=0.1), 2, 48, 0.04, id="all-hooks-n129-durable-transfer"),
]


@pytest.mark.parametrize("name,cfg,batch,ticks,p_down", MUTANT_ROWS)
def test_tick_body_matches_plain_step_under_mutants(host_lib, name, cfg, batch, ticks, p_down):
    """K1-d: the body under each TEST-ONLY mutant hook, in both worker
    orders with the race proxy's poison, equals the plain tick every tick;
    the inputs come from a heterogeneous two-segment genome (scenario path)
    plus crash fuzz."""
    if cfg is None:
        cfg = mutant_config(name, tconfig.RaftConfig(**MUTANT_CONFIGS[name]))
    g = mutant_genome(cfg, batch, 7)
    rng = np.random.default_rng(5)
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(2), batch))
    keys = threefry.split(threefry.key(3), batch)
    led = 0
    for t in range(ticks):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t, genome=g, seg_len=ticks // 2))
        inp = _fuzz(inp, rng, p_down)
        want = trb.step_b(cfg, s, inp, t)
        for reverse in (False, True):
            got = tick_engine.step_host(host_lib, cfg, s, inp, t, reverse=reverse, poison=True)
            diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
            assert diff is None, f"tick {t}, {'reverse' if reverse else 'forward'} order: {diff}"
        led += int(want[1].n_leaders.sum() > 0)
        s = want[0]
    assert led > 0


@pytest.mark.parametrize("name,body", [
    ("weak-quorum", 0), ("single-server-change", 2), ("act-on-commit", 2),
    ("ignore-truncation-rollback", 2), ("stale-read", 2), ("blind-transfer", 2),
    ("lease-skew", 1), ("ack-before-fsync", 1), ("volatile-vote", 2),
])
def test_mutants_pick_their_body(host_lib, name, body):
    """Which body a mutant runs (csrc/tick.cuh `body_for`): a lean config the
    lean one whatever its hooks; the quorum, the lease window and the
    durability gate are runtime parameters of the lean or full bodies; the
    other hooks take the mutant body."""
    import ctypes

    cfg = mutant_config(name, tconfig.RaftConfig(**MUTANT_CONFIGS[name]))
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0), 1))
    assert host_lib.rs_tick_body(ctypes.byref(tick_engine._params(cfg, s, False))) == body


@pytest.mark.parametrize("name,lean", [("config2-served", True), ("config7-served", True),
                                       ("config9-served", False), ("config6r-served", False),
                                       ("config10-served", False), ("n129-full-served", False)])
def test_served_configs_keep_their_gate_set(host_lib, name, lean):
    """serve_ingest/serve_reads add no gate of their own: a served config2
    or config7 stays on the lean body (the offer-tick plane is a runtime
    gate), and the read-carrying or compacting ones take the full body."""
    import ctypes

    cfg = SERVED[name]
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0), 1))
    params = tick_engine._params(cfg, s, False)
    assert params.track == 1 and params.reads == int(cfg.read_index)
    assert bool(host_lib.rs_tick_lean(ctypes.byref(params))) is lean


@pytest.mark.parametrize("name", HAND_BUILT)
def test_tick_body_matches_plain_step_on_hand_built_compaction_states(host_lib, name):
    """The snapshot wipe/keep/conflict and same-tick rebase states of
    tests/test_torch_step_fixtures.py, two ticks each."""
    from raft_sim_tpu_torch.utils.config import RaftConfig

    jcfg, st, inp = hand_built_batch(name)
    cfg = RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    s = bridge.to_port(jax.device_get(st), ttypes.ClusterState)
    inp = bridge.to_port(jax.device_get(inp), ttypes.StepInputs)
    for t in range(2):
        want = trb.step_b(cfg, s, inp)
        got = tick_engine.step_host(host_lib, cfg, s, inp)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"{name} tick {t}: {diff}"
        s = want[0]


@pytest.mark.parametrize("name", RECONFIG_CASES)
def test_tick_body_matches_plain_step_on_reconfig_and_lease_states(host_lib, name):
    """The joint lifecycle, origination refusals, transfers, the tick-start
    config at a joint exit and the lease cases of tests/test_torch_step_fixtures.py,
    each tick of each run."""
    jcfg, st, inps = reconfig_case_batch(name)
    cfg = tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    s = bridge.to_port(jax.device_get(st), ttypes.ClusterState)
    for t, inp in enumerate(inps):
        inp = bridge.to_port(jax.device_get(inp), ttypes.StepInputs)
        want = trb.step_b(cfg, s, inp)
        got = tick_engine.step_host(host_lib, cfg, s, inp)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"{name} tick {t}: {diff}"
        s = want[0]


@pytest.mark.parametrize("name", RING_LM_CASES)
def test_tick_body_matches_plain_step_on_ring_log_matching_states(host_lib, name):
    """The skipped-pair fixture and the planted suffix and prefix-checksum
    mismatches on wrapped rings of tests/test_torch_step_fixtures.py, in both worker
    orders with the race proxy's poison."""
    jcfg, st, inp, _ = ring_lm_cases()[name]
    cfg = _port_cfg(jcfg)
    s = bridge.to_port(jax.device_get(st), ttypes.ClusterState)
    inp = bridge.to_port(jax.device_get(inp), ttypes.StepInputs)
    want = trb.step_b(cfg, s, inp)
    for reverse in (False, True):
        got = tick_engine.step_host(host_lib, cfg, s, inp, reverse=reverse, poison=True)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"{name}, reverse={reverse}: {diff}"


@pytest.mark.parametrize("n", [31, 32, 33])
def test_tick_body_matches_plain_step_on_recovery_word_edges(host_lib, n):
    """The word-edge recovery fixture of tests/test_torch_step_fixtures.py (forced
    restarts with torn spans at N=31/32/33), each tick of its run."""
    jcfg, st, inps = storage_edge_case(n)
    cfg = _port_cfg(jcfg)
    s = bridge.to_port(jax.device_get(st), ttypes.ClusterState)
    for t, inp in enumerate(inps):
        inp = bridge.to_port(jax.device_get(inp), ttypes.StepInputs)
        want = trb.step_b(cfg, s, inp)
        got = tick_engine.step_host(host_lib, cfg, s, inp)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"N={n} tick {t}: {diff}"
        s = want[0]


@pytest.mark.parametrize("name,batch,ticks", [("config5c", 3, 40), ("config7x", 2, 16)])
def test_tick_body_matches_plain_step_under_compact_planes(host_lib, name, batch, ticks):
    """The compacted carry layout through `step_host`'s boundary (unpack,
    the body on the dense view, repack with the gated-off legs passed
    through), in both worker orders with the race proxy's poison, equals the
    plain compacted tick every tick; config5c crosses its log-matching tick
    32."""
    cfg = tconfig.PRESETS[name][0]
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(2), batch))
    keys = threefry.split(threefry.key(3), batch)
    for t in range(ticks):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
        want = trb.step_b(cfg, s, inp, t)
        for reverse in (False, True):
            got = tick_engine.step_host(host_lib, cfg, s, inp, t, reverse=reverse, poison=True)
            diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
            assert diff is None, f"tick {t}, {'reverse' if reverse else 'forward'} order: {diff}"
        s = want[0]
    assert s.ack_age.dim() == 2  # the carry stayed packed
