"""The port's node-axis sharding (raft_sim_tpu_torch/parallel/nodeshard.py,
the `sh` branches of models/raft_batched.py, the exchange of
parallel/comm.py) on the CPU: one cluster's node rows partitioned over
shards must give the unsharded tick's trajectory -- final state (through
`unshard_state`), run metrics and window records -- at every mesh shape,
and the JAX package's `simulate_node_sharded` on its 8 virtual devices.

The shards run as threads on the one `cpu` device. In place of the JAX
package's jaxpr audit, the exchange counts its collectives by kind: one
mailbox gather a tick, the `[B]` folds, and a leaders gather only under
check_invariants. Giant-N word boundaries ride along (N=101 and 255, shard
rows that split a packed word).

Tolerance: exact equality of every leaf (the tick is integer-only).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.ops import bitplane as jbitplane
from raft_sim_tpu.parallel import nodeshard as jnodeshard
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.parallel import comm, nodeshard
from raft_sim_tpu_torch.sim import faults, scan, telemetry
from raft_sim_tpu_torch.types import ClusterState, Mailbox, StepInputs, compact_twin, node_dtype
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

N5_KW = dict(n_nodes=5, client_interval=8, drop_prob=0.1)
# The whole sharded surface in one config: PreVote, ring compaction, client
# traffic (the offer-tick plane), invariants, crash and drop churn. N=33
# needs two packed words, and 33 % 8 != 0, so pad rows exist on the mesh.
FEATURED_33 = dict(n_nodes=33, log_capacity=24, compact_margin=8, pre_vote=True,
                   client_interval=5, drop_prob=0.1, crash_prob=0.1, crash_period=32,
                   crash_down_ticks=8)
TICKS = 64


def _same(a, b, what):
    d = bridge.first_difference(a, b)
    assert d is None, f"{what}: {d}"


def _mesh(n_nodes_shards, n_cluster_shards=1):
    return nodeshard.make_node_mesh(n_nodes_shards, n_cluster_shards=n_cluster_shards,
                                    devices=["cpu"] * (n_nodes_shards * n_cluster_shards))


def _parity(kw, seed, batch, mesh, counts=None):
    """Port sharded == port unsharded (dense twin); returns the sharded
    (state, metrics) and the unsharded metrics."""
    cfg = tconfig.RaftConfig(**kw)
    fs, ms = nodeshard.simulate_node_sharded(cfg, seed, batch, TICKS, mesh, counts=counts)
    fd, md = scan.simulate(compact_twin(cfg, False), seed, batch, TICKS, device="cpu")
    _same(ms, md, "metrics")
    _same(nodeshard.unshard_state(cfg, fs), fd, "state")
    return fs, ms, md


@pytest.fixture(scope="module")
def n5_eight():
    counts = {}
    return _parity(N5_KW, 3, 8, _mesh(8), counts), counts


@pytest.fixture(scope="module")
def f33_eight():
    counts = {}
    return _parity(FEATURED_33, 7, 4, _mesh(8), counts), counts


def _jax(kw, seed, batch):
    f, m = jnodeshard.simulate_node_sharded(rst.RaftConfig(**kw), seed, batch, TICKS,
                                            jnodeshard.make_node_mesh(8))
    return jax.device_get(f), jax.device_get(m)


def test_parity_n5_eight_shards(n5_eight):
    """N=5 over 8 node shards (n_pad 8, one row a shard, three of them pad):
    the port equals its unsharded run and the JAX package's sharded run,
    padded writer-major state included."""
    (fs, ms, md), _ = n5_eight
    jf, jm = _jax(N5_KW, 3, 8)
    _same(ms, jm, "metrics vs JAX")
    _same(fs, jf, "padded state vs JAX")
    assert int(md.max_commit.max()) > 0


def test_parity_n33_featured(f33_eight):
    """The whole surface at N=33 (two words, pad rows) against the JAX
    package's sharded run."""
    (fs, ms, md), _ = f33_eight
    jf, jm = _jax(FEATURED_33, 7, 4)
    _same(ms, jm, "metrics vs JAX")
    _same(fs, jf, "padded state vs JAX")
    assert int(md.max_commit.max()) > 0


def test_windowed_parity_n33():
    """Window records -- per-window metrics and first_viol_tick -- equal the
    unsharded `simulate_windowed`, over 4 node shards (n_pad 36)."""
    cfg = tconfig.RaftConfig(**FEATURED_33)
    fs, ms, recs = nodeshard.simulate_node_sharded_windowed(cfg, 7, 2, TICKS, 32, _mesh(4))
    fd, md, recd, _ = telemetry.simulate_windowed(cfg, 7, 2, TICKS, 32, device="cpu")
    _same(ms, md, "metrics")
    _same(recs, recd, "records")
    _same(nodeshard.unshard_state(cfg, fs), fd, "state")


def test_windowed_parity_n5_jax():
    """The windowed node-sharded run against the JAX package's on its 8
    virtual devices (N=5 over 8 shards): state, metrics, window records."""
    cfg = tconfig.RaftConfig(**N5_KW)
    fs, ms, recs = nodeshard.simulate_node_sharded_windowed(cfg, 3, 8, TICKS, 32, _mesh(8))
    jf, jm, jr = jax.device_get(jnodeshard.simulate_node_sharded_windowed(
        rst.RaftConfig(**N5_KW), 3, 8, TICKS, 32, jnodeshard.make_node_mesh(8)))
    _same(ms, jm, "metrics")
    _same(recs, jr, "records")
    _same(fs, jf, "padded state")


def test_two_dim_mesh():
    """The batch over 2 cluster shards and the nodes over 4 at once."""
    _parity(N5_KW, 3, 8, _mesh(4, n_cluster_shards=2))


def test_compact_twin_routing():
    """A compact_planes config runs the sharded carry dense: the metrics of
    its dense twin and of the compacted unsharded run."""
    cfg = tconfig.RaftConfig(**dict(N5_KW, compact_planes=True))
    _, ms = nodeshard.simulate_node_sharded(cfg, 3, 2, 32, _mesh(2))
    _, md = scan.simulate(cfg, 3, 2, 32, device="cpu")
    _same(ms, md, "compacted run")


def test_config7_smoke():
    """The giant-N preset (N=101, CAP=16 < N: the quorum's threshold form
    in JAX, the sort here) over 8 shards: 13 rows a shard, shard 2 splitting
    the 31/32 word edge."""
    cfg, _ = tconfig.PRESETS["config7"]
    fs, ms = nodeshard.simulate_node_sharded(cfg, 3, 2, 16, _mesh(8))
    fd, md = scan.simulate(cfg, 3, 2, 16, device="cpu")
    _same(ms, md, "metrics")
    _same(nodeshard.unshard_state(cfg, fs), fd, "state")


# ---------------------------------------------------- the collective record


def _per_tick(counts, ticks):
    assert all(v % ticks == 0 for v in counts.values()), counts
    return {k: v // ticks for k, v in counts.items()}


def test_collective_whitelist(n5_eight, f33_eight):
    """The exchange's record, per tick: ONE mailbox gather, the [B] folds
    (sum/max/min/any) of the offer-latency plane, the no-op and client
    counts and the StepInfo reductions, and one leaders gather under
    check_invariants -- nothing else crosses shards. The folds taken at one
    point share a meeting: the latency plane's three points, the client
    count, the StepInfo reductions (and the no-op count under compaction)."""
    _, c5 = n5_eight
    assert _per_tick(c5, TICKS) == {"mailbox_gather": 1, "leaders_gather": 1,
                                    "sum": 6, "max": 3, "min": 3, "any": 2, "meetings": 7}
    _, c33 = f33_eight  # compaction adds the noop_blocked sum
    assert _per_tick(c33, TICKS) == {"mailbox_gather": 1, "leaders_gather": 1,
                                     "sum": 7, "max": 3, "min": 3, "any": 2, "meetings": 8}
    counts = {}
    cfg = tconfig.RaftConfig(**dict(N5_KW, check_invariants=False))
    nodeshard.simulate_node_sharded(cfg, 3, 2, 8, _mesh(4), counts=counts)
    assert _per_tick(counts, 8) == {"mailbox_gather": 1, "sum": 6, "max": 3, "min": 3,
                                    "any": 1, "meetings": 6}


def test_failing_shard_fails_the_run(monkeypatch):
    """A shard that raises mid-run stops the others at their next collective:
    the run raises the shard's error well inside the exchange's timeout."""
    real = raft_batched._gather_mailbox

    def broken(cfg, mb, sh):
        if sh.rank == 2 and sh.exchange.counts["mailbox_gather"] >= 3:
            raise RuntimeError("shard 2 failed")
        return real(cfg, mb, sh)

    monkeypatch.setattr(raft_batched, "_gather_mailbox", broken)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        nodeshard.simulate_node_sharded(tconfig.RaftConfig(**N5_KW), 3, 2, 16, _mesh(4),
                                        timeout=30.0)
    assert time.monotonic() - t0 < 20.0


def test_hung_shard_times_out():
    """A shard that never reaches a collective: the others give up after
    the exchange's timeout, and the run raises ShardAborted instead of
    waiting for ever."""
    ex = comm.Exchange(3, timeout=0.5)
    release = threading.Event()

    def body(rank):
        if rank == 1:
            release.wait(10.0)  # hangs past every timeout below
            return None
        with ex.shard(rank):
            return ex.fold(rank, torch.tensor([rank]), "sum")

    t0 = time.monotonic()
    with pytest.raises(comm.ShardAborted):
        comm.run_spmd(body, 3, [ex], grace=1.0)
    assert time.monotonic() - t0 < 5.0
    release.set()


def test_exchange_collectives():
    """Gathers concatenate in shard order; folds are exact whatever order
    the shards start in; the shards take turns, in rank order, between
    meetings."""
    ex = comm.Exchange(4)
    order = []

    def body(rank):
        time.sleep(0.01 * (3 - rank))  # start in reverse order
        x = torch.tensor([rank, 10 * rank], dtype=torch.int32)
        with ex.shard(rank):
            g = ex.all_gather(rank, (x[None], x[:1]), 0)
            order.append(rank)
            return (g, ex.fold(rank, x, "max"), ex.fold(rank, x, "min"),
                    ex.fold(rank, x, "sum"), ex.fold(rank, x > 15, "any"))

    outs = comm.run_spmd(body, 4, [ex])
    assert order == [0, 1, 2, 3]
    for g, mx, mn, sm, an in outs:
        assert g[0].tolist() == [[r, 10 * r] for r in range(4)]
        assert g[1].tolist() == [0, 1, 2, 3]
        assert mx.tolist() == [3, 30] and mn.tolist() == [0, 0] and sm.tolist() == [6, 60]
        assert an.tolist() == [False, True] and sm.dtype == torch.int32
    assert dict(ex.counts) == {"all_gather": 1, "max": 1, "min": 1, "sum": 1, "any": 1}
    assert ex.meetings == 5
    ex = comm.Exchange(4)

    def two(rank):
        with ex.shard(rank):
            return ex.folds(rank, [(torch.tensor([rank]), "max"), (torch.tensor([rank]), "sum")])

    pair = comm.run_spmd(two, 4, [ex])
    assert [p[0].item() for p in pair] == [3] * 4 and [p[1].item() for p in pair] == [6] * 4
    assert ex.meetings == 1 and dict(ex.counts) == {"max": 1, "sum": 1}


def test_exchange_stress():
    """More shard threads than cores, a switch interval of a microsecond, 200
    meetings: every fold is exact every meeting (a lost or stale
    contribution would break the sums) and the turns keep rank order."""
    import os
    import sys

    size, rounds = 2 * (os.cpu_count() or 4), 200
    ex = comm.Exchange(size, timeout=60.0)
    seen = []

    def body(rank):
        with ex.shard(rank):
            out = []
            for r in range(rounds):
                seen.append(rank)
                got = ex.folds(rank, [(torch.tensor([rank + r]), "sum"),
                                      (torch.tensor([rank * r]), "max")])
                out.append((int(got[0]), int(got[1])))
            return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        outs = comm.run_spmd(body, size, [ex], grace=10.0)
    finally:
        sys.setswitchinterval(old)
    assert time.monotonic() - t0 < 60.0
    want = [(size * (size - 1) // 2 + size * r, (size - 1) * r) for r in range(rounds)]
    assert all(o == want for o in outs)
    # The threads start together; from the first meeting on, they take turns.
    assert sorted(seen[:size]) == list(range(size))
    assert seen[size:] == list(range(size)) * (rounds - 1) and ex.meetings == rounds


# ------------------------------------------------------- guards and errors


@pytest.mark.parametrize("kw", [{"reconfig_interval": 10}, {"transfer_interval": 10},
                                {"read_interval": 4}, {"client_redirect": True},
                                {"check_log_matching": True}, {"fsync_interval": 3}])
def test_rejects_unsupported_features(kw):
    cfg = tconfig.RaftConfig(n_nodes=9, log_capacity=64, **kw)
    with pytest.raises(ValueError, match="node sharding does not support"):
        nodeshard.check_shardable(cfg, 8)
    with pytest.raises(ValueError, match="node sharding does not support"):
        jnodeshard.check_shardable(rst.RaftConfig(n_nodes=9, log_capacity=64, **kw), 8)


def test_rejects_word_crossing_padding():
    """N=96 over 7 shards pads to 98: 4 words against 3 -- refused, as in
    the JAX package."""
    with pytest.raises(ValueError, match="word boundary"):
        nodeshard.check_shardable(tconfig.RaftConfig(n_nodes=96), 7)


def test_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="batch"):
        nodeshard.simulate_node_sharded(tconfig.RaftConfig(n_nodes=5), 0, 3, 10,
                                        _mesh(2, n_cluster_shards=2))
    with pytest.raises(ValueError, match="needs 8 devices, only 4"):
        nodeshard.make_node_mesh(4, n_cluster_shards=2, devices=["cpu"] * 4)


@pytest.mark.parametrize("n,shards", [(5, 8), (33, 8), (101, 8), (101, 3), (255, 3), (255, 4)])
def test_check_shardable_matches_jax(n, shards):
    """n_pad of the port and of the JAX package agree."""
    got = nodeshard.check_shardable(tconfig.RaftConfig(n_nodes=n), shards)
    assert got == jnodeshard.check_shardable(rst.RaftConfig(n_nodes=n), shards)


# -------------------------------------- giant-N word boundaries (W = 4 / 8)


@pytest.mark.parametrize("n", [101, 255])
def test_bitplane_roundtrip_giant(n):
    """pack/unpack round trips and popcounts at W=4 (N=101) and W=8
    (N=255), equal to the JAX package's words."""
    dense = np.random.default_rng(n).integers(0, 2, size=(16, n)).astype(bool)
    packed = bitplane.pack(torch.from_numpy(dense), axis=1)
    assert packed.shape == (16, bitplane.n_words(n))
    want = np.asarray(jax.device_get(jbitplane.pack(dense, axis=1)))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(bitplane.unpack(packed, n, axis=1).numpy(), dense)
    np.testing.assert_array_equal(bitplane.count(packed, axis=1).numpy(),
                                  dense.sum(axis=1).astype(np.int32))


@pytest.mark.parametrize("n,n_dev", [(101, 8), (255, 3)])
def test_shard_boundary_rows_split_packed_word(n, n_dev):
    """A shard's row range splits packed words (N=101 over 8: shard 2 owns
    rows 26..38 across the 31/32 edge; N=255 over 3: 85 rows a shard): the
    local rows' popcounts equal the dense counts, and the local rows of the
    packed identity (`_loc(eye(n_pad))`, the tick's self bits) hold each
    row's own global bit."""
    n_pad = nodeshard.check_shardable(tconfig.RaftConfig(n_nodes=n), n_dev)
    nl = n_pad // n_dev
    straddles = [d for d in range(n_dev)
                 if (d * nl) // 32 != min(((d + 1) * nl - 1) // 32, (n - 1) // 32)]
    assert straddles, f"no shard straddles a word edge at N={n}, D={n_dev}"
    rng = np.random.default_rng(n)
    votes = rng.integers(0, 2, size=(n_pad, n)).astype(bool)
    votes[n:] = False  # pad voters never vote
    packed = bitplane.pack(torch.from_numpy(votes), axis=1)
    eye = bitplane.eye(n_pad)
    for d in straddles:
        sh = raft_batched.NodeShardCtx(exchange=None, rank=d, nl=nl, n_pad=n_pad)
        local = raft_batched._loc(packed, sh)
        np.testing.assert_array_equal(bitplane.count(local, axis=1).numpy(),
                                      votes[d * nl:(d + 1) * nl].sum(axis=1))
        own = bitplane.unpack(raft_batched._loc(eye, sh), n_pad, axis=1).numpy()
        assert (own.argmax(axis=1) == np.arange(d * nl, (d + 1) * nl)).all()


@pytest.mark.parametrize("name", ["config7", "config7x"])
def test_giant_preset_quorum_forms(name):
    """config7 takes CAP < N (the JAX threshold-quorum form) and config7x
    the int16 node ids, in both packages."""
    cfg, _ = tconfig.PRESETS[name]
    jcfg, _ = rst.PRESETS[name]
    assert cfg.log_capacity < cfg.n_nodes and jcfg.log_capacity < jcfg.n_nodes
    want = torch.int8 if cfg.n_nodes <= 126 else torch.int16
    assert node_dtype(cfg) == want
    assert np.dtype(rst.types.node_dtype(jcfg)) == np.dtype(str(want).split(".")[-1])


def test_pad_tables_cover_every_leaf():
    """Every state, mailbox and input leg has a pad rule, and the rules are
    the JAX package's: the same node axes and fills."""
    assert set(nodeshard._STATE_PAD) | {"mailbox"} == set(ClusterState._fields)
    assert set(nodeshard._MAILBOX_PAD) == set(Mailbox._fields)
    assert set(nodeshard._INPUT_PAD) == set(StepInputs._fields)
    cfg, jcfg = tconfig.RaftConfig(n_nodes=7), rst.RaftConfig(n_nodes=7)
    for mine, theirs in ((nodeshard._STATE_PAD, jnodeshard._STATE_PAD),
                         (nodeshard._MAILBOX_PAD, jnodeshard._MAILBOX_PAD),
                         (nodeshard._INPUT_PAD, jnodeshard._INPUT_PAD)):
        assert set(mine) == set(theirs)
        for f, (axes, fill) in mine.items():
            j_axes, j_fill = theirs[f]
            assert axes == j_axes, f
            fill = fill(cfg) if callable(fill) else fill
            j_fill = j_fill(jcfg) if callable(j_fill) else j_fill
            assert fill == j_fill, f


def test_pad_and_unshard_round_trip():
    """pad_state then cutting back is the identity, the mailbox's transposed
    legs included (`unshard_state` of a padded dense state whose response
    planes are stored responder-major)."""
    cfg = tconfig.RaftConfig(**dict(FEATURED_33, n_nodes=7))
    final, _ = scan.simulate(cfg, 1, 3, 24, device="cpu")
    padded = nodeshard.pad_state(cfg, final, 8)
    mb = padded.mailbox
    pv = bitplane.unpack(mb.pv_grant, 8, axis=2).transpose(1, 2)
    stored = padded._replace(mailbox=mb._replace(
        resp_kind=mb.resp_kind.transpose(1, 2).contiguous(),
        pv_grant=bitplane.pack(pv, axis=2)))
    _same(nodeshard.unshard_state(cfg, stored), final, "round trip")
    keys = scan.seed_fleet(cfg, 1, 3, "cpu")[1]
    inp = nodeshard.pad_inputs(cfg, raft_batched.to_batch_minor(faults.make_inputs(cfg, keys, 0)),
                               8, lead=0)
    assert inp.alive.shape[0] == 8 and not bool(inp.alive[7:].any())
    assert inp.deliver_mask.shape[0] == 8 and not bool((inp.deliver_mask[7:] != 0).any())
