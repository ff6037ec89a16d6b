"""The Hopper tick kernel on the card (marker `cuda`): `step_cuda` on CUDA
tensors against the plain PyTorch tick on the same CUDA tensors, tick by tick,
and `simulate` on the card against the port on the CPU; the sanitizer's
armed runs against unarmed ones and K1's ptxas resources against their pins
(raft_sim_tpu_torch/analysis). Skips where torch sees
no CUDA device; on a machine with one H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: exact equality of every leaf (the health rows' device-wait share,
a clock reading, left out).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.sim import faults, scan
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

pytestmark = pytest.mark.cuda

NIL = ttypes.NIL
INT32_EDGES = np.array([-(2**31), -(2**31) + 1, -3, 0, 1, 2**31 - 2, 2**31 - 1], np.int64)


def served_planes(batch: int, ticks: int, seed: int, reads: bool = True):
    """(cmds, reads) offer planes [ticks, batch] int32 from a numpy seed, as
    the serve loop feeds them: a distinct-ish payload per (tick, cluster)
    slot, a fifth of them at or next to the int32 extremes, NIL holes in
    three slots of ten (NIL and NOOP never offered), and a read offered in
    half the slots (None when `reads` is False)."""
    rng = np.random.default_rng(seed)
    cmds = rng.integers(-(2**31), 2**31, size=(ticks, batch), dtype=np.int64)
    edge = rng.random((ticks, batch)) < 0.2
    cmds[edge] = rng.choice(INT32_EDGES, size=int(edge.sum()))
    cmds[(cmds == NIL) | (cmds == ttypes.NOOP)] = 7
    cmds[rng.random((ticks, batch)) < 0.3] = NIL
    read_plane = np.where(rng.random((ticks, batch)) < 0.5, 1, NIL).astype(np.int32)
    return cmds.astype(np.int32), (read_plane if reads else None)


def served_inputs(cfg, keys, t: int, cmds, reads):
    """Tick t's batch-minor inputs with the planes' row t in place of the
    scheduled client command and read offer (scan.tick_batch_minor's
    overrides)."""
    inp = faults.make_inputs(cfg, keys, t)
    dev = keys.device
    inp = inp._replace(client_cmd=torch.as_tensor(cmds[t], device=dev))
    if reads is not None:
        inp = inp._replace(read_cmd=torch.as_tensor(reads[t], device=dev))
    return trb.to_batch_minor(inp)


def _serve_config(cfg):
    from raft_sim_tpu_torch.serve.loop import serve_config

    return serve_config(cfg)


# The served rows (K1-c): the presets under serve_config -- the client and
# read cadences replaced by offered planes, the offer-tick plane live --
# config2 on the lean body, config9/config6r/config10 on the full one,
# config7 (N=101, two nodes a thread) and the full gate set at N=129 (int16
# node ids, width tier 8) with reads.
SERVED = {
    "config2-served": _serve_config(tconfig.PRESETS["config2"][0]),
    "config9-served": _serve_config(tconfig.PRESETS["config9"][0]),
    "config6r-served": _serve_config(tconfig.PRESETS["config6r"][0]),
    "config10-served": _serve_config(tconfig.PRESETS["config10"][0]),
    "config7-served": _serve_config(tconfig.PRESETS["config7"][0]),
    "n129-full-served": _serve_config(tconfig.RaftConfig(
        n_nodes=129, log_capacity=12, compact_margin=3, max_entries_per_rpc=3, client_interval=2,
        reconfig_interval=5, transfer_interval=7, read_interval=2, pre_vote=True,
        election_min_ticks=8, election_range_ticks=6, drop_prob=0.1)),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("torch sees no CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _hold(cfg, batch, ticks, card, proxy=False):
    """`ticks` ticks from the seed-0 state of `batch` clusters: each tick the
    kernel (or its race proxy) equals the plain tick on the same CUDA tensors,
    state and StepInfo, leaf for leaf. Returns the final state."""
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0, card), batch))
    keys = threefry.split(threefry.key(1, card), batch)
    for t in range(ticks):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_cuda(cfg, s, inp, t, proxy=proxy)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        s = got[0]
    return s


@pytest.mark.parametrize(
    "name", ["config1", "config2", "config3", "config4", "config5", "config3p", "config6", "config6r",
             "config8", "config9", "config10", "config4c", "config7"]
)
def test_step_cuda_matches_plain_step(card, name):
    cfg, _ = tconfig.PRESETS[name]
    batch = 1 if name == "config1" else 200  # ragged batches: the test below
    # config6's CAP=32 ring wraps near tick 130; config8's first toggle lands
    # at tick 97 and its transfers at 61 and 122; config10's crash windows
    # end at 64 and 128.
    ticks = 400 if cfg.compaction else 200 if cfg.reconfig or cfg.durable_storage else 64
    before = tick_engine.step_cuda.launches
    s = _hold(cfg, batch, ticks, card)
    assert tick_engine.step_cuda.launches == before + ticks
    if cfg.compaction:
        assert int(s.log_base.min()) > 0  # every node of every cluster compacted


# One cluster, and 45 clusters (a ragged last block at every block shape): at
# N=5, N=51 and N=101 (two nodes a thread, width tier 4), on each gate set;
# then config7's mix dense at N=128 (int16 node ids) and at N=255 (width tier
# 8, 4 clusters a block) under partitions.
SMALL_AND_RAGGED = (
    [("config1", 1), ("config7", 1)]
    + [(name, 45) for name in ("config2", "config5", "config3p", "config6", "config6r", "config8",
                               "config9", "config10", "config4c", "config7")]
    + [("config7-n128", 45), ("config7-n255-partitions", 45)]
    + [("config6-cap8-lm", 45), ("config7-n101-compaction-lm", 45)]
)

# Log matching on the compacting ring (K1-b): config6 and config9 with the
# check every tick, config6 on an 8-slot ring (incomparable pairs), and
# config7's mix at N=101 compacting (two nodes a thread, width tier 4).
RING_LM = {
    "config6-lm": dataclasses.replace(tconfig.PRESETS["config6"][0], check_log_matching=True),
    "config9-lm": dataclasses.replace(tconfig.PRESETS["config9"][0], check_log_matching=True),
    "config6-cap8-lm": dataclasses.replace(tconfig.PRESETS["config6"][0], log_capacity=8,
                                           compact_margin=4, max_entries_per_rpc=2,
                                           client_interval=2, check_log_matching=True),
    "config7-n101-compaction-lm": dataclasses.replace(tconfig.PRESETS["config7"][0], compact_margin=4,
                                                      check_log_matching=True),
}


def _small_cfg(name):
    cfg7 = tconfig.PRESETS["config7"][0]
    if name == "config7-n128":
        return dataclasses.replace(cfg7, n_nodes=128)
    if name == "config7-n255-partitions":
        return dataclasses.replace(cfg7, n_nodes=255, partition_period=32, partition_prob=0.25)
    if name in RING_LM:
        return RING_LM[name]
    return tconfig.PRESETS[name][0]


@pytest.mark.parametrize(
    "name,batch,ticks",
    [("config6-lm", 200, 400), ("config9-lm", 200, 400), ("config6-cap8-lm", 200, 200),
     ("config7-n101-compaction-lm", 45, 96)],
)
def test_step_cuda_matches_plain_step_ring_log_matching(card, name, batch, ticks):
    """K1-b: the kernel's ring-form log matching (every partner pair, the
    checksum at the larger base, the skipped-pair count) equals the plain
    tick every tick, and the 8-slot ring meets incomparable pairs."""
    cfg = RING_LM[name]
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0, card), batch))
    keys = threefry.split(threefry.key(1, card), batch)
    skipped = 0
    for t in range(ticks):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_cuda(cfg, s, inp, t)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        skipped += int(got[1].lm_skipped_pairs.sum())
        assert not bool(got[1].viol_log_matching.any()), t
        s = got[0]
    assert int(s.log_base.max()) > 0
    if name == "config6-cap8-lm":
        assert skipped > 0


def test_session_resume_on_the_card_equals_one_run(card, tmp_path):
    """The long-horizon path on the card: a Session of config6 with log
    matching, run 96 ticks, saved, restored and run 96 more, equals one
    uninterrupted 192-tick Session and the same run on the CPU."""
    from raft_sim_tpu_torch.driver import Session

    cfg = RING_LM["config6-lm"]
    whole = Session(cfg, batch=64, seed=3, device=card)
    whole.run(192, chunk=32)
    half = Session(cfg, batch=64, seed=3, device=card)
    half.run(96, chunk=32)
    again = Session.restore(half.save(str(tmp_path / "ck")), device=card)
    again.run(96, chunk=32)
    cpu = Session(cfg, batch=64, seed=3, device="cpu")
    cpu.run(192, chunk=64)
    for got in (again, cpu):
        assert bridge.first_difference(whole.state, got.state) is None
        assert bridge.first_difference(whole.metrics, got.metrics) is None


@pytest.mark.parametrize("name,batch", SMALL_AND_RAGGED)
def test_step_cuda_matches_plain_step_on_small_and_ragged_batches(card, name, batch):
    """Small enough for a race checker, if the card's machine allows one:
    compute-sanitizer --tool racecheck --kernel-name kns=tick_kernel
        python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -k "ragged and not proxy"
    """
    _hold(_small_cfg(name), batch, 96 if name in tconfig.PRESETS or name in RING_LM else 64, card)


@pytest.mark.parametrize("name,batch", SMALL_AND_RAGGED)
def test_race_proxy_matches_plain_step_on_small_and_ragged_batches(card, name, batch):
    """The race proxy (csrc/tick.cu built with RS_RACE_PROXY: node slots and
    clusters mapped to threads in reverse, each exchange field poisoned once
    its last reader's phase is over) equals the plain tick on the same rows.
    A proxy for a race checker, not one: it shows that no read depends on
    the thread order or outlives the barrier schedule on these inputs."""
    _hold(_small_cfg(name), batch, 96 if name in tconfig.PRESETS or name in RING_LM else 64, card,
          proxy=True)


# The compacted carry layout: config5c (N=51, LM every 16), config7x (N=255,
# partitions) and the compacting config6 twin (full body, index planes dense).
COMPACT = {
    "config5c": (tconfig.PRESETS["config5c"][0], 200, 48),
    "config7x": (tconfig.PRESETS["config7x"][0], 45, 32),
    "config6-compact": (ttypes.compact_twin(tconfig.PRESETS["config6"][0]), 45, 96),
}


@pytest.mark.parametrize("proxy", [False, True], ids=["kernel", "proxy"])
@pytest.mark.parametrize("name", list(COMPACT))
def test_step_cuda_matches_plain_step_under_compact_planes(card, name, proxy):
    """step_cuda on a compacted carry (unpack, K1 or its race proxy on the
    dense view, repack with the gated-off legs passed through) equals the
    plain compacted tick every tick, one launch a tick; the state stays
    packed."""
    cfg, batch, ticks = COMPACT[name]
    before = tick_engine.step_cuda.launches
    s = _hold(cfg, batch, ticks if not proxy else 16, card, proxy=proxy)
    assert tick_engine.step_cuda.launches == before + (ticks if not proxy else 16)
    assert s.ack_age.dim() == 2 and s.mailbox.resp_kind.dim() == 2


@pytest.mark.parametrize("name", ["config5c", "config7x"])
def test_simulate_compact_card_matches_cpu(card, name):
    cfg, _ = tconfig.PRESETS[name]
    got = scan.simulate(cfg, 3, 8, 32, device=card)
    want = scan.simulate(cfg, 3, 8, 32, device="cpu")
    assert bridge.first_difference(want[0], got[0]) is None
    assert bridge.first_difference(want[1], got[1]) is None


@pytest.mark.parametrize("name", ["config2", "config4", "config6r", "config8", "config9", "config10",
                                  "config7"])
def test_simulate_card_matches_cpu(card, name):
    cfg, _ = tconfig.PRESETS[name]
    got = scan.simulate(cfg, 3, 32, 80, device=card)
    want = scan.simulate(cfg, 3, 32, 80, device="cpu")
    assert bridge.first_difference(want[0], got[0]) is None
    assert bridge.first_difference(want[1], got[1]) is None


@pytest.mark.parametrize("proxy", [False, True], ids=["kernel", "proxy"])
@pytest.mark.parametrize("name,batch,ticks", [
    ("config2-served", 45, 96), ("config9-served", 45, 160), ("config6r-served", 45, 160),
    ("config10-served", 45, 160), ("config7-served", 45, 64), ("n129-full-served", 45, 64),
])
def test_step_cuda_matches_plain_step_served_ragged(card, name, batch, ticks, proxy):
    """K1-c: the kernel (and its race proxy) under served per-cluster offer
    and read planes with NIL holes and int32-edge payloads equals the plain
    tick every tick, on a ragged 45 clusters."""
    cfg = SERVED[name]
    cmds, reads = served_planes(batch, ticks, 5, cfg.read_index)
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0, card), batch))
    keys = threefry.split(threefry.key(1, card), batch)
    injected = served = 0
    for t in range(ticks):
        inp = served_inputs(cfg, keys, t, cmds, reads)
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_cuda(cfg, s, inp, t, proxy=proxy)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        injected += int(got[1].cmds_injected.sum())
        served += int(got[1].reads_served.sum())
        s = got[0]
    assert injected > 0
    assert served > 0 or not cfg.read_index


def test_serve_session_card_matches_cpu(card):
    """The serve loop on the card equals it on the CPU: a served config9 of
    16 clusters, 4 tenants, two serving chunks of 64 after one warmup chunk
    -- state, metrics, window lines and delta rows."""
    import itertools

    from raft_sim_tpu_torch.serve import ServeSession, Tenant

    def session(dev):
        counter = itertools.count(1)
        tenants = [Tenant(f"t{i}", 4, source=(next(counter) for _ in itertools.repeat(0)),
                          reads=10**6) for i in range(4)]
        sess = ServeSession(tconfig.PRESETS["config9"][0], batch=16, seed=2, chunk=64,
                            window=16, delta_depth=16, warmup_ticks=64, tenants=tenants,
                            device=dev)
        stats = sess.serve(chunks=2)
        stats.pop("wall_s")
        return sess, stats

    g, g_stats = session(card)
    c, c_stats = session("cpu")
    assert g_stats == c_stats and g_stats["commands_acked"] > 0 and g_stats["reads_served"] > 0
    assert bridge.first_difference(c.state, g.state) is None
    assert bridge.first_difference(c.metrics, g.metrics) is None
    assert c.delta_rows == g.delta_rows


# K1-d: a config per registry name on which its hook's plane runs and the
# hook fires within 150 ticks at 8 clusters (tests/test_torch_mutation.py
# holds the plain tick to the JAX tick on them; tests/test_torch_tick_body.py
# the kernel's body), as RaftConfig keyword arguments.
_RECONFIG = dict(n_nodes=5, log_capacity=8, client_interval=2, reconfig_interval=5, drop_prob=0.2,
                 crash_prob=0.4, crash_period=16, crash_down_ticks=8, partition_period=16,
                 partition_prob=0.3)
_DURABLE = dict(n_nodes=5, log_capacity=8, client_interval=2, fsync_interval=3,
                fsync_jitter_prob=0.25, torn_tail_prob=0.3, lost_suffix_span=3, drop_prob=0.2,
                crash_prob=0.5, crash_period=16, crash_down_ticks=8)
MUTANT_ROWS = {
    "weak-quorum": dict(n_nodes=5, client_interval=4, drop_prob=0.2, partition_period=16,
                        partition_prob=0.3),
    "single-server-change": _RECONFIG,
    "joint-bypass": _RECONFIG,
    "act-on-commit": _RECONFIG,
    "ignore-truncation-rollback": dict(_RECONFIG, compact_margin=4),
    "stale-read": dict(n_nodes=5, log_capacity=8, client_interval=2, read_interval=2,
                       drop_prob=0.2, partition_period=16, partition_prob=0.5),
    "blind-transfer": dict(n_nodes=5, log_capacity=16, client_interval=2, transfer_interval=5,
                           drop_prob=0.2),
    "lease-skew": dict(n_nodes=5, log_capacity=16, election_min_ticks=12, election_range_ticks=1,
                       drop_prob=0.05, clock_skew_prob=0.2, compact_margin=4, client_interval=2,
                       read_interval=2, read_lease_ticks=4, partition_period=16,
                       partition_prob=0.4),
    "ack-before-fsync": _DURABLE,
    "volatile-vote": _DURABLE,
}


def mutant_genome(cfg, batch: int, seed: int):
    """A [batch, 2] genome from a numpy seed: every cluster and segment its
    own drop, partitions, crashes, skew and (where the plane runs) cadences
    and disk faults."""
    from raft_sim_tpu_torch.scenario import genome as genome_mod

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(batch):
        row = []
        for _ in range(2):
            kw = dict(drop_prob=rng.uniform(0, 0.4), partition_period=int(rng.integers(0, 40)),
                      partition_prob=rng.uniform(0, 1), crash_prob=rng.uniform(0, 0.5),
                      crash_down_ticks=int(rng.integers(1, cfg.crash_period + 1)),
                      clock_skew_prob=rng.uniform(0, 0.3))
            for f, on in (("client_interval", cfg.client_interval > 0),
                          ("reconfig_interval", cfg.reconfig),
                          ("transfer_interval", cfg.leader_transfer),
                          ("read_interval", cfg.read_index)):
                if on:
                    kw[f] = int(rng.integers(1, 2 * getattr(cfg, f) + 1))
            if cfg.durable_storage:
                kw.update(fsync_interval=int(rng.integers(1, 6)),
                          fsync_jitter_prob=rng.uniform(0, 0.5), torn_tail_prob=rng.uniform(0, 0.5),
                          lost_suffix_span=int(rng.integers(1, cfg.log_capacity // 2 + 1)))
            row.append(genome_mod.segment(**kw))
        rows.append(row)
    g = genome_mod.ScenarioGenome(**{
        f: torch.tensor([[sg[f] for sg in r] for r in rows], dtype=genome_mod.leaf_dtype(f))
        for f in genome_mod.ScenarioGenome._fields
    })
    genome_mod.validate(cfg, g)
    return g


@pytest.mark.parametrize("proxy", [False, True], ids=["kernel", "proxy"])
@pytest.mark.parametrize("name", list(MUTANT_ROWS))
def test_step_cuda_matches_plain_step_under_mutants(card, name, proxy):
    """Each mutant's hook on the card: the kernel (and its race proxy, on a
    ragged 45) equals the plain tick every tick, inputs drawn on the
    scenario path from a per-cluster two-segment genome."""
    from raft_sim_tpu_torch.scenario import genome as genome_mod
    from raft_sim_tpu_torch.scenario.mutation import mutant_config

    cfg = mutant_config(name, tconfig.RaftConfig(**MUTANT_ROWS[name]))
    batch, ticks = (45, 96) if proxy else (200, 128)
    g = genome_mod.to_device(mutant_genome(cfg, batch, 7), card)
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0, card), batch))
    keys = threefry.split(threefry.key(1, card), batch)
    for t, inp in zip(range(ticks), scan.input_ticks(cfg, keys, 0, ticks, g, ticks // 2)):
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_cuda(cfg, s, inp, t, proxy=proxy)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        s = got[0]


def test_corpus_replays_on_the_card(card):
    """Every tests/corpus artifact replays through the kernel to its tick
    and kinds, with its events and state lines, one launch a tick."""
    import glob
    import os

    from raft_sim_tpu_torch.scenario import shrink as shrink_mod

    paths = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "corpus", "*.json")))
    assert len(paths) == 7
    for path in paths:
        art = shrink_mod.load_artifact(path)
        horizon = art["tick"] + 31
        tick_engine.step_cuda.launches = 0
        rep = shrink_mod.replay_artifact(art, horizon=horizon, device=card)
        assert tick_engine.step_cuda.launches == horizon, path
        assert rep["tick"] == art["tick"] and rep["kinds"] == art["kinds"], path
        last = max(t for t, _ in art["events"])
        assert [[t, e] for t, e in rep["events"] if t <= last] == art["events"], path
        assert rep["state_lines"] == art["state_lines"], path


def test_search_and_shrink_card_match_cpu(card):
    """A weak-quorum hunt on the kitchen-sink config and the shrink of its
    hit: the card's generation log, hit and artifact equal the CPU's."""
    import json

    from raft_sim_tpu_torch.scenario import search as search_mod
    from raft_sim_tpu_torch.scenario import shrink as shrink_mod
    from raft_sim_tpu_torch.scenario.mutation import mutant_config

    cfg = mutant_config("weak-quorum", tconfig.RaftConfig(
        n_nodes=5, log_capacity=8, client_interval=4, drop_prob=0.2, partition_period=16,
        partition_prob=0.3, crash_prob=0.3, crash_period=32, crash_down_ticks=8,
        clock_skew_prob=0.1))
    spec = search_mod.SearchSpec(generations=2, population=16, ticks=64, window=32)
    g, c = (search_mod.search(cfg, spec, device=d) for d in (card, "cpu"))
    assert g.to_json() == c.to_json() and g.hit is not None
    art_g = shrink_mod.shrink(cfg, g.hit, mutant="weak-quorum", device=card)
    art_c = shrink_mod.shrink(cfg, c.hit, mutant="weak-quorum", device="cpu")
    assert json.dumps(art_g) == json.dumps(art_c)


@pytest.mark.parametrize("name", ["config2", "config5", "config6", "config8", "config10"])
def test_step_cuda_matches_plain_step_with_trace_events(card, name):
    """Under track_trace, each tick through the kernel (scan.tick_batch_minor
    with events) equals the plain tick's state, StepInfo and TickEvents from
    the same state and inputs, the pre-tick state the extractor reads is
    intact after the launch, and the traced trajectory is the untraced one."""
    cfg = dataclasses.replace(tconfig.PRESETS[name][0], track_trace=True)
    batch = 45
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0, card), batch))
    untraced = s
    keys = threefry.split(threefry.key(1, card), batch)
    m = trb.to_batch_minor(scan.init_metrics_batch(batch, card))
    fired = 0
    for t in range(96):
        before = trb._map(torch.clone, s)
        got = scan.tick_batch_minor(cfg, s, keys, m, t, events=True)
        want = scan.tick_batch_minor(cfg, s, keys, m, t, step_fn=trb.step_b, events=True)
        for part, w, g in zip(("state", "metrics", "info", "events"), want, got):
            assert bridge.first_difference(w, g) is None, f"tick {t} {part}"
        assert bridge.first_difference(before, s) is None, f"tick {t}: pre-tick state written"
        untraced = scan.tick_batch_minor(tconfig.PRESETS[name][0], untraced, keys, m, t)[0]
        assert bridge.first_difference(untraced, got[0]) is None, f"tick {t}: traced != untraced"
        fired += int(got[3].flags.sum())
        s, m = got[0], got[1]
    assert fired > 0


def test_trace_sink_card_matches_cpu(card, tmp_path):
    """run --trace's library path (Session with a telemetry sink and a trace
    armed) on the card writes the CPU's trace files byte for byte."""
    import os

    from raft_sim_tpu_torch.driver import Session

    cfg = dataclasses.replace(tconfig.PRESETS["config6"][0], track_trace=True)
    for dev in (card, "cpu"):
        sess = Session(cfg, batch=16, seed=0, device=dev)
        sess.attach_telemetry(str(tmp_path / str(dev)), window=64, ring=8)
        sess.attach_trace(depth=256)
        sess.run(128, chunk=64)
        sess.finalize_telemetry()
    for f in ("trace.jsonl", "trace_windows.jsonl", "trace_meta.json", "windows.jsonl",
              "summary.json"):
        a = open(os.path.join(tmp_path, str(card), f), "rb").read()
        assert a == open(os.path.join(tmp_path, "cpu", f), "rb").read(), f


def test_farm_fresh_freeze_card_matches_cpu(card, tmp_path):
    """The farm's fresh-freeze hunt (blind-transfer, scalar,coverage, 16 x
    192, 4 generations, freezing into an empty corpus) on the card writes
    the CPU's hunt rows, manifest and frozen artifact."""
    import os

    from raft_sim_tpu_torch.farm import FarmSpec, run_farm, validate_farm_dir
    from raft_sim_tpu_torch.scenario.mutation import mutant_config

    cfg = mutant_config("blind-transfer", tconfig.RaftConfig(
        n_nodes=5, log_capacity=16, client_interval=2, transfer_interval=9))
    spec = FarmSpec(portfolio=("scalar", "coverage"), budget_gens=4, population=16, ticks=192,
                    window=32, trace_depth=16, seed=0)
    files = {}
    for dev in (card, "cpu"):
        out, corpus = tmp_path / f"out_{dev}", tmp_path / f"corpus_{dev}"
        corpus.mkdir()
        res = run_farm(cfg, spec, mutant="blind-transfer", out_dir=str(out),
                       corpus_dir=str(corpus), freeze=True, device=dev)
        assert validate_farm_dir(str(out)) == [] and len(res.frozen) == 1
        man = res.manifest
        for d in man["dedup_rejected"]:
            d.pop("path")
        files[str(dev)] = (man, *(open(os.path.join(out, "members", m, "hunt.jsonl")).read()
                                  for m in ("scalar", "coverage")),
                           open(res.frozen[0]).read())
    assert files[str(card)] == files["cpu"]


def test_run_perf_health_card_matches_cpu(card, tmp_path):
    """`run --perf --health` through Session on the card: the trajectory,
    the window stream and the health and alert lines equal the CPU run's,
    and the perf rows carry the card's allocated bytes as an int."""
    import json
    import os

    from raft_sim_tpu_torch.driver import Session
    from raft_sim_tpu_torch.utils import telemetry_sink

    cfg = tconfig.PRESETS["config6"][0]
    runs = {}
    for dev in (card, "cpu"):
        d = str(tmp_path / str(dev))
        sess = Session(cfg, batch=16, seed=0, device=dev)
        sess.attach_telemetry(d, window=64, ring=8)
        sess.attach_perf()
        sess.attach_health()
        sess.run(256, chunk=64)
        assert telemetry_sink.validate(d) == []
        runs[str(dev)] = (sess, d)
    (gs, gd), (cs, cd) = runs[str(card)], runs["cpu"]
    assert bridge.first_difference(cs.state, gs.state) is None
    assert bridge.first_difference(cs.metrics, gs.metrics) is None
    for f in ("windows.jsonl", "alerts.jsonl"):
        assert open(os.path.join(gd, f)).read() == open(os.path.join(cd, f)).read(), f
    strip = lambda r: {**r, "slis": {k: v for k, v in r["slis"].items() if k != "device_wait"}}  # noqa: E731
    rows = [[strip(json.loads(x)) for x in open(os.path.join(d, "health.jsonl"))]
            for d in (gd, cd)]
    assert rows[0] == rows[1]
    perf = [json.loads(x) for x in open(os.path.join(gd, "perf.jsonl"))]
    assert len(perf) == 4 and all(isinstance(r["live_bytes"], int) for r in perf)
    assert not any(r["recompiled"] for r in perf)


def test_sharded_session_planes_card_match_unsharded(card, tmp_path):
    """A 4-shard Session on the card with the sink, the flight ring and the
    trace plane writes the unsharded card run's files; its offers return
    the unsharded dicts."""
    import os

    from raft_sim_tpu_torch.driver import Session

    cfg = dataclasses.replace(tconfig.PRESETS["config6"][0], track_trace=True)
    files = {}
    for devices in (None, [card] * 4):
        d = tmp_path / str(bool(devices))
        sess = Session(cfg, batch=64, seed=0, device=card, devices=devices)
        sess.attach_telemetry(str(d), window=32, ring=4)
        sess.attach_trace(depth=128, trigger="leader")
        sess.run(96, chunk=64)
        sess.finalize_telemetry()
        files[bool(devices)] = {f: open(d / f, "rb").read() for f in sorted(os.listdir(d))
                                if f != "manifest.json"}
    assert files[True] == files[False] and "trace.jsonl" in files[True]
    offers = []
    for devices in (None, [card] * 4):
        sess = Session(tconfig.PRESETS["config9"][0], batch=64, seed=0, device=card,
                       devices=devices)
        sess.run(32, chunk=32)
        offers.append([sess.offer(7, wait=16), sess.offer_read(wait=16)])
    assert offers[0] == offers[1]


def test_tools_card_match_cpu(card, tmp_path):
    """The tools tier on the card: repro's shrink equals the CPU's, the
    corpus replays, the device parity check passes, the measurement pass
    writes a document metrics_report renders."""
    from raft_sim_tpu_torch import __main__ as cli
    from raft_sim_tpu_torch import device_parity_check, metrics_report, repro

    class BrokenQuorum(tconfig.RaftConfig):
        @property
        def quorum(self):
            return self.n_nodes // 2

    cfg = BrokenQuorum(n_nodes=5, drop_prob=0.3)
    got = repro.shrink(cfg, 1, 16, 512, chunk=256, device=card)
    assert got is not None and got == repro.shrink(cfg, 1, 16, 512, chunk=256, device="cpu")
    assert repro.main(["--corpus", "tests/corpus"]) == 0
    assert device_parity_check.check(batch=8, ticks=64, device=card) == {
        name: [] for name in device_parity_check.CONFIGS}
    doc = tmp_path / "pass.json"
    assert cli.main(["bench", "--measurement-pass", "--configs", "config2", "--ab-preset",
                     "config2", "--mesh-preset", "config2", "--ticks", "8", "--repeats", "1",
                     "--out", str(doc)]) == 0
    assert metrics_report.main(["--perf", str(doc)]) == 0


def test_sanitized_loops_on_the_card_equal_unarmed(card):
    """The release-poison sanitizer on the card: each chunk loop's armed run
    (chunked, telemetry, serve) equals its unarmed run leaf for leaf, the
    wrapper fired, and the caller's input is unchanged."""
    from raft_sim_tpu_torch.analysis import sanitizer

    found, info = sanitizer.run_dynamic(str(card))
    assert found == []
    assert all(sum(st["calls"].values()) >= 2 for st in info["loops"].values())
    assert all(st["poisoned"] + st["released"] > 0 for st in info["loops"].values())


def test_run_sanitize_on_the_card_equals_unarmed(card):
    """`Session.run` armed and unarmed at config6, 4 chunks:
    state and metrics equal; the caller's state unchanged."""
    import contextlib

    from raft_sim_tpu_torch.analysis import sanitizer
    from raft_sim_tpu_torch.driver import Session

    cfg = tconfig.PRESETS["config6"][0]
    runs = []
    for arm in (False, True):
        sess = Session(cfg, batch=64, seed=0, device=card)
        before = sess.state
        snap = sanitizer.snapshot(before)
        ctx = sanitizer.armed() if arm else contextlib.nullcontext(None)
        with ctx as stats:
            sess.run(128, chunk=32)
        assert sanitizer.mismatched_leaves(snap, sanitizer.snapshot(before)) == []
        runs.append((sanitizer.snapshot(sess.state), sanitizer.snapshot(sess.metrics)))
    assert stats["calls"] == {"sim.chunked._chunk": 4} and stats["poisoned"] > 0
    assert sanitizer.mismatched_leaves(runs[0], runs[1]) == []


def test_kernel_resources_hold_the_pins(card):
    """ptxas's registers, stack and spills of every K1 instantiation of the
    build against tests/golden_torch_cost.json (cost-kernel-resources)."""
    import json

    from raft_sim_tpu_torch.analysis import cost_model

    tick_engine.build()
    report = tick_engine.ptxas_report()
    assert len(report) >= 12
    with open(cost_model.golden_path()) as f:
        pins = json.load(f)["kernel_resources"]
    assert cost_model.check_kernel_resources(report, pins) == []


@pytest.mark.parametrize("name", ["config3", "config4", "config6r", "config8", "config10", "config5c",
                                  "config7x"])
def test_draw_cuda_matches_plain_draws(card, name):
    """The draw kernel (K2) on the card equals the plain draws on the card,
    every StepInputs leaf and fault fact, with and without the facts, at
    ticks across the first crash window's edge; on a two-segment genome with
    per-row ticks; and in one `draw_span` launch."""
    from raft_sim_tpu_torch.kernels import draw_engine
    from raft_sim_tpu_torch.scenario import genome as gmod

    cfg, _ = tconfig.PRESETS[name]
    batch = 45
    keys = threefry.split(threefry.key(1, card), batch)
    for t in (0, 1, 2, 31, 32, 63, 64, 65, 97):
        for facts in (False, True):
            want = draw_engine.draw_plain(cfg, keys, t, facts=facts)
            got = draw_engine.draw_cuda(cfg, keys, t, facts=facts)
            inp_w, inp_g = (want[0], got[0]) if facts else (want, got)
            assert bridge.first_difference(inp_w, inp_g) is None, f"tick {t}"
            if facts:
                assert all(torch.equal(a, b) for a, b in zip(want[1], got[1])), f"tick {t} facts"
    rng = np.random.default_rng(3)
    segs = [gmod.segment(drop_prob=rng.uniform(0, 0.4), partition_period=int(rng.integers(0, 20)),
                         partition_prob=rng.uniform(), crash_prob=rng.uniform(0, 0.5),
                         crash_down_ticks=8, clock_skew_prob=rng.uniform(0, 0.3),
                         client_interval=int(rng.integers(0, 5))) for _ in range(2)]
    g = gmod.to_device(gmod.broadcast(gmod.from_segments(segs), batch), card)
    now = torch.arange(batch, dtype=torch.int32, device=card)
    want = draw_engine.draw_plain(cfg, keys, now, g, 16, facts=True)
    got = draw_engine.draw_cuda(cfg, keys, now, g, 16, facts=True)
    assert bridge.first_difference(want[0], got[0]) is None
    assert all(torch.equal(a, b) for a, b in zip(want[1], got[1]))
    launches = draw_engine.draw_cuda.launches
    g8 = gmod.to_device(gmod.broadcast(gmod.from_segments(segs), 8), card)
    want = faults.draw_span(cfg, keys[:8], 3, 24, g8, 16)
    got = draw_engine.draw_span(cfg, keys[:8], 3, 24, g8, 16)
    assert draw_engine.draw_cuda.launches == launches + 1
    assert bridge.first_difference(want, type(got)(*(x.movedim(-1, 1) for x in got))) is None


def test_card_runs_never_take_the_plain_draws(card, monkeypatch):
    """On the card every path draws through K2: with the plain draws patched
    to raise, `simulate`, `simulate_scenario` (a draw a tick), a traced
    replay (a span a launch) and a traced windowed run (the facts) run, and
    K2 launches once a tick (once a span on the replay)."""
    from raft_sim_tpu_torch.kernels import draw_engine
    from raft_sim_tpu_torch.scenario import genome as gmod
    from raft_sim_tpu_torch.sim import telemetry
    from raft_sim_tpu_torch.trace import ring as tring

    def refuse(*a, **k):
        raise AssertionError("the plain draws ran on the card")

    monkeypatch.setattr(faults, "make_inputs", refuse)
    monkeypatch.setattr(faults, "draw_span", refuse)
    monkeypatch.setattr(faults, "trace_fault_inputs", refuse)
    cfg = tconfig.PRESETS["config6r"][0]
    draw_engine.draw_cuda.launches = 0
    scan.simulate(cfg, 0, 64, 32, device=card)
    assert draw_engine.draw_cuda.launches == 32
    g = gmod.from_config(cfg)
    draw_engine.draw_cuda.launches = 0
    scan.simulate_scenario(cfg, 0, 64, 32, gmod.broadcast(g, 64), seg_len=16, device=card)
    assert draw_engine.draw_cuda.launches == 32
    state, keys = scan.seed_fleet(cfg, 0, 1, card)
    draw_engine.draw_cuda.launches = 0
    scan.run_traced(cfg, state, keys, 48, genome=gmod.to_device(gmod.broadcast(g, 1), card))
    assert draw_engine.draw_cuda.launches == 1  # one span: 48 ticks x 1 cluster
    tcfg = dataclasses.replace(cfg, track_trace=True)
    draw_engine.draw_cuda.launches = 0
    telemetry.simulate_windowed(tcfg, 0, 64, 32, 16, trace=tring.TraceSpec(depth=64), device=card)
    assert draw_engine.draw_cuda.launches == 32


@pytest.mark.parametrize("cap,e", [(64, 32), (24, 24), (127, 127)])
def test_step_cuda_takes_windows_up_to_the_config_ceiling(card, cap, e):
    """K1 at max_entries_per_rpc above its old limit of 16, up to min(CAP,
    127), equals the plain tick every tick under heavy drop."""
    cfg = tconfig.RaftConfig(n_nodes=5, log_capacity=cap, max_entries_per_rpc=e,
                             client_interval=1, drop_prob=0.45)
    _hold(cfg, 64, 128, card)
