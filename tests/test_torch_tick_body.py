"""The Hopper tick kernel's own logic, on the CPU: csrc/tick.cuh (the
node-parallel phase functions the CUDA kernel runs) compiled with g++ through
the plain C harness csrc/tick_host.cpp, which runs each phase over every
(cluster, node) of a tile of clusters before the next, loaded with ctypes, and
driven through the same leaf checks and pointer table as the CUDA wrapper
(kernels/tick_engine.py `step_host`). It is held against the plain PyTorch tick, which
tests/test_torch_step.py holds against the JAX package: here on the preset and
fuzz rows, in the forward and the reverse worker order (each row's plain
trajectory computed once for both); tests/test_torch_tick_body_planes.py
holds it under the served, mutant, fixture and compacted-layout planes. The
library is built once per source hash (`tick_engine.host_library`).

Tolerance: exact equality of every ClusterState and StepInfo leaf.
Skips only where no g++ is installed.
"""

import ctypes
import dataclasses
import re
import shutil

import numpy as np
import pytest
import torch

from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.scenario.mutation import mutant_config
from raft_sim_tpu_torch.sim import faults
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry
from tests.test_torch_step import DURABLE_CRASHES, DURABLE_PREVOTE_DENSE, RING_LM_CAP8, _port_cfg

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def host_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    return tick_engine.load_host(tick_engine.host_library(gxx))


def test_ptr_enum_matches_wrapper_order():
    """csrc/tick.cuh's Ptr enum lists the leaves in PTR_ORDER's order."""
    src = (tick_engine.CSRC / "tick.cuh").read_text()
    body = src[src.index("enum Ptr {"):src.index("N_PTR")]
    names = re.findall(r"\b([A-Z]+)_([A-Z_]+)\b", body)
    prefix = {"S": "state", "M": "mailbox", "I": "inputs", "O": "state_out",
              "OM": "mailbox_out", "F": "info_out"}
    got = [(prefix[p], n.lower()) for p, n in names]
    assert got == list(tick_engine.PTR_ORDER)

def _fuzz(inp, rng, p_down):
    alive = torch.from_numpy(rng.random(tuple(inp.alive.shape)) >= p_down)
    restarted = alive & torch.from_numpy(rng.random(tuple(inp.alive.shape)) < p_down)
    return inp._replace(alive=alive, restarted=restarted)

# config7's mix (N=101, CAP=16, a client every 4 ticks, drop 0.05) on a
# compacting ring with log matching every tick.
N101_RING_LM = dataclasses.replace(tconfig.PRESETS["config7"][0], compact_margin=4,
                                   check_log_matching=True)

# A client every tick under heavy drop: followers fall far behind, so the
# leader ships its widest windows.
E32_CFG = tconfig.RaftConfig(n_nodes=5, log_capacity=64, max_entries_per_rpc=32, client_interval=1,
                             drop_prob=0.45)

ROWS = [
    pytest.param(tconfig.RaftConfig(n_nodes=3, log_capacity=8, max_entries_per_rpc=2), 8, 120, 0.0, id="n3-small"),
    pytest.param(tconfig.RaftConfig(n_nodes=5, client_interval=4, drop_prob=0.2), 8, 120, 0.0, id="n5-faults"),
    pytest.param(tconfig.PRESETS["config4"][0], 8, 120, 0.0, id="config4"),
    pytest.param(tconfig.PRESETS["config2"][0], 5, 120, 0.0, id="config2-ragged-b5"),
    pytest.param(tconfig.PRESETS["config1"][0], 1, 120, 0.0, id="config1-int16"),
    pytest.param(tconfig.PRESETS["config5"][0], 3, 64, 0.0, id="config5-n51"),
    pytest.param(
        tconfig.RaftConfig(n_nodes=5, log_capacity=6, client_interval=1, drop_prob=0.25, clock_skew_prob=0.2),
        8, 128, 0.08, id="n5-tiny-log-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=7, log_capacity=12, client_interval=2, drop_prob=0.2,
                           check_log_matching=True, check_invariants=True, ack_timeout_ticks=7),
        6, 128, 0.05, id="n7-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=4, client_interval=3, check_invariants=False, ack_timeout_ticks=200),
        6, 100, 0.03, id="n4-no-invariants-ack-int16",
    ),
    # The slice-2 presets under their own crash schedules, long enough for
    # config6's CAP=32 ring to wrap; then the fast-wrapping ring under fuzz.
    pytest.param(tconfig.PRESETS["config6"][0], 8, 160, 0.0, id="config6"),
    pytest.param(tconfig.PRESETS["config6r"][0], 7, 160, 0.0, id="config6r-ragged-b7"),
    pytest.param(tconfig.PRESETS["config3p"][0], 8, 120, 0.0, id="config3p"),
    pytest.param(
        dataclasses.replace(tconfig.PRESETS["config6"][0], log_capacity=8, compact_margin=4,
                            max_entries_per_rpc=2, client_interval=2),
        8, 128, 0.06, id="config6-cap8-fast-wrap-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=5, log_capacity=8, compact_margin=2, max_entries_per_rpc=4,
                           client_interval=1, client_redirect=True, client_pipeline=3,
                           drop_prob=0.2, pre_vote=True, clock_skew_prob=0.1),
        8, 128, 0.05, id="n5-prevote-redirect-cap8-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=7, log_capacity=12, compact_margin=3, max_entries_per_rpc=3,
                           client_interval=2, check_invariants=False, pre_vote=True,
                           ack_timeout_ticks=200),
        6, 120, 0.05, id="n7-compaction-prevote-no-invariants-ack-int16",
    ),
    # The slice-3 presets, then the reconfiguration plane under crash fuzz:
    # with PreVote on a fast-wrapping ring (the snapshot config context), with
    # leases and transfers together, and at N=33 (two packed words per
    # member row) with the redirect client.
    pytest.param(tconfig.PRESETS["config8"][0], 8, 128, 0.0, id="config8"),
    pytest.param(tconfig.PRESETS["config9"][0], 7, 260, 0.0, id="config9-ragged-b7"),
    pytest.param(
        tconfig.RaftConfig(n_nodes=5, log_capacity=8, compact_margin=4, client_interval=1,
                           reconfig_interval=11, transfer_interval=13, read_interval=3,
                           pre_vote=True, drop_prob=0.2, crash_prob=0.4, crash_period=16,
                           crash_down_ticks=8),
        8, 128, 0.05, id="n5-reconfig-prevote-compaction-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=5, log_capacity=8, client_interval=2, reconfig_interval=7,
                           transfer_interval=5, read_interval=2, read_lease_ticks=3,
                           election_min_ticks=10, election_range_ticks=6, drop_prob=0.2,
                           clock_skew_prob=0.2),
        8, 128, 0.06, id="n5-reconfig-lease-transfer-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=33, log_capacity=12, compact_margin=3, max_entries_per_rpc=3,
                           client_interval=2, client_redirect=True, client_pipeline=3,
                           reconfig_interval=5, transfer_interval=7, read_interval=2,
                           read_lease_ticks=2, election_min_ticks=8, election_range_ticks=6,
                           drop_prob=0.1),
        3, 120, 0.03, id="n33-reconfig-lease-redirect-compaction-crash-fuzz",
    ),
    # N=64: two full packed words a row, and on the card two nodes a worker
    # at the widest the body takes.
    pytest.param(
        tconfig.RaftConfig(n_nodes=64, log_capacity=12, compact_margin=3, max_entries_per_rpc=3,
                           client_interval=2, client_redirect=True, client_pipeline=3,
                           reconfig_interval=5, transfer_interval=7, read_interval=2,
                           read_lease_ticks=2, pre_vote=True, election_min_ticks=8,
                           election_range_ticks=6, drop_prob=0.1),
        2, 100, 0.03, id="n64-reconfig-lease-prevote-redirect-compaction-crash-fuzz",
    ),
    # The storage plane: config10, the oracle's storage rows (the PreVote one
    # on the dense layout) under crash fuzz, and N=33 (two packed vote words)
    # with transfers and PreVote beside it.
    pytest.param(tconfig.PRESETS["config10"][0], 7, 200, 0.0, id="config10-ragged-b7"),
    pytest.param(_port_cfg(DURABLE_CRASHES), 8, 128, 0.06, id="n5-durable-crashes-crash-fuzz"),
    pytest.param(_port_cfg(DURABLE_PREVOTE_DENSE), 8, 128, 0.06, id="n5-durable-prevote-dense-crash-fuzz"),
    pytest.param(
        tconfig.RaftConfig(n_nodes=33, log_capacity=12, client_interval=2, fsync_interval=2,
                           fsync_jitter_prob=0.3, torn_tail_prob=0.5, lost_suffix_span=4,
                           transfer_interval=7, pre_vote=True, election_min_ticks=8,
                           election_range_ticks=6, drop_prob=0.1),
        3, 120, 0.04, id="n33-durable-prevote-transfer-crash-fuzz",
    ),
    # config4c (a ragged tile at B=5), then clusters above 64 nodes: config7
    # (N=101, four packed words a row), its mix at N=65 (W=3), at the int8 ->
    # int16 node-id edge (N=126/127), at the width-4 -> width-8 edge
    # (N=128/129) and at N=255 under rolling partitions; the full gate set at
    # N=101 under crash fuzz; the storage plane at N=129.
    pytest.param(tconfig.PRESETS["config4c"][0], 5, 60, 0.0, id="config4c-ragged-b5"),
    pytest.param(tconfig.PRESETS["config7"][0], 3, 60, 0.0, id="config7-n101"),
    *(pytest.param(dataclasses.replace(tconfig.PRESETS["config7"][0], n_nodes=n), 2, 40, 0.0,
                   id=f"config7-mix-n{n}") for n in (65, 126, 127, 128, 129)),
    pytest.param(
        dataclasses.replace(tconfig.PRESETS["config7"][0], n_nodes=255, partition_period=32,
                            partition_prob=0.25),
        2, 48, 0.0, id="config7-mix-n255-partitions",
    ),
    # The wide quorum commit (csrc/tick.cuh `QHist`) under drop 0.3: leaders
    # come and go, their match rows spread over several values, so the walk
    # it replaced would recount.
    *(pytest.param(dataclasses.replace(tconfig.PRESETS["config7"][0], n_nodes=n, drop_prob=0.3),
                   b, 128, 0.0, id=f"config7-mix-n{n}-drop03") for n, b in ((65, 4), (101, 3))),
    pytest.param(
        tconfig.RaftConfig(n_nodes=101, log_capacity=12, compact_margin=3, max_entries_per_rpc=3,
                           client_interval=2, client_redirect=True, client_pipeline=3,
                           reconfig_interval=5, transfer_interval=7, read_interval=2,
                           read_lease_ticks=2, pre_vote=True, election_min_ticks=8,
                           election_range_ticks=6, drop_prob=0.1),
        2, 80, 0.03, id="n101-reconfig-lease-prevote-redirect-compaction-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=129, log_capacity=12, client_interval=2, fsync_interval=2,
                           fsync_jitter_prob=0.3, torn_tail_prob=0.5, lost_suffix_span=4,
                           transfer_interval=7, pre_vote=True, election_min_ticks=8,
                           election_range_ticks=6, drop_prob=0.1),
        2, 60, 0.04, id="n129-durable-prevote-transfer-crash-fuzz",
    ),
    # Log matching on the compacting ring (every partner pair, the checksum
    # at the larger base, skipped pairs): config6 and config9 checked every
    # tick and every 4th, the fast-wrapping 8-slot ring under crash fuzz, and
    # config7's mix at N=101 compacting (two nodes a worker on the card).
    *(pytest.param(dataclasses.replace(tconfig.PRESETS[name][0], check_log_matching=True,
                                       log_matching_interval=k), 4, ticks, 0.0, id=f"{name}-lm-every-{k}")
      for name, ticks in (("config6", 160), ("config9", 260)) for k in (1, 4)),
    pytest.param(_port_cfg(RING_LM_CAP8), 4, 120, 0.06, id="config6-cap8-lm-crash-fuzz"),
    # The trace plane's gate: the tick takes it and reads nothing of it.
    pytest.param(dataclasses.replace(tconfig.PRESETS["config8"][0], track_trace=True), 3, 64,
                 0.03, id="config8-track-trace-crash-fuzz"),
    pytest.param(N101_RING_LM, 2, 80, 0.0, id="config7-mix-n101-compaction-lm"),
    # AppendEntries windows past 16 entries, up to RaftConfig's ceiling
    # min(CAP, 127): E = 32 on a 64-slot log, and E = CAP on a plain log and
    # on a compacting ring, under drop and crash fuzz so lagging followers
    # are sent wide windows.
    *(pytest.param(cfg, 4, 120, 0.08, id=name) for name, cfg in (
        ("n5-e32-cap64-crash-fuzz", E32_CFG),
        ("n5-e24-cap24-crash-fuzz", dataclasses.replace(E32_CFG, log_capacity=24,
                                                        max_entries_per_rpc=24)),
        ("n5-e16-cap16-ring-crash-fuzz", dataclasses.replace(E32_CFG, log_capacity=16,
                                                             max_entries_per_rpc=16,
                                                             compact_margin=4, drop_prob=0.2)))),
]

@pytest.fixture(scope="module")
def plain_trajectories():
    """Each ROWS row's plain trajectory -- [(state, inputs, plain step)] a
    tick -- computed once for the forward and the reverse-order tests
    (`plain_trajectory`), and dropped after the second."""
    return {}


def plain_trajectory(cache, cfg, batch, ticks, p_down, last_use=False):
    key = (cfg, batch, ticks, p_down)
    if key not in cache:
        rng = np.random.default_rng(5)
        s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(2), batch))
        keys = threefry.split(threefry.key(3), batch)
        steps = []
        for t in range(ticks):
            inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
            if p_down:
                inp = _fuzz(inp, rng, p_down)
            want = trb.step_b(cfg, s, inp, t)
            steps.append((s, inp, want))
            s = want[0]
        cache[key] = steps
    return cache.pop(key) if last_use else cache[key]


@pytest.mark.parametrize("cfg,batch,ticks,p_down", ROWS)
def test_tick_body_matches_plain_step(host_lib, plain_trajectories, cfg, batch, ticks, p_down):
    led = 0
    for t, (s, inp, want) in enumerate(plain_trajectory(plain_trajectories, cfg, batch, ticks,
                                                        p_down)):
        got = tick_engine.step_host(host_lib, cfg, s, inp, t)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        led += int(want[1].n_leaders.sum() > 0)
    assert led > 0
    if cfg.compaction:  # the trajectory compacted: log_base moved off 0
        assert int(want[0].log_base.max()) > 0


@pytest.mark.parametrize("cfg,batch,ticks,p_down", ROWS)
def test_tick_body_reverse_worker_order(host_lib, plain_trajectories, cfg, batch, ticks, p_down):
    """Each phase's (cluster, node) workers run in reverse order and give the
    same leaves as the forward order and the plain tick: no phase reads a
    value another node writes in the same phase (on the card those workers
    run concurrently between two barriers). Both orders run with the race
    proxy's poison (each exchange field overwritten once its last reader's
    phase is over), so no phase reads a field past that schedule either."""
    steps = plain_trajectory(plain_trajectories, cfg, batch, ticks, p_down, last_use=True)
    for t, (s, inp, want) in enumerate(steps):
        fwd = tick_engine.step_host(host_lib, cfg, s, inp, t, poison=True)
        rev = tick_engine.step_host(host_lib, cfg, s, inp, t, reverse=True, poison=True)
        for got, order in ((rev, "reverse"), (fwd, "forward")):
            diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
            assert diff is None, f"tick {t}, {order} order: {diff}"


def test_wrapper_rejects_bad_leaves(host_lib):
    cfg = tconfig.PRESETS["config2"][0]
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0), 4))
    inp = trb.to_batch_minor(faults.make_inputs(cfg, threefry.split(threefry.key(1), 4), 0))
    with pytest.raises(ValueError, match="next_index"):
        tick_engine.step_host(host_lib, cfg, s._replace(next_index=s.next_index.to(torch.int16)), inp, 0)
    with pytest.raises(ValueError, match="not contiguous"):
        tick_engine.step_host(host_lib, cfg, s._replace(log_term=s.log_term.transpose(0, 1).contiguous().transpose(0, 1)), inp, 0)
    with pytest.raises(ValueError, match="skew"):
        tick_engine.step_host(host_lib, cfg, s, inp._replace(skew=inp.skew[:, :2]), 0)
    with pytest.raises(NotImplementedError, match="compact_planes"):
        tick_engine.check_supported(tconfig.RaftConfig(n_nodes=101, compact_planes=True))


def test_append_windows_up_to_the_config_ceiling_are_taken(host_lib):
    """The kernel takes every window width RaftConfig admits, 1 to
    min(CAP, 127) (the int8 window offset), and E32_CFG's trajectory ships
    windows wider than 16 entries through the host body equal to the plain
    tick's."""
    for cap, e in ((8, 8), (16, 16), (64, 17), (64, 32), (64, 64), (128, 127), (256, 127)):
        tick_engine.check_supported(tconfig.RaftConfig(n_nodes=5, log_capacity=cap,
                                                       max_entries_per_rpc=e))
    cfg = E32_CFG
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(2), 4))
    keys = threefry.split(threefry.key(3), 4)
    widest = 0
    for t in range(120):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_host(host_lib, cfg, s, inp, t)
        assert bridge.first_difference(want[0], got[0]) is None, f"tick {t}"
        s = got[0]
        widest = max(widest, int(s.mailbox.ent_count.max()))
    assert widest > 16


def test_every_dense_cluster_size_is_taken(host_lib):
    """The kernel takes every N that RaftConfig admits (2..255, dense): the
    wrapper accepts it, and its block shape keeps at most 512 threads, at
    most two nodes a thread and an exchange within a block's shared memory
    (232,448 bytes on Hopper) at any batch."""
    for n in range(2, 256):
        tick_engine.check_supported(tconfig.RaftConfig(n_nodes=n))
        for b in (1, 45, 1_000, 100_000):
            tc, s = tick_engine.block_shape(n, b, 132)
            assert tc * s <= 512 and -(-n // s) <= 2, (n, b, tc, s)
            assert host_lib.rs_tick_smem_bytes(n, tc) <= 232_448, (n, b, tc)
    assert tick_engine.block_shape(101, 1_000, 132) == (8, 64)
    assert tick_engine.block_shape(255, 1_000, 132) == (4, 128)
    assert host_lib.rs_tick_smem_bytes(101, 8) == 82_496
    assert host_lib.rs_tick_smem_bytes(255, 4) == 119_168
    assert host_lib.rs_tick_smem_bytes(51, 16) == 78_464


def _order_statistic(vals, maj: int) -> int:
    """The maj-th largest of `vals` (0 when fewer than maj): the leader's
    quorum match, by a sort."""
    ranked = np.sort(np.asarray(vals, dtype=np.int64))[::-1]
    return int(ranked[maj - 1]) if len(ranked) >= maj else 0


@pytest.mark.parametrize("n", [33, 51, 65, 101, 128, 255])
def test_quorum_histogram_matches_a_sort(host_lib, n):
    """The lean wide body's quorum commit (csrc/tick.cuh `QHist`,
    `quorum_select`: a histogram over the window (base, base + QH] and a
    count above it, the exact walk when a majority lies above) equals
    max(the order statistic by a numpy sort, base) -- as does the walk
    (`qmatch`) it replaces -- on random rows: values spread below and
    through the window and past it (some beyond the leader's length), the
    leader's own slot read as `self` (its length or a durable length below
    it), every node or a random member set (two a trial, as the old and new
    sets of a joint configuration), majorities from 1 to N."""
    fn = host_lib.rs_tick_quorum_match
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    qh = int(re.search(r"constexpr int QH = (\d+);",
                       (tick_engine.CSRC / "tick.cuh").read_text())[1])
    rng = np.random.default_rng(n)
    above = 0  # trials whose majority lay above the window: the walk ran
    for trial in range(300):
        base = int(rng.integers(0, 40))
        length = base + int(rng.integers(0, 2 * qh))
        spread = trial % 4
        if spread == 0:  # caught-up followers: most at the leader's length
            row = np.where(rng.random(n) < 0.7, length, rng.integers(0, length + 1, n))
        elif spread == 1:  # spread through the window and below it
            row = rng.integers(max(base - 5, 0), length + 1, n)
        elif spread == 2:  # values past the window, some past the length
            row = rng.integers(base, base + 4 * qh, n)
        else:  # duplicates on a few values
            row = rng.choice(rng.integers(0, length + 3 * qh, 4), n)
        row = np.ascontiguousarray(row, dtype=np.int32)
        i = int(rng.integers(0, n))
        self_ = length if trial % 3 else int(rng.integers(max(base - 2, 0), length + 1))
        vals = row.astype(np.int64).copy()
        vals[i] = self_
        sets = [None] if trial % 2 else [rng.random(n) < rng.uniform(0.2, 1.0) for _ in range(2)]
        for members in sets:
            if members is None:
                mask, maj, picked = None, n // 2 + 1, vals
            else:
                words = np.zeros(8, dtype=np.uint32)
                for j in np.flatnonzero(members):
                    words[j // 32] |= np.uint32(1 << (j % 32))
                mask = words.ctypes.data
                maj, picked = int(members.sum()) // 2 + 1, vals[members]
            if trial % 5 == 4:
                maj = int(rng.integers(1, n + 1))
            want = max(_order_statistic(picked, maj), base)
            above += int((picked > base + qh).sum() >= maj)
            got = fn(row.ctypes.data, n, i, self_, mask, maj, base, 0)
            walk = fn(row.ctypes.data, n, i, self_, mask, maj, base, 1)
            assert got == want == walk, (trial, members is not None, maj, base, got, want, walk)
    assert above > 0


def test_kernel_report_names_each_cells_instantiation(host_lib, monkeypatch):
    """chip_smoke.py's per-cell ptxas line: the report is parsed per kernel,
    and each preset maps to its (index, ack, node, width tier, nodes a
    thread, body) instantiation, with the body as `body_for` decides it --
    config7 at width 4 with int8 node ids, N=255 at width 8 with int16 ones,
    a mutant with a full plane on the mutant body."""
    entries = {"IaaaLi2ELi1ELi0E": (63, 0), "IaaaLi2ELi2ELi0E": (64, 136),
               "IiaaLi2ELi1ELi1E": (112, 0), "IaaaLi4ELi2ELi0E": (128, 512),
               "IaasLi8ELi2ELi0E": (128, 1024), "IsaaLi2ELi1ELi2E": (120, 8)}
    text = "".join(
        f"ptxas info    : Compiling entry function '_ZN4anon11tick_kernel{tag}EvN2rs8TickArgsEii' for 'sm_90a'\n"
        f"ptxas info    : Function properties for _ZN4anon11tick_kernel{tag}EvN2rs8TickArgsEii\n"
        f"    {stack} bytes stack frame, {stack} bytes spill stores, {2 * stack} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for tag, (regs, stack) in entries.items()
    )
    monkeypatch.setitem(tick_engine.BUILD_INFO, "ptxas", text)
    wide = dataclasses.replace(tconfig.PRESETS["config7"][0], n_nodes=255)
    blind = mutant_config("blind-transfer", tconfig.PRESETS["config8"][0])
    for name, npt, tag in (("config3", 1, "IaaaLi2ELi1ELi0E"), ("config5", 2, "IaaaLi2ELi2ELi0E"),
                           ("config6", 1, "IiaaLi2ELi1ELi1E"), ("config7", 2, "IaaaLi4ELi2ELi0E"),
                           ("config7-n255", 2, "IaasLi8ELi2ELi0E"),
                           ("config8-blind", 1, "IsaaLi2ELi1ELi2E")):
        cfg = {"config7-n255": wide, "config8-blind": blind}.get(name) or tconfig.PRESETS[name][0]
        s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0), 1))
        got = tick_engine.kernel_report(cfg, s, npt, host_lib)
        regs, stack = entries[tag]
        body = {"config6": "full", "config8-blind": "mutant"}.get(name, "lean")
        assert got == {"instantiation": "tick_kernel" + tag, "registers": regs, "stack": stack,
                       "spill_stores": stack, "spill_loads": 2 * stack, "gate_set": body}, name


@pytest.mark.parametrize(
    "name,per_cluster",
    [
        # (bytes read, bytes written) per cluster. config1-config5 were
        # counted before the compaction, PreVote and redirect legs existed;
        # those legs stay gated off there, so these do not move.
        ("config1", (124_067, 124_060)),
        ("config2", (2_807, 2_800)),
        ("config3", (2_087, 2_080)),
        ("config4", (2_987, 2_936)),
        ("config5", (26_787, 25_564)),
        # Compaction: int32 index planes, the snapshot triple, req_base legs
        # and noop_blocked; redirect: the K=5 pipeline slots and routing
        # inputs; PreVote: heard_clock and the packed pv_grant plane.
        ("config6", (3_067, 3_104)),
        ("config6r", (3_151, 3_164)),
        ("config3p", (2_127, 2_120)),
        # The reconfiguration plane: config8 adds the member rows, the config
        # plane, the transfer and read legs and the admin inputs; config9 the
        # read legs, the lease anchor and heard_clock on config6's ring.
        ("config8", (6_389, 6_402)),
        ("config9", (5_091, 5_197)),
        # The storage plane: the three watermarks both ways, the two disk
        # inputs and the lag pair, on an N=5, CAP=64 log (int16 index tier).
        ("config10", (4_872, 4_848)),
    ],
)
def test_traffic_bytes_pinned(name, per_cluster):
    cfg, batch = tconfig.PRESETS[name]
    assert tick_engine.traffic_bytes(cfg, 1) == per_cluster
    assert tick_engine.traffic_bytes(cfg, batch) == (per_cluster[0] * batch, per_cluster[1] * batch)


def test_gated_legs_follow_the_config():
    """Legs a gate leaves untouched get no pointer; the live set grows with
    each gate and nothing else."""
    def live(cfg):
        return {(g, f) for g, f in tick_engine.PTR_ORDER if tick_engine.leg_live(cfg, g, f)}

    plain = live(tconfig.PRESETS["config3"][0])
    assert live(tconfig.PRESETS["config3p"][0]) - plain == {
        ("state", "heard_clock"), ("state_out", "heard_clock"),
        ("mailbox", "pv_grant"), ("mailbox_out", "pv_grant"),
    }
    comp = live(tconfig.PRESETS["config6"][0]) - live(tconfig.PRESETS["config2"][0])
    assert {f for _, f in comp} == {
        "log_base", "base_term", "base_chk", "req_base", "req_base_term", "req_base_chk",
        "noop_blocked",
    }
    redirect = live(tconfig.PRESETS["config6r"][0]) - live(tconfig.PRESETS["config6"][0])
    assert {f for _, f in redirect} == {
        "client_pend", "client_dst", "client_tick", "client_target", "client_bounce",
    }
    # Reconfig on the plain log: the member rows and config plane both ways,
    # cfg_epoch written only, the snapshot context read only (it moves only
    # under compaction), heard_clock for the vote denial.
    plain5 = tconfig.RaftConfig(n_nodes=5, log_capacity=8, client_interval=2)
    rcf = live(dataclasses.replace(plain5, reconfig_interval=9)) - live(plain5)
    assert rcf == {
        ("state", "member_old"), ("state_out", "member_old"),
        ("state", "member_new"), ("state_out", "member_new"),
        ("state", "cfg_pend"), ("state_out", "cfg_pend"),
        ("state", "log_cfg"), ("state_out", "log_cfg"),
        ("mailbox", "ent_cfg"), ("mailbox_out", "ent_cfg"),
        ("state_out", "cfg_epoch"), ("state", "base_mold"), ("state", "base_pend"),
        ("state", "base_epoch"), ("inputs", "reconfig_cmd"),
        ("state", "heard_clock"), ("state_out", "heard_clock"),
    }
    # ...and under compaction the snapshot context moves and rides the header.
    comp5 = dataclasses.replace(plain5, compact_margin=2)
    rcf_comp = live(dataclasses.replace(comp5, reconfig_interval=9)) - live(comp5)
    assert rcf_comp - rcf == {
        ("state_out", "base_mold"), ("state_out", "base_pend"), ("state_out", "base_epoch"),
        ("mailbox", "req_base_mold"), ("mailbox_out", "req_base_mold"),
        ("mailbox", "req_base_pend"), ("mailbox_out", "req_base_pend"),
        ("mailbox", "req_base_epoch"), ("mailbox_out", "req_base_epoch"),
    }
    # Transfer alone: its own legs; the disruption flag only beside a denial gate.
    xfr = live(dataclasses.replace(plain5, transfer_interval=9)) - live(plain5)
    assert {f for _, f in xfr} == {"xfer_to", "xfer_tgt", "transfer_cmd"}
    xfr_rcf = live(dataclasses.replace(plain5, transfer_interval=9, reconfig_interval=9))
    assert xfr_rcf - live(dataclasses.replace(plain5, reconfig_interval=9)) - xfr == {
        ("mailbox", "req_disrupt"), ("mailbox_out", "req_disrupt"),
    }
    # ReadIndex reads, then leases on top.
    reads = live(dataclasses.replace(plain5, read_interval=3)) - live(plain5)
    assert {f for _, f in reads} == {
        "read_idx", "read_tick", "read_acks", "read_cmd", "reads_served", "read_lat_sum",
        "read_hist",
    }
    lease_cfg = dataclasses.replace(plain5, read_interval=3, read_lease_ticks=2,
                                    election_min_ticks=8)
    lease = live(lease_cfg) - live(dataclasses.replace(plain5, read_interval=3))
    assert {f for _, f in lease} == {"read_fr", "viol_read_stale", "heard_clock"}
    # The storage plane: the watermarks both ways, the disk draws in, the
    # lag pair out.
    dur = live(dataclasses.replace(plain5, fsync_interval=3)) - live(plain5)
    assert dur == {
        ("state", "dur_len"), ("state_out", "dur_len"),
        ("state", "dur_term"), ("state_out", "dur_term"),
        ("state", "dur_vote"), ("state_out", "dur_vote"),
        ("inputs", "fsync_fire"), ("inputs", "torn_drop"),
        ("info_out", "fsync_lag_sum"), ("info_out", "fsync_lag_max"),
    }


def test_lm_skipped_pairs_leg_is_live_only_with_ring_log_matching():
    """The kernel writes StepInfo.lm_skipped_pairs only where the ring form
    of log matching runs (compaction with log matching on); elsewhere the
    wrapper hands back zeros."""
    def live(cfg):
        return {(g, f) for g, f in tick_engine.PTR_ORDER if tick_engine.leg_live(cfg, g, f)}

    ring = tconfig.PRESETS["config6"][0]
    assert live(dataclasses.replace(ring, check_log_matching=True)) - live(ring) == {
        ("info_out", "lm_skipped_pairs")}
    prefix = tconfig.PRESETS["config2"][0]
    assert live(dataclasses.replace(prefix, check_log_matching=True)) == live(prefix)
