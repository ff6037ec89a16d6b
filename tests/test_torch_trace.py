"""The port's protocol trace plane (raft_sim_tpu_torch/trace: events, ring,
history) through its telemetry loop, against the JAX package's on the CPU at
a small size: the same seed gives the same trace windows (every event slot,
count and coverage word), the same carried TracePersist and the same
histories; a traced run follows the untraced trajectory; the fault facts
equal JAX's `trace_fault_inputs` (tick 0 included, scalar and genome paths);
the events agree with a B=1 replay's state deltas and with the inputs;
overflow is counted, never silent; coverage is deterministic and bounded;
the flight recorder freezes on an event kind; and the windowed loop's span
draws equal its per-tick draws.

Tolerance: exact equality of every leaf (value, dtype, shape) and event.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_sim_tpu.sim import faults as jfaults
from raft_sim_tpu.sim import telemetry as jtel
from raft_sim_tpu.trace import events as jev
from raft_sim_tpu.trace import history as jhistory
from raft_sim_tpu.trace.ring import TraceSpec as JSpec
from raft_sim_tpu.utils.config import RaftConfig as JConfig
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.scenario import genome as tgenome
from raft_sim_tpu_torch.sim import faults as tfaults
from raft_sim_tpu_torch.sim import scan as tscan
from raft_sim_tpu_torch.sim import telemetry as ttel
from raft_sim_tpu_torch.trace import checker as tchecker
from raft_sim_tpu_torch.trace import events as tev
from raft_sim_tpu_torch.trace import history as thistory
from raft_sim_tpu_torch.trace.ring import COV_BITS, TraceSpec, cov_popcount
from raft_sim_tpu_torch.types import NIL
from raft_sim_tpu_torch.utils.config import RaftConfig

torch.set_num_threads(1)

# A fault-rich little fleet (the JAX trace tests' own): client traffic, drops,
# crashes and rolling partitions, so most event kinds fire.
KW = dict(n_nodes=5, client_interval=4, drop_prob=0.2, crash_prob=0.2, crash_period=32,
          crash_down_ticks=8, partition_period=16, partition_prob=0.3)
CFG, CFG_T = RaftConfig(**KW), RaftConfig(**KW, track_trace=True)
JCFG_T = JConfig(**KW, track_trace=True)
SEED, BATCH, TICKS, WINDOW, DEPTH = 3, 4, 96, 32, 256


@functools.lru_cache(maxsize=1)
def runs():
    """(JAX traced run, port traced run) of simulate_windowed, with a 4-deep
    flight recorder armed on the first LEADER event."""
    want = jax.device_get(jtel.simulate_windowed(JCFG_T, SEED, BATCH, TICKS, WINDOW, 4, None, 1,
                                                 JSpec(depth=DEPTH), jev.EV_LEADER))
    got = ttel.simulate_windowed(CFG_T, SEED, BATCH, TICKS, WINDOW, ring=4,
                                 trace=TraceSpec(depth=DEPTH), trigger_kind=tev.EV_LEADER,
                                 device="cpu")
    return want, got


def test_slot_tables_and_kind_order():
    n = CFG.n_nodes
    assert tev.KINDS == jev.KINDS and tev.N_KINDS == jev.N_KINDS
    assert tev.PER_NODE_KINDS == jev.PER_NODE_KINDS and tev.CLUSTER_KINDS == jev.CLUSTER_KINDS
    for n in (2, 5, 51, 101):
        assert np.array_equal(tev.slot_kinds(n), jev.slot_kinds(n))
        assert np.array_equal(tev.slot_nodes(n), jev.slot_nodes(n))
        assert tev.n_slots(n) == jev.n_slots(n) == len(tev.slot_kinds(n))
    kinds = tev.slot_kinds(CFG.n_nodes)
    assert sorted(tev.KINDS.values()) == list(range(1, tev.N_KINDS))
    assert list(kinds) == sorted(kinds)  # kind-major: slot order is event order
    assert max(tev.EV_FOLLOWER, tev.EV_PRECANDIDATE, tev.EV_CANDIDATE,
               tev.EV_LEADER) < tev.EV_COMMIT
    assert tev.EV_TRUNCATE < tev.EV_CRASH <= tev.EV_RESTART
    assert list(tev.slot_nodes(CFG.n_nodes)[-len(tev.CLUSTER_KINDS):]) == [NIL] * 2
    for k in range(tev.N_KINDS):  # the contiguous row block of each kind
        rows = tev.kind_rows(CFG.n_nodes, k)
        assert list(range(len(kinds))[rows]) == list(np.flatnonzero(kinds == k))


def test_traced_windows_match_jax():
    want, got = runs()
    assert len(got) == 6
    for part, w, g in zip(("state", "metrics", "records", "recorder", "trace windows",
                           "trace persist"), want, got):
        assert bridge.first_difference(w, g) is None, part
    assert int(got[4].win.n.sum()) > 0


def test_traced_run_does_not_perturb_trajectory():
    """The untraced config's run, and the gate alone (track_trace, no trace
    asked for), equal the traced run's state, metrics and records."""
    _, got = runs()
    plain = ttel.simulate_windowed(CFG, SEED, BATCH, TICKS, WINDOW, device="cpu")
    for part, w, g in zip(("state", "metrics", "records"), plain, got):
        assert bridge.first_difference(w, g) is None, part
    gate = ttel.simulate_windowed(CFG_T, SEED, BATCH, WINDOW, WINDOW, device="cpu")
    short = ttel.simulate_windowed(CFG, SEED, BATCH, WINDOW, WINDOW, device="cpu")
    assert len(gate) == 4
    for part, w, g in zip(("state", "metrics", "records"), short, gate):
        assert bridge.first_difference(w, g) is None, part


def test_trace_requires_track_trace():
    with pytest.raises(ValueError, match="track_trace"):
        ttel.simulate_windowed(CFG, SEED, BATCH, TICKS, WINDOW, trace=TraceSpec(depth=8),
                               device="cpu")
    with pytest.raises(ValueError, match="track_trace"):
        ttel.simulate_windowed(CFG, SEED, BATCH, TICKS, WINDOW, ring=4,
                               trigger_kind=tev.EV_LEADER, device="cpu")


def test_history_counts_and_windows():
    want, got = runs()
    hist = thistory.from_device(got[4])
    jhist = jhistory.from_device(want[4])
    assert dataclasses.asdict(hist) == dataclasses.asdict(jhist)
    assert hist.complete and hist.n_windows == TICKS // WINDOW
    total = got[5].total.numpy()
    for c in range(BATCH):
        assert hist.emitted[c] == int(total[c])
        assert len(hist.events[c]) == hist.emitted[c] - hist.dropped[c]
        ticks = [e.tick for e in hist.events[c]]
        assert ticks == sorted(ticks)
    rep = tchecker.check_history(hist)
    assert rep.complete and rep.ok, {n: r.note for n, r in rep.results.items() if not r.ok}


def _delta_events(states, init, cluster):
    """The delta-derived kinds (follower .. truncate) of one cluster, from a
    replay's per-tick states ([T, N] leaves) and its initial state."""
    fields = ("role", "term", "voted_for", "commit_index", "log_len")
    g0 = {f: getattr(init, f)[cluster].numpy() for f in fields}
    gs = {f: getattr(states, f)[0].numpy() for f in fields}
    out = []
    for t in range(gs["role"].shape[0]):
        old = g0 if t == 0 else {f: gs[f][t - 1] for f in fields}
        new = {f: gs[f][t] for f in fields}
        per_kind = {
            tev.EV_FOLLOWER: ((new["role"] == 0) & (old["role"] != 0), new["term"]),
            tev.EV_PRECANDIDATE: ((new["role"] == 3) & (old["role"] != 3), new["term"]),
            tev.EV_CANDIDATE: ((new["role"] == 1) & (old["role"] != 1), new["term"]),
            tev.EV_LEADER: ((new["role"] == 2) & (old["role"] != 2), new["term"]),
            tev.EV_TERM: (new["term"] > old["term"], new["term"]),
            tev.EV_VOTE: ((new["voted_for"] != old["voted_for"]) & (new["voted_for"] != NIL),
                          new["voted_for"]),
            tev.EV_COMMIT: (new["commit_index"] > old["commit_index"], new["commit_index"]),
            tev.EV_APPEND: (new["log_len"] > old["log_len"], new["log_len"]),
            tev.EV_TRUNCATE: (new["log_len"] < old["log_len"], new["log_len"]),
        }
        for kind in sorted(per_kind):
            flags, detail = per_kind[kind]
            out += [(t, node, kind, int(detail[node])) for node in np.flatnonzero(flags)]
    return out


def test_device_events_match_b1_replay():
    """Each cluster replayed alone (scan.run_traced at B=1, on the scenario
    path under the config's own homogeneous genome: the scalar trajectory)
    gives, state delta by state delta, the traced fleet's events."""
    _, got = runs()
    hist = thistory.from_device(got[4])
    state, keys = tscan.seed_fleet(CFG_T, SEED, BATCH, "cpu")
    g1 = tgenome.broadcast(tgenome.from_config(CFG_T), 1)
    for c in range(BATCH):
        one = tscan.raft_batched._map(lambda x: x[c:c + 1].contiguous(), state)
        _, _, (_, states) = tscan.run_traced(CFG_T, one, keys[c:c + 1], TICKS, genome=g1)
        want = _delta_events(states, state, c)
        assert want and [(e.tick, e.node, e.kind, e.detail) for e in hist.events[c]
                         if e.kind <= tev.EV_TRUNCATE] == want, c


def test_fault_events_consistent_with_inputs():
    """Every restart event is a `restarted` input, every crash event a crash
    edge of `alive`, and every partition event a change of the cut."""
    _, got = runs()
    hist = thistory.from_device(got[4])
    _, keys = tscan.seed_fleet(CFG_T, SEED, BATCH, "cpu")
    kinds = {tev.EV_RESTART: 0, tev.EV_CRASH: 0, tev.EV_PARTITION: 0}
    for c in range(BATCH):
        for e in hist.events[c]:
            if e.kind not in kinds:
                continue
            kinds[e.kind] += 1
            now, prev = (tfaults.make_inputs(CFG_T, keys[c:c + 1], t) for t in (e.tick, e.tick - 1))
            if e.kind == tev.EV_RESTART:
                assert bool(now.restarted[0, e.node]), e
            elif e.kind == tev.EV_CRASH:
                assert not bool(now.alive[0, e.node]) and bool(prev.alive[0, e.node]), e
            else:
                assert e.detail == int(tfaults.trace_fault_inputs(CFG_T, keys[c:c + 1],
                                                                  e.tick)[1][0]), e
    assert all(kinds.values()), kinds


@functools.lru_cache(maxsize=2)
def _jax_facts_fn(with_genome: bool):
    """jit(vmap(JAX trace_fault_inputs)) over (keys, now, genome)."""
    def one(k, now, g):
        return jfaults.trace_fault_inputs(JCFG_T, k, now, genome=g, seg_len=8)

    if with_genome:
        return jax.jit(lambda k, now, g: jax.vmap(one, in_axes=(0, None, 0))(k, now, g))
    return jax.jit(lambda k, now: jax.vmap(lambda kk: one(kk, now, None))(k))


def test_trace_fault_inputs_match_jax_including_tick_zero():
    """The scalar path at ticks 0, 1 and across crash and partition window
    edges, and the genome path (a numpy-made [B, 2] genome of mixed crash and
    partition settings, segments of 8 ticks) at the same ticks and in one
    span call: crashed, cut_now and cut_prev equal JAX's."""
    from raft_sim_tpu.scenario import genome as jgenome

    _, keys = tscan.seed_fleet(CFG_T, SEED, BATCH, "cpu")
    jkeys = jax.random.split(jax.random.split(jax.random.key(SEED))[1], BATCH)
    rng = np.random.default_rng(11)
    rows = [[dict(drop_prob=0.1, partition_period=int(rng.integers(0, 20)),
                  partition_prob=float(rng.uniform(0, 1)), crash_prob=float(rng.uniform(0, 0.6)),
                  crash_down_ticks=int(rng.integers(1, 33))) for _ in range(2)]
            for _ in range(BATCH)]
    tg = tgenome.stack_rows([tgenome.from_segments([tgenome.segment(**kw) for kw in r])
                             for r in rows])
    jg = jgenome.stack_rows([jgenome.from_segments([jgenome.segment(**kw) for kw in r])
                             for r in rows])
    ticks = (0, 1, 15, 16, 17, 31, 32, 33)
    for t in ticks:
        now = jnp.int32(t)
        for want, got in ((jax.device_get(_jax_facts_fn(False)(jkeys, now)),
                           tfaults.trace_fault_inputs(CFG_T, keys, t)),
                          (jax.device_get(_jax_facts_fn(True)(jkeys, now, jg)),
                           tfaults.trace_fault_inputs(CFG_T, keys, t, genome=tg, seg_len=8))):
            for w, g in zip(want, got):
                assert np.array_equal(np.asarray(w), g.numpy()), t
    # Drawn beside the inputs, the inputs are the plain draw's; a span of
    # ticks in one call (draw_span) gives each tick's facts and inputs.
    span_inp, span = tfaults.draw_span(CFG_T, keys, 0, 34, tg, 8, facts=True)
    for t in ticks:
        for genome in (None, tg):
            inp, _ = tfaults.make_inputs(CFG_T, keys, t, genome=genome, seg_len=8, facts=True)
            plain = tfaults.make_inputs(CFG_T, keys, t, genome=genome, seg_len=8)
            assert bridge.first_difference(plain, inp) is None, t
        want = tfaults.trace_fault_inputs(CFG_T, keys, t, genome=tg, seg_len=8)
        for w, g in zip(want, span):
            assert torch.equal(w, g[t]), t
        assert bridge.first_difference(plain, type(span_inp)(*(x[t] for x in span_inp))) is None


def test_overflow_is_flagged_never_silent():
    """Depth 4: the clamped windows equal JAX's, the history counts the
    drops, and the checker leaves every property undecided."""
    want = jax.device_get(jtel.simulate_windowed(JCFG_T, SEED, BATCH, 64, 32, 0, None, 1,
                                                 JSpec(depth=4)))
    got = ttel.simulate_windowed(CFG_T, SEED, BATCH, 64, 32, trace=TraceSpec(depth=4),
                                 device="cpu")
    assert bridge.first_difference(want[4], got[4]) is None
    assert bridge.first_difference(want[5], got[5]) is None
    hist = thistory.from_device(got[4])
    assert any(hist.dropped.values()) and not hist.complete
    rep = tchecker.check_history(hist)
    assert not rep.ok and rep.violated == []
    assert all(r.ok is None for r in rep.results.values())
    assert "incomplete" in rep.results["election_safety"].note


def test_coverage_deterministic_bounded_and_monotone():
    _, got = runs()
    # The same (shorter) run twice gives the same coverage words.
    once, again = (ttel.simulate_windowed(CFG_T, SEED, 2, 32, 32, trace=TraceSpec(depth=8),
                                          device="cpu")[5].cov for _ in range(2))
    assert torch.equal(once, again) and bool((cov_popcount(once) > 0).all())
    traws, tp = got[4], got[5]
    bits = cov_popcount(tp.cov)
    assert bool((bits > 0).all()) and bool((bits <= COV_BITS).all())
    cov_w = traws.cov  # [W, C, B]
    for w in range(1, cov_w.shape[0]):
        assert torch.equal(cov_w[w] & cov_w[w - 1], cov_w[w - 1])
    assert torch.equal(cov_w[-1], tp.cov)


def test_flight_recorder_event_trigger():
    """Armed on the first LEADER event, the recorder freezes at each
    cluster's first election, that tick its newest entry (the recorder
    equals JAX's: test_traced_windows_match_jax)."""
    _, got = runs()
    rec, hist = got[3], thistory.from_device(got[4])
    for c in range(BATCH):
        leads = [e.tick for e in hist.events[c] if e.kind == tev.EV_LEADER]
        assert bool(rec.frozen[c]) == bool(leads)
        if leads:
            ticks, _ = ttel.export_cluster(rec, c)
            assert ticks[-1] == leads[0]


def test_span_draws_equal_per_tick_draws(monkeypatch):
    """A small fleet on the scenario path draws the traced loop's inputs and
    fault facts a span of ticks at a time; drawing them tick by tick gives
    the same run, trace windows and persist."""
    g = tgenome.broadcast(tgenome.from_config(CFG_T), 2)
    spec = TraceSpec(depth=64, freeze_kind=tev.EV_COMMIT)
    spans = ttel.simulate_windowed(CFG_T, 5, 2, 64, 32, genome=g, trace=spec, device="cpu")
    monkeypatch.setattr(tscan, "spans_pay", lambda batch: False)
    ticks = ttel.simulate_windowed(CFG_T, 5, 2, 64, 32, genome=g, trace=spec, device="cpu")
    for part, w, x in zip(("state", "metrics", "records", "recorder", "windows", "persist"),
                          ticks, spans):
        if w is not None:
            assert bridge.first_difference(w, x) is None, part
    assert bool(spans[5].frozen.all())  # the freeze kind latched


def test_extraction_reads_the_intact_pre_tick_state():
    """The extractor reads the pre-tick state after the tick ran: the tick
    returns fresh tensors for every leg it writes, so the old state is
    intact, and the events equal those from a deep copy of it."""
    state, keys = tscan.seed_fleet(CFG_T, SEED, 2, "cpu")
    s = tscan.raft_batched.to_batch_minor(state)
    m = tscan.raft_batched.to_batch_minor(tscan.init_metrics_batch(2, "cpu"))
    for t in range(16):
        before = tscan.raft_batched._map(torch.clone, s)
        s2, m, info, ev = tscan.tick_batch_minor(CFG_T, s, keys, m, t, events=True)
        assert bridge.first_difference(before, s) is None
        inp = tscan.raft_batched.to_batch_minor(tfaults.make_inputs(CFG_T, keys, t))
        crashed, cut_now, cut_prev = tfaults.trace_fault_inputs(CFG_T, keys, t)
        again = tev.extract(CFG_T, before, s2, inp, info, crashed.T, cut_now, cut_prev)
        assert bridge.first_difference(again, ev) is None
        s = s2
