"""Pass E's interval interpreter (raft_sim_tpu_torch/analysis/interval.py):
value ranges proven over a captured graph of the port's tick, held against
the JAX package's pins (tests/golden_ranges.json) and witnessed by the
observing pass.

One seeded negative per rule, as tests/test_range_audit.py has them for the
JAX interpreter; the tick-genericity guard (every tier's programs capture
one op stream at two ticks, and a host branch on the tick is caught);
soundness (every value the observing pass sees lies inside its leg's proven
interval, on all twelve tiers); JAX parity (every leg equals JAX's record
or is listed, with a reason, in the golden's `jax_differs`); the handlers'
traps; and the interval leg's CPU budget, timed apart from the observing
pass's.
"""

from __future__ import annotations

import copy
import json
import re
import time

import pytest
import torch

from raft_sim_tpu_torch.analysis import interval, op_audit, policy, range_audit
from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.utils.config import PRESETS

torch.set_num_threads(1)

CFG3 = PRESETS["config3"][0]


def _hits(findings, rule: str, needle: str):
    return [f for f in findings if f.rule == rule and needle in f.message]


def _show(findings):
    return [f"{f.rule} {f.path}: {f.message}" for f in findings]


@pytest.fixture(scope="module")
def head():
    """The interval leg derived on the tree from a cold cache, its CPU
    seconds, and the observing pass it is witnessed by."""
    range_audit._derive_intervals.cache_clear()
    t0 = time.process_time()
    dint, captures, found = range_audit.derive_intervals()
    cpu_s = time.process_time() - t0
    observed, _ = range_audit.derive_all()
    return dint, captures, found, cpu_s, observed


@pytest.fixture(scope="module")
def sim3():
    return interval.capture_program("config3", CFG3, "simulate")


@pytest.fixture(scope="module")
def golden():
    with open(range_audit.golden_path()) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_tiers():
    with open(range_audit.jax_golden_path()) as f:
        return json.load(f)["tiers"]


# ------------------------------------------------------------- gate on head


def test_interval_leg_clean_on_head_within_budget(head, golden):
    dint, _, found, cpu_s, _ = head
    assert found == [], _show(found)
    assert range_audit.compare_intervals(dint, golden) == []
    assert cpu_s < 90.0  # the interval leg's own budget, in CPU seconds


def test_every_program_of_every_tier_is_derived(head):
    dint, captures, _, _, _ = head
    assert set(dint["tiers"]) == set(op_audit.AUDIT_CONFIGS)
    for name, caps in captures.items():
        for variant in interval.PROGRAMS:
            assert caps[variant]["hash"] == caps[variant]["hash_second_tick"], (name, variant)
            assert caps[variant]["nodes"] > 1000
        assert caps["scenario_simulate"] == {"same_capture_as": "simulate"}
    assert dint["shared_captures"] == {"scenario_simulate": "simulate"}


@pytest.mark.parametrize("name", op_audit.AUDIT_CONFIGS)
def test_record_names_every_carry_leg_metrics_included(head, name):
    legs = head[0]["tiers"][name]["legs"]
    assert list(legs) == policy.carry_leaf_names() and len(legs) == 90
    assert sum(leg.startswith("metric.") for leg in legs) == 21
    assert head[0]["tiers"][name]["unknown_ops"] == []


# ---------------------------------------------------------------- soundness


@pytest.mark.parametrize("name", op_audit.AUDIT_CONFIGS)
def test_witness_lies_inside_the_proof(head, name):
    """Every value the observing pass watched (run_tier: B = 4, the tier's
    AUDIT_TICKS) lies inside its leg's proven interval; a rate leg's within
    entry + rate x tick."""
    dint, _, _, _, observed = head
    cfg = PRESETS[name][0]
    legs = dint["tiers"][name]["legs"]
    assert range_audit.check_witness(name, cfg, observed["tiers"][name], legs) == []


def test_a_proof_narrower_than_the_run_fails_the_witness(head):
    dint, _, _, _, observed = head
    legs = copy.deepcopy(dint["tiers"]["config6"]["legs"])
    assert "rate" in legs["log_val"] and legs["log_val"]["lo"] == -2  # the NOOP value
    legs["log_val"]["lo"] = 0
    legs["clock"]["rate"] = 0
    got = range_audit.check_witness("config6", PRESETS["config6"][0],
                                    observed["tiers"]["config6"], legs)
    assert {f.rule for f in got} == {"range-golden"}
    assert _hits(got, "range-golden", "`log_val`") and _hits(got, "range-golden", "`clock`")


# --------------------------------------------------------------- JAX parity


def unexplained(name: str, legs: dict, jax_tiers: dict, differs: dict) -> list[str]:
    """The legs of `legs` whose record is not JAX's and that `differs` does
    not list with both records and a reason."""
    out = []
    for leg, rec in legs.items():
        j = jax_tiers[name]["legs"].get(leg)
        if rec == j:
            continue
        entry = differs.get(leg)
        if entry is None or entry["port"] != rec or entry["jax"] != j or not entry["reason"]:
            out.append(leg)
    return out


@pytest.mark.parametrize("name", op_audit.AUDIT_CONFIGS)
def test_every_leg_equals_jax_or_is_listed_with_a_reason(head, golden, jax_tiers, name):
    legs = head[0]["tiers"][name]["legs"]
    pinned = golden["interval"]["tiers"][name]
    assert pinned["legs"] == legs
    assert unexplained(name, legs, jax_tiers, pinned["jax_differs"]) == []
    assert set(pinned["jax_differs"]) == {leg for leg in legs
                                          if legs[leg] != jax_tiers[name]["legs"][leg]}
    # Every reason is the hand-kept table's, none generated.
    reasons = range_audit.load_jax_reasons()
    assert {leg: e["reason"] for leg, e in pinned["jax_differs"].items()} == {
        leg: reasons[(name, leg)] for leg in pinned["jax_differs"]}


def test_a_divergence_without_a_reason_fires_and_update_goldens_refuses(monkeypatch, tmp_path):
    """A leg that differs from JAX with no entry in analysis/jax_differs.json
    is a finding, and --update-goldens writes nothing until it has one; a
    reason for a leg that equals JAX's is a stale entry."""
    table = dict(range_audit.load_jax_reasons())
    assert ("config3", "votes") in table and ("config3", "term") not in table
    del table[("config3", "votes")]
    table[("config3", "term")] = "a stale reason"
    monkeypatch.setattr(range_audit, "load_jax_reasons", lambda path=None: table)
    range_audit._derive_intervals.cache_clear()
    try:
        doc, _caps, finds = range_audit.derive_intervals(("config3",))
        out = tmp_path / "golden.json"
        with pytest.raises(range_audit.UnexplainedDivergence, match="config3/votes"):
            range_audit.update_golden(str(out), ("config3",))
    finally:
        range_audit._derive_intervals.cache_clear()
    assert doc["tiers"]["config3"]["jax_differs"]["votes"]["reason"] is None
    assert _hits(finds, "range-golden", "`votes`") and "gives no reason" in _hits(
        finds, "range-golden", "`votes`")[0].message
    assert _hits(finds, "range-golden", "`term`: analysis/jax_differs.json gives a reason")
    assert not out.exists()


def test_reason_table_names_each_pair_once(tmp_path):
    path = tmp_path / "reasons.json"
    path.write_text(json.dumps({"reasons": [
        {"tiers": ["config3"], "legs": ["votes", "term"], "reason": "a"},
        {"tiers": ["config3", "config4"], "legs": ["votes"], "reason": "b"}]}))
    with pytest.raises(ValueError, match="config3/votes"):
        range_audit.load_jax_reasons(str(path))


def test_a_leg_differing_from_jax_unlisted_fails(head, golden, jax_tiers):
    legs = head[0]["tiers"]["config6"]["legs"]
    differs = dict(golden["interval"]["tiers"]["config6"]["jax_differs"])
    dropped = sorted(differs)[0]
    del differs[dropped]
    assert unexplained("config6", legs, jax_tiers, differs) == [dropped]
    g = copy.deepcopy(golden)
    g["interval"]["tiers"]["config6"]["jax_differs"] = differs
    got = range_audit.compare_intervals(head[0], g)
    assert len(got) == 1 and got[0].path == "range:config6/golden"
    assert f"jax_differs/{dropped}" in got[0].message


def test_most_legs_equal_jax(head, jax_tiers):
    """The proof reproduces JAX's record on most legs of every tier, not
    only on the listed ones."""
    for name, tier in head[0]["tiers"].items():
        same = sum(rec == jax_tiers[name]["legs"][leg] for leg, rec in tier["legs"].items())
        assert same >= 54, (name, same)


@pytest.mark.parametrize("name", op_audit.AUDIT_CONFIGS)
def test_jax_horizon_legs_have_a_measured_horizon_past_the_soak(head, jax_tiers, name):
    legs = head[0]["tiers"][name]["legs"]
    for leg, j in jax_tiers[name]["legs"].items():
        if "horizon" in j and interval.protocol_leg(leg):
            assert "rate" in legs[leg] and legs[leg]["horizon"] >= interval.SOAK_TICKS, leg


def test_leg_copying_a_faster_leg_is_gated_on_its_recorded_horizon():
    """`b` grows by 1 in the first iterations but copies `a` (2 a tick) less
    100: the widened image raises its rate to 2, and the range-horizon gate
    reads the horizon the record pins."""
    a = torch.zeros((), dtype=torch.int16)
    b = torch.zeros((), dtype=torch.int16)
    prog = _loop(lambda: {"a": torch.zeros((), dtype=torch.int16),
                          "b": torch.zeros((), dtype=torch.int16)},
                 lambda: {"a": a + 2, "b": torch.maximum(b + 1, a - 100)}, ["a", "b"],
                 {"a": a, "b": b})
    finds, rec, _ = range_audit.audit_program(prog, declared={}, leg_names=["a", "b"])
    assert rec["b"]["rate"] == 2 and rec["b"]["hi"] == 0
    for leg in ("a", "b"):
        hit = _hits(finds, "range-horizon", f"`{leg}`")
        assert len(hit) == 1, _show(finds)
        gated = int(re.search(r"wraps after ~([\d,]+) ticks", hit[0].message)[1].replace(",", ""))
        assert gated == rec[leg]["horizon"] == 32767 // 2


def test_measured_horizon_is_the_dtype_headroom_over_the_rate(head):
    for name, tier in head[0]["tiers"].items():
        for leg, rec in tier["legs"].items():
            if "rate" in rec:
                top = 2**31 - 1 if rec["dtype"] == "int32" else torch.iinfo(
                    getattr(torch, rec["dtype"])).max
                want = min((top - rec["hi"]) // rec["rate"], interval.HORIZON_CAP)
                assert rec["rate"] >= 1 and rec["horizon"] == want, (name, leg, rec)


# ---------------------------------------------------- seeded negatives


def test_seeded_widened_index_leg_fires_dtype_overflow(sim3):
    declared = dict(range_audit.proof_declared(CFG3))
    assert "next_index" in declared
    declared["next_index"] = (1, 200)  # the int8 plane tops out at 127
    finds, _rec, _ = range_audit.audit_program(sim3, declared=declared)
    hits = _hits(finds, "range-dtype-overflow", "`next_index`")
    assert hits and "does not fit" in hits[0].message, _show(finds)


def _interp_fn(fn, inputs: dict, seeds: dict):
    g = interval.capture(fn, inputs)
    finds: list = []
    it = interval.Interp("range:seeded/fn", finds)
    env = it.run(g, it.env(g, seeds))
    return finds, {k: env[s] for k, s in g.outputs.items()}


def test_seeded_unclipped_gather_index_fires_index_oob():
    # The capture runs on in-bounds values; the seeds give the intervals.
    x = torch.zeros(8, dtype=torch.int32)
    i = torch.zeros(3, dtype=torch.int64)
    j = torch.ones(3, dtype=torch.int64)

    def f():
        return {"y": x.gather(0, i), "z": x.gather(0, j - 1)}

    finds, _ = _interp_fn(f, {"x": x, "i": i, "j": j},
                          {"x": interval.TOP, "i": (9, 9, False), "j": (0, 7, False)})
    assert _hits(finds, "range-index-oob", "[9, 9] is not within [0, 7]"), _show(finds)
    # A negative index, which torch would wrap to the last slot silently.
    assert _hits(finds, "range-index-oob", "[-1, 6]"), _show(finds)


def test_clamped_index_discharges_the_proof():
    x = torch.zeros(8, dtype=torch.int32)
    i = torch.zeros(3, dtype=torch.int64)
    finds, _ = _interp_fn(lambda: {"y": x.gather(0, (i - 1).clamp(0, 7))}, {"x": x, "i": i},
                          {"x": interval.TOP, "i": interval.TOP})
    assert finds == []


def test_seeded_stale_declared_range_fires_annotation_stale(sim3):
    declared = dict(range_audit.proof_declared(CFG3))
    assert "commit_index" in declared
    declared["commit_index"] = (5, 9)  # the initial commit index is 0
    finds, _rec, _ = range_audit.audit_program(sim3, declared=declared)
    hits = _hits(finds, "range-annotation-stale", "`commit_index`")
    assert hits and "[5, 9]" in hits[0].message, _show(finds)


def _loop(init, body, names, carry0):
    g_init = interval.capture(init, {})
    g_body = interval.capture(body, carry0)
    return interval.Program("range:seeded/loop", CFG3, g_init, g_body, names, {}, (0, 1),
                            g_body.hash)


def test_seeded_int16_term_leg_fires_horizon_below_soak():
    term = torch.zeros((), dtype=torch.int16)
    prog = _loop(lambda: {"term": torch.zeros((), dtype=torch.int16)},
                 lambda: {"term": term + 1}, ["term"], {"term": term})
    finds, rec, _ = range_audit.audit_program(prog, declared={}, leg_names=["term"])
    hits = _hits(finds, "range-horizon", "`term`")
    assert hits, _show(finds)
    assert rec["term"]["rate"] == 1 and rec["term"]["horizon"] == 32767 < interval.SOAK_TICKS


def test_missing_target_loop_is_visible_not_silent():
    a = torch.zeros((), dtype=torch.int32)
    prog = _loop(lambda: {"a": torch.zeros((), dtype=torch.int32)}, lambda: {"a": a + 1}, ["a"],
                 {"a": a})
    finds, rec, _ = range_audit.audit_program(prog, declared={}, leg_names=["a", "b"])
    assert rec is None
    assert _hits(finds, "range-golden", "NOT being checked")
    assert _hits(finds, "range-golden", "2-leg carry")


def test_derivation_exception_is_visible_not_silent(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("seeded derivation failure")

    range_audit._derive_intervals.cache_clear()
    monkeypatch.setattr(interval, "capture_program", boom)
    try:
        _doc, _caps, finds = range_audit.derive_intervals(("config3",))
    finally:
        range_audit._derive_intervals.cache_clear()
    hits = _hits(finds, "range-golden", "NOT being checked")
    assert len(hits) == len(interval.PROGRAMS) and "seeded derivation failure" in hits[0].message


# ------------------------------------------------------- tick-genericity


def _branching_tick(read_in_the_open: bool):
    def tick(cfg, s, keys, m, now, step_fn=None, **kw):
        if read_in_the_open:
            t = int(s.now[0])  # a device read the recorder sees
        else:
            with torch.utils._python_dispatch._disable_current_modes():
                t = int(s.now[0])  # a host copy of the tick, as a Python loop keeps one
        out = scan.tick_batch_minor(cfg, s, keys, m, now, step_fn=step_fn, **kw)
        if t % 2:
            out = (out[0]._replace(term=out[0].term + 0),) + tuple(out[1:])
        return out
    return tick


def test_seeded_host_branch_on_the_tick_fires_golden():
    prog = interval.capture_program("config3", CFG3, "simulate",
                                    tick_fn=_branching_tick(False))
    assert prog.body.hash != prog.hash_b
    finds, rec, _ = range_audit.audit_program(prog)
    assert rec is None
    assert _hits(finds, "range-golden", "differs between ticks"), _show(finds)
    assert _hits(finds, "range-golden", "NOT being checked")


def test_seeded_device_read_on_the_host_fires_golden():
    prog = interval.capture_program("config3", CFG3, "simulate",
                                    tick_fn=_branching_tick(True))
    finds, rec, _ = range_audit.audit_program(prog)
    assert rec is None
    assert _hits(finds, "range-golden", "reads a device value on the host"), _show(finds)


def test_probe_ticks_differ_in_residue_for_every_cadence():
    for name in op_audit.AUDIT_CONFIGS:
        cfg = PRESETS[name][0]
        ta, tb = interval.probe_ticks(cfg)
        assert ta > 0 and all(ta % c != tb % c for c in interval.cadences(cfg)), name


def test_log_matching_cadence_runs_both_arms():
    """config5's log-matching cadence (every 16 ticks) is a host branch: the
    capture runs step_b under both arms and joins them."""
    cfg = PRESETS["config5"][0]
    assert interval.lm_branch(cfg) and not interval.lm_branch(CFG3)
    prog = interval.capture_program("config5", cfg, "simulate")
    joins = sum(n.op == "__join__" for n in prog.body.nodes)
    assert joins > 0 and prog.body.hash == prog.hash_b


def test_uniform_drop_rate_genome_equals_the_scalar_path():
    """config4's hidden per-cluster drop rate rides the genome's drop leaf,
    so the captured genome path draws what the scalar path does."""
    from raft_sim_tpu_torch.kernels import draw_engine

    cfg = PRESETS["config4"][0]
    assert cfg.drop_prob_uniform
    _, keys = scan.seed_fleet(cfg, 3, 6, torch.device("cpu"))
    g = interval.audit_genome(cfg, keys)
    for t in (0, 1, 7):
        a = draw_engine.draw_plain(cfg, keys, t)
        b = draw_engine.draw_plain(cfg, keys, torch.full((6,), t, dtype=torch.int32),
                                   genome=g, seg_len=1)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------- handler traps


def _one(fn, seeds: dict, dtype=torch.int64):
    x = torch.zeros(4, dtype=dtype)
    y = torch.ones(4, dtype=dtype)
    finds, out = _interp_fn(lambda: {"r": fn(x, y)}, {"x": x, "y": y}, seeds)
    return finds, out["r"]


@pytest.mark.parametrize("fn, seeds, want", [
    # floor-mod: a positive divisor gives [0, d - 1] whatever the dividend
    (lambda x, y: x % 7, {"x": interval.TOP}, (0, 6)),
    (lambda x, y: torch.remainder(x, y), {"x": (-50, 50, False), "y": (3, 5, False)}, (0, 4)),
    # x & c for a non-negative c lies in [0, c]
    (lambda x, y: x & 0xFFFF, {"x": interval.TOP}, (0, 0xFFFF)),
    (lambda x, y: (x ^ y) & 0xFFFFFFFF, {"x": interval.TOP, "y": interval.TOP}, (0, 2**32 - 1)),
    (lambda x, y: torch.where(x > 3, x, y), {"x": (5, 9, False), "y": (0, 0, False)}, (5, 9)),
    (lambda x, y: x.clamp(0, 3), {"x": interval.TOP}, (0, 3)),
    (lambda x, y: (x >> 4) + 1, {"x": (0, 255, False)}, (1, 16)),
    (lambda x, y: x.sum(0), {"x": (0, 3, False)}, (0, 12)),
])
def test_handler_interval(fn, seeds, want):
    finds, got = _one(fn, dict({"x": (0, 0, False), "y": (1, 1, False)}, **seeds))
    assert finds == [] and got[:2] == want


def test_uint32_carrier_cast_and_product_do_not_fire():
    """The package's uint32 word arithmetic (interval.WORD_ARITHMETIC) is
    modular by design: the checksum's products of words carried in int64,
    and a lane packed into a word's top bit (cast to and shifted in the
    int32 carrier), give no finding and an unknown value."""
    from raft_sim_tpu_torch.ops import log_ops, tile

    finds, got = _one(lambda x, y: log_ops.chk_weights_at(x)[0], {"x": interval.TOP})
    assert finds == [] and got[:2] == (1, 2**32 - 1)  # odd, masked after the wrapping product
    lanes = torch.zeros(8, 3, dtype=torch.int64)
    finds, out = _interp_fn(lambda: {"w": tile.pack_words(lanes, 4)}, {"lanes": lanes},
                            {"lanes": (0, 15, False)})
    assert finds == [] and out["w"][:2] == (None, None)


@pytest.mark.parametrize("fn", [
    lambda x, y: (x & 0xFFFFFFFF).to(torch.int32),  # a non-carrier int64 in [0, 2^32)
    lambda x, y: (x & 0xFFFFFFFF) * 0xFFFFFFF1,  # a product of words outside the checksums
    lambda x, y: (x & 0xFF).to(torch.int32) << 28,  # a lane into bit 31 outside pack_words
])
def test_non_carrier_escape_fires_dtype_overflow(fn):
    """Outside the word arithmetic, a value in [0, 2^32) that leaves its
    signed dtype is a finding, as JAX's narrowing casts are."""
    finds, got = _one(fn, {"x": interval.TOP})
    assert _hits(finds, "range-dtype-overflow", ""), _show(finds)
    assert got[:2] == (None, None)


def test_capture_hash_is_op_audits_hash():
    """The capture's op hash is op_audit.op_hash of the same op stream, and
    a device argument enters it by type only (the card hashes as the CPU)."""
    x = torch.arange(6, dtype=torch.int32)

    def f():
        return {"y": (torch.as_tensor(x, dtype=torch.int64, device=x.device) * 3).sum().reshape(1)}

    rec = op_audit.OpRecorder(0, light=True)
    with rec:
        f()
    assert interval.capture(f, {"x": x}).hash == op_audit.op_hash(rec.records)
    assert any("device" in r.ins for r in rec.records if r.name == "_to_copy")


def test_narrowing_cast_that_escapes_fires():
    finds, got = _one(lambda x, y: (x + 100).to(torch.int8), {"x": (0, 100, False)})
    assert _hits(finds, "range-dtype-overflow", "narrowing cast to int8"), _show(finds)
    assert got[:2] == (None, None)


def test_in_place_write_through_a_view_reaches_the_base():
    x = torch.zeros(4, dtype=torch.int32)

    def f():
        y = x.clone()
        y[1:3].add_(5)
        return {"y": y}

    finds, out = _interp_fn(f, {"x": x}, {"x": (0, 0, False)})
    assert finds == [] and out["y"][:2] == (0, 5)


def test_unknown_op_gives_unknown_and_is_listed():
    x = torch.zeros(4, dtype=torch.int32)
    g = interval.capture(lambda: {"y": torch.bitwise_and(torch.gcd(x, x + 2), 1023)}, {"x": x})
    finds: list = []
    it = interval.Interp("range:seeded/unknown", finds)
    env = it.run(g, it.env(g, {"x": (0, 9, False)}))
    assert dict(it.unknown) == {"gcd": 1}
    assert env[g.outputs["y"]][:2] == (0, 1023)


def test_step_program_runs_the_step_span_alone(sim3):
    span = sim3.body.marks["step"]
    assert 0 < span["start"] < span["end"] <= len(sim3.body.nodes)
    assert set(span["slots"]) == set(policy.state_leaves(
        raft_batched.to_batch_minor(scan.seed_fleet(CFG3, 0, 1, torch.device("cpu"))[0])))
    assert range_audit.audit_step_program(sim3, "range:config3/step") == []
