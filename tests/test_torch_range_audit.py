"""The port's Pass E (raft_sim_tpu_torch/analysis/range_audit.py), held
against the JAX package's range pins on the CPU.

The ceilings equal tests/golden_ranges.json's; every value the port's plain
tick produces at a tier lies within the [lo, hi] the JAX pins give that leg
(legs not widened; a leg with a growth rate may grow by it each tick); the
tree gates clean against tests/golden_torch_ranges.json within the
analyzer's budget; and each rule fires on a seeded fault.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import pytest
import torch

from raft_sim_tpu_torch.analysis import op_audit, range_audit
from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.utils.config import PRESETS

torch.set_num_threads(1)

JAX_GOLDEN = os.path.join(os.path.dirname(__file__), "golden_ranges.json")


def rules_of(found):
    return [f.rule for f in found]


@pytest.fixture(scope="module")
def head():
    t0 = time.process_time()
    derived, found = range_audit.derive_all()
    return derived, found, time.process_time() - t0


def test_range_pass_clean_on_head_within_budget(head):
    derived, found, cpu_s = head
    with open(range_audit.golden_path()) as f:
        golden = json.load(f)
    assert found == [] and range_audit.compare(derived, golden) == []
    assert cpu_s < 60.0  # the analyzer's budget, in CPU seconds


def test_golden_pins_every_audited_tier_with_horizons():
    with open(range_audit.golden_path()) as f:
        golden = json.load(f)
    assert set(golden["tiers"]) == set(op_audit.AUDIT_CONFIGS)
    for name, tier in golden["tiers"].items():
        rates = range_audit.monotone_rates(PRESETS[name][0])
        assert set(tier["horizons"]) == set(rates)
        assert all(h >= range_audit.SOAK_TICKS for h in tier["horizons"].values())
        assert tier["ticks"] == range_audit.AUDIT_TICKS[name]


def test_ceilings_equal_the_jax_pins():
    with open(JAX_GOLDEN) as f:
        jax_golden = json.load(f)
    found, ceilings = range_audit.check_ceilings()
    assert found == [] and ceilings == jax_golden["ceilings"] == {
        "MAX_INT8_LOG_CAPACITY": 41, "MAX_INT8_NODES": 126, "MAX_LOG_CAPACITY": 4095,
        "window_min_encoding_max": 12287}


@pytest.mark.parametrize("name", op_audit.AUDIT_CONFIGS)
def test_observed_values_lie_within_the_jax_ranges(head, name):
    """The JAX package's interval interpreter bounds each leg it did not
    widen; every value the port's real tick produces stays inside. A leg
    with a growth `rate` is pinned at the scan's entry ([lo, hi] of the
    carry going in, then a rate): its entry values are held to the pin."""
    with open(JAX_GOLDEN) as f:
        pins = json.load(f)["tiers"][name]["legs"]
    tier = head[0]["tiers"][name]
    checked = 0
    for leg, pin in pins.items():
        if pin.get("widened") or pin.get("lo") is None or leg not in tier["legs"]:
            continue
        lo, hi = tier["entry" if "rate" in pin else "legs"][leg]
        assert pin["lo"] <= lo and hi <= pin["hi"], (leg, (lo, hi), pin)
        checked += 1
    assert checked >= 30


def test_a_short_audit_that_misses_its_states_is_visible():
    cfg = PRESETS["config6"][0]
    run = range_audit.run_tier("config6", cfg, ticks=8, check_every=8)
    got = range_audit.check_run("config6", cfg, run)[0]
    assert set(rules_of(got)) == {"range-golden"}
    assert any("compaction state" in f.message for f in got)


# ------------------------------------------------------------ seeded faults


def _seeded(fn):
    def tick(cfg, s, keys, m, t, step_fn=None, **kw):
        def step(cfg, s, inp, now):
            s2, info = raft_batched.step_b(cfg, s, inp, now)
            return fn(s2), info
        return scan.tick_batch_minor(cfg, s, keys, m, t, step_fn=step, **kw)
    return tick


def _tier(fn, name="config3", ticks=2):
    cfg = PRESETS[name][0]
    run = range_audit.run_tier(name, cfg, ticks=ticks, check_every=1, tick_fn=_seeded(fn))
    return range_audit.check_run(name, cfg, run)[0]


def test_seeded_narrowing_overflow_fires():
    got = _tier(lambda s: s._replace(
        ack_age=(s.ack_age.to(torch.int32) + 200).to(torch.int8)))
    assert "range-dtype-overflow" in rules_of(got)
    assert any("int32 -> int8" in f.message and "do not fit" in f.message for f in got)


def test_seeded_unclipped_index_fires():
    def bad(s):
        # The last entry's term by advanced indexing: -1 on an empty log,
        # which torch wraps to the ring's last slot without a word.
        n, _, b = s.log_term.shape
        idx = (s.commit_index - 1).long()
        got = s.log_term[torch.arange(n)[:, None], idx, torch.arange(b)[None, :]]
        return s._replace(term=torch.maximum(s.term, got))

    got = _tier(bad)
    assert "range-index-oob" in rules_of(got) and any("[-1," in f.message for f in got)


def test_seeded_stale_declared_range_fires():
    got = _tier(lambda s: s._replace(role=torch.where(s.role == 0, 7, s.role).to(torch.int32)))
    assert "range-annotation-stale" in rules_of(got)
    assert any("`role`" in f.message and "[0, 3]" in f.message for f in got)


def test_seeded_pack_width_shrunk_one_bit_fires():
    from raft_sim_tpu_torch.ops import tile

    cfg = PRESETS["config5c"][0]
    widths = dict(tile.pack_width_table(cfg))
    bits, bias, lo, hi = widths["ack_age"]
    widths["ack_age"] = (bits - 1, bias, lo, hi)
    got = range_audit.check_pack_widths(cfg, "config5c", widths=widths)
    assert rules_of(got) == ["range-pack-width"] and "ack_age" in got[0].message
    declared = dict(range_audit.policy.declared_ranges(cfg), **{"mb.req_off": (-1, 9)})
    got = range_audit.check_pack_widths(cfg, "config5c", declared=declared)
    assert rules_of(got) == ["range-pack-width"] and "disagrees" in got[0].message


def test_seeded_fast_leg_and_escaped_copy_fire_horizon():
    got = _tier(lambda s: s._replace(term=s.term + 5, heard_clock=s.clock + 100))
    msgs = [f.message for f in got if f.rule == "range-horizon"]
    assert any("`term` grew" in m for m in msgs) and any("`heard_clock` rose" in m for m in msgs)


def test_derivation_failure_is_visible_not_silent(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("seeded")

    monkeypatch.setattr(range_audit, "run_tier", boom)
    range_audit._derive_all.cache_clear()
    try:
        _, found = range_audit.derive_all(("config3",))
    finally:
        range_audit._derive_all.cache_clear()
    assert rules_of(found) == ["range-golden"] and "NOT being checked" in found[0].message


def test_seeded_leg_near_its_ceiling_fires_horizon_below_soak():
    """A monotone leg that starts near int32's top wraps inside the soak
    budget at its declared rate."""
    cfg = PRESETS["config3"][0]
    run = range_audit.run_tier("config3", cfg, ticks=1, check_every=1)
    legs = dict(run.legs, term=(1, 2**31 - 1000))
    got = range_audit.check_run("config3", cfg, dataclasses.replace(run, legs=legs))[0]
    assert rules_of(got) == ["range-horizon"] and "wraps int32 after 999 ticks" in got[0].message
