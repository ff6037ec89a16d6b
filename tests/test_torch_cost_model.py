"""The port's cost pass (raft_sim_tpu_torch/analysis/cost_model.py), held
against the JAX package's structures on the CPU and against its own pins in
tests/golden_torch_cost.json.

The per-leg carry and input bytes equal the leaf bytes of the JAX package's
`policy.state_avals` (jax.eval_shape) at every audited tier; the tree gates
clean against the pins; each rule fires on a seeded regression; an
improvement is a stale-pin finding, not a regression; the chunk loops hold
no more than two carries at a chunk boundary; and the kernel-resource pins
hold K1's ptxas report. Nothing here reads the JAX package's cost pins.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from raft_sim_tpu.analysis import policy as jpolicy
from raft_sim_tpu.utils.config import PRESETS as JPRESETS
from raft_sim_tpu_torch.analysis import cost_model, op_audit
from raft_sim_tpu_torch.utils.config import PRESETS

torch.set_num_threads(1)


def rules_of(found):
    return [f.rule for f in found]


def _jax_bytes(leaf) -> int:
    return int(np.prod(leaf.shape, dtype=np.int64)) * leaf.dtype.itemsize if leaf.shape else \
        leaf.dtype.itemsize


@pytest.mark.parametrize("name", op_audit.AUDIT_CONFIGS)
def test_carry_and_input_bytes_equal_the_jax_avals(name):
    """Per leg, logical bytes a cluster: the port's carry (its layout,
    compacted or dense) and inputs against jax.eval_shape's at the tier."""
    state, inputs, _ = jpolicy.state_avals(JPRESETS[name][0])
    legs = cost_model.carry_legs(PRESETS[name][0])
    want = {f: _jax_bytes(getattr(state, f)) for f in state._fields if f != "mailbox"}
    want.update({f"mb.{f}": _jax_bytes(getattr(state.mailbox, f)) for f in state.mailbox._fields})
    assert {k: v for k, v in legs.items() if not k.startswith("metric.")} == want
    ins = cost_model.input_legs(PRESETS[name][0])
    assert ins == {f: _jax_bytes(getattr(inputs, f)) for f in inputs._fields}


@pytest.fixture(scope="module")
def derived():
    return cost_model.derive_all()


@pytest.fixture(scope="module")
def golden():
    with open(cost_model.golden_path()) as f:
        return json.load(f)


def test_golden_pins_every_audited_tier(golden):
    assert set(golden["tiers"]) == set(op_audit.AUDIT_CONFIGS)
    assert set(golden["mesh"]) == {f"{n}@{d}" for n, d in cost_model.MESH_TIERS}
    for entry in golden["tiers"].values():
        assert set(entry["live_peak"]) == set(op_audit.VARIANTS)
        assert entry["k1_bytes_per_cluster_tick"] > 0
    assert golden["hbm_bytes_per_s"] == 3.35e12


def test_tree_gates_clean_cost_pass(derived, golden):
    assert derived["errors"] == {}
    assert cost_model.compare(derived, golden) == []
    assert cost_model.check_release() == []


def test_k1_bytes_are_the_kernels_traffic(derived):
    from raft_sim_tpu_torch.kernels import tick_engine

    cfg, batch = PRESETS["config3"]
    rd, wr = tick_engine.traffic_bytes(cfg, batch)
    d = derived["tiers"]["config3"]
    assert d["k1_bytes_per_cluster_tick"] == (rd + wr) / batch
    assert d["k1_bound_ns_per_cluster_tick"] == pytest.approx((rd + wr) / batch / 3.35e12 * 1e9)


@pytest.mark.parametrize("edit, rule, needle", [
    (lambda d: d["tiers"]["config3"]["carry_legs"].__setitem__(
        "next_index", d["tiers"]["config3"]["carry_legs"]["next_index"] * 4),
     "cost-carry-bytes", "'next_index' grew"),
    (lambda d: d["tiers"]["config3"]["carry_legs"].__setitem__("extra_leg", 64),
     "cost-carry-bytes", "'extra_leg'"),
    (lambda d: d["tiers"]["config6"]["live_peak"].__setitem__(
        "simulate", d["tiers"]["config6"]["live_peak"]["simulate"] * 2),
     "cost-live-peak", "live peak"),
    (lambda d: d["tiers"]["config5"].__setitem__(
        "k1_bytes_per_cluster_tick", d["tiers"]["config5"]["k1_bytes_per_cluster_tick"] * 1.5),
     "cost-roofline", "K1 bytes"),
    (lambda d: d["mesh"]["config7x@8"].__setitem__(
        "gather_bytes_per_tick", d["mesh"]["config7x@8"]["gather_bytes_per_tick"] * 2),
     "cost-mesh-bytes", "gather_bytes_per_tick"),
])
def test_seeded_regressions_fire_their_rules(derived, golden, edit, rule, needle):
    d = copy.deepcopy(derived)
    edit(d)
    got = cost_model.compare(d, golden)
    assert rules_of(got) == [rule] and needle in got[0].message, got


def test_improvement_reports_stale_golden_not_regression(derived, golden):
    d = copy.deepcopy(derived)
    legs = d["tiers"]["config3"]["carry_legs"]
    legs["log_val"] //= 2
    got = cost_model.compare(d, golden)
    assert rules_of(got) == ["cost-golden"] and "improved" in got[0].message


def test_failed_derivation_is_a_visible_finding(derived, golden):
    d = copy.deepcopy(derived)
    del d["tiers"]["config9"]
    d["errors"]["config9"] = "RuntimeError: seeded"
    got = cost_model.compare(d, golden)
    assert rules_of(got) == ["cost-golden"] and "NOT being checked" in got[0].message


def test_missing_golden_is_itself_a_finding(tmp_path):
    golden, problem = cost_model.load_golden(str(tmp_path / "none.json"))
    assert golden is None and problem.rule == "cost-golden" and "no golden" in problem.message
    (tmp_path / "bad.json").write_text("{")
    golden, problem = cost_model.load_golden(str(tmp_path / "bad.json"))
    assert golden is None and "unreadable" in problem.message


def test_update_golden_preserves_tolerances_and_kernel_pins(tmp_path, golden):
    p = tmp_path / "g.json"
    tuned = dict(golden, tolerance=dict(golden["tolerance"], live_peak=0.2))
    p.write_text(json.dumps(tuned))
    cost_model.update_golden(str(p))
    doc = json.loads(p.read_text())
    assert doc["tolerance"]["live_peak"] == 0.2
    assert doc["kernel_resources"] == golden["kernel_resources"]
    assert doc["tiers"] == json.loads(json.dumps(golden["tiers"]))


def test_release_fires_on_a_loop_that_keeps_its_carries(monkeypatch):
    """A callback that keeps every chunk's state makes the ledger grow."""
    from raft_sim_tpu_torch.sim import chunked

    kept = []
    real = chunked.run_chunked

    def hoarding(cfg, state, keys, n, chunk=1024, callback=None, **kw):
        def cb(done, st, m):
            kept.append(st)
            return callback(done, st, m)
        return real(cfg, state, keys, n, chunk=chunk, callback=cb, **kw)

    monkeypatch.setattr(chunked, "run_chunked", hoarding)
    live, carry = cost_model.release_boundaries("run_chunked")
    assert live[-1] > live[0] and len(kept) == cost_model.RELEASE_CHUNKS
    boundaries = {loop: ([carry, carry], carry) for loop in cost_model.RELEASE_LOOPS}
    boundaries["run_chunked"] = (live, carry)
    got = cost_model.check_release(boundaries)
    assert rules_of(got) == ["cost-release"] and "run_chunked" in got[0].message


# ptxas -v lines of one build: two instantiations, the second spilling more
# than its pin.
PTXAS = """ptxas info    : Function properties for _ZN_11tick_kernelIaaaLi2ELi1ELi0EEEvN2rs8TickArgsEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 1 barriers
ptxas info    : Function properties for _ZN_11tick_kernelIssaLi8ELi2ELi1EEEvN2rs8TickArgsEii
    392 bytes stack frame, 1300 bytes spill stores, 1254 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 392 bytes cumulative stack size
"""


def test_kernel_resource_pins_read_the_ptxas_report(golden):
    from raft_sim_tpu_torch.kernels import tick_engine

    report = tick_engine.ptxas_report(PTXAS)
    pins = {k: golden["kernel_resources"][k] for k in ("w2_npt1_lean", "w8_npt2_full")}
    got = cost_model.check_kernel_resources(report, pins)
    assert rules_of(got) == ["cost-kernel-resources"]
    assert "w8_npt2_full" in got[0].message and "spill_stores 1300" in got[0].message
    clean = PTXAS.replace("1300 bytes spill stores", "1090 bytes spill stores")
    assert cost_model.check_kernel_resources(tick_engine.ptxas_report(clean), pins) == []
    # PERF.md section 6's record of the library the port runs.
    kr = golden["kernel_resources"]
    assert kr["w2_npt1_lean"]["registers"] == [63, 63]
    assert kr["w2_npt1_full"]["registers"] == [108, 112]
    assert kr["w8_npt2_mutant"]["spill_loads"] == [1490, 1490]
