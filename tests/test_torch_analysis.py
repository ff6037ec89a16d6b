"""The port's analyzer, Passes A and B and the findings engine
(raft_sim_tpu_torch/analysis/{findings,policy,ast_lint,op_audit}.py), held
against the JAX package's on the CPU.

Every rule fires on a seeded violation and stays silent on the tree; the
parsed types.py contracts, the schema fingerprint and the checkpoint key set
equal the JAX package's. Pass A's per-tier programs run on a few tiers here
(the full set is `python -m raft_sim_tpu_torch check --ops --device cpu`);
each program is one recorded tick at B = 4.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from raft_sim_tpu.analysis import policy as jpolicy
from raft_sim_tpu.utils import checkpoint as jcheckpoint
from raft_sim_tpu_torch.analysis import ast_lint, findings as F, op_audit, policy, run
from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.utils import checkpoint
from raft_sim_tpu_torch.utils.config import PRESETS

torch.set_num_threads(1)

SIM_PATH = "raft_sim_tpu_torch/sim/fake_tick.py"
FAST_TIERS = ("config3", "config6", "config7x")


def rules_of(found):
    return [f.rule for f in found]


# ------------------------------------------------------------- findings


def test_waiver_matching_and_stale_reporting():
    found = [F.Finding("host-sync", "a.py", "in f(): x", line=3),
             F.Finding("host-sync", "b.py", "in g(): y", line=4)]
    waivers = [{"rule": "host-sync", "path": "a.py", "contains": "f()", "reason": "r1"},
               {"rule": "host-sync", "path": "c.py", "reason": "stale"}]
    unused = F.apply_waivers(found, waivers)
    assert found[0].waived and found[0].waiver_reason == "r1" and not found[1].waived
    assert unused == [waivers[1]]


def test_report_schema_validates_and_catches_corruption():
    doc = F.report([F.Finding("float-op", "ops:x", "m")], extras={"elapsed_s": 1.0})
    assert F.validate(doc) == [] and doc["torch_version"] == torch.__version__
    bad = json.loads(json.dumps(doc))
    bad["n_unwaived"] = 5
    del bad["findings"][0]["line"]
    errs = F.validate(bad)
    assert any("n_unwaived" in e for e in errs) and any("'line'" in e for e in errs)


@pytest.mark.parametrize("doc, needle", [
    ({"schema_version": 2, "waivers": []}, "schema_version"),
    ({"schema_version": 1, "waivers": {}}, "must be a list"),
    ({"schema_version": 1, "waivers": [{"rule": "host-sync", "path": "a.py"}]}, "'reason'"),
    ({"schema_version": 1, "waivers": ["x"]}, "must be an object"),
])
def test_waiver_file_format_errors_are_loud(tmp_path, doc, needle):
    p = tmp_path / "w.json"
    p.write_text(json.dumps(doc))
    _, problems = F.load_waivers(str(p))
    assert any(needle in prob for prob in problems), problems


def test_every_waiver_carries_a_justification():
    entries, problems = F.load_waivers(run.DEFAULT_WAIVERS)
    assert problems == [] and entries
    assert all(len(w["reason"].split()) >= 5 for w in entries)


def test_partial_run_does_not_report_other_passes_waivers_stale(tmp_path):
    p = tmp_path / "w.json"
    p.write_text(json.dumps({"schema_version": 1, "waivers": [
        {"rule": "range-index-oob", "path": "range:x", "reason": "another pass's waiver"}]}))
    _, unused, problems, timings, _ = run.run_all(
        do_ops=False, do_cost=False, do_race=False, do_range=False, waivers_path=str(p))
    assert unused == [] and problems == [] and set(timings) == {"ast"}


# --------------------------------------------------------------- Pass B


@pytest.mark.parametrize("body, what", [
    ("    if state.term.max() > 3:\n        return state\n", "Python `if`"),
    ("    while state.commit_index.any():\n        pass\n", "Python `while`"),
    ("    ok = bool(state.commit_index.any())\n", "`bool()`"),
    ("    n = state.term.max().item()\n", "`.item()`"),
    ("    n = int(state.now.reshape(-1)[0])\n", "`int()`"),
    ("    t = state.log_val.cpu()\n", "`.cpu()`"),
    ("    t = state.log_val.tolist()\n", "`.tolist()`"),
    ("    x = torch.zeros(3)\n    v = x.numpy()\n", "`.numpy()`"),
    ("    v = 1 if state.term.any() else 0\n", "conditional expression"),
])
def test_host_sync_fires_on_seeded_tick(body, what):
    src = "import torch\ndef tick(cfg, state: ClusterState):\n" + body
    got = ast_lint.lint_source(src, SIM_PATH)
    assert [f.rule for f in got] == ["host-sync"] and what in got[0].message


def test_host_sync_ignores_config_branches_and_metadata():
    src = ("import torch\n"
           "def tick(cfg, state: ClusterState, x: torch.Tensor | None = None):\n"
           "    if cfg.pre_vote and state.term.shape[0] > 2 and len(state.role) and x is None:\n"
           "        pass\n"
           "    n = int(state.role.numel())\n"
           "    tag = ''.join(str(t.element_size()) for t in (state.term, state.role))\n")
    assert ast_lint.lint_source(src, SIM_PATH) == []
    # Outside models/ sim/ ops/ kernels/ the rule does not apply.
    assert ast_lint.lint_source("def f(s: ClusterState):\n    return s.term.item()\n",
                                "raft_sim_tpu_torch/driver.py") == []


def test_float_literal_fires_in_hot_path_only():
    src = "import torch\ndef f(x):\n    return torch.where(x > 0, 0.5, 1)\n"
    assert rules_of(ast_lint.lint_source(src, "raft_sim_tpu_torch/models/m.py")) == ["float-literal"]
    assert ast_lint.lint_source(src, "raft_sim_tpu_torch/bench.py") == []


def test_parse_error_is_a_finding():
    assert rules_of(ast_lint.lint_source("def f(:\n", SIM_PATH)) == ["parse-error"]


def test_types_comments_equal_the_jax_contracts():
    """The port's types.py comments parse to the JAX package's specs (the
    uint32 legs declare uint32 too: their int32 carrier is prose)."""
    jspecs, jprob = jpolicy.parse_types_comments()
    pspecs, pprob = policy.parse_types_comments()
    assert jprob == [] and pprob == []
    assert set(pspecs) == set(jspecs)
    for cls, fields in jspecs.items():
        assert set(pspecs[cls]) == set(fields), cls
        for f, s in fields.items():
            assert pspecs[cls][f].key() == (s.ndim, s.dtypes, s.lo, s.hi), (cls, f)
    jax_field = jpolicy._FIELD_RE
    specs_via_jax_re, _ = policy.parse_types_comments(
        open(jpolicy.rst_types.__file__).read(), field_re=jax_field)
    assert {c: {f: s.key() for f, s in v.items()} for c, v in specs_via_jax_re.items()} == \
        {c: {f: s.key() for f, s in v.items()} for c, v in pspecs.items()}


def test_dtype_comments_hold_on_the_tree():
    assert ast_lint.check_dtype_comments() == []


@pytest.mark.parametrize("old, new, needle", [
    ("next_index: torch.Tensor  # [N, N] index_dtype", "next_index: torch.Tensor  # [N, N] int32",
     "next_index is int8"),
    ("role: torch.Tensor  # [N] int32", "role: torch.Tensor  # [N, N] int32", "ndim"),
    ("term: torch.Tensor  # [N] int32", "term: torch.Tensor  # [N] float", "does not parse"),
])
def test_dtype_comment_rule_fires_on_drift(old, new, needle):
    from raft_sim_tpu_torch import types as port_types

    src = open(port_types.__file__).read()
    assert old in src
    got = ast_lint.check_dtype_comments(("config3",), source=src.replace(old, new, 1))
    assert got and all(f.rule == "dtype-comment" for f in got)
    assert any(needle in f.message for f in got), [f.message for f in got]


def test_schema_fingerprint_and_keys_equal_the_jax_pins():
    """Both packages load each other's v25 files: the port pins JAX's pair."""
    assert checkpoint._SCHEMA_FINGERPRINT == jcheckpoint._SCHEMA_FINGERPRINT == (
        25, "541dcec1cfa9709e")
    assert policy.schema_fingerprint() == "541dcec1cfa9709e"
    assert checkpoint.FORMAT_VERSION == jcheckpoint._FORMAT_VERSION
    assert policy.expected_checkpoint_keys() == jpolicy.expected_checkpoint_keys()
    assert ast_lint.check_checkpoint_version() == []
    assert ast_lint.check_checkpoint_serialization() == []


@pytest.mark.parametrize("pin, version, needle", [
    ((25, "0000000000000000"), 25, "hash to"),
    ((24, "541dcec1cfa9709e"), 25, "pins version 24"),
])
def test_checkpoint_version_rule_fires(pin, version, needle):
    got = ast_lint.check_checkpoint_version(pin=pin, version=version)
    assert rules_of(got) == ["checkpoint-version"] and needle in got[0].message


def test_tree_gates_clean_ast_pass():
    found, unused, problems, _, _ = run.run_all(do_ops=False, do_cost=False, do_race=False,
                                               do_range=False)
    assert [f for f in found if not f.waived] == [] and unused == [] and problems == []


# --------------------------------------------------------------- Pass A


@pytest.mark.parametrize("name", FAST_TIERS)
def test_tier_programs_are_float_free_unwidened_and_carry_clean(name):
    cfg, _ = PRESETS[name]
    for prog in op_audit.programs(name, cfg):
        got = (op_audit.check_float_ops(prog) + op_audit.check_plane_widening(prog)
               + op_audit.check_carry(prog) + op_audit.check_large_constants(prog))
        assert got == [], [f.message for f in got]
        assert len(prog.records) > 1000 and prog.live_peak > prog.carry_bytes


def _seeded(fn):
    """A tick whose step is `fn(cfg, s2, info)` applied after the plain one."""
    def tick(cfg, s, keys, m, t, step_fn=None, **kw):
        def step(cfg, s, inp, now):
            s2, info = raft_batched.step_b(cfg, s, inp, now)
            return fn(cfg, s2, info)
        return scan.tick_batch_minor(cfg, s, keys, m, t, step_fn=step, **kw)
    return tick


def _prog(fn, name="config3"):
    return op_audit.run_tick(PRESETS[name][0], "simulate", tick_fn=_seeded(fn), label="ops:seed")


def test_float_upcast_is_caught():
    prog = _prog(lambda cfg, s, info: (s._replace(term=(s.term.float() * 1).to(torch.int32)), info))
    assert "float-op" in rules_of(op_audit.check_float_ops(prog))


def test_scalar_where_widening_a_plane_is_caught_and_reduction_exempt():
    def widen(cfg, s, info):
        plane = torch.where(s.next_index > 0, 1, 0)  # int64 [N, N, B]: the trap
        return s._replace(next_index=(s.next_index + plane).to(s.next_index.dtype)), info

    def reduced(cfg, s, info):
        votes = torch.where(s.next_index > 0, 1, 0).sum(1)  # straight into a reduction
        return s._replace(commit_index=torch.maximum(s.commit_index, votes.to(torch.int32) * 0)), info

    got = op_audit.check_plane_widening(_prog(widen))
    assert rules_of(got) == ["plane-widening"] and "bool -> int64" in got[0].message
    assert op_audit.check_plane_widening(_prog(reduced)) == []


@pytest.mark.parametrize("leg, fn, rule", [
    ("heard_clock", lambda c, s, i: (s._replace(heard_clock=s.heard_clock.clone()), i),
     "carry-passthrough"),
    ("match_index", lambda c, s, i: (s._replace(match_index=s.match_index.to(torch.int32)), i),
     "carry-dtype"),
])
def test_carry_rules_fire_on_seeded_legs(leg, fn, rule):
    got = op_audit.check_carry(_prog(fn))
    assert rule in rules_of(got) and any(f"'{leg}'" in f.message for f in got)


def test_large_constant_rule():
    prog = _prog(lambda c, s, i: (s._replace(term=s.term + torch.zeros(40_000, dtype=torch.int32)[:1]), i))
    got = op_audit.check_large_constants(prog)
    assert rules_of(got) == ["large-constant"] and "160000-byte" in got[0].message


def test_recompile_fork_guard_clean_and_seeded():
    assert op_audit.check_recompile_forks(pairs=(("config3", {"heartbeat_ticks": 4}),)) == []
    cfg = PRESETS["config3"][0]
    forked = dataclasses.replace(cfg, drop_prob=0.3)

    def branchy(c, s, info):  # a Python branch on a tuned value
        return (s._replace(term=s.term + 0) if c.drop_prob > 0.2 else s), info

    a = op_audit.run_tick(cfg, "simulate", tick_fn=_seeded(branchy))
    b = op_audit.run_tick(forked, "simulate", tick_fn=_seeded(branchy))
    assert op_audit.op_hash(a.records) != op_audit.op_hash(b.records)
    # Values are ignored: the same ops at other constants hash equal.
    c = op_audit.run_tick(cfg, "simulate", tick_fn=_seeded(lambda c, s, i: (s._replace(term=s.term + 1), i)))
    d = op_audit.run_tick(cfg, "simulate", tick_fn=_seeded(lambda c, s, i: (s._replace(term=s.term + 7), i)))
    assert op_audit.op_hash(c.records) == op_audit.op_hash(d.records)


def test_kernel_instantiation_from_the_host_build():
    prog = op_audit.program("config3", PRESETS["config3"][0], "simulate")
    tag = op_audit.kernel_instantiation(PRESETS["config3"][0], prog.state_in)
    assert tag == "tick_kernelIaaaLi2ELi1ELi0E"  # int8 tiers, width 2, 1 node a thread, lean


def test_node_collectives_declared_and_seeded():
    cfg, counts = op_audit.node_collective_counts()
    assert op_audit.check_node_collectives(cfg, counts, op_audit.NODE_TICKS) == []
    assert counts["mailbox_gather"] == op_audit.NODE_TICKS
    extra = dict(counts, all_to_all=1)
    got = op_audit.check_node_collectives(cfg, extra, op_audit.NODE_TICKS)
    assert rules_of(got) == ["node-collectives"] and "all_to_all" in got[0].message
    twice = dict(counts, mailbox_gather=2 * op_audit.NODE_TICKS)
    assert rules_of(op_audit.check_node_collectives(cfg, twice, op_audit.NODE_TICKS)) == [
        "node-collectives"]
