"""The port's violation hunt and shrink (raft_sim_tpu_torch/scenario/search.py
and shrink.py) against the JAX package's, on the CPU at a small spec: the
same spec gives the same generation log and hit (genome_raw included) under
the weak-quorum mutant, the real config survives the same budget in both
packages, and the port's shrink of the hit is the JAX artifact field for
field. The JAX search, the shrink and their compiles are shared at module
scope.

Tolerance: exact equality of every JSON field (floats included: both run the
same numpy host arithmetic on equal telemetry counters).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.scenario import mutation as jmut
from raft_sim_tpu.scenario import search as jsearch
from raft_sim_tpu.scenario import shrink as jshrink
from raft_sim_tpu_torch.scenario import mutation as tmut
from raft_sim_tpu_torch.scenario import search as tsearch
from raft_sim_tpu_torch.scenario import shrink as tshrink
from raft_sim_tpu_torch.sim import telemetry as ttel
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

KW = dict(n_nodes=5, log_capacity=8, client_interval=4, drop_prob=0.2, partition_period=16,
          partition_prob=0.3, crash_prob=0.3, crash_period=32, crash_down_ticks=8,
          clock_skew_prob=0.1)
SPEC = dict(generations=4, population=16, ticks=64, window=32, seed=0)


def _json(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def mutant_hunts():
    jcfg = jmut.mutant_config("weak-quorum", rst.RaftConfig(**KW))
    tcfg = tmut.mutant_config("weak-quorum", tconfig.RaftConfig(**KW))
    want = jsearch.search(jcfg, jsearch.SearchSpec(**SPEC))
    got = tsearch.search(tcfg, tsearch.SearchSpec(**SPEC), device="cpu")
    return jcfg, tcfg, want, got


def test_search_matches_jax_and_hits(mutant_hunts):
    _, _, want, got = mutant_hunts
    assert _json(got.to_json()) == _json(want.to_json())
    assert got.hit is not None and len(got.generations) <= SPEC["generations"]
    assert 0 <= got.hit["cluster"] < SPEC["population"]
    assert 0 <= got.hit["first_viol_tick"] < SPEC["ticks"]


def test_real_config_survives_the_same_budget():
    want = jsearch.search(rst.RaftConfig(**KW), jsearch.SearchSpec(**SPEC))
    got = tsearch.search(tconfig.RaftConfig(**KW), tsearch.SearchSpec(**SPEC), device="cpu")
    assert got.hit is None and all(g["violating_clusters"] == 0 for g in got.generations)
    assert _json(got.to_json()) == _json(want.to_json())


def test_shrink_is_the_jax_artifact(mutant_hunts, tmp_path):
    """The port's shrink of the hit equals the JAX one field for field, and
    the artifact file replays to the identical tick and kinds in both."""
    jcfg, tcfg, want, got = mutant_hunts
    j_art = jshrink.shrink(jcfg, want.hit, mutant="weak-quorum")
    t_art = tshrink.shrink(tcfg, got.hit, mutant="weak-quorum", device="cpu")
    assert _json(t_art) == _json(j_art)
    assert t_art["ticks"] == t_art["tick"] + 1 and t_art["kinds"]
    path = tshrink.save_artifact(str(tmp_path / "repro.json"), t_art)
    rep = tshrink.replay_artifact(tshrink.load_artifact(path), device="cpu")
    assert rep["reproduced"] and rep["tick"] == t_art["tick"], rep
    assert jshrink.replay_artifact(jshrink.load_artifact(path))["reproduced"]
    with pytest.raises(ValueError, match="does not reproduce"):
        tshrink.shrink(tconfig.RaftConfig(**KW), got.hit, device="cpu")


def test_fitness_prefers_distress():
    """Violations dominate; leaderless windows and concurrent leaders raise
    the score (hand-built records, as the JAX test builds them)."""
    b, w = 3, 4
    zeros = np.zeros((b, w), np.int32)
    llt = zeros - 1
    llt[1] = 5
    rec = SimpleNamespace(metrics=SimpleNamespace(last_leaderless_tick=llt, max_commit=zeros),
                          first_viol_tick=zeros + ttel.NEVER)
    m = SimpleNamespace(violations=np.array([0, 0, 1]), max_term=np.array([3, 3, 3]),
                        total_cmds=np.array([0, 0, 0]), lat_excluded=np.array([0, 0, 0]),
                        multi_leader=np.array([0, 7, 0]))
    fit = tsearch.fitness_from_records(rec, m)
    assert np.array_equal(fit, jsearch.fitness_from_records(rec, m))
    assert fit[1] > fit[0] and fit[2] > fit[1] * 10
    m2 = SimpleNamespace(**{**m.__dict__, "multi_leader": np.array([0, 0, 0])})
    assert fit[1] > tsearch.fitness_from_records(rec, m2)[1]


def test_knobs_and_decoding_match_jax():
    for kw in (KW, dict(KW, fsync_interval=3, torn_tail_prob=0.2, lost_suffix_span=3)):
        jcfg, tcfg = rst.RaftConfig(**kw), tconfig.RaftConfig(**kw)
        jk, tk = jsearch.default_knobs(jcfg), tsearch.default_knobs(tcfg)
        assert [tuple(vars(k).values()) for k in tk] == [tuple(vars(k).values()) for k in jk]
        xs = np.random.default_rng(2).uniform(size=(6, len(tk)))
        for x in xs:
            from raft_sim_tpu.scenario import genome as jg
            from raft_sim_tpu_torch.scenario import genome as tg

            assert tg.to_raw(tsearch.decode_row(tcfg, tk, x)) == jg.to_raw(
                jsearch.decode_row(jcfg, jk, x))


@pytest.mark.parametrize("kw,item", [(dict(fitness="coverage"), "item 14"),
                                     (dict(proposal="coverage-guided"), "item 14")])
def test_unported_search_modes_raise(kw, item):
    """The coverage modes, refused until the trace plane was ported, are
    taken: coverage fitness runs, its generations carrying coverage counts,
    and so do guided proposals over it (without it they are the JAX
    package's usage error). perf attribution, refused until the chunk timer
    was ported, is taken too: one row a generation, the same hunt."""
    cov = dict(SPEC, fitness="coverage", stop_on_hit=False, generations=2)
    if "proposal" in kw:
        with pytest.raises(ValueError, match="coverage"):
            tsearch.search(tconfig.RaftConfig(**KW), tsearch.SearchSpec(**{**SPEC, **kw}),
                           device="cpu")
    res = tsearch.search(tconfig.RaftConfig(**KW), tsearch.SearchSpec(**{**cov, **kw}),
                         device="cpu")
    assert res.spec["fitness"] == "coverage" and res.spec["proposal"] == kw.get(
        "proposal", "gaussian")
    assert res.generations[0]["cov_new_bits"] > 0 and len(res.generations) == 2
    from raft_sim_tpu_torch.obs import ChunkTimer

    timer = ChunkTimer(label="search", batch=SPEC["population"])
    timed = tsearch.search(tconfig.RaftConfig(**KW), tsearch.SearchSpec(**{**cov, **kw}),
                           perf=timer, device="cpu")
    assert timed.to_json() == res.to_json() and len(timer.rows) == len(res.generations)
