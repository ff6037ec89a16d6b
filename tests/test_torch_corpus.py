"""The regression corpus (tests/corpus/*.json: the JAX scenario engine's
shrunk repro artifacts, one per hunted bug) replayed in the port:
raft_sim_tpu_torch/scenario/shrink.py `replay_artifact` rebuilds each
artifact's mutant config and genome, replays its cluster from the seeded
fleet through the port's plain tick, and must reach the artifact's first
violating tick with its kinds. Replayed past the violation by the artifact's
event context, the events around it must be the artifact's (up to its last
event: the hunt's run that wrote them may have ended sooner) and each node's
state line at the violation must be the artifact's, character for character.

The corpus checker (raft_sim_tpu_torch/farm/corpus.py `check_artifact`: the
artifact's cluster replayed traced at batch 1, then the six-property
whole-history checker) holds two artifacts both ways against the JAX
package's: the mutant replay is rejected on a complete history naming the
provenance's property with a witness, and the real config on the same replay
passes all six; the reports are equal field for field. The card runs all
seven (chip_smoke.py). Tolerance: exact equality.
"""

import glob
import os

import pytest
import torch

from raft_sim_tpu_torch.scenario import shrink as tshrink
from raft_sim_tpu_torch.scenario.mutation import MUTANTS

torch.set_num_threads(1)

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus")
ARTIFACTS = sorted(glob.glob(os.path.join(CORPUS, "*.json")))
CONTEXT = 30  # the artifacts' event context (shrink's default)


def test_corpus_holds_seven_mutants_the_port_knows():
    arts = [tshrink.load_artifact(p) for p in ARTIFACTS]
    assert len(arts) == 7
    assert {a["mutant"] for a in arts} <= set(MUTANTS)
    assert all(a["schema"] in tshrink.ARTIFACT_SCHEMAS for a in arts)


@pytest.mark.parametrize("path", ARTIFACTS, ids=[os.path.basename(p) for p in ARTIFACTS])
def test_artifact_replays_in_the_port(path):
    art = tshrink.load_artifact(path)
    rep = tshrink.replay_artifact(art, horizon=art["tick"] + CONTEXT + 1, device="cpu")
    assert rep["tick"] == art["tick"] and rep["kinds"] == art["kinds"], rep
    assert rep["reproduced"]
    last = max(t for t, _ in art["events"])
    assert [[t, e] for t, e in rep["events"] if t <= last] == art["events"]
    assert rep["state_lines"] == art["state_lines"]
    if art["ticks"] <= 64:  # the short ones again at their own horizon, as tools/repro.py does
        short = tshrink.replay_artifact(art, context=0, device="cpu")
        assert short["reproduced"] and [e for _, e in short["events"]] == [
            e for t, e in art["events"] if t == art["tick"]]


@pytest.mark.parametrize("name", ["weak-quorum-n5.json", "blind-transfer-n5.json"])
def test_check_artifact_both_ways_matches_jax(name):
    from raft_sim_tpu.farm import corpus as jcorpus
    from raft_sim_tpu_torch.farm import corpus as tcorpus

    art = tshrink.load_artifact(os.path.join(CORPUS, name))
    assert tcorpus.validate_artifact(art) == []
    prop = art["provenance"]["checker_property"]
    for real in (False, True):
        got = tcorpus.check_artifact(art, real=real, device="cpu")
        assert got.to_dict() == jcorpus.check_artifact(art, real=real).to_dict()
        assert got.complete
        if real:
            assert got.ok and all(r.ok is True for r in got.results.values())
        else:
            assert got.violated and got.violated[0] == prop
            assert got.results[prop].witness


def test_corpus_signatures_dedup_and_freeze_match_jax(tmp_path):
    """Each artifact's mechanisms, signature, validation and duplicate are
    the JAX module's; freezing the weak-quorum artifact into an empty
    corpus stamps it with the checker's property, a second freeze takes the
    next name, a v1 artifact is upgraded in place, and an artifact whose
    replay the checker passes (the real config) is refused."""
    import json

    from raft_sim_tpu.farm import corpus as jcorpus
    from raft_sim_tpu_torch.farm import corpus as tcorpus

    arts = [tshrink.load_artifact(p) for p in ARTIFACTS]
    for art in arts:
        assert tcorpus.mechanisms(art) == jcorpus.mechanisms(art)
        assert tcorpus.signature(art) == jcorpus.signature(art)
        assert tcorpus.validate_artifact(art) == jcorpus.validate_artifact(art) == []
        assert tcorpus.find_duplicate(art, CORPUS) == jcorpus.find_duplicate(art, CORPUS)
        assert tcorpus.default_name(art) == jcorpus.default_name(art)
    assert tcorpus.find_duplicate(arts[0], str(tmp_path / "none")) is None
    wq = next(a for a in arts if a["mutant"] == "weak-quorum")
    v1 = {k: v for k, v in wq.items() if k not in ("schema", "provenance")}
    v1["schema"] = "scenario-repro-v1"
    assert tcorpus.validate_artifact(v1) == jcorpus.validate_artifact(v1) != []
    prov = {k: wq["provenance"][k] for k in tcorpus.PROVENANCE_FIELDS}
    corpus = str(tmp_path / "corpus")
    path, frozen = tcorpus.freeze(v1, corpus, prov, device="cpu")
    assert os.path.basename(path) == "weak-quorum-n5.json"
    assert frozen["provenance"]["checker_property"] == "election_safety"
    assert tcorpus.freeze(v1, corpus, prov, device="cpu")[0].endswith("weak-quorum-n5-2.json")
    dup = tcorpus.find_duplicate(v1, corpus)
    assert dup == jcorpus.find_duplicate(v1, corpus) and dup["duplicate_of"].startswith("weak")
    old = str(tmp_path / "old.json")
    tshrink.save_artifact(old, v1)
    assert tcorpus.backfill_provenance(old, prov) == jcorpus.stamp(v1, prov)
    assert json.load(open(old))["schema"] == tcorpus.CORPUS_SCHEMA
    with pytest.raises(ValueError, match="refusing to freeze"):
        tcorpus.freeze(dict(v1, mutant=None), corpus, dict(prov, mutant=None), device="cpu")
