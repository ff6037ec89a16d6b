"""The regression corpus (tests/corpus/*.json: the JAX scenario engine's
shrunk repro artifacts, one per hunted bug) replayed in the port:
raft_sim_tpu_torch/scenario/shrink.py `replay_artifact` rebuilds each
artifact's mutant config and genome, replays its cluster from the seeded
fleet through the port's plain tick, and must reach the artifact's first
violating tick with its kinds. Replayed past the violation by the artifact's
event context, the events around it must be the artifact's (up to its last
event: the hunt's run that wrote them may have ended sooner) and each node's
state line at the violation must be the artifact's, character for character.

The six-property trace checker over each replay waits for the protocol trace
plane (ROADMAP item 14). Tolerance: exact equality.
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
