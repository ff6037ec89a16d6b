"""The port's repro tool (raft_sim_tpu_torch/repro.py) against the JAX tool
(tools/repro.py, loaded as tests/test_repro.py loads it) on the CPU.

`shrink` runs on the JAX test's deliberately broken config (quorum one vote
short: N=5, drop 0.3, seed 1, 1,024 ticks in chunks of 256) at batch 16,
cut from the JAX test's 64 to keep the plain tick's CPU time down; every
field of its result equals the JAX tool's, `repro_cmd` apart from the
module it names. A clean run returns None. `--corpus` over a copy of two
corpus artifacts exits 0; with one artifact's tick altered it exits 2 and
names it.

Tolerance: exact equality of every field.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import pytest
import torch

from raft_sim_tpu import RaftConfig as JConfig
from raft_sim_tpu_torch import repro as trepro
from raft_sim_tpu_torch.utils.config import RaftConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_repro", REPO / "tools" / "repro.py")
jrepro = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jrepro)
CORPUS = ("weak-quorum-n5.json", "blind-transfer-n5.json")


class BrokenQuorum(RaftConfig):
    """quorum - 1: deliberately unsafe (the JAX test's config)."""

    @property
    def quorum(self):
        return self.n_nodes // 2


class JBrokenQuorum(JConfig):
    @property
    def quorum(self):
        return self.n_nodes // 2


def test_shrink_equals_jax_tool():
    kw = dict(seed=1, batch=16, n_ticks=1024, chunk=256)
    got = trepro.shrink(BrokenQuorum(n_nodes=5, drop_prob=0.3), device="cpu", **kw)
    want = jrepro.shrink(JBrokenQuorum(n_nodes=5, drop_prob=0.3), **kw)
    assert got is not None and want is not None
    assert set(got) == set(want)
    for k in ("cluster", "tick", "kinds", "chunk_start", "state_lines"):
        assert got[k] == want[k], k
    assert [(int(t), e) for t, e in got["events"]] == [(int(t), e) for t, e in want["events"]]
    assert got["repro_cmd"] == want["repro_cmd"].replace("-m raft_sim_tpu ",
                                                         "-m raft_sim_tpu_torch ")
    assert "viol_election_safety" in got["kinds"] and len(got["state_lines"]) == 5
    assert any("becomes leader" in e for _, e in got["events"])


def test_clean_run_returns_none(capsys):
    cfg = RaftConfig(n_nodes=5, drop_prob=0.3)
    assert trepro.shrink(cfg, seed=1, batch=4, n_ticks=96, chunk=32, device="cpu") is None
    assert trepro.main(["--n-nodes", "5", "--batch", "4", "--ticks", "32", "--device",
                        "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {"found": False, "ticks": 32, "batch": 4}


def test_cli_device_and_usage(capsys):
    """With no card and no --device the tool fails instead of running on
    the CPU; --ticks is required for a shrink; --scenario and --corpus are
    exclusive."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trepro.main(["--n-nodes", "5", "--batch", "2", "--ticks", "4"])
    for argv in (["--device", "cpu"], ["--device", "cpu", "--scenario", "a", "--corpus", "b"]):
        with pytest.raises(SystemExit) as ex:
            trepro.main(argv)
        assert ex.value.code == 2


def test_corpus_replay(tmp_path, capsys):
    for name in CORPUS:
        shutil.copy(REPO / "tests" / "corpus" / name, tmp_path / name)
    assert trepro.main(["--corpus", str(tmp_path), "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[-1] == {"corpus": str(tmp_path), "artifacts": 2, "reproduced": 2}
    assert all(ln["reproduced"] for ln in lines[:-1])
    art = json.loads((tmp_path / CORPUS[0]).read_text())
    art["tick"] += 1
    (tmp_path / CORPUS[0]).write_text(json.dumps(art))
    assert trepro.main(["--corpus", str(tmp_path), "--device", "cpu"]) == 2
    cap = capsys.readouterr()
    assert f"corpus DRIFT: {CORPUS[0]}" in cap.err
    assert json.loads(cap.out.splitlines()[-1])["drifted"] == CORPUS[0]
    assert trepro.main(["--scenario", str(REPO / "tests" / "corpus" / CORPUS[1]), "--device",
                        "cpu"]) == 0
