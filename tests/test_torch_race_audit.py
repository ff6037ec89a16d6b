"""The port's Pass D (raft_sim_tpu_torch/analysis/race_audit.py) and its
runtime leg, the release-poison sanitizer (analysis/sanitizer.py), on the
CPU.

Every static rule fires on a seeded violation -- a late read of a released
carry (directly, through a view, through a closure, on the next
iteration), a write inside the dispatch->sync window or into a buffer whose
copy is in flight, a double-drawn threefry key, a second sink writer, an
unregistered releasing step -- and stays silent on the port's idioms; the
tree gates clean. The sanitizer leaves armed runs equal to unarmed ones
(`run --sanitize`, `serve --sanitize` and the dynamic leg), keeps the
caller's input unchanged, catches an injected use-after-release, and
restores the entry points it patched.
"""

from __future__ import annotations

import json

import pytest
import torch

from raft_sim_tpu_torch.analysis import policy, race_audit, run, sanitizer
from raft_sim_tpu_torch.sim import chunked, scan
from raft_sim_tpu_torch.utils.config import RaftConfig

torch.set_num_threads(1)

SIM_PATH = "raft_sim_tpu_torch/sim/fake_loop.py"
KEY_PATH = "raft_sim_tpu_torch/farm/fake_keys.py"
TINY = RaftConfig(n_nodes=3, log_capacity=4, max_entries_per_rpc=1)


def rules_of(found):
    return [f.rule for f in found]


# ------------------------------------------------------ use-after-release


@pytest.mark.parametrize("src", [
    # a direct read after the release
    "def loop(cfg, state, keys, export):\n"
    "    out = _chunk(cfg, state, keys, 4, 0, [None], 1)\n"
    "    export(state)\n",
    # a view taken before the release, read after it
    "def loop(cfg, state, keys):\n"
    "    view = from_batch_minor(state)\n"
    "    state = _chunk(cfg, state, keys, 4, 0, [None], 1)\n"
    "    return view\n",
    # a closure that captured the released carry
    "def loop(cfg, state, keys, sink):\n"
    "    snap = lambda: state[0].term\n"
    "    out = _chunk(cfg, state, keys, 4, 0, [None], 1)\n"
    "    sink(snap)\n",
    # the next iteration re-reads a carry that was never rebound
    "def loop(cfg, state, keys, n_ticks):\n"
    "    done = 0\n"
    "    while done < n_ticks:\n"
    "        out = _chunk(cfg, state, keys, 4, done, [None], 1)\n"
    "        done += 4\n"
    "    return state\n",
], ids=["direct", "view", "closure", "next-iteration"])
def test_use_after_release_fires(src):
    assert "race-use-after-release" in rules_of(race_audit.lint_source(src, SIM_PATH))


@pytest.mark.parametrize("src", [
    "def loop(cfg, state, keys):\n"
    "    outs = _chunk(cfg, state, keys, 4, 0, [None], 1)\n"
    "    state = [s for s, _ in outs]\n"
    "    return state\n",
    "def loop(cfg, state, keys, export):\n"
    "    snap = snapshot(state)\n"
    "    state = _chunk(cfg, state, keys, 4, 0, [None], 1)\n"
    "    export(snap)\n"
    "    return state\n",
], ids=["rebind-from-outputs", "copy-before-release"])
def test_port_idioms_are_clean(src):
    assert race_audit.lint_source(src, SIM_PATH) == []


# ------------------------------------------------------------ overlap window


def test_window_mutation_fires_and_sync_closes_the_window():
    body = ("    outs = _chunk(cfg, state, keys, 4, 0, [None], 1)\n"
            "    state = [s for s, _ in outs]\n")
    bad = ("def loop(cfg, state, keys, perf):\n" + body
           + "    state = [x for x in state[::-1]]\n"
           + "    perf.end(sync=lambda: outs[0][1].ticks.cpu())\n")
    got = race_audit.lint_source(bad, SIM_PATH)
    assert rules_of(got) == ["race-window-mutation"] and got[0].line == 4
    good = ("def loop(cfg, state, keys, perf):\n" + body
            + "    perf.end(sync=lambda: outs[0][1].ticks.cpu())\n"
            + "    state = [x for x in state[::-1]]\n")
    assert race_audit.lint_source(good, SIM_PATH) == []


@pytest.mark.parametrize("line, fires", [
    ("    pending[0][0].fill_(0)\n", True),
    ("    pending[0][0][:] = 0\n", True),
    ("    rows = host_numpy(*pending)\n    rows[0][:] = 0\n", False),
])
def test_write_into_an_in_flight_copy(line, fires):
    src = ("def export(recs):\n"
           "    pending = to_host_async(recs)\n" + line)
    got = race_audit.lint_source(src, SIM_PATH)
    assert rules_of(got) == (["race-window-mutation"] if fires else []), got


def test_overlap_write_sets_exclude_the_carry():
    sets = race_audit.overlap_write_sets()
    serve = sets.get("raft_sim_tpu_torch/serve/loop.py::serve")
    assert serve, sorted(sets)
    assert "self._s" not in serve and "next_planes" in serve


# --------------------------------------------------------- key-stream rule


@pytest.mark.parametrize("body, fires", [
    ("    a = threefry.bits(k, (4,))\n    b = threefry.bits(k, (4,))\n", True),
    ("    a = threefry.split(k, 2)\n    b = threefry.split(k, 3)\n", True),
    ("    a = threefry.randint(k, (), 0, 5)\n    b = threefry.fold_in(k, 1)\n", True),
    ("    a = threefry.fold_in(k, 3)\n    b = threefry.fold_in(k, 3)\n", True),
    ("    a = threefry.fold_in(k, 3)\n    b = threefry.fold_in(k, 5)\n"
     "    c = threefry.split(k, 2)\n", False),
    ("    a = threefry.bits(k, (4,))\n    k = threefry.split(k0, 2)[0]\n"
     "    b = threefry.bits(k, (4,))\n", False),
], ids=["double-draw", "double-split", "draw-then-fold", "same-salt", "distinct-streams",
        "rebind-resets"])
def test_key_reuse(body, fires):
    src = "def draw(k, k0):\n" + body
    assert ("race-key-reuse" in rules_of(race_audit.lint_source(src, KEY_PATH))) == fires
    # Outside the stochastic packages the rule does not run.
    assert race_audit.lint_source(src, "raft_sim_tpu_torch/obs/fake.py") == []


# ------------------------------------------------------- registries


def test_second_sink_writer_fires_and_registered_one_is_clean():
    src = ("def append_windows(self, recs):\n"
           "    with open(self._path('windows.jsonl'), 'a') as f:\n"
           "        f.write('x')\n")
    assert race_audit.lint_source(src, "raft_sim_tpu_torch/utils/telemetry_sink.py") == []
    got = race_audit.lint_source(src, "raft_sim_tpu_torch/serve/other.py")
    assert rules_of(got) == ["race-sink-writer"] and "windows.jsonl" in got[0].message


def test_stale_owner_row_fires(monkeypatch):
    monkeypatch.setitem(race_audit.APPEND_OWNERS,
                        ("raft_sim_tpu_torch/serve/loop.py", "gone"), "ghost.jsonl")
    got = race_audit.lint_tree(run.package_root())
    assert rules_of(got) == ["race-sink-writer"] and "ghost.jsonl" in got[0].message


def test_unregistered_release_both_ways(monkeypatch):
    src = ("@releases('state')\n"
           "def _my_chunk(cfg, state):\n"
           "    return state\n")
    got = race_audit.lint_source(src, SIM_PATH)
    assert rules_of(got) == ["race-unregistered-release"]
    ghost = policy.ReleasingEntry("sim.x._ghost", "raft_sim_tpu_torch/sim/chunked.py", "_ghost",
                                  "state", "released")
    monkeypatch.setattr(policy, "releasing_entry_points",
                        lambda real=policy.releasing_entry_points: real() + (ghost,))
    got = race_audit.lint_tree(run.package_root())
    assert rules_of(got) == ["race-unregistered-release"] and "_ghost" in got[0].message


def test_registry_covers_every_marked_step():
    marked = set()
    import ast
    import os

    from raft_sim_tpu_torch.analysis.ast_lint import iter_package_files

    for full, rel in iter_package_files(run.package_root()):
        for fname, _ in race_audit.release_marked(ast.parse(open(full).read())):
            marked.add((rel, fname))
    registered = {(e.path, e.func) for e in policy.releasing_entry_points()
                  if e.expected == "released"}
    assert marked == registered and len(marked) == 3
    assert os.path.exists(os.path.join(os.path.dirname(run.package_root()),
                                       "raft_sim_tpu_torch/utils/release.py"))


def test_parse_error_is_a_finding():
    assert rules_of(race_audit.lint_source("def f(:\n", SIM_PATH)) == ["race-parse-error"]


def test_tree_gates_clean_race_pass():
    assert race_audit.run_pass(run.package_root()) == []


# ------------------------------------------------------------- the sanitizer


def test_dynamic_leg_gates_clean():
    found, info = sanitizer.run_dynamic("cpu")
    assert found == []
    for label, stats in info["loops"].items():
        assert sum(stats["calls"].values()) >= 2, label
        assert stats["poisoned"] + stats["released"] > 0, label
    assert info["loops"]["sim.chunked.run_chunked"]["poisoned"] > 0


def test_sanitizer_catches_an_injected_use_after_release():
    """A loop that keeps a reference to a carry it has released and reads it
    after the next chunk: unarmed it reads the old state, armed the poison."""
    from raft_sim_tpu_torch.models import raft_batched

    state0, keys = scan.seed_fleet(TINY, 0, 2, torch.device("cpu"))

    def leaky():
        ss = [raft_batched.to_batch_minor(state0)]
        outs = chunked._chunk(TINY, ss, [keys], 4, 0, [None], 1)
        kept = [s for s, _ in outs]
        outs = chunked._chunk(TINY, kept, [keys], 4, 4, [None], 1)  # releases `kept`
        return int(kept[0].log_term.sum()), int(outs[0][0].term.sum())  # a late read

    plain = leaky()
    with sanitizer.armed() as stats:
        armed = leaky()
    assert stats["poisoned"] > 0 and stats["calls"] == {"sim.chunked._chunk": 2}
    assert armed[1] == plain[1] and armed[0] != plain[0]
    assert sanitizer.mismatched_leaves(plain, armed) == ["[0]"]


def test_sanitizer_restores_the_entry_points():
    from raft_sim_tpu_torch.serve import loop
    from raft_sim_tpu_torch.sim import telemetry

    before = (chunked._chunk, telemetry._chunk_t, loop._serve_chunk)
    with sanitizer.armed():
        assert chunked._chunk is not before[0] and hasattr(chunked._chunk, "_race_sanitizer_real")
        with sanitizer.armed() as inner:  # re-arming is a no-op
            assert inner["calls"] == {}
    assert (chunked._chunk, telemetry._chunk_t, loop._serve_chunk) == before


def _cli(argv, capsys):
    from raft_sim_tpu_torch.__main__ import main

    assert main(argv) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_run_sanitize_equals_unarmed(tmp_path, capsys):
    from raft_sim_tpu_torch.utils import checkpoint

    outs = {}
    for tag, extra in (("plain", []), ("armed", ["--sanitize"])):
        argv = ["run", "--preset", "config6", "--batch", "4", "--ticks", "48", "--chunk", "16",
                "--device", "cpu", "--telemetry-dir", str(tmp_path / tag), "--telemetry-window",
                "16", "--save", str(tmp_path / f"{tag}.npz"), *extra]
        outs[tag] = _cli(argv, capsys)
    (plain, perr), (armed, aerr) = outs["plain"], outs["armed"]
    assert "sanitizer:" not in perr and "sanitizer: clean (sim.telemetry._chunk_tx3;" in aerr
    drop = ("wall_s", "cluster_ticks_per_s")
    assert {k: v for k, v in plain.items() if k not in drop} == \
        {k: v for k, v in armed.items() if k not in drop}
    a = checkpoint.load(str(tmp_path / "plain.npz"), device="cpu")
    b = checkpoint.load(str(tmp_path / "armed.npz"), device="cpu")
    assert sanitizer.mismatched_leaves(a[1:4], b[1:4]) == []
    for name in ("windows.jsonl", "summary.json"):
        assert (tmp_path / "plain" / name).read_text().replace(str(tmp_path / "plain"), "") == \
            (tmp_path / "armed" / name).read_text().replace(str(tmp_path / "armed"), "")


def test_serve_sanitize_equals_unarmed(tmp_path, capsys):
    src = tmp_path / "cmds.jsonl"
    src.write_text("".join(f"{v}\n" for v in range(1, 9)))
    outs = {}
    for tag, extra in (("plain", []), ("armed", ["--sanitize"])):
        argv = ["serve", "--source", str(src), "--preset", "config9", "--batch", "4", "--chunk",
                "16", "--window", "8", "--warmup", "32", "--chunks", "3", "--device", "cpu",
                "--sink", str(tmp_path / tag), *extra]
        outs[tag] = _cli(argv, capsys)
    (plain, _), (armed, aerr) = outs["plain"], outs["armed"]
    assert "serve.loop._serve_chunkx3" in aerr
    drop = ("wall_s", "cluster_ticks_per_s", "ops_per_s", "sink")
    assert {k: v for k, v in plain.items() if k not in drop} == \
        {k: v for k, v in armed.items() if k not in drop}
    assert plain["commands_acked"] > 0
    assert (tmp_path / "plain" / "deltas.jsonl").read_text() == \
        (tmp_path / "armed" / "deltas.jsonl").read_text()
