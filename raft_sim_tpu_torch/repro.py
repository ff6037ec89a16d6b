"""Violation repro and shrink (the port of tools/repro.py).

A fuzz run reports `violations > 0` as one count over many clusters and
ticks. `shrink` isolates the first one: it re-runs the same seeded fleet in
chunks (trajectories are functions of (seed, cfg) alone, so nothing need be
saved from the first run), stops at the first chunk with a violation, takes
the first offending cluster and replays it alone from the chunk's start
with every tick's state (`scan.run(..., trace_states=True)`, a B=1 view of
the batched path: one kernel launch a tick on the card), and returns

  - the cluster, the first violating tick and the violation kinds,
  - the decoded events around it (sim/trace.py),
  - each node's state line at that tick, and
  - a command line that replays the run up to just past it.

    python -m raft_sim_tpu_torch.repro --preset config4 --seed 7 --ticks 20000
    python -m raft_sim_tpu_torch.repro --n-nodes 5 --drop-prob 0.3 --seed 3 --ticks 5000
    python -m raft_sim_tpu_torch.repro --scenario repro.json   # replay a shrunk artifact
    python -m raft_sim_tpu_torch.repro --corpus tests/corpus   # replay every artifact

Exit codes: 0 with {"found": false} for a clean run; 1 with the violation
(a failure for scripts); with --scenario, 0 when the artifact's violation
comes back at the same tick with the same kinds and 2 when it does not;
with --corpus, 0 when every artifact reproduces and 2 naming the first that
drifts. It runs on the card (and fails without one) unless given
--device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

import numpy as np

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import chunked, scan, trace
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

VIOL_FIELDS = ("viol_election_safety", "viol_commit", "viol_log_matching", "viol_read_stale")


def shrink(cfg: RaftConfig, seed: int, batch: int, n_ticks: int, chunk: int = 512,
           context: int = 30, device="cuda") -> dict | None:
    """The first violating (cluster, tick) of a seeded run, or None when no
    violation occurs within `n_ticks`: a dict with cluster, tick, kinds,
    chunk_start, events ((tick, text) pairs within `context` ticks of it),
    state_lines (one per node at that tick) and repro_cmd."""
    dev = device_mod.resolve(device)
    state, keys = scan.seed_fleet(cfg, seed, batch, dev)
    done = 0
    while done < n_ticks:
        n = min(chunk, n_ticks - done)
        nxt, m = chunked.run_chunked(cfg, state, keys, n, chunk=n, now=done)
        viol = m.violations.cpu().numpy()
        if int(viol.sum()) == 0:
            state, done = nxt, done + n
            continue
        # The first offending cluster, replayed alone from the chunk start
        # with every tick's info and state (equal to its batched run).
        cluster = int(np.argmax(viol > 0))
        one = raft_batched._map(lambda x: x[cluster], state)
        _, _, (infos, states) = scan.run(cfg, one, keys[cluster], n, trace_states=True)
        kinds_by_tick = {f: getattr(infos, f).cpu().numpy() for f in VIOL_FIELDS}
        bad = np.zeros(n, bool)
        for v in kinds_by_tick.values():
            bad |= v
        assert bad.any(), "batched run flagged a violation the replay did not"
        t_rel = int(np.argmax(bad))
        tick = done + t_rel
        return {
            "cluster": cluster,
            "tick": tick,
            "kinds": [f for f, v in kinds_by_tick.items() if bool(v[t_rel])],
            "chunk_start": done,
            "events": [(done + t, e) for t, e in trace.events(states)
                       if abs(t - t_rel) <= context],
            "state_lines": [trace.node_line(states, t_rel, i) for i in range(cfg.n_nodes)],
            "repro_cmd": _repro_cmd(cfg, seed, batch, tick),
        }
    return None


def _repro_cmd(cfg: RaftConfig, seed: int, batch: int, tick: int) -> str:
    """A command line replaying the run up to just past the violation."""
    flags = [f"--{f.name.replace('_', '-')} {getattr(cfg, f.name)}"
             for f in dataclasses.fields(RaftConfig) if getattr(cfg, f.name) != f.default]
    return (f"python -m raft_sim_tpu_torch run --seed {seed} --batch {batch} "
            f"--ticks {tick + 1} " + " ".join(flags))


def replay_scenario(path: str, context: int, device="cuda") -> int:
    """Replay a scenario repro artifact; 0 = reproduced at the same tick."""
    from raft_sim_tpu_torch.scenario import shrink as shrink_mod

    art = shrink_mod.load_artifact(path)
    res = shrink_mod.replay_artifact(art, context=context, device=device)
    print(json.dumps({
        "found": res["tick"] is not None,
        "reproduced": res["reproduced"],
        "tick": res["tick"],
        "expected_tick": res["expected_tick"],
        "kinds": res["kinds"],
        "expected_kinds": res["expected_kinds"],
        "mutant": art.get("mutant"),
        "segments": art.get("segments"),
    }))
    for t, e in res["events"]:
        marker = " <== VIOLATION TICK" if t == res["tick"] else ""
        print(f"tick {t:>7}  {e}{marker}", file=sys.stderr)
    return 0 if res["reproduced"] else 2


def replay_corpus(directory: str, device="cuda") -> int:
    """Replay every artifact of a corpus directory; 0 = all reproduced, 2 =
    the first drifting artifact, named on stderr and in the last line."""
    from raft_sim_tpu_torch.scenario import shrink as shrink_mod

    paths = sorted(glob.glob(os.path.join(directory, "*.json")))
    if not paths:
        print(json.dumps({"corpus": directory, "error": "no artifacts"}))
        return 2
    for path in paths:
        name = os.path.basename(path)
        art = shrink_mod.load_artifact(path)
        res = shrink_mod.replay_artifact(art, context=0, device=device)
        print(json.dumps({
            "artifact": name,
            "reproduced": res["reproduced"],
            "tick": res["tick"],
            "expected_tick": res["expected_tick"],
            "kinds": res["kinds"],
            "expected_kinds": res["expected_kinds"],
            "mutant": art.get("mutant"),
        }))
        if not res["reproduced"]:
            print(f"corpus DRIFT: {name} (expected tick {res['expected_tick']} "
                  f"{res['expected_kinds']}, got {res['tick']} {res['kinds']})", file=sys.stderr)
            print(json.dumps({"corpus": directory, "artifacts": len(paths), "drifted": name}))
            return 2
    print(json.dumps({"corpus": directory, "artifacts": len(paths), "reproduced": len(paths)}))
    return 0


def main(argv=None) -> int:
    from raft_sim_tpu_torch.driver import add_config_flags, add_device_arguments, build_config
    from raft_sim_tpu_torch.driver import select_device

    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch.repro")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--context", type=int, default=30)
    ap.add_argument("--scenario", metavar="FILE", default=None,
                    help="replay a scenario repro artifact instead of shrinking a run (exit 0 "
                         "iff the violation reproduces at the same tick)")
    ap.add_argument("--corpus", metavar="DIR", default=None,
                    help="replay every artifact in a corpus directory (tests/corpus); exit 2 "
                         "naming the first drifting artifact")
    add_device_arguments(ap)
    add_config_flags(ap)
    args = ap.parse_args(argv)
    select_device(ap, args)
    if args.scenario and args.corpus:
        ap.error("--scenario and --corpus are exclusive")
    if args.corpus:
        return replay_corpus(args.corpus, device=args.device)
    if args.scenario:
        return replay_scenario(args.scenario, args.context, device=args.device)
    if args.ticks is None:
        ap.error("--ticks is required (unless replaying with --scenario or --corpus)")
    cfg, batch = build_config(args)
    res = shrink(cfg, args.seed, batch, args.ticks, chunk=args.chunk, context=args.context,
                 device=args.device)
    if res is None:
        print(json.dumps({"found": False, "ticks": args.ticks, "batch": batch}))
        return 0
    events = res.pop("events")
    lines = res.pop("state_lines")
    print(json.dumps({"found": True, **res}))
    print(f"--- state at tick {res['tick']} (cluster {res['cluster']}) ---", file=sys.stderr)
    for ln in lines:
        print(ln, file=sys.stderr)
    print("--- events around the violation ---", file=sys.stderr)
    for t, e in events:
        marker = " <== VIOLATION TICK" if t == res["tick"] else ""
        print(f"tick {t:>7}  {e}{marker}", file=sys.stderr)
    return 1  # a violation is a failure for scripts


if __name__ == "__main__":
    sys.exit(main())
