"""Shrink a violating (genome, seed, horizon) triple to a small repro
artifact, and replay one (the port of raft_sim_tpu/scenario/shrink.py).

A search hit names one cluster of a heterogeneous fleet whose invariants
tripped. `shrink` minimizes it greedily -- drop each whole fault mechanism,
then halve the surviving thresholds -- where every trial replays that one
cluster from the seeded fleet's own init and key (`_single_cluster`: the same
trajectory the fleet ran) through `scan.run_traced`, a B=1 view of the
batch-minor path, so on the card each trial tick is one launch of the tick
kernel. The artifact holds the minimized genome (exact leaves and decoded
units), (config, mutant, seed, batch, cluster, seg_len, horizon = first
violating tick + 1, kinds), the events around the violation and each node's
state line at it (sim/trace.py), equal to the JAX `shrink`'s field for field
but `provenance` (which the JAX fuzzing farm stamps).

`replay_artifact` replays an artifact at its horizon and reports whether the
same first violating tick and kinds came back.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from raft_sim_tpu_torch.scenario import genome as genome_mod
from raft_sim_tpu_torch.sim import scan, trace
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig, nondefault_fields

VIOL_FIELDS = (
    "viol_election_safety", "viol_commit", "viol_log_matching", "viol_read_stale",
)

# Ablation groups tried whole-mechanism-first, then threshold knobs halved
# while the violation survives (the JAX order: the artifacts must agree).
ABLATIONS = (
    ("clock skew", {"skew": 0}),
    ("client traffic", {"client_interval": 0}),
    ("leadership transfers", {"transfer_interval": 0}),
    ("reads", {"read_interval": 0}),
    ("membership changes", {"reconfig_interval": 0}),
    ("message drop", {"drop": 0}),
    ("partitions", {"part": 0, "part_period": 0}),
    ("crashes", {"crash": 0}),
)
HALVABLE = ("drop", "part", "crash", "skew")
CHECK_EVERY = 16  # ticks between a trial's reads of its violation flag


def _single_cluster(cfg: RaftConfig, seed: int, batch: int, cluster: int, device):
    """(state [1, ...], keys [1, 2]) of one cluster of the seeded fleet: its
    slice of the batched init and run keys."""
    state, keys = scan.seed_fleet(cfg, seed, batch, device)
    take = lambda x: x[cluster:cluster + 1].contiguous()  # noqa: E731
    return scan.raft_batched._map(take, state), keys[cluster:cluster + 1].contiguous()


def _replay(cfg, state, keys, n_ticks: int, g, seg_len: int):
    """(infos, states) of one cluster's replay under the `[S]` genome `g`, as
    numpy trees with a leading [T] axis."""
    dev = state.role.device
    g1 = genome_mod.broadcast(genome_mod.to_device(g, dev), 1)
    _, _, (infos, states) = scan.run_traced(cfg, state, keys, n_ticks, genome=g1,
                                            seg_len=seg_len)
    take = lambda tree: device_mod.host_numpy(  # noqa: E731
        *device_mod.to_host_async(scan.raft_batched._map(lambda x: x[0], tree)))
    return take(infos), take(states)


def _violates(cfg, state, keys, n_ticks: int, g, seg_len: int) -> bool:
    """Whether the replay trips any invariant within `n_ticks`. The flag is
    read back every CHECK_EVERY ticks and the replay stops at the first
    read that shows one: the answer is the full horizon's."""
    dev = state.role.device
    g1 = genome_mod.broadcast(genome_mod.to_device(g, dev), 1)
    now = int(state.now.reshape(-1)[0])
    s = scan.raft_batched.to_batch_minor(state)
    m = scan.raft_batched.to_batch_minor(scan.init_metrics_batch(1, dev))
    bad = torch.zeros((1,), dtype=torch.bool, device=dev)
    drawn = scan.input_ticks(cfg, keys, now, n_ticks, g1, seg_len)
    for k, (t, inp) in enumerate(zip(range(now, now + n_ticks), drawn)):
        s, m, info = scan.tick_batch_minor(cfg, s, keys, m, t, inputs=inp)
        bad = bad | scan.step_bad(info)
        if (k + 1) % CHECK_EVERY == 0 and bool(bad.item()):
            return True
    return bool(bad.item())


def _first_violation(infos) -> tuple[int | None, list[str]]:
    """(first violating tick index, kinds at that tick) of stacked StepInfo."""
    flags = {f: np.asarray(getattr(infos, f)) for f in VIOL_FIELDS}
    bad = np.zeros_like(next(iter(flags.values())))
    for v in flags.values():
        bad = bad | v
    if not bad.any():
        return None, []
    t = int(np.argmax(bad))
    return t, [f for f, v in flags.items() if bool(v[t])]


def _zero(genome, fields: dict):
    return genome._replace(**{f: torch.zeros_like(getattr(genome, f)) for f in fields})


def _events(states, tick: int, context: int) -> list:
    return [(t, e) for t, e in trace.events(states) if abs(t - tick) <= context]


def shrink(cfg: RaftConfig, hit: dict, mutant: str | None = None, halving_rounds: int = 3,
           context: int = 30, device="cuda") -> dict:
    """Minimize a search hit (search.py's hit schema) to a repro artifact.
    `cfg` must be the tick the hit was found against (the mutation.py config
    for a mutant hunt); `mutant` labels the artifact so a replay rebuilds
    it. Raises ValueError if the hit does not reproduce at its horizon."""
    dev = device_mod.resolve(device)
    seed, batch, cluster = hit["seed"], hit["batch"], hit["cluster"]
    seg_len, horizon = int(hit["seg_len"]), int(hit["ticks"])
    g0 = genome_mod.from_raw(hit["genome_raw"])
    state, keys = _single_cluster(cfg, seed, batch, cluster, dev)

    def violates(g):
        return _violates(cfg, state, keys, horizon, g, seg_len)

    if not violates(g0):
        raise ValueError(
            "hit does not reproduce: cluster "
            f"{cluster} of seed {seed} ran {horizon} ticks clean under its "
            "recorded genome -- (genome, seed, horizon) bookkeeping is broken"
        )

    # Phase 1: drop whole fault mechanisms while the violation survives.
    g, removed = g0, []
    for label, fields in ABLATIONS:
        cand = _zero(g, fields)
        if violates(cand):
            g, removed = cand, removed + [label]

    # Phase 2: halve surviving thresholds, `halving_rounds` passes at most.
    for _ in range(halving_rounds):
        any_halved = False
        for f in HALVABLE:
            leaf = getattr(g, f)
            if not bool(leaf.any()):
                continue
            cand = g._replace(**{f: leaf // 2})
            if violates(cand):
                g, any_halved = cand, True
        if not any_halved:
            break

    # Confirmation at the minimized genome: tick, kinds, events, state lines.
    infos, states = _replay(cfg, state, keys, horizon, g, seg_len)
    tick, kinds = _first_violation(infos)
    events = _events(states, tick, context)
    state_lines = [trace.node_line(states, tick, i) for i in range(cfg.n_nodes)]
    return {
        "schema": "scenario-repro-v1",
        "config": nondefault_fields(cfg),
        "mutant": mutant,
        "seed": int(seed),
        "batch": int(batch),
        "cluster": int(cluster),
        "seg_len": seg_len,
        "ticks": int(tick) + 1,
        "tick": int(tick),
        "kinds": kinds,
        "removed": removed,
        "genome_raw": genome_mod.to_raw(g),
        "segments": genome_mod.decode(g),
        "events": events,
        "state_lines": state_lines,
        "repro_cmd": "python tools/repro.py --scenario <artifact.json>",
    }


def save_artifact(path: str, art: dict) -> str:
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
        f.write("\n")
    return path


# v1 is the raw shrink output; v2 adds the fuzzing farm's provenance block.
# Replay needs only (config, mutant, genome, seed, horizon), which both carry.
ARTIFACT_SCHEMAS = ("scenario-repro-v1", "scenario-repro-v2")


def load_artifact(path: str) -> dict:
    with open(path) as f:
        art = json.load(f)
    if art.get("schema") not in ARTIFACT_SCHEMAS:
        raise ValueError(f"not a scenario repro artifact: {path}")
    return art


def artifact_config(art: dict) -> RaftConfig:
    """The exact tick the artifact was minimized against (the mutant label
    routes through mutation.py's registry)."""
    cfg = RaftConfig(**art.get("config", {}))
    if art.get("mutant"):
        from raft_sim_tpu_torch.scenario.mutation import mutant_config

        cfg = mutant_config(art["mutant"], cfg)
    return cfg


def replay_artifact(art: dict, context: int = 30, horizon: int | None = None,
                    device="cuda") -> dict:
    """Replay an artifact (at its own horizon, or `horizon` ticks: a longer
    one shows the events after the violation). Returns {"reproduced",
    "tick", "expected_tick", "kinds", "expected_kinds", "events",
    "state_lines"}; `reproduced` means the same first violating tick and
    kinds came back."""
    dev = device_mod.resolve(device)
    cfg = artifact_config(art)
    g = genome_mod.from_raw(art["genome_raw"])
    state, keys = _single_cluster(cfg, art["seed"], art["batch"], art["cluster"], dev)
    n_ticks = int(art["ticks"]) if horizon is None else int(horizon)
    infos, states = _replay(cfg, state, keys, n_ticks, g, int(art["seg_len"]))
    tick, kinds = _first_violation(infos)
    found = tick is not None
    return {
        "reproduced": tick == art["tick"] and kinds == art["kinds"],
        "tick": tick,
        "expected_tick": art["tick"],
        "kinds": kinds,
        "expected_kinds": art["kinds"],
        "events": _events(states, tick, context) if found else [],
        "state_lines": ([trace.node_line(states, tick, i) for i in range(cfg.n_nodes)]
                        if found else []),
    }
