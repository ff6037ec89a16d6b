"""The safety corpus: dedup, provenance and the checker gate (the port of
raft_sim_tpu/farm/corpus.py).

  signature   a hit's identity is (kernel, violation kinds, mechanism set):
              which tick broke, which invariants fired, and which fault
              mechanisms survived the shrink. Two hits with one signature
              are one bug reached twice.
  dedup       a new artifact whose mechanism set equals, or nests either way
              with, an existing same-kernel same-kinds artifact's is refused.
  provenance  a corpus artifact (schema scenario-repro-v2) records who found
              it: fitness, generation, seed, the shrink's ablations.
  checker     before freezing, the artifact's cluster is replayed traced at
              batch 1 (the same trajectory as its fleet run) and the six-
              property whole-history checker (trace/checker.py) must reject
              it naming a property (`check_artifact`).
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os

import numpy as np

from raft_sim_tpu_torch.scenario import genome as genome_mod
from raft_sim_tpu_torch.scenario import shrink as shrink_mod
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig

# scenario-repro-v1 plus the required provenance block.
CORPUS_SCHEMA = "scenario-repro-v2"

PROVENANCE_FIELDS = ("mutant", "fitness", "generation", "seed", "ablated")

CORE_FIELDS = (
    "seed", "batch", "cluster", "seg_len", "ticks", "tick", "kinds",
    "genome_raw",
)

# A mechanism is active iff ALL its gating genome fields are nonzero (labels
# are shrink.ABLATIONS'): a partition needs its threshold and its period.
MECHANISM_GATES = {
    "clock skew": ("skew",),
    "client traffic": ("client_interval",),
    "leadership transfers": ("transfer_interval",),
    "reads": ("read_interval",),
    "membership changes": ("reconfig_interval",),
    "message drop": ("drop",),
    "partitions": ("part", "part_period"),
    "crashes": ("crash",),
}
assert set(MECHANISM_GATES) == {label for label, _ in shrink_mod.ABLATIONS}


def mechanisms(art: dict) -> frozenset:
    """The fault mechanisms active in an artifact's minimized genome: what
    the shrink could not remove."""
    raw = art["genome_raw"]
    return frozenset(label for label, gates in MECHANISM_GATES.items()
                     if all(f in raw and np.asarray(raw[f]).any() for f in gates))


def signature(art: dict) -> tuple:
    """(kernel, violation kinds, mechanism set): the dedup identity."""
    kernel = art.get("mutant") or "real"
    return (kernel, tuple(sorted(art["kinds"])), mechanisms(art))


def load_corpus(directory: str) -> list[tuple[str, dict]]:
    """Every artifact in a corpus directory, sorted by name."""
    return [(p, shrink_mod.load_artifact(p))
            for p in sorted(glob.glob(os.path.join(directory, "*.json")))]


def find_duplicate(art: dict, corpus_dir: str) -> dict | None:
    """The existing artifact a new hit duplicates (same kernel, same kinds,
    mechanism sets nested either way) as {"path", "signature",
    "duplicate_of"}, or None."""
    if not os.path.isdir(corpus_dir):
        return None
    kernel, kinds, mech = signature(art)
    for path, old in load_corpus(corpus_dir):
        k2, kinds2, mech2 = signature(old)
        if kernel == k2 and kinds == kinds2 and (mech <= mech2 or mech2 <= mech):
            return {"path": path, "signature": [kernel, list(kinds), sorted(mech)],
                    "duplicate_of": os.path.basename(path)}
    return None


def validate_artifact(art: dict) -> list[str]:
    """Problems with a corpus-grade artifact ([] = valid); a v1 artifact
    (no provenance) fails."""
    errs = []
    if art.get("schema") != CORPUS_SCHEMA:
        errs.append(f"schema {art.get('schema')!r}: corpus artifacts must be "
                    f"{CORPUS_SCHEMA} (provenance-stamped)")
    for k in CORE_FIELDS:
        if k not in art:
            errs.append(f"missing core field {k!r}")
    prov = art.get("provenance")
    if not isinstance(prov, dict):
        errs.append("missing provenance block (who found this, and how?)")
        return errs
    for k in PROVENANCE_FIELDS:
        if k not in prov:
            errs.append(f"provenance: missing field {k!r}")
    if "generation" in prov and not (prov["generation"] is None
                                     or isinstance(prov["generation"], int)):
        errs.append("provenance: generation must be an int or null")
    if "seed" in prov and not isinstance(prov["seed"], int):
        errs.append("provenance: seed must be an int")
    if "ablated" in prov and not isinstance(prov["ablated"], list):
        errs.append("provenance: ablated must be the shrink ablation list")
    if "mutant" in prov and prov["mutant"] != art.get("mutant"):
        errs.append(f"provenance: mutant {prov.get('mutant')!r} disagrees with the "
                    f"artifact's kernel label {art.get('mutant')!r}")
    return errs


def stamp(art: dict, provenance: dict) -> dict:
    """A v2 corpus artifact from a shrink output and provenance facts (the
    ablation set defaults to the artifact's own `removed`)."""
    prov = dict(provenance)
    prov.setdefault("mutant", art.get("mutant"))
    prov.setdefault("ablated", list(art.get("removed", [])))
    out = dict(art, schema=CORPUS_SCHEMA, provenance=prov)
    problems = validate_artifact(out)
    if problems:
        raise ValueError(f"artifact failed corpus validation: {problems}")
    return out


def check_artifact(art: dict, real: bool = False, window: int = 64, depth: int = 512,
                   device="cuda"):
    """Replay an artifact's cluster traced and run the six-property checker
    over its history. `real=False` replays the artifact's own tick (mutant
    included): the freeze gate expects a rejection naming a property;
    `real=True` drops the mutant: the fixed tick under the same genome, seed
    and faults must pass all six. The replay is the artifact's cluster at
    batch 1 (its fleet run's trajectory), on `device`, through the windowed
    telemetry loop with inputs drawn a span of ticks at a time, for the
    horizon rounded up to whole windows. Returns the CheckReport."""
    from raft_sim_tpu_torch.sim import telemetry
    from raft_sim_tpu_torch.trace import checker as checker_mod
    from raft_sim_tpu_torch.trace import history as history_mod
    from raft_sim_tpu_torch.trace.ring import TraceSpec

    dev = device_mod.resolve(device)
    cfg = RaftConfig(**art.get("config", {})) if real else shrink_mod.artifact_config(art)
    cfg = dataclasses.replace(cfg, track_trace=True)
    n_ticks = int(math.ceil(int(art["ticks"]) / window)) * window
    spec = TraceSpec(depth=depth)
    state, keys = shrink_mod._single_cluster(cfg, int(art["seed"]), int(art["batch"]),
                                             int(art["cluster"]), dev)
    g = genome_mod.to_device(genome_mod.broadcast(genome_mod.from_raw(art["genome_raw"]), 1),
                             dev)
    out = telemetry.run_batch_minor_telemetry(cfg, state, keys, n_ticks, window, None,
                                              genome=g, seg_len=int(art["seg_len"]),
                                              trace_spec=spec, now=0)
    return checker_mod.check_history(history_mod.from_device(out[4], spec))


def default_name(art: dict) -> str:
    """`<kernel>-n<N>`, the corpus naming (weak-quorum-n5)."""
    kernel = art.get("mutant") or "real"
    return f"{kernel}-n{RaftConfig(**art.get('config', {})).n_nodes}"


def freeze(art: dict, corpus_dir: str, provenance: dict, name: str | None = None,
           window: int = 64, depth: int = 512, device="cuda") -> tuple[str, dict]:
    """Stamp, checker-gate and write one artifact into the corpus. Raises if
    the checker does not reject the artifact's tick (a hit the six properties
    cannot name does not belong in a safety corpus) or the stamped artifact
    fails validation; dedup is the caller's gate (`find_duplicate`). Returns
    (path, stamped artifact), the rejected property in
    provenance["checker_property"]."""
    rep = check_artifact(art, window=window, depth=depth, device=device)
    if not rep.violated:
        state = "passed" if rep.ok else "was undecided on"
        raise ValueError(
            f"refusing to freeze: the six-property checker {state} the artifact's replay "
            f"(complete={rep.complete}, problems={rep.problems[:2]}) -- the corpus regresses "
            "safety semantics, so a hit the checker cannot name does not belong in it")
    art2 = stamp(art, dict(provenance, checker_property=rep.violated[0]))
    os.makedirs(corpus_dir, exist_ok=True)
    base = name or default_name(art2)
    path = os.path.join(corpus_dir, f"{base}.json")
    i = 2
    while os.path.exists(path):
        path = os.path.join(corpus_dir, f"{base}-{i}.json")
        i += 1
    shrink_mod.save_artifact(path, art2)
    return path, art2


def backfill_provenance(path: str, provenance: dict) -> dict:
    """Upgrade a v1 artifact file in place to the v2 corpus schema."""
    art2 = stamp(shrink_mod.load_artifact(path), provenance)
    shrink_mod.save_artifact(path, art2)
    return art2
