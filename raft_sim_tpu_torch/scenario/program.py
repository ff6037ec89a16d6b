"""Phased nemesis programs: declarative fault timelines over a fleet (the port
of raft_sim_tpu/scenario/program.py; host-only).

A ScenarioProgram is S genome segments played in order, `seg_len` ticks each
("partition for 200 ticks, heal, then crash"): the tick's inputs read segment
clip(now // seg_len, 0, S - 1) (faults.genome_at), so the final segment holds
past the program's end. Programs load from JSON:

    {"name": "partition-heal-crash", "seg_len": 200,
     "segments": [{"partition_period": 32, "partition_prob": 1.0}, {},
                  {"crash_prob": 0.5, "crash_down_ticks": 12}]}

Segment keys are `genome.segment`'s keywords in human units; an empty segment
is fault-free. `to_dict(exact=True)` adds the integer leaves (`genome_raw`),
which checkpoints and repro artifacts carry so a resumed run draws from the
identical thresholds.
"""

from __future__ import annotations

import dataclasses
import json

from raft_sim_tpu_torch.scenario import genome as genome_mod
from raft_sim_tpu_torch.scenario.genome import ScenarioGenome
from raft_sim_tpu_torch.utils.config import RaftConfig

# The declarative segment vocabulary (genome.segment keywords).
SEGMENT_KEYS = frozenset({
    "drop_prob", "partition_period", "partition_prob", "crash_prob",
    "crash_down_ticks", "clock_skew_prob", "client_interval",
})


@dataclasses.dataclass(frozen=True)
class ScenarioProgram:
    """A named phased timeline: `genome` holds `[S]` per-segment leaves,
    `seg_len` is the per-segment tick span."""

    name: str
    seg_len: int
    genome: ScenarioGenome

    @property
    def n_segments(self) -> int:
        return self.genome.drop.shape[0]

    @property
    def span(self) -> int:
        """Ticks until the final segment becomes standing (it holds forever)."""
        return self.seg_len * (self.n_segments - 1)


def from_dict(doc: dict, cfg: RaftConfig | None = None) -> ScenarioProgram:
    """Build (and, given `cfg`, validate) a program from the schema above. A
    `genome_raw` key (exact integer leaves) takes precedence over re-encoding
    the human-unit segments, whose probabilities are rounded."""
    unknown = set(doc) - {"name", "seg_len", "segments", "genome_raw"}
    if unknown:
        raise ValueError(f"unknown scenario keys {sorted(unknown)}")
    segments = doc.get("segments")
    if not isinstance(segments, list) or not segments:
        raise ValueError("scenario needs a non-empty 'segments' list")
    seg_len = int(doc.get("seg_len", 1))
    if seg_len < 1:
        raise ValueError(f"seg_len must be >= 1, got {seg_len}")
    for i, seg in enumerate(segments):
        bad = set(seg) - SEGMENT_KEYS
        if bad:
            raise ValueError(
                f"segment {i}: unknown keys {sorted(bad)} "
                f"(legal: {sorted(SEGMENT_KEYS)})"
            )
    if doc.get("genome_raw") is not None:
        g = genome_mod.from_raw(doc["genome_raw"])
        if g.drop.shape[0] != len(segments):
            raise ValueError(
                f"genome_raw carries {g.drop.shape[0]} segments but the "
                f"'segments' list has {len(segments)}"
            )
    else:
        # crash_down_ticks defaults to 1 so fault-free segments validate
        # under any crash_period.
        g = genome_mod.from_segments([
            genome_mod.segment(**{"crash_down_ticks": 1, **seg}) for seg in segments
        ])
    if cfg is not None:
        genome_mod.validate(cfg, g)
    return ScenarioProgram(name=str(doc.get("name", "scenario")), seg_len=seg_len, genome=g)


def to_dict(program: ScenarioProgram, exact: bool = False) -> dict:
    """Inverse of from_dict in human units; `exact=True` also embeds the
    integer leaves (`genome_raw`), so the round trip is bit-exact."""
    segs = []
    for row in genome_mod.decode(program.genome):
        seg = {k: row[k] for k in (
            "drop_prob", "partition_period", "partition_prob", "crash_prob",
            "crash_down_ticks", "clock_skew_prob", "client_interval",
        )}
        segs.append({k: v for k, v in seg.items() if v not in (0, 0.0)} or {})
    doc = {"name": program.name, "seg_len": program.seg_len, "segments": segs}
    if exact:
        doc["genome_raw"] = genome_mod.to_raw(program.genome)
    return doc


def load(path: str, cfg: RaftConfig | None = None) -> ScenarioProgram:
    with open(path) as f:
        return from_dict(json.load(f), cfg)


def save(path: str, program: ScenarioProgram) -> str:
    with open(path, "w") as f:
        json.dump(to_dict(program), f, indent=1)
        f.write("\n")
    return path
