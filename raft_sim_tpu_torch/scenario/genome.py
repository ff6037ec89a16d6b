"""ScenarioGenome: per-cluster fault parameters as data (the port of
raft_sim_tpu/scenario/genome.py).

A genome is one point in fault space -- drop rate, rolling-partition period
and probability, crash probability and down-span, clock-skew probability, the
client and admin cadences, the disk-fault axes -- encoded so the tick stays
integer-only: every probability is a uint32 Bernoulli threshold
(`faults.p_to_u32`; an event fires iff a fresh uint32 draw is below it), every
cadence or span an int32. Each leaf carries a trailing `[S]` segment axis
(S = 1 for an unphased genome; program.py builds S > 1 timelines);
`broadcast` tiles it to the batched `[B, S]` layout, where row b is cluster
b's own fault setting -- the heterogeneous fleet sim/faults.py draws from.

The threshold leaves (`U32_FIELDS`) are int64 tensors holding the uint32
values, the form the port's threefry draws take (torch's CPU uint32 lacks
compares); the rest are int32. The genome covers tuning knobs only:
structural config (topology, log shape, timers, feature gates) stays on
RaftConfig, and `validate` holds each genome axis to the gate it tunes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raft_sim_tpu_torch.sim.faults import p_to_u32
from raft_sim_tpu_torch.utils.config import RaftConfig

U32_SPAN = float(1 << 32)


class ScenarioGenome(NamedTuple):
    """Per-segment fault parameters, `[S]` per leaf (batched: `[B, S]`); the
    field order is the JAX ScenarioGenome's."""

    drop: torch.Tensor  # uint32 value: per-edge message-drop threshold
    part_period: torch.Tensor  # int32: rolling-partition window ticks (0 = off)
    part: torch.Tensor  # uint32 value: per-window partition-activation threshold
    crash: torch.Tensor  # uint32 value: per-window per-node crash threshold
    crash_down: torch.Tensor  # int32: max down-span ticks (uniform 1..this)
    skew: torch.Tensor  # uint32 value: clock-skew threshold (half stall, half jump)
    client_interval: torch.Tensor  # int32: client offer cadence (0 = none)
    reconfig_interval: torch.Tensor  # int32: membership-toggle cadence (0 = none)
    transfer_interval: torch.Tensor  # int32: leadership-transfer cadence (0 = none)
    read_interval: torch.Tensor  # int32: ReadIndex offer cadence (0 = none)
    fsync_interval: torch.Tensor  # int32: fsync cadence ticks (0 = plane off)
    fsync_jitter: torch.Tensor  # uint32 value: per-node flush-stall threshold
    torn: torch.Tensor  # uint32 value: torn-tail-on-restart threshold
    torn_span: torch.Tensor  # int32: max extra entries a torn tail rejects


# The threshold-encoded fields; everything else is int32.
U32_FIELDS = frozenset({"drop", "part", "crash", "skew", "fsync_jitter", "torn"})


def leaf_dtype(field: str) -> torch.dtype:
    """The port's leaf dtype for a ScenarioGenome field: int64 carrying a
    uint32 value for the thresholds, int32 for the rest."""
    return torch.int64 if field in U32_FIELDS else torch.int32


def segment(
    *,
    drop_prob: float = 0.0,
    partition_period: int = 0,
    partition_prob: float = 0.0,
    crash_prob: float = 0.0,
    crash_down_ticks: int = 1,
    clock_skew_prob: float = 0.0,
    client_interval: int = 0,
    reconfig_interval: int = 0,
    transfer_interval: int = 0,
    read_interval: int = 0,
    fsync_interval: int = 0,
    fsync_jitter_prob: float = 0.0,
    torn_tail_prob: float = 0.0,
    lost_suffix_span: int = 1,
) -> dict:
    """One segment's parameters in human units (probabilities as floats),
    encoded to the genome's integer fields. A scenario file's segment keys
    are these keyword names."""
    return {
        "drop": p_to_u32(drop_prob),
        "part_period": int(partition_period),
        "part": p_to_u32(partition_prob),
        "crash": p_to_u32(crash_prob),
        "crash_down": int(crash_down_ticks),
        "skew": p_to_u32(clock_skew_prob),
        "client_interval": int(client_interval),
        "reconfig_interval": int(reconfig_interval),
        "transfer_interval": int(transfer_interval),
        "read_interval": int(read_interval),
        "fsync_interval": int(fsync_interval),
        "fsync_jitter": p_to_u32(fsync_jitter_prob),
        "torn": p_to_u32(torn_tail_prob),
        "torn_span": int(lost_suffix_span),
    }


def from_segments(segments: list[dict], device="cpu") -> ScenarioGenome:
    """Stack encoded segment dicts (see `segment`) into an `[S]` genome."""
    if not segments:
        raise ValueError("a genome needs at least one segment")
    return ScenarioGenome(**{
        f: torch.tensor([s[f] for s in segments], dtype=leaf_dtype(f), device=device)
        for f in ScenarioGenome._fields
    })


def from_config(cfg: RaftConfig, device="cpu") -> ScenarioGenome:
    """The homogeneous genome replicating cfg's fault scalars (S = 1): a fleet
    running it equals the scalar path bit for bit."""
    if cfg.drop_prob_uniform:
        raise ValueError(
            "drop_prob_uniform draws a hidden per-cluster rate; genomes "
            "express per-cluster heterogeneity directly -- give each cluster "
            "its own drop threshold instead"
        )
    return from_segments([
        segment(
            drop_prob=cfg.drop_prob,
            partition_period=cfg.partition_period,
            partition_prob=cfg.partition_prob,
            crash_prob=cfg.crash_prob,
            crash_down_ticks=cfg.crash_down_ticks if cfg.crash_prob > 0 else 1,
            clock_skew_prob=cfg.clock_skew_prob,
            client_interval=cfg.client_interval,
            reconfig_interval=cfg.reconfig_interval,
            transfer_interval=cfg.transfer_interval,
            read_interval=cfg.read_interval,
            fsync_interval=cfg.fsync_interval,
            fsync_jitter_prob=cfg.fsync_jitter_prob,
            torn_tail_prob=cfg.torn_tail_prob,
            lost_suffix_span=cfg.lost_suffix_span,
        )
    ], device)


def broadcast(genome: ScenarioGenome, batch: int) -> ScenarioGenome:
    """Tile an `[S]` genome to the batched `[B, S]` layout (every cluster the
    same setting)."""
    return ScenarioGenome(*(leaf[None].expand((batch,) + leaf.shape).contiguous()
                            for leaf in genome))


def stack_rows(rows: list[ScenarioGenome]) -> ScenarioGenome:
    """Stack B per-cluster `[S]` genomes into the batched `[B, S]` layout."""
    return ScenarioGenome(*(torch.stack([getattr(r, f) for r in rows])
                            for f in ScenarioGenome._fields))


def to_device(genome: ScenarioGenome, device) -> ScenarioGenome:
    """The genome with every leaf on `device`."""
    return ScenarioGenome(*(leaf.to(device) for leaf in genome))


def _np(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def validate(cfg: RaftConfig, genome: ScenarioGenome) -> None:
    """Host-side sanity of an `[S]` or `[B, S]` genome against its base
    config. Raises ValueError naming the first offense (the JAX messages)."""
    shapes = {f: _np(getattr(genome, f)).shape for f in genome._fields}
    if len(set(shapes.values())) != 1:
        raise ValueError(f"genome leaves disagree on shape: {shapes}")
    (shape,) = set(shapes.values())
    if len(shape) not in (1, 2) or shape[-1] < 1:
        raise ValueError(f"genome leaves must be [S] or [B, S] with S >= 1, got {shape}")
    g = {f: _np(getattr(genome, f)) for f in genome._fields}
    if (g["part_period"] < 0).any():
        raise ValueError("part_period must be >= 0 (0 disables partitions)")
    cd = g["crash_down"]
    if (cd < 1).any() or (cd > cfg.crash_period).any():
        raise ValueError(
            f"crash_down must lie in [1, crash_period={cfg.crash_period}] "
            "(spans clip at the window edge; see faults.alive_at)"
        )
    ci = g["client_interval"]
    if (ci < 0).any():
        raise ValueError("client_interval must be >= 0 (0 disables the client)")
    if (ci > 0).any() and cfg.client_interval == 0:
        raise ValueError(
            "genome injects client traffic but cfg.client_interval == 0: the "
            "tick's commit-latency path is a STRUCTURAL gate (it only runs "
            "when the config carries a client workload) -- set a nonzero "
            "cfg.client_interval as the base cadence the genome tunes"
        )
    for field, gate in (
        ("reconfig_interval", cfg.reconfig),
        ("transfer_interval", cfg.leader_transfer),
        ("read_interval", cfg.read_index),
    ):
        v = g[field]
        if (v < 0).any():
            raise ValueError(f"{field} must be >= 0 (0 disables the stream)")
        if (v > 0).any() and not gate:
            raise ValueError(
                f"genome drives {field} but the config's {field} is 0: the "
                "reconfiguration-plane handlers are STRUCTURAL gates (they "
                "only run when the config enables the extension) -- set a "
                f"nonzero cfg.{field} as the base cadence the genome tunes"
            )
    fi = g["fsync_interval"]
    if (fi < 0).any():
        raise ValueError("fsync_interval must be >= 0 (0 disables fsync)")
    if (fi > 0).any() and not cfg.durable_storage:
        raise ValueError(
            "genome drives fsync_interval but the config's fsync_interval is "
            "0: the durable storage plane is a STRUCTURAL gate -- set a "
            "nonzero cfg.fsync_interval as the base cadence the genome tunes"
        )
    for field in ("fsync_jitter", "torn"):
        if (g[field] > 0).any() and not cfg.durable_storage:
            raise ValueError(
                f"genome sets {field} but the config's fsync_interval is 0: "
                "disk faults perturb the durable storage plane -- set a "
                "nonzero cfg.fsync_interval as the base cadence they perturb"
            )
    ts = g["torn_span"]
    if (ts < 1).any() or (ts > cfg.log_capacity).any():
        raise ValueError(
            f"torn_span must lie in [1, log_capacity={cfg.log_capacity}] "
            "(the torn-tail draw rejects 1..span extra entries; see "
            "faults._genome_inputs)"
        )


def decode(genome: ScenarioGenome) -> list[dict]:
    """`[S]` genome -> human-readable per-segment dicts (thresholds back to
    probabilities rounded to 9 decimals), for reports and artifacts."""
    g = {f: _np(getattr(genome, f)) for f in genome._fields}
    (s_count,) = g["drop"].shape
    prob = lambda f, i: round(float(g[f][i]) / U32_SPAN, 9)  # noqa: E731
    return [
        {
            "drop_prob": prob("drop", i),
            "partition_period": int(g["part_period"][i]),
            "partition_prob": prob("part", i),
            "crash_prob": prob("crash", i),
            "crash_down_ticks": int(g["crash_down"][i]),
            "clock_skew_prob": prob("skew", i),
            "client_interval": int(g["client_interval"][i]),
            "reconfig_interval": int(g["reconfig_interval"][i]),
            "transfer_interval": int(g["transfer_interval"][i]),
            "read_interval": int(g["read_interval"][i]),
            "fsync_interval": int(g["fsync_interval"][i]),
            "fsync_jitter_prob": prob("fsync_jitter", i),
            "torn_tail_prob": prob("torn", i),
            "lost_suffix_span": int(g["torn_span"][i]),
        }
        for i in range(s_count)
    ]


def to_raw(genome: ScenarioGenome) -> dict:
    """Exact integer leaves as JSON-ready lists (decode rounds; this does
    not): the bit-exact half of a repro artifact."""
    return {f: _np(getattr(genome, f)).tolist() for f in genome._fields}


# Fields from_raw may backfill when an older artifact lacks them, with the
# value that reproduces the old trajectory (disabled streams draw nothing the
# tick reads); a missing core field is corruption and raises.
_OPTIONAL_FIELDS = {
    "reconfig_interval": 0,
    "transfer_interval": 0,
    "read_interval": 0,
    "fsync_interval": 0,
    "fsync_jitter": 0,
    "torn": 0,
    "torn_span": 1,
}


def from_raw(raw: dict, device="cpu") -> ScenarioGenome:
    """Inverse of to_raw: the exact genome from artifact integers."""
    shape = np.asarray(raw["drop"]).shape
    leaves = {}
    for f in ScenarioGenome._fields:
        if f in _OPTIONAL_FIELDS:
            v = raw.get(f, np.full(shape, _OPTIONAL_FIELDS[f], dtype=np.int64).tolist())
        else:
            v = raw[f]
        leaves[f] = torch.tensor(v, dtype=leaf_dtype(f), device=device)
    return ScenarioGenome(**leaves)
