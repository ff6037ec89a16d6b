"""Commit-delta extraction: the fleet's apply stream without a state diff (the
port of raft_sim_tpu/serve/deltas.py).

`extract` gathers, for every cluster, the node-0 entries committed past a
per-cluster watermark (the last exported 1-based index) into a fixed
[B, depth] buffer -- values, offer stamps and indices -- and advances the
watermark. It is a pure gather over node 0's ring on the device (a few
elementwise ops and two `gather`s; no kernel of its own), so a chunk moves
O(B x depth) bytes to the host instead of the [B, N, CAP] log.

Semantics, as the JAX package's:
  - the stream is node 0's committed prefix in commit order (log matching
    makes every node's committed prefix the same);
  - `depth` is backpressure, not loss: a cluster that committed more than
    `depth` entries exports the rest in the next round (`drain` loops until
    every cluster is dry);
  - entries compacted past node 0's log_base before export are gone; they
    show as a per-cluster `gap` count;
  - leader no-ops (types.NOOP) ride the raw stream; `applied_values` and the
    `applied` count leave them out.

`DeltaStream` owns the watermark across chunks. The serve loop runs a fixed
number of rounds behind each chunk on the device stream (`begin_rounds`,
their host copies asynchronous behind a CUDA event) and builds the rows
after the chunk's sync (`finish_rounds`). A stream built with
`batch_minor=True` reads states in the batch-minor layout the serve loop
keeps ([..., B] trailing), else the public [B, ...] layout.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from raft_sim_tpu_torch.types import NIL, NOOP
from raft_sim_tpu_torch.utils.device import host_numpy, to_host_async


class DeltaBatch(NamedTuple):
    """One extraction round (every leaf batch-leading)."""

    start: torch.Tensor  # [B] int32: 0-based index before the first exported entry
    count: torch.Tensor  # [B] int32: entries exported this round (<= depth)
    gap: torch.Tensor  # [B] int32: entries lost to compaction since the watermark
    values: torch.Tensor  # [B, D] int32: committed payloads (NIL past count)
    ticks: torch.Tensor  # [B, D] int32: offer stamps (log_tick; 0 past count)
    watermark: torch.Tensor  # [B] int32: the new watermark (start + count)


def _node0(state, batch_minor: bool):
    """(commit [B], base [B], log_val [B, CAP], log_tick [B, CAP]) of node 0."""
    if batch_minor:
        return (state.commit_index[0], state.log_base[0], state.log_val[0].T,
                state.log_tick[0].T)
    return (state.commit_index[:, 0], state.log_base[:, 0], state.log_val[:, 0, :],
            state.log_tick[:, 0, :])


def extract(state, watermark: torch.Tensor, depth: int, batch_minor: bool = False) -> DeltaBatch:
    """One fixed-capacity extraction round over the whole fleet: up to
    `depth` node-0 entries per cluster committed past `watermark` ([B]
    int32, 0 = nothing exported yet). Reads the state, writes nothing."""
    commit, base, log_val, log_tick = _node0(state, batch_minor)
    cap = log_val.shape[-1]
    # Entries in (watermark, base] were compacted before export: gap, skip.
    start = torch.maximum(watermark, base)
    gap = start - watermark
    count = torch.clamp(commit - start, 0, depth)
    k = torch.arange(depth, dtype=torch.int32, device=start.device)
    idx0 = start[:, None] + k[None, :]  # [B, D] 0-based absolute entry index
    slot = (idx0 % cap).long()  # ring slot (idx0 itself on the prefix layout)
    valid = k[None, :] < count[:, None]
    vals = torch.gather(log_val, 1, slot)
    ticks = torch.gather(log_tick, 1, slot)
    return DeltaBatch(
        start=start,
        count=count,
        gap=gap,
        values=torch.where(valid, vals, NIL),
        ticks=torch.where(valid, ticks, 0),
        watermark=start + count,
    )


class DeltaStream:
    """Host-side consumer of `extract`: owns the watermark across chunks.
    `exported` counts entries exported (no-ops included), `applied` the
    client entries among them (the commands-acked count), `gap_entries`
    those lost to compaction."""

    def __init__(self, batch: int, depth: int = 64, device="cpu", batch_minor: bool = False):
        if depth < 1:
            raise ValueError(f"delta depth must be >= 1, got {depth}")
        self.batch = batch
        self.depth = depth
        self.batch_minor = batch_minor
        self.watermark = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.exported = 0
        self.applied = 0
        self.gap_entries = 0

    def skip_to_now(self, state) -> None:
        """Move the watermark past everything already committed on any node
        of each cluster, so later drains report only later commits
        (Session.offer's pre-offer reset)."""
        nodes = 0 if self.batch_minor else 1
        self.watermark = torch.maximum(self.watermark, state.commit_index.amax(dim=nodes))

    def _extract(self, state, watermark) -> DeltaBatch:
        return extract(state, watermark, self.depth, self.batch_minor)

    def _rows_of(self, d: DeltaBatch) -> list[dict]:
        """Rows of one round already on the host (numpy leaves), with the
        export accounting."""
        counts, gaps = d.count, d.gap
        rows: list[dict] = []
        if not counts.any() and not gaps.any():
            return rows
        for c in np.flatnonzero(counts | gaps):
            cnt = int(counts[c])
            vals = [int(v) for v in d.values[c, :cnt]]
            rows.append({
                "cluster": int(c),
                "start": int(d.start[c]) + 1,
                "gap": int(gaps[c]),
                "values": vals,
                "ticks": [int(t) for t in d.ticks[c, :cnt]],
            })
            self.exported += cnt
            self.applied += sum(1 for v in vals if v != NOOP)
            self.gap_entries += int(gaps[c])
        return rows

    def drain(self, state, max_rounds: int = 1024) -> list[dict]:
        """Extract until no cluster has pending deltas. One row per (cluster,
        round) with anything new: {"cluster", "start" (1-based index of the
        first value), "gap", "values", "ticks"}; values are raw (no-ops
        included)."""
        rows: list[dict] = []
        for _ in range(max_rounds):
            d = self._extract(state, self.watermark)
            host = host_numpy(*to_host_async(d))
            new = self._rows_of(host)
            if not new:
                break
            rows.extend(new)
            self.watermark = d.watermark
            if int(host.count.max(initial=0)) < self.depth:
                break  # nobody filled the buffer: every cluster is dry
        return rows

    def begin_rounds(self, state, rounds: int):
        """Queue `rounds` extraction rounds against `state` behind the work
        already on the device stream, with their copies to the host, and
        advance the watermark to the last round's. Returns the pending
        rounds for `finish_rounds`. rounds x depth >= a chunk's commits
        keeps the stream dry in steady state; the rest is backpressure."""
        futs = []
        wm = self.watermark
        for _ in range(rounds):
            d = self._extract(state, wm)
            futs.append(d)
            wm = d.watermark
        self.watermark = wm
        return to_host_async(futs)

    def finish_rounds(self, pending) -> list[dict]:
        """The rows of rounds queued by `begin_rounds` (waits for their
        copies)."""
        futs, event = pending
        rows: list[dict] = []
        for d in futs:
            rows.extend(self._rows_of(host_numpy(d, event)))
        return rows


# ----------------------------------------------------------- stream file form

DELTA_FIELDS = ("cluster", "start", "gap")  # per line; values/ticks are lists


def append_delta_rows(path: str, rows: list[dict]) -> int:
    """Append drained rows to a deltas.jsonl stream."""
    if not rows:
        return 0
    with open(path, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)


def validate_deltas(path: str) -> list[str]:
    """Schema-check a deltas.jsonl stream: per cluster, each row's start
    picks up where the previous row's start + gap + len(values) left off."""
    errors: list[str] = []
    next_start: dict[int, int] = {}
    try:
        f = open(path)
    except OSError as ex:
        return [f"{path}: unreadable: {ex}"]
    with f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"deltas.jsonl:{ln}: not JSON: {ex}")
                continue
            for k in DELTA_FIELDS:
                if not isinstance(row.get(k), int):
                    errors.append(f"deltas.jsonl:{ln}: field {k!r} missing or non-int")
            vals, ticks = row.get("values"), row.get("ticks")
            for name, lst in (("values", vals), ("ticks", ticks)):
                if not isinstance(lst, list) or not all(isinstance(x, int) for x in lst):
                    errors.append(f"deltas.jsonl:{ln}: {name} must be a list of ints")
            if isinstance(vals, list) and isinstance(ticks, list) and len(vals) != len(ticks):
                errors.append(f"deltas.jsonl:{ln}: values/ticks length mismatch")
            if not (isinstance(row.get("cluster"), int) and isinstance(row.get("start"), int)):
                continue
            c, start = row["cluster"], row["start"]
            want = next_start.get(c)
            got = start - row.get("gap", 0)
            if want is not None and got != want:
                errors.append(
                    f"deltas.jsonl:{ln}: cluster {c} stream not dense: "
                    f"start - gap = {got}, expected {want}")
            next_start[c] = start + (len(vals) if isinstance(vals, list) else 0)
    return errors


def applied_values(rows: list[dict], cluster: int) -> list[int]:
    """One cluster's committed client values in commit order, no-ops left
    out (the apply-log view of the rows)."""
    out: list[int] = []
    for row in rows:
        if row["cluster"] == cluster:
            out.extend(v for v in row["values"] if v != NOOP)
    return out
