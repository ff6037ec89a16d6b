"""Client command ingest: host sources packed into per-chunk offer planes (the
port of raft_sim_tpu/serve/ingest.py; host-side numpy, no device work).

A `CommandSource` is any iterator of int32 payloads (a JSONL file, stdin, a
generator). The serve loop packs the next chunk's values into an offer
plane while the current chunk runs: `pack_chunk` ([chunk], one command per
tick slot) or `pack_plane` ([chunk, lanes], one per (tick, cluster) slot),
NIL where nothing is offered. Every plane goes through these two helpers,
so the validation rule (`check_value`) has one home.
"""

from __future__ import annotations

import json
import sys
from typing import Iterable, Iterator

import numpy as np

from raft_sim_tpu_torch.types import NIL, NOOP

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def check_value(value: int) -> int:
    """Validate one client payload: any int32 but the NIL/NOOP sentinels
    (-1/-2), the rule Session.offer enforces too."""
    value = int(value)
    if value in (NIL, NOOP):
        raise ValueError(
            f"client value {value} collides with the NIL/NOOP sentinels "
            f"({NIL}/{NOOP}); any other int32 is legal"
        )
    if not _INT32_MIN <= value <= _INT32_MAX:
        raise ValueError(f"client value must fit int32, got {value}")
    return value


def pack_chunk(values: list[int], chunk: int) -> np.ndarray:
    """Up to `chunk` validated payloads into a [chunk] int32 plane, one
    command per tick slot, NIL = no offer that tick."""
    if len(values) > chunk:
        raise ValueError(f"{len(values)} values do not fit a {chunk}-tick chunk")
    plane = np.full((chunk,), NIL, np.int32)
    for i, v in enumerate(values):
        plane[i] = check_value(v)
    return plane


def pack_plane(values: list[int], chunk: int, lanes: int) -> np.ndarray:
    """Up to `chunk * lanes` validated payloads into a [chunk, lanes] int32
    plane, filled tick-major (lanes 0..L-1 of tick 0 first), NIL-padded."""
    if lanes < 1:
        raise ValueError(f"pack_plane needs >= 1 lane, got {lanes}")
    if len(values) > chunk * lanes:
        raise ValueError(
            f"{len(values)} values do not fit a {chunk}-tick x {lanes}-lane chunk")
    plane = np.full((chunk, lanes), NIL, np.int32)
    for i, v in enumerate(values):
        plane[i // lanes, i % lanes] = check_value(v)
    return plane


def parse_line(raw: str):
    """One JSONL source line -> its payload, or None for a blank or comment
    line. A line is a bare integer or {"value": <int>} (other keys ignored)."""
    line = raw.strip()
    if not line or line.startswith("#"):
        return None
    doc = json.loads(line)
    if isinstance(doc, dict):
        if "value" not in doc:
            raise ValueError(f"command record without a 'value' key: {line!r}")
        doc = doc["value"]
    if isinstance(doc, bool) or not isinstance(doc, int):
        raise ValueError(f"command value must be an integer, got {line!r}")
    return doc


def jsonl_commands(path: str) -> Iterator[int]:
    """Payloads of a JSONL command file ('-' = stdin), one per line."""
    fh = sys.stdin if path == "-" else open(path)
    try:
        for raw in fh:
            v = parse_line(raw)
            if v is not None:
                yield v
    finally:
        if fh is not sys.stdin:
            fh.close()


class CommandSource:
    """Pull-based ingest queue over a payload iterator. `exhausted` turns
    True when the iterator ends; `offered` counts the payloads pulled."""

    def __init__(self, commands: Iterable[int]):
        self._it = iter(commands)
        self.exhausted = False
        self.offered = 0

    def next_values(self, n: int) -> list[int]:
        """Pull up to `n` raw payloads."""
        values: list[int] = []
        while len(values) < n and not self.exhausted:
            try:
                values.append(next(self._it))
            except StopIteration:
                self.exhausted = True
        self.offered += len(values)
        return values

    def next_chunk(self, chunk: int) -> np.ndarray:
        return pack_chunk(self.next_values(chunk), chunk)
