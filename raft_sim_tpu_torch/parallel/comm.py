"""The exchange behind node-axis sharding: collectives among shard threads.

The node-sharded tick (parallel/nodeshard.py, `models/raft_batched.step_b`
with a `NodeShardCtx`) has collectives in the middle of its body, so its
shards cannot run one after another: they run SPMD, one Python thread per
shard (`run_spmd`), and meet at the collectives of one `Exchange`. The JAX
package gets the same points from `lax` collectives inside `shard_map`:

- `all_gather(rank, x, dim)`: every shard's `x`, concatenated along `dim` in
  shard order (a tiled gather);
- `fold(rank, x, op)`: the elementwise `max`, `min`, `sum` or `any` over the
  shards' `x` -- exact integer (or boolean) folds, so a fold's value never
  depends on the shard count or on the order the shards arrive in;
  `folds(rank, [(x, op), ...])` takes the folds of one point of the tick in
  one meeting.

The shards take turns: between two meetings one shard thread runs at a
time, in rank order, and the last to arrive at a meeting completes it and
hands the turn back to rank 0. torch releases the GIL inside every op, so
shard threads left to run together trade it at every op; in turns, each
keeps it until its next meeting. The launches a shard queues still overlap
the others' work on the card. A shard thread enters the exchange at its
first meeting and leaves it with `done(rank)` (the `shard(rank)` context
does that, and breaks the exchange for the others if its body raises).

Contributions sit in one of two slot rows, alternating per meeting: a shard
cannot post to the meeting after next before every shard has read this
one's. Shards may live on different devices: the gather copies every part
to the caller's device before it concatenates.

Every wait has a timeout, and a shard that raises breaks the exchange, so
the other shards fail at their next wait instead of waiting forever
(`ShardAborted`); `run_spmd` re-raises the first real failure. `counts`
tallies the collectives by kind (counted once a meeting, not per shard),
the record the collective-whitelist test reads; `meetings` counts the
meetings.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

# Seconds a shard waits for its turn before the exchange gives up.
DEFAULT_TIMEOUT = 120.0

FOLDS = ("max", "min", "sum", "any")

# The gathers the node-sharded tick declares, with the most it takes of each
# a tick: ONE gather of the outbound mailbox, and one of the leaders by term
# under check_invariants. With FOLDS they are every kind `counts` may hold
# (the analyzer's `node-collectives` rule, analysis/op_audit.py).
GATHERS_PER_TICK = {"mailbox_gather": 1, "leaders_gather": 1}
DECLARED_KINDS = frozenset(GATHERS_PER_TICK) | frozenset(FOLDS)


def _fold(st: torch.Tensor, op: str, dtype) -> torch.Tensor:
    if op == "max":
        return st.amax(0)
    if op == "min":
        return st.amin(0)
    if op == "sum":
        return st.sum(0, dtype=dtype)
    return st.any(0)


class ShardAborted(RuntimeError):
    """A collective could not complete: another shard failed, or the wait
    passed the exchange's timeout."""


class Exchange:
    """Collectives among `size` shard threads (ranks 0..size-1)."""

    def __init__(self, size: int, timeout: float = DEFAULT_TIMEOUT):
        if size < 1:
            raise ValueError(f"an exchange needs at least one shard, got {size}")
        self.size = size
        self.timeout = timeout
        self.counts: collections.Counter = collections.Counter()
        self.meetings = 0  # meetings completed
        self._cond = threading.Condition()
        self._turn = 0  # the rank that may run now
        self._arrived = 0  # ranks at the meeting in progress
        self._broken = False
        self._slots = [[None] * size, [None] * size]
        self._calls = [0] * size  # each rank's meeting count: picks the slot row

    def _wait(self, ready, what: str) -> None:
        """Wait (holding the condition) until `ready()`; raise ShardAborted
        when the exchange breaks or the wait passes the timeout."""
        deadline = time.monotonic() + self.timeout
        while not ready():
            if self._broken:
                raise ShardAborted(f"{what}: another shard failed")
            left = deadline - time.monotonic()
            if left <= 0:
                self._broken = True
                self._cond.notify_all()
                raise ShardAborted(f"{what}: no turn within {self.timeout} s")
            self._cond.wait(left)
        if self._broken:
            raise ShardAborted(f"{what}: another shard failed")

    def _meet(self, rank: int, kinds, x) -> list:
        what = f"shard {rank}, the {'/'.join(kinds)} collective"
        with self._cond:
            self._wait(lambda: self._turn == rank, what)
            k = self._calls[rank]
            row = self._slots[k & 1]
            self._calls[rank] += 1
            row[rank] = x
            self._arrived += 1
            if self._arrived == self.size:  # the last: complete it, rank 0 goes on
                self._arrived = 0
                self.meetings += 1
                self.counts.update(kinds)
                self._turn = 0
            else:
                self._turn = rank + 1
            self._cond.notify_all()
            self._wait(lambda: self.meetings > k and self._turn == rank, what)
        return row

    def done(self, rank: int) -> None:
        """`rank` ran its last segment: hand the turn on."""
        with self._cond:
            self._wait(lambda: self._turn == rank, f"shard {rank}, its end")
            self._turn = rank + 1
            self._cond.notify_all()

    @contextlib.contextmanager
    def shard(self, rank: int):
        """One shard thread's life in the exchange: `done` at the end, the
        exchange broken if the body raises."""
        try:
            yield
        except BaseException:
            self.abort()
            raise
        self.done(rank)

    def all_gather(self, rank: int, x, dim: int = 0, kind: str = "all_gather"):
        """Every shard's `x` (a tensor, or a tuple of them: one collective
        for all), concatenated along `dim` in shard order, on this shard's
        device."""
        parts = self._meet(rank, (kind,), x)
        if isinstance(x, tuple):
            return tuple(torch.cat([p[i].to(leaf.device) for p in parts], dim)
                         for i, leaf in enumerate(x))
        return torch.cat([p.to(x.device) for p in parts], dim)

    def fold(self, rank: int, x: torch.Tensor, op: str) -> torch.Tensor:
        """The elementwise `op` (max, min, sum, any) of every shard's `x`, in
        `x`'s dtype (bool for `any`), on this shard's device."""
        return self.folds(rank, [(x, op)])[0]

    def folds(self, rank: int, pairs) -> list:
        """`fold` of each (x, op) of `pairs`, all in one meeting."""
        ops = tuple(op for _, op in pairs)
        bad = [op for op in ops if op not in FOLDS]
        if bad:
            raise ValueError(f"unknown fold {bad[0]!r} (have {FOLDS})")
        parts = self._meet(rank, ops, tuple(x for x, _ in pairs))
        return [_fold(torch.stack([p[i].to(x.device) for p in parts]), op, x.dtype)
                for i, (x, op) in enumerate(pairs)]

    def abort(self) -> None:
        """Break the exchange: every shard waiting now, or later, raises
        ShardAborted."""
        with self._cond:
            self._broken = True
            self._cond.notify_all()


def run_spmd(fn, size: int, exchanges=(), grace: float = DEFAULT_TIMEOUT):
    """Run `fn(rank)` for rank 0..size-1, one thread each, and return their
    results in rank order. When a shard raises, the `exchanges` are broken
    so the others stop at their next wait; once any shard has failed, the
    rest get `grace` seconds to end. The first failure that is not a
    ShardAborted is raised (else the first one). A run in which nothing
    fails is never cut short."""
    results = [None] * size
    errors: list = [None] * size

    def body(rank: int) -> None:
        try:
            results[rank] = fn(rank)
        except BaseException as ex:  # noqa: BLE001 -- re-raised below, after the join
            errors[rank] = ex
            for ex_ in exchanges:
                ex_.abort()

    threads = [threading.Thread(target=body, args=(r,), name=f"shard-{r}", daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    deadline = None
    for t in threads:
        while t.is_alive():
            t.join(0.05)
            if deadline is None and any(e is not None for e in errors):
                deadline = time.monotonic() + grace
            if deadline is not None and time.monotonic() > deadline:
                for ex_ in exchanges:
                    ex_.abort()
                raise ShardAborted(
                    f"{t.name} still running {grace} s after another shard failed") from next(
                        e for e in errors if e is not None)
    real = [e for e in errors if e is not None and not isinstance(e, ShardAborted)]
    if real:
        raise real[0]
    first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results
