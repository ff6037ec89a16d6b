"""The trace ring and the transition-coverage bitmap (the port of
raft_sim_tpu/trace/ring.py).

The ring keeps up to `depth` events (trace/events.py) per cluster per
telemetry window, exports them every window and can stop a cluster's
recording after the first event of a chosen kind (`freeze_kind`). Overflow
clamps, never wraps: a window keeps its first `depth` events in order and
counts the rest (`TraceWin.n` is the emitted total), so every export is a
prefix of the window's history and the checker can name the gap.

The coverage plane is a packed bitmap over two blocks:

  role x kind    bit r * N_KINDS + k: a node in role r emitted kind k
                 (ROLE_CLUSTER for cluster-scope events);
  kind -> kind   bit ADJ_BASE + p * N_KINDS + k: kind k directly followed
                 kind p in the cluster's stream (the previous window's last
                 kind seeds a window's first adjacency).

It is OR-folded across windows. The JAX package's uint32 words ride int32
here, holding the same bit patterns (ops/bitplane.py). Leaves are
batch-minor ([..., B]) and integer-only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.trace import events as tev
from raft_sim_tpu_torch.utils.config import RaftConfig

ROLE_KIND_BITS = tev.ROLE_DIM * tev.N_KINDS
ADJ_BASE = ROLE_KIND_BITS
COV_BITS = ROLE_KIND_BITS + tev.N_KINDS * tev.N_KINDS
COV_WORDS = bitplane.n_words(COV_BITS)

# int32 weight of each bit of a word: 1, 2, ..., 2^30 and -2^31. A sum of
# distinct ones is the word's bit pattern; it is summed in int64 and taken
# back to int32 by bitplane.i32, so the bound is provable without knowing
# the bits are distinct.
_BIT_WEIGHTS = [1 << j for j in range(31)] + [-(1 << 31)]


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """The trace plane's settings.

    depth        events kept per cluster per window (the rest are counted);
    coverage     fold the transition-coverage bitmap;
    freeze_kind  EV_NONE (0) records forever; an EV_* kind stops a cluster's
                 recording after the tick that first emits it (inclusive).
    """

    depth: int = 128
    coverage: bool = True
    freeze_kind: int = 0

    def __post_init__(self):
        assert self.depth >= 1
        assert 0 <= self.freeze_kind < tev.N_KINDS


class TraceWin(NamedTuple):
    """One window's event buffer for every cluster; slot i holds the window's
    i-th event (kind EV_NONE = empty)."""

    ev_tick: torch.Tensor  # [R, B] int32 absolute tick
    ev_node: torch.Tensor  # [R, B] int32 node id (NIL = cluster-scope)
    ev_kind: torch.Tensor  # [R, B] int32
    ev_detail: torch.Tensor  # [R, B] int32
    n: torch.Tensor  # [B] int32 events emitted this window (may exceed R)


class TracePersist(NamedTuple):
    """Trace state carried across windows."""

    frozen: torch.Tensor  # [B] bool: freeze_kind latched
    last_kind: torch.Tensor  # [B] int32: the stream's previous event kind
    cov: torch.Tensor  # [COV_WORDS, B] uint32 bit patterns (int32 carrier)
    total: torch.Tensor  # [B] int32 events emitted over the run


class TraceWindowOut(NamedTuple):
    """One window's export: its event buffer and the cumulative coverage at
    its end."""

    win: TraceWin
    cov: torch.Tensor  # [COV_WORDS, B] (int32 carrier)


def init_window(spec: TraceSpec, batch: int, device="cpu") -> TraceWin:
    def z(*shape):
        return torch.zeros((*shape, batch), dtype=torch.int32, device=device)

    r = spec.depth
    return TraceWin(ev_tick=z(r), ev_node=z(r), ev_kind=z(r), ev_detail=z(r), n=z())


def init_persist(spec: TraceSpec, batch: int, device="cpu") -> TracePersist:
    return TracePersist(
        frozen=torch.zeros((batch,), dtype=torch.bool, device=device),
        last_kind=torch.zeros((batch,), dtype=torch.int32, device=device),
        cov=torch.zeros((COV_WORDS, batch), dtype=torch.int32, device=device),
        total=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _coverage(cov, write, role, kv, prev_kind) -> torch.Tensor:
    """OR this tick's (role x kind) and (prev kind -> kind) bits into the
    packed words `cov`: every written slot sets its two bits in a [bits, B]
    map (unwritten slots land on a row past the words, dropped), which is
    then packed 32 bits a word."""
    b = write.shape[1]
    kind = kv[:, None]
    idx = torch.cat([role * tev.N_KINDS + kind, ADJ_BASE + prev_kind * tev.N_KINDS + kind])
    rows = COV_WORDS * bitplane.WORD
    idx = torch.where(torch.cat([write, write]), idx, rows).long()
    bits = torch.zeros((rows + 1, b), dtype=torch.bool, device=write.device)
    bits.scatter_(0, idx, True)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=write.device)[:, None]
    words = torch.where(bits[:rows].view(COV_WORDS, bitplane.WORD, b), weights, 0)
    return cov | bitplane.i32(words.sum(dim=1, dtype=torch.int64))


def record(cfg: RaftConfig, spec: TraceSpec, tw: TraceWin, tp: TracePersist,
           ev: tev.TickEvents, now: torch.Tensor) -> tuple[TraceWin, TracePersist]:
    """Fold one tick's events into the window buffer and the carried state.
    `now` is the [B] pre-tick tick. The sparse slots compact into buffer
    rows by an exclusive cumsum and one scatter a plane into a buffer with
    one spare row, where every event past `depth` (and every empty slot)
    lands and is cut off."""
    m, batch = ev.flags.shape
    depth = spec.depth
    kv, nv = tev.slot_table(cfg.n_nodes, ev.flags.device)
    write = ev.flags & ~tp.frozen[None, :]
    wi = write.to(torch.int32)
    cum = wi.cumsum(dim=0, dtype=torch.int32)
    emitted = cum[-1]
    pos = tw.n[None, :] + cum - wi  # exclusive cumsum offset
    slot = torch.where(write, pos.clamp(0, depth), depth).long()  # pos >= 0: the clip proves it

    def put(plane, val):
        ext = torch.cat([plane, plane.new_zeros((1, batch))])
        ext.scatter_(0, slot, val.expand(m, batch))
        return ext[:depth]

    tw2 = TraceWin(
        ev_tick=put(tw.ev_tick, now[None, :]),
        ev_node=put(tw.ev_node, nv[:, None]),
        ev_kind=put(tw.ev_kind, kv[:, None]),
        ev_detail=put(tw.ev_detail, ev.detail),
        n=tw.n + emitted,
    )
    # Adjacency predecessor per slot: the kind of the latest written slot
    # strictly before it this tick, else the carried stream tail.
    ar = torch.arange(m, dtype=torch.int32, device=write.device)[:, None]
    incl = torch.cummax(torch.where(write, ar, -1), dim=0).values
    prev_idx = torch.cat([torch.full((1, batch), -1, dtype=torch.int32, device=write.device),
                          incl[:-1]])
    prev_kind = torch.where(prev_idx >= 0, kv[prev_idx.clamp(0, m - 1).long()],
                            tp.last_kind[None, :])
    cov = _coverage(tp.cov, write, ev.role, kv, prev_kind) if spec.coverage else tp.cov
    last_idx = incl[-1]
    last_kind = torch.where(last_idx >= 0, kv[last_idx.clamp(0, m - 1).long()], tp.last_kind)
    frozen = tp.frozen
    if spec.freeze_kind:
        frozen = frozen | write[tev.kind_rows(cfg.n_nodes, spec.freeze_kind)].any(dim=0)
    tp2 = TracePersist(frozen=frozen, last_kind=last_kind, cov=cov, total=tp.total + emitted)
    return tw2, tp2


def cov_popcount(cov: torch.Tensor) -> torch.Tensor:
    """Set bits per cluster of a [COV_WORDS, B] coverage plane -> [B] int32
    (reduces axis 0 of any layout)."""
    return bitplane.popcount(cov).sum(dim=0, dtype=torch.int32)


def stack_windows(outs: list[TraceWindowOut]) -> TraceWindowOut:
    """Per-window exports -> one TraceWindowOut with a leading [n_windows]
    axis on every leaf (the JAX scan's stacked output)."""
    return TraceWindowOut(
        win=TraceWin(*(torch.stack(leaves) for leaves in zip(*(o.win for o in outs)))),
        cov=torch.stack([o.cov for o in outs]),
    )
