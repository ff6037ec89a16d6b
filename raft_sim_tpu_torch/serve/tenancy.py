"""Multi-tenant partitioning of a standing serve fleet (the port of
raft_sim_tpu/serve/tenancy.py; host-side numpy).

A tenant is a named contiguous slice of the fleet's cluster range with its
own command source, ReadIndex demand and export streams. The batch axis is
the tenancy axis: `TenantRouter.pack` turns the tenants' queues into the
[chunk, B] offer and read planes the serve loop runs, and `credit_windows`
/ `route_deltas` split the per-cluster outputs back per tenant. The chunk
itself never sees the partition.

Files under a serving sink directory:

    <dir>/tenants.json                 {name: {lo, hi, offered, acked,
                                        reads_offered, reads_served}}
    <dir>/tenants/<name>/windows.jsonl the tenant's slice, same line schema
                                        as the fleet's (window_lines)
    <dir>/tenants/<name>/deltas.jsonl  the tenant's delta rows, clusters
                                        renumbered tenant-local (cluster - lo)
"""

from __future__ import annotations

import json
import os

import numpy as np

from raft_sim_tpu_torch.serve import deltas as deltas_mod
from raft_sim_tpu_torch.serve.ingest import CommandSource, pack_plane
from raft_sim_tpu_torch.types import NIL, NOOP


def split_even(total: int, n: int) -> list[int]:
    """`total` clusters over `n` tenants in contiguous sizes, remainders to
    the earliest: the partition the serve CLI and the bench row use."""
    if not 1 <= n <= total:
        raise ValueError(f"cannot split {total} clusters over {n} tenants")
    return [total // n + (i < total % n) for i in range(n)]


class Tenant:
    """One tenant: `clusters` of the fleet, a command source (any payload
    iterable or CommandSource; None = read-only), and a demand of `reads`
    ReadIndex reads offered at most one per cluster every `read_every`
    ticks and re-offered until the windows credit enough serves.
    `broadcast` offers each command to every cluster of the slice (the
    single-source serve form); `weight` is the tenant's integer share of
    offer ticks against the heaviest tenant."""

    def __init__(self, name: str, clusters: int, source=None, reads: int = 0,
                 read_every: int = 2, broadcast: bool = False, weight: int = 1):
        if clusters < 1:
            raise ValueError(f"tenant {name!r} needs >= 1 cluster")
        if reads < 0:
            raise ValueError(f"tenant {name!r}: reads must be >= 0")
        if read_every < 1:
            raise ValueError(f"tenant {name!r}: read_every must be >= 1")
        if not isinstance(weight, int) or weight < 1:
            raise ValueError(
                f"tenant {name!r}: weight must be an integer >= 1 (integer Bresenham credit)")
        self.name = name
        self.clusters = clusters
        self.weight = weight
        if source is not None and not isinstance(source, CommandSource):
            source = CommandSource(source)
        self.source = source
        self.reads = reads
        self.read_every = read_every
        self.broadcast = broadcast
        self.lo = self.hi = 0  # assigned by TenantRouter
        # The read cadence counts the tenant's active ticks, not the global
        # phase, so it composes with the weighted schedule.
        self._read_seq = 0
        self.reads_offered = 0
        self.reads_served = 0
        self.acked_values: list[int] = []
        self.delta_rows: list[dict] = []

    @property
    def writes_done(self) -> bool:
        return self.source is None or self.source.exhausted

    @property
    def reads_done(self) -> bool:
        return self.reads_served >= self.reads

    @property
    def offered(self) -> int:
        return 0 if self.source is None else self.source.offered


class TenantRouter:
    """Partition a B-cluster fleet among tenants and route planes and
    streams: `pack(chunk)` -> (cmds [chunk, B], reads [chunk, B] or None);
    `credit_windows(records)` and `route_deltas(rows)` hand each chunk's
    outputs to their tenants (and their files, once `attach_dir` armed
    them)."""

    def __init__(self, tenants: list[Tenant], batch: int, reads_enabled: bool):
        if not tenants:
            raise ValueError("need at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        total = sum(t.clusters for t in tenants)
        if total != batch:
            raise ValueError(
                f"tenant cluster counts sum to {total}, fleet batch is {batch}: the "
                "partition must cover the cluster range exactly")
        if any(t.reads for t in tenants) and not reads_enabled:
            raise ValueError(
                "a tenant demands reads but the serve config carries no ReadIndex plane "
                "(cfg.serve_reads / read cadence)")
        self.tenants = tenants
        self.batch = batch
        self.reads_enabled = reads_enabled
        lo = 0
        for t in tenants:
            t.lo, t.hi = lo, lo + t.clusters
            lo = t.hi
        self._by_cluster = np.zeros(batch, np.int32)
        for i, t in enumerate(tenants):
            self._by_cluster[t.lo:t.hi] = i
        self._dir = None
        self._tenant_windows: dict[str, int] = {}
        self._read_phase = 0  # global tick phase of the offer schedule
        self._w_max = max(t.weight for t in tenants)

    def attach_dir(self, directory: str) -> None:
        """Arm (and truncate) the per-tenant files under
        `directory`/tenants/<name>/."""
        self._dir = directory
        for t in self.tenants:
            d = os.path.join(directory, "tenants", t.name)
            os.makedirs(d, exist_ok=True)
            open(os.path.join(d, "windows.jsonl"), "w").close()
            open(os.path.join(d, "deltas.jsonl"), "w").close()
            self._tenant_windows[t.name] = 0

    def write_manifest(self, path: str) -> None:
        doc = {
            t.name: {
                "lo": t.lo, "hi": t.hi,
                "offered": t.offered,
                "acked": len(t.acked_values),
                "reads_offered": t.reads_offered,
                "reads_served": t.reads_served,
            }
            for t in self.tenants
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")

    def _active_rows(self, t: Tenant, chunk: int) -> list[int]:
        """The tick slots of this chunk tenant t may offer in: Bresenham
        credit against the heaviest weight, on the global tick phase."""
        w, wm = t.weight, self._w_max
        k0 = self._read_phase
        return [k for k in range(chunk) if ((k0 + k + 1) * w) // wm > ((k0 + k) * w) // wm]

    def pack(self, chunk: int) -> tuple[np.ndarray, np.ndarray | None]:
        """The next chunk's per-cluster planes from every tenant's queues."""
        cmds = np.full((chunk, self.batch), NIL, np.int32)
        reads = np.full((chunk, self.batch), NIL, np.int32) if self.reads_enabled else None
        for t in self.tenants:
            rows = self._active_rows(t, chunk)
            if t.source is not None and not t.source.exhausted and rows:
                if t.broadcast:
                    vals = t.source.next_values(len(rows))
                    cmds[rows, t.lo:t.hi] = pack_plane(vals, len(rows), 1)
                else:
                    vals = t.source.next_values(len(rows) * t.clusters)
                    cmds[rows, t.lo:t.hi] = pack_plane(vals, len(rows), t.clusters)
            if reads is not None and t.reads_served < t.reads:
                # Up to the outstanding demand (crediting lags a chunk, so
                # the over-offer is bounded by one chunk's serves), one read
                # per cluster every read_every active ticks.
                want = t.reads - t.reads_served
                for j, k in enumerate(rows):
                    if want <= 0:
                        break
                    if (t._read_seq + j) % t.read_every:
                        continue
                    lanes = min(want, t.clusters)
                    reads[k, t.lo:t.lo + lanes] = 1
                    t.reads_offered += lanes
                    want -= lanes
            t._read_seq = (t._read_seq + len(rows)) % (2 ** 30)
        self._read_phase = (self._read_phase + chunk) % (2 ** 30)
        return cmds, reads

    def credit_windows(self, records) -> None:
        """Slice a chunk's stacked WindowRecord (public layout, numpy leaves)
        by tenant: credit served reads against each demand and append the
        tenant's windows.jsonl lines."""
        from raft_sim_tpu_torch.utils.telemetry_sink import window_lines

        def sl(tree, lo, hi):
            if isinstance(tree, tuple):
                return type(tree)(*(sl(x, lo, hi) for x in tree))
            return np.asarray(tree)[lo:hi]

        for t in self.tenants:
            part = sl(records, t.lo, t.hi)
            t.reads_served += int(np.asarray(part.metrics.reads_served, np.int64).sum())
            if self._dir is not None:
                lines = window_lines(part, self._tenant_windows[t.name])
                path = os.path.join(self._dir, "tenants", t.name, "windows.jsonl")
                with open(path, "a") as f:
                    for line in lines:
                        f.write(json.dumps(line) + "\n")
                self._tenant_windows[t.name] += len(lines)

    def route_deltas(self, rows: list[dict]) -> None:
        """Split delta rows by tenant: tenant-local cluster numbers, the ack
        ledger, and the per-tenant deltas.jsonl."""
        per: dict[str, list[dict]] = {t.name: [] for t in self.tenants}
        for row in rows:
            t = self.tenants[int(self._by_cluster[row["cluster"]])]
            local = dict(row, cluster=row["cluster"] - t.lo)
            t.delta_rows.append(local)
            t.acked_values.extend(v for v in row["values"] if v != NOOP)
            per[t.name].append(local)
        if self._dir is not None:
            for t in self.tenants:
                if per[t.name]:
                    deltas_mod.append_delta_rows(
                        os.path.join(self._dir, "tenants", t.name, "deltas.jsonl"), per[t.name])

    @property
    def exhausted(self) -> bool:
        """Every tenant's source is dry and every read demand met."""
        return all(t.writes_done and t.reads_done for t in self.tenants)

    @property
    def offered(self) -> int:
        return sum(t.offered for t in self.tenants)

    @property
    def reads_offered(self) -> int:
        return sum(t.reads_offered for t in self.tenants)

    @property
    def reads_served(self) -> int:
        return sum(t.reads_served for t in self.tenants)
