"""The standing-fleet service loop: streamed ingest in, telemetry windows and
commit deltas out (the port of raft_sim_tpu/serve/loop.py).

A chunk (`run_windowed_served`) advances the whole fleet `chunk` ticks with
each tick's client command and ReadIndex offer taken from explicit [T, B]
planes (NIL = none in that (tick, cluster) slot) instead of the scheduled
cadences, folding telemetry windows exactly as sim/telemetry.py does. Each
tick is `scan.tick_batch_minor` with the `client_cmd`/`read_cmd`
overrides, so on the card every served tick is one launch of the tick
kernel (`tick_engine.step_cuda`).

`ServeSession` runs the loop in the JAX package's order:

    dispatch chunk k  ->  export chunk k-1's windows and delta rows, pack
    chunk k+1's planes  ->  queue chunk k's extraction rounds behind it
    ->  collect chunk k  ->  dispatch chunk k+1 ...

Dispatching a chunk enqueues its work on the card's stream; the outputs
come back through asynchronous copies into pinned host memory, each batch
of them closed by a CUDA event, so the host waits only where it reads.
The session holds one fleet on the device: it keeps the state in the
batch-minor layout and hands it to the chunk without keeping a reference,
so each tick's input state is freed once the next exists.

`perf` (an obs.ChunkTimer) gets one row a chunk at the loop's own phase
boundaries: begun before the chunk's first launch, dispatched after its
last, closed at the sync on a host copy of the chunk's `metrics.ticks`
(queued right behind the chunk, ahead of the extraction rounds), with the
host window's export and packing times as `export_s` and `pack_s` inside
`host_s`. `health` arms SLO monitors over the exported windows (one for the
fleet, one per tenant), after the warmup.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.serve import deltas as deltas_mod
from raft_sim_tpu_torch.serve.ingest import CommandSource
from raft_sim_tpu_torch.sim import scan, telemetry
from raft_sim_tpu_torch.sim.chunked import merge_metrics
from raft_sim_tpu_torch.types import NIL
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig


def serve_config(cfg: RaftConfig) -> RaftConfig:
    """The serve-mode variant of a config: offered writes replace the client
    cadence (client_interval 0, serve_ingest on: the offer-tick plane stays
    live), and where the config carries the ReadIndex plane offered reads
    replace the read cadence (read_interval 0, serve_reads on)."""
    repl: dict = {}
    if not (cfg.serve_ingest and cfg.client_interval == 0):
        repl.update(serve_ingest=True, client_interval=0)
    if cfg.read_index and not (cfg.serve_reads and cfg.read_interval == 0):
        repl.update(serve_reads=True, read_interval=0)
    return dataclasses.replace(cfg, **repl) if repl else cfg


def _plane(x, device) -> torch.Tensor:
    """A [T, B] int32 offer plane on `device` (from numpy through pinned
    memory, copied without blocking)."""
    t = torch.as_tensor(x, dtype=torch.int32)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _check_planes(cfg: RaftConfig, cmds, reads, window: int) -> None:
    if cmds.shape[0] % window:
        raise ValueError(f"chunk of {cmds.shape[0]} ticks must divide by window {window}")
    if reads is not None and not cfg.read_index:
        raise ValueError(
            "a read plane needs the ReadIndex gate (cfg.serve_reads or a read cadence)")


def run_windowed_served(cfg: RaftConfig, state, keys: torch.Tensor, cmds, window: int,
                        reads=None, now: int | None = None, step_fn=None):
    """One chunk of `cmds` ([T, B] int32 offer plane) over the [B, ...]
    `state`, one WindowRecord every `window` ticks; `reads` ([T, B], 1 =
    offer a read, NIL = none) needs cfg.read_index. Returns (final_state,
    chunk_metrics, records) in public layouts. `now` is the host's copy of
    the state's tick (read once when not given)."""
    _check_planes(cfg, cmds, reads, window)
    dev = state.role.device
    if now is None:
        now = int(state.now.reshape(-1)[0]) if state.role.shape[0] else 0
    s, m, recs, _ = telemetry.run_minor_telemetry(
        cfg, raft_batched.to_batch_minor(state), keys, cmds.shape[0], window, now,
        step_fn=step_fn, cmds=_plane(cmds, dev),
        reads=None if reads is None else _plane(reads, dev))
    return raft_batched.from_batch_minor(s), raft_batched.from_batch_minor(m), recs


def simulate_serve(cfg: RaftConfig, seed: int, batch: int, cmds, window: int, reads=None,
                   device="cuda", step_fn=None):
    """Init from the seed (the `simulate` key split) and one served chunk:
    (final_state, metrics, records)."""
    state, keys = scan.seed_fleet(cfg, seed, batch, device_mod.resolve(device))
    return run_windowed_served(cfg, state, keys, cmds, window, reads=reads, now=0,
                               step_fn=step_fn)


class ServeSession:
    """A standing fleet taking streamed commands between chunks.

    >>> s = ServeSession(RaftConfig(n_nodes=5), batch=8, seed=0, chunk=128)
    >>> stats = s.serve(CommandSource([7, 7, 2**31 - 1]), chunks=4)
    >>> s.delta_rows  # every cluster's committed (index, value, tick) stream

    With `tenants=[Tenant(...), ...]` the cluster range is partitioned among
    named tenants, each with its own source, read demand and export streams
    (serve/tenancy.py). `sink` (utils/telemetry_sink.TelemetrySink) streams
    windows to windows.jsonl and delta rows to deltas.jsonl; with tenants,
    their views land under tenants/<name>/. The session runs on the card
    unless it is given device="cpu". `perf` (an obs.ChunkTimer) times each
    chunk; its warmup grows to cover the warmup chunks and the first serving
    chunk. `health` (an SLO spec: "default", a path or a dict; needs `sink`)
    arms one monitor for the fleet, which owns the runtime SLIs, and one per
    tenant slice, all streaming into the sink's directory; they are armed
    after the warmup, so electing leaders is never billed against the
    availability budget.
    """

    def __init__(self, cfg: RaftConfig, batch: int = 1, seed: int = 0, chunk: int = 256,
                 window: int = 64, delta_depth: int = 64, sink=None, warmup_ticks: int = 0,
                 perf=None, tenants=None, health=None, device="cuda"):
        if chunk % window:
            raise ValueError(f"chunk {chunk} must divide by window {window}")
        self.device = device_mod.resolve(device)
        self.cfg = serve_config(cfg)
        self.batch = batch
        self.reads_enabled = self.cfg.read_index
        self.router = None
        if tenants is not None:
            from raft_sim_tpu_torch.serve.tenancy import TenantRouter

            self.router = TenantRouter(tenants, batch, self.reads_enabled)
            if sink is not None:
                self.router.attach_dir(sink.directory)
        # Extraction rounds queued behind each chunk: commits are at most
        # one entry a cluster a tick, so rounds x depth >= chunk keeps the
        # stream dry in steady state (+1 for boundary slack).
        self._drain_rounds = -(-chunk // delta_depth) + 1
        self.seed = seed
        self.chunk = chunk
        self.window = window
        self.sink = sink
        self.perf = perf
        if perf is not None:
            perf.watch(self.device)
            if warmup_ticks:
                # The warmup chunks (leader election) and the first serving
                # chunk (its wall runs from the loop's start) are not steady
                # serving.
                perf.warmup_chunks = max(perf.warmup_chunks,
                                         self._round_up(warmup_ticks) // chunk + 1)
        if sink is not None:
            # The session owns the delta stream; truncate a stale one so
            # every cluster's stream starts dense at index 1.
            self._deltas_path = os.path.join(sink.directory, "deltas.jsonl")
            open(self._deltas_path, "w").close()
        state, self.keys = scan.seed_fleet(self.cfg, seed, batch, self.device)
        self._s = raft_batched.to_batch_minor(state)
        del state
        self.now = 0
        self.metrics = scan.init_metrics_batch(batch, self.device)
        self.deltas = deltas_mod.DeltaStream(batch, depth=delta_depth, device=self.device,
                                             batch_minor=True)
        self.delta_rows: list[dict] = []
        self.chunks_done = 0
        self.ticks_done = 0
        self.warmup_chunks = 0
        # Host times of each serving chunk's sync, and the device ms of each
        # chunk's extraction rounds (CUDA events; on the card only).
        self.sync_times: list[float] = []
        self.extract_ms: list[float] = []
        self.monitors: list = []
        self._health_status: tuple | None = None
        if warmup_ticks:
            # Elect leaders before the first offer (an offer into a
            # leaderless tick is dropped). Warmup is not serving: the chunk
            # budget and the stats cover serving chunks only.
            self._advance(self._round_up(warmup_ticks))
            self.warmup_chunks, self.chunks_done = self.chunks_done, 0
            self.ticks_done = 0
        if health is not None:
            self._arm_health(health, seed)

    def _arm_health(self, health, seed: int) -> None:
        """One fleet monitor (the perf rows are loop-wide: it owns the
        runtime SLIs) and one per tenant slice, sharing one writer."""
        from raft_sim_tpu_torch.health import HealthMonitor, HealthWriter, load_spec
        from raft_sim_tpu_torch.utils.telemetry_sink import config_hash

        if self.sink is None:
            raise ValueError("health monitoring needs a sink: the health/alert streams and "
                             "evidence bundles live in its directory")
        spec = load_spec(health)
        writer = HealthWriter(self.sink.directory)
        refs = {"config_hash": config_hash(self.cfg), "seed": int(seed),
                "batch": int(self.batch), "source": "serve"}
        capture = lambda alert, clusters: {"refs": refs}  # noqa: E731
        self.monitors.append(HealthMonitor(spec, batch=self.batch, writer=writer, scope="fleet",
                                           perf=self.perf, capture=capture))
        if self.router is not None:
            for t in self.router.tenants:
                self.monitors.append(HealthMonitor(
                    spec, batch=t.hi - t.lo, writer=writer, scope=f"tenant:{t.name}",
                    cluster_base=t.lo, capture=capture))

    @property
    def state(self):
        """The fleet's state in the public [B, ...] layout (a copy)."""
        return raft_batched.from_batch_minor(self._s)

    def _round_up(self, ticks: int) -> int:
        return -(-ticks // self.chunk) * self.chunk

    def _nil_planes(self, ticks: int):
        cmds = np.full((ticks, self.batch), NIL, np.int32)
        reads = np.full((ticks, self.batch), NIL, np.int32) if self.reads_enabled else None
        return cmds, reads

    def _advance(self, ticks: int) -> None:
        """Warmup: chunks without offers, each dispatched and collected."""
        for _ in range(ticks // self.chunk):
            self._dispatch(*self._nil_planes(self.chunk))
            self._collect()

    def _take(self):
        s, self._s = self._s, None
        return s

    def _dispatch(self, cmds_np: np.ndarray, reads_np=None) -> None:
        """Enqueue one chunk; its records start home behind it."""
        _check_planes(self.cfg, cmds_np, reads_np, self.window)
        n = int(cmds_np.shape[0])
        if self.perf is not None:
            self.perf.begin(n)
        cmds = _plane(cmds_np, self.device)
        reads = None if reads_np is None else _plane(reads_np, self.device)
        # The state goes to the chunk by value only (_take): no reference to
        # the chunk's input fleet outlives its first tick.
        self._s, self._m_pending, recs, _ = telemetry.run_minor_telemetry(
            self.cfg, self._take(), self.keys, n, self.window, self.now, cmds=cmds, reads=reads)
        self._recs_pending = device_mod.to_host_async(recs)
        if self.perf is not None:
            self.perf.dispatched()
            # The timer's sync: a host copy of the chunk's metrics.ticks,
            # queued right behind the chunk.
            self._ticks_pending = device_mod.to_host_async(self._m_pending.ticks)
        self.now += n
        self.chunks_done += 1
        self.ticks_done += n
        self._last_offered = int(np.sum(cmds_np != NIL)) + (
            0 if reads_np is None else int(np.sum(reads_np != NIL)))

    def _export(self, recs_pending, rows: list[dict]) -> None:
        """Host-side export of one collected chunk: the fleet sink, the
        tenants' windows and deltas, and the ack ledgers."""
        if recs_pending is not None:
            recs = device_mod.host_numpy(*recs_pending)
            if self.sink is not None:
                self.sink.append_windows(recs)
            if self.router is not None:
                self.router.credit_windows(recs)
            if self.monitors:
                self._observe_health(recs)
        self.delta_rows.extend(rows)
        if self.sink is not None and rows:
            deltas_mod.append_delta_rows(self._deltas_path, rows)
        if self.router is not None and rows:
            self.router.route_deltas(rows)

    def _observe_health(self, recs) -> None:
        """Fan one collected chunk's window units (split once) to the fleet
        and tenant monitors, and print the status lines to stderr whenever a
        scope changes state."""
        from raft_sim_tpu_torch.health.monitor import slice_units

        units = telemetry.window_cluster_counters(recs)
        for m in self.monitors:
            if m.cluster_base == 0 and m.batch == self.batch:
                m.observe_units(units)
            else:
                m.observe_units(slice_units(units, m.cluster_base, m.cluster_base + m.batch))
        status = tuple(m.status for m in self.monitors)
        if self._health_status is not None and status != self._health_status:
            print("; ".join(m.status_line() for m in self.monitors), file=sys.stderr)
        self._health_status = status

    def _merge_pending(self) -> None:
        self.metrics = merge_metrics(self.metrics, raft_batched.from_batch_minor(self._m_pending))
        self._m_pending = None
        if self.perf is not None:
            self.perf.end(sync=lambda: device_mod.host_numpy(*self._ticks_pending))

    def _collect(self) -> list[dict]:
        """Synchronous collect (warmup): merge the chunk's metrics, drain its
        deltas to dryness, export."""
        self._merge_pending()
        rows = self.deltas.drain(self._s)
        self._export(self._recs_pending, rows)
        return rows

    def _begin_extraction(self):
        """Queue this chunk's extraction rounds (timed on the card)."""
        if self.device.type != "cuda":
            return self.deltas.begin_rounds(self._s, self._drain_rounds), None
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        futs = self.deltas.begin_rounds(self._s, self._drain_rounds)
        ev1.record()
        return futs, (ev0, ev1)

    def serve(self, source: CommandSource | None = None, chunks: int | None = None,
              drain_chunks: int = 4, progress=None, stall_chunks: int = 256) -> dict:
        """Run the overlapped service loop and return its stats.

        `source` (single-tenant form) offers each command to every cluster;
        a session built with tenants takes none. Stops after `chunks`
        serving chunks when given; otherwise once every source is exhausted,
        every read demand met and `drain_chunks` offer-free chunks have
        flushed the trailing commits. `progress(stats)` runs after each
        chunk. `stall_chunks` (0 = off) raises if no tenant's ledger moves
        for that many chunks while demands remain."""
        from raft_sim_tpu_torch.serve.tenancy import Tenant, TenantRouter

        if self.router is None:
            if source is None:
                raise ValueError("serve() needs a source (or tenants=[...])")
            self.router = TenantRouter(
                [Tenant("default", self.batch, source=source, broadcast=True)],
                self.batch, self.reads_enabled)
            if self.sink is not None:
                self.router.attach_dir(self.sink.directory)
        elif source is not None:
            raise ValueError(
                "this session was built with tenants=[...]; their sources replace serve(source)")
        router = self.router
        t0 = time.perf_counter()
        drain_left = drain_chunks
        stall = 0
        last_ledger = None
        pending = None  # chunk k-1's (records, delta rows), exported under chunk k
        self._dispatch(*router.pack(self.chunk))
        while True:
            # ---- host window: chunk k is queued on the device -------------
            e0 = time.perf_counter()
            if pending is not None:
                self._export(*pending)
            e1 = time.perf_counter()
            if chunks is not None:
                stop = self.chunks_done >= chunks
            else:
                if router.exhausted and self._last_offered == 0:
                    drain_left -= 1
                stop = router.exhausted and drain_left <= 0
                if not router.exhausted and stall_chunks:
                    ledger = tuple((len(t.acked_values), t.reads_served, t.offered)
                                   for t in router.tenants)
                    stall = stall + 1 if ledger == last_ledger else 0
                    last_ledger = ledger
                    if stall >= stall_chunks:
                        stuck = [t.name for t in router.tenants
                                 if not (t.writes_done and t.reads_done)]
                        raise RuntimeError(
                            f"serve loop stalled for {stall_chunks} chunks with unmet demands "
                            f"on tenants {stuck}: the demand may be unservable under this "
                            "config (e.g. read-only tenants need elections that append no-ops)")
            next_planes = None if stop else router.pack(self.chunk)
            e2 = time.perf_counter()
            futs, timing = self._begin_extraction()
            if self.perf is not None:
                self.perf.annotate(export_s=round(e1 - e0, 6), pack_s=round(e2 - e1, 6))
            # ---- sync: the chunk's rows wait for its extraction copies ----
            self._merge_pending()
            pending = (self._recs_pending, self.deltas.finish_rounds(futs))
            self.sync_times.append(time.perf_counter())
            if timing is not None:
                self.extract_ms.append(timing[0].elapsed_time(timing[1]) / self._drain_rounds)
            if progress is not None:
                progress(self.stats())
            if stop:
                self._export(*pending)
                tail = self.deltas.drain(self._s)  # drain to dryness
                if tail:
                    self._export(None, tail)
                break
            self._dispatch(*next_planes)
        stats = self.stats()
        stats["wall_s"] = round(time.perf_counter() - t0, 3)
        stats["offered"] = router.offered
        stats["reads_offered"] = router.reads_offered
        if self.perf is not None:
            stats["perf"] = self.perf.finish()  # prints the watchdog's finding, if any
        if self.monitors:
            # The trailing partial period is evaluated; each scope's rollup
            # replaces the live status map.
            stats["health"] = [m.finalize() for m in self.monitors]
        if self.sink is not None:
            from raft_sim_tpu_torch.summary import summarize

            self.sink.write_summary({**summarize(self.metrics)._asdict(), **stats})
            self.router.write_manifest(os.path.join(self.sink.directory, "tenants.json"))
        return stats

    def stats(self) -> dict:
        reads_served = int(self.metrics.reads_served.sum())
        return {
            "chunks": self.chunks_done,
            "ticks": self.ticks_done,
            "warmup_chunks": self.warmup_chunks,
            "batch": self.batch,
            "chunk": self.chunk,
            "window": self.window,
            "tenants": 0 if self.router is None else len(self.router.tenants),
            "deltas_exported": self.deltas.exported,
            "delta_gap_entries": self.deltas.gap_entries,
            # Client entries only (leader no-ops left out): the commands
            # half of the throughput metric.
            "commands_acked": self.deltas.applied,
            "reads_served": reads_served,
            "ops_done": self.deltas.applied + reads_served,
            "violations": int(self.metrics.violations.sum()),
            **({"health": {m.scope: m.status for m in self.monitors}} if self.monitors else {}),
        }

    def acked_values(self, cluster: int = 0) -> list[int]:
        """One cluster's commit-ack stream: committed client values in
        commit order, no-ops left out."""
        return deltas_mod.applied_values(self.delta_rows, cluster)
