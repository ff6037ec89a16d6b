"""Host driver: `Session` and the `run` and `serve` subcommands (the port of
raft_sim_tpu/driver.py's plain, telemetry and serve paths).

`Session` holds one experiment -- a config, a fleet of `batch` clusters from
a seed, its run keys and accumulated metrics -- and steps it in chunks
(sim/chunked.py, or sim/telemetry.py with a telemetry sink attached),
optionally exporting one cluster's committed values (utils/apply_log.py)
between chunks, offering single client commands and reads (`offer`,
`offer_read`, acked through the commit-delta stream of serve/deltas.py),
and saving or restoring the whole of it (utils/checkpoint.py, the JAX
package's file format):

    s = Session(PRESETS["config6"][0], batch=1000, seed=0)
    s.run(10_000, chunk=1024)
    s.save("fuzz.npz")
    s = Session.restore("fuzz.npz"); s.run(10_000)

A Session runs on the card unless it is given device="cpu". It keeps the
lockstep tick `now` on the host, so a run reads nothing back per chunk but
what the apply log and the progress line ask for. `devices=N` splits the
cluster batch over N shards (parallel/mesh.py: dealt over the cards in
turn, so they share a card where there are fewer cards than shards, or N
shards on the CPU; a list names the devices): each shard's state, keys and
metrics stay on its device between chunks, its ticks interleaved with the
others', and `summary()`, `save()` and the `state` attribute gather the
shards in cluster order. Every plane runs sharded: each shard runs its own
windowed loop under a telemetry sink (its flight recorder and trace carry
stay on its device), the window records, trace windows and flights reach
the sink gathered in cluster order, and the offers tick each shard.
Trajectories and files are the same at any shard count.

`add_run_arguments` / `run` are the CLI's `run` subcommand: --preset, one
flag per RaftConfig field (`add_config_flags`, `build_config`), --batch,
--ticks, --seed, --chunk, --save, --resume (exclusive with every flag that
sets the experiment), --apply-log, --apply-cluster, --telemetry-dir,
--telemetry-window, --telemetry-ring, the protocol trace plane (--trace,
--trace-depth, --trace-freeze, --trace-trigger: `Session.attach_trace`;
--trace-ticks, --trace-events, --trace-cluster: `Session.trace`), --mutant
(a TEST-ONLY weakened tick, scenario/mutation.py), --devices N (shard the
batch, `Session(devices=)`), --perf (the chunk timer,
`Session.attach_perf`), --health [SPEC] (the SLO monitor,
`Session.attach_health`), --profile DIR (`profile_ctx`), --sanitize (the
release-poison sanitizer, `sanitize_ctx`), --progress,
--device and --backend (`select_device`: the JAX driver's backend names
mapped to a torch device).
`add_serve_arguments` / `serve` are the `serve` subcommand: the standing
fleet of serve/loop.py fed from a JSONL command source, with --perf,
--health, --profile and --sanitize (the warmup runs unarmed, as in JAX).
`add_scenario_arguments` / `scenario` are the `scenario` subcommands: `run`
(a fleet under a JSON nemesis program, `run_scenario`; its checkpoints carry
the program), `search` (the violation hunt, scenario/search.py), `farm` (the
fuzzing farm, farm/core.py) and `shrink` (a hit to a repro artifact,
scenario/shrink.py); `search` takes --fitness coverage, --proposal
coverage-guided, --trace-depth and --profile; `farm --mesh D` shards each
generation over D devices (--population is then the per-device share).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.parallel import mesh as mesh_mod
from raft_sim_tpu_torch.sim import chunked, scan, telemetry
from raft_sim_tpu_torch.sim import trace as trace_view
from raft_sim_tpu_torch.summary import summarize
from raft_sim_tpu_torch.utils import checkpoint
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.apply_log import ApplyLogWriter
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig, nondefault_fields


class Session:
    """One experiment and the verbs over it: run, reset, summary, save,
    restore, offer, offer_read, the apply-log export, the telemetry sink,
    the trace plane, the chunk timer and the health plane.

    `devices` (None, an int N, a list of devices or a parallel Mesh) shards
    the cluster batch (module docstring); every verb runs on a sharded
    Session as on an unsharded one, with the same results."""

    def __init__(self, cfg: RaftConfig, batch: int = 1, seed: int = 0, device="cuda",
                 devices=None):
        self.cfg = cfg
        self.batch = batch
        self.seed = seed
        self.device = device_mod.resolve(device)
        self.devices = devices
        self.apply_writer = None
        self.telemetry = None  # TelemetrySink (attach_telemetry)
        self._tel_recs = None  # the flight recorder's carry per shard (batch-minor)
        self._deltas = None  # serve.deltas.DeltaStream: offer()'s ack watcher
        self._trace_spec = None  # trace.TraceSpec (attach_trace)
        self._trace_persists = None  # the trace plane's cross-chunk carry per shard
        self._trace_trigger = None  # the flight recorder's event-kind trigger
        self.perf = None  # obs.ChunkTimer (attach_perf)
        self.health = None  # health.HealthMonitor (attach_health)
        self._health_args = None  # (spec, directory) for reset's re-attach
        self._live_recs = None  # this chunk's recorders (the health evidence hook)
        self.reset()

    def reset(self) -> None:
        """Back to tick 0 with the same seed: the same key derivation as
        `scan.simulate`, so a Session's run equals `simulate` leaf for leaf.
        An attached apply log, telemetry sink, chunk timer or health monitor
        starts over (files truncated, burn state back to ok)."""
        self._mesh = None  # the parallel Mesh while sharded (_apply_sharding)
        self.state, self.keys = scan.seed_fleet(self.cfg, self.seed, self.batch, self.device)
        self.metrics = scan.init_metrics_batch(self.batch, self.device)
        self._apply_sharding()
        self.now = 0
        self._deltas = None
        if self.apply_writer is not None:
            self.attach_apply_log(self.apply_writer.directory, self.apply_writer.cluster)
        if self.telemetry is not None:
            self.attach_telemetry(self.telemetry.directory, window=self.telemetry.window,
                                  ring=self.telemetry.ring)
        # The re-attach truncated the trace files: re-arming rewrites the meta
        # and starts the cross-window carry over.
        self._trace_persists = None
        if self._trace_spec is not None and self.telemetry is not None:
            self.telemetry.write_trace_meta(self._trace_spec)
        if self.perf is not None:
            self.attach_perf(warmup_chunks=self.perf.warmup_chunks)
        self._live_recs = None
        if self._health_args is not None:
            self.attach_health(*self._health_args)

    # ---- the cluster-axis shards -------------------------------------------------
    # `_state`, `_keys` and `_metrics` hold the shards' slices, each on its
    # device (one shard when unsharded); the attributes `state`, `keys` and
    # `metrics` gather them (reads) or split a whole-fleet value (writes).
    # `_tel_recs` and `_trace_persists` hold the batch-minor carries the same
    # way, gathered by `_tel_rec` and `_trace_persist`.

    def _apply_sharding(self) -> None:
        """Validate `devices` and split the fleet over its shards (the JAX
        `_apply_sharding`, with its errors); one shard is no sharding."""
        if self.devices is None:
            return
        whole = (self.state, self.keys, self.metrics)
        if isinstance(self.devices, mesh_mod.Mesh):
            mesh = self.devices
        elif isinstance(self.devices, int):
            if self.devices < 1:
                raise ValueError(f"devices must be >= 1, got {self.devices}")
            if self.batch % self.devices:
                raise ValueError(f"batch {self.batch} must divide over {self.devices} devices")
            mesh = _device_mesh(self.device, self.devices)
        else:
            mesh = mesh_mod.make_mesh(devices=list(self.devices))
        mesh_mod.check_batch(self.batch, mesh)
        self._mesh = mesh if mesh.size > 1 else None
        self.state, self.keys, self.metrics = whole

    def _split(self, tree, dim: int = 0) -> list:
        if self._mesh is None:
            return [tree]
        return [mesh_mod.take(tree, lo, hi, dim=dim, device=dev)
                for dev, lo, hi in mesh_mod.shard_rows(self.batch, self._mesh)]

    @property
    def state(self):
        return mesh_mod.concat(self._state)

    @state.setter
    def state(self, value):
        self._state = self._split(value)

    @property
    def keys(self):
        return mesh_mod.concat(self._keys)

    @keys.setter
    def keys(self, value):
        self._keys = self._split(value)

    @property
    def metrics(self):
        return mesh_mod.concat(self._metrics)

    @metrics.setter
    def metrics(self, value):
        self._metrics = self._split(value)

    @property
    def _tel_rec(self):
        return None if self._tel_recs is None else mesh_mod.concat(self._tel_recs, dim=-1)

    @_tel_rec.setter
    def _tel_rec(self, value):
        self._tel_recs = None if value is None else self._split(value, dim=-1)

    @property
    def _trace_persist(self):
        tps = self._trace_persists
        return None if tps is None else mesh_mod.concat(tps, dim=-1)

    def attach_apply_log(self, directory: str, cluster: int = 0) -> None:
        """Stream cluster `cluster`'s committed values to
        `directory`/node_<i>.log at every chunk boundary of run(). Keep chunks
        short enough that commit moves less than CAP - compact_margin a
        chunk, or compacted spans show as `# snapshot gap` lines."""
        if not 0 <= cluster < self.batch:
            raise IndexError(f"cluster {cluster} out of range for batch {self.batch}")
        self.apply_writer = ApplyLogWriter(directory, self.cfg, cluster)
        self.apply_writer.update(self.state)  # anything already committed

    def attach_telemetry(self, directory: str, window: int = 64, ring: int = 32) -> None:
        """Stream windowed fleet telemetry to `directory` (manifest and
        windows.jsonl, utils/telemetry_sink.py) and arm a `ring`-deep flight
        recorder that freezes each cluster's last ticks at its first
        violation (ring=0: none). run() then goes through sim/telemetry.py:
        the same trajectory as the plain path. finalize_telemetry() writes
        the flights and the summary at the end."""
        from raft_sim_tpu_torch.utils.telemetry_sink import TelemetrySink

        if window < 1:
            raise ValueError(f"telemetry window must be >= 1, got {window}")
        if ring < 0:
            raise ValueError(f"telemetry ring must be >= 0, got {ring}")
        self.telemetry = TelemetrySink(directory, self.cfg, seed=self.seed, batch=self.batch,
                                       window=window, ring=ring, backend=self.device.type)
        self._tel_rec = (telemetry.init_recorder(self.cfg, ring, self.batch, self.device)
                         if ring else None)

    def attach_trace(self, depth: int = 128, freeze: str | None = None,
                     trigger: str | None = None, coverage: bool = True) -> None:
        """Arm the protocol trace plane (raft_sim_tpu_torch/trace; needs
        cfg.track_trace and an attached telemetry sink): run() extracts each
        cluster's protocol events and streams them per window as trace.jsonl
        and trace_windows.jsonl, for the whole-history checker (`python -m
        raft_sim_tpu_torch.trace.checker DIR`). `freeze` (an event-kind name,
        trace.KINDS) stops a cluster's recording after that kind's first
        event; `trigger` freezes the flight recorder on that kind's first
        event instead of the first violation."""
        from raft_sim_tpu_torch.trace import KINDS, TraceSpec

        if not self.cfg.track_trace:
            raise ValueError("attach_trace needs cfg.track_trace=True (the trace plane is a "
                             "structural config gate)")
        if self.telemetry is None:
            raise RuntimeError("attach_trace needs an attached telemetry sink "
                               "(attach_telemetry): trace windows stream through it")

        def kind_code(name, what):
            if name is None:
                return None
            if name not in KINDS:
                raise ValueError(f"unknown {what} event kind {name!r} (have {sorted(KINDS)})")
            return KINDS[name]

        self._trace_spec = TraceSpec(depth=depth, coverage=coverage,
                                     freeze_kind=kind_code(freeze, "freeze") or 0)
        self._trace_trigger = kind_code(trigger, "trigger")
        self._trace_persists = None
        self.telemetry.write_trace_meta(self._trace_spec)

    def attach_perf(self, warmup_chunks: int | None = None) -> None:
        """Arm per-chunk runtime attribution (obs.ChunkTimer): run() writes
        one perf row a chunk into the attached telemetry sink's perf.jsonl
        (or keeps them on `self.perf.rows` with no sink). Host-side only:
        the trajectory is the unarmed one's."""
        from raft_sim_tpu_torch.obs import ChunkTimer

        kwargs = {} if warmup_chunks is None else {"warmup_chunks": warmup_chunks}
        self.perf = ChunkTimer(label="run", batch=self.batch, sink=self.telemetry, **kwargs)
        if self.health is not None:
            # Either attach order works: an armed monitor takes the new timer
            # for its runtime SLIs.
            self.health.perf = self.perf

    def attach_health(self, spec="default", directory: str | None = None) -> None:
        """Arm the fleet health plane (health/): run() evaluates the SLO spec
        every `eval_windows` telemetry windows (or chunks, on the plain
        path) and streams health.jsonl and alerts.jsonl into the telemetry
        sink's directory, or `directory` with no sink attached. A firing
        alert triages the worst clusters and freezes an evidence bundle,
        with their live flight rings when the recorder is armed. Host-side
        only: the trajectory is the unmonitored one's."""
        from raft_sim_tpu_torch.health import HealthMonitor, HealthWriter, load_spec

        target = directory or (self.telemetry.directory if self.telemetry is not None else None)
        if target is None:
            raise RuntimeError("attach_health needs somewhere to stream health.jsonl: attach a "
                               "telemetry sink first (attach_telemetry) or pass directory=")
        self._health_args = (spec, directory)
        self.health = HealthMonitor(load_spec(spec) if not isinstance(spec, dict) else spec,
                                    batch=self.batch, writer=HealthWriter(target), scope="fleet",
                                    perf=self.perf, capture=self._health_capture)

    def _health_capture(self, alert, clusters):
        """The monitor's evidence hook: the triaged clusters' live flight
        rings (telemetry path with a ring; the plain path gives refs only)."""
        flights = {}
        recs = self._live_recs if self._live_recs is not None else self._tel_recs
        rec = None if recs is None else mesh_mod.concat(recs, dim=-1)
        if rec is not None:
            for c in clusters:
                flights[int(c)] = telemetry.export_cluster(rec, int(c))
        return {"flights": flights,
                "refs": {"seed": self.seed, "batch": self.batch, "source": "run"}}

    def run(self, n_ticks: int, chunk: int = 4096, progress: bool = False) -> None:
        """Step the fleet `n_ticks` in chunks of `chunk` ticks through the
        tick kernel (the plain tick on the CPU), folding the metrics; with a
        telemetry sink attached, each chunk's windows stream to it, and with
        a trace armed its trace windows too. An armed chunk timer writes a
        row a chunk; an armed health monitor observes each chunk's windows
        (the plain path: its metric deltas)."""

        def after_chunk(done, states, metrics):
            # The shards gathered where read: the metrics, and the state for
            # the apply log.
            metrics = mesh_mod.concat(metrics)
            if self.health is not None and self.telemetry is None:
                # The chunk is the plain path's window.
                self.health.observe_chunk(done, metrics)
            if self.apply_writer is not None:
                self.apply_writer.update(mesh_mod.concat(states))
            if progress:
                v = int(metrics.violations.sum())
                print(f"  {done}/{n_ticks} ticks, violations={v}", file=sys.stderr)
            return False

        if self.telemetry is not None:
            def cb_t(done, states, metrics, records):
                if self.health is not None:
                    # One host copy, read by the sink and the monitor alike.
                    records = device_mod.host_numpy(*device_mod.to_host_async(records))
                self.telemetry.append_windows(records)
                if self.health is not None:
                    self.health.observe_records(records)
                return after_chunk(done, states, metrics)

            def hook(done, recs):
                # A firing alert snapshots this chunk's carried recorders
                # (none with ring=0).
                self._live_recs = recs if recs[0] is not None else None

            out = telemetry.run_chunked_telemetry(
                self.cfg, self._state, self._keys, n_ticks, window=self.telemetry.window,
                recorder=self._tel_recs, chunk=chunk, callback=cb_t, now=self.now,
                perf=self.perf, trace_spec=self._trace_spec,
                trace_persist=self._trace_persists, trigger_kind=self._trace_trigger,
                trace_callback=lambda done, traws: self.telemetry.append_trace(traws),
                chunk_hook=hook if self.health is not None else None)
            self._state, m, recs = out[:3]
            if self._tel_recs is not None:
                self._tel_recs = recs
            if self._trace_spec is not None:
                self._trace_persists = out[3]
        else:
            if self.health is not None:
                # run_chunked restarts its metrics and tick count each call.
                self.health.begin_run()
            self._state, m = chunked.run_chunked(
                self.cfg, self._state, self._keys, n_ticks, chunk=chunk, callback=after_chunk,
                now=self.now, perf=self.perf)
        self._metrics = [chunked.merge_metrics(a, b) for a, b in zip(self._metrics, m)]
        self.now += n_ticks

    def finalize_telemetry(self, max_flights: int = 8) -> dict:
        """End-of-experiment export: summary.json, and the flight recording
        of up to `max_flights` clusters whose recorder froze as
        flight_<cluster>.jsonl. Returns {"flights": clusters written,
        "flights_frozen", "flights_exported", "summary": path}; the frozen
        and exported counts are in summary.json too."""
        if self.telemetry is None:
            raise RuntimeError("no telemetry attached (attach_telemetry)")
        flights = []
        frozen_total = 0
        rec = self._tel_rec  # the shards' recorders in cluster order
        if rec is not None:
            frozen = np.flatnonzero(rec.frozen.cpu().numpy())
            frozen_total = int(frozen.size)
            for cluster in frozen[:max_flights]:
                ticks, infos = telemetry.export_cluster(rec, int(cluster))
                self.telemetry.write_flight(int(cluster), ticks, infos)
                flights.append(int(cluster))
            if frozen.size > max_flights:
                print(f"telemetry: {frozen.size} frozen clusters, exported first {max_flights} "
                      f"flight recordings ({frozen.size - max_flights} not exported -- raise "
                      "max_flights to keep them)", file=sys.stderr)
        summary = self.summary()
        summary["flights_frozen"] = frozen_total
        summary["flights_exported"] = len(flights)
        tp = self._trace_persist
        if tp is not None:
            from raft_sim_tpu_torch.trace.ring import cov_popcount

            summary["trace"] = {
                "events_emitted": int(tp.total.to(torch.int64).sum()),
                "frozen_clusters": int(tp.frozen.sum()),
                "cov_bits_max": int(cov_popcount(tp.cov).max()),
            }
        path = self.telemetry.write_summary(summary)
        return {"flights": flights, "flights_frozen": frozen_total,
                "flights_exported": len(flights), "summary": path}

    def _offer_step(self, client_cmd=None, read_cmd=None):
        """One tick of every shard through the shared tick body with an offer
        override; returns its StepInfo, gathered in cluster order."""
        outs = [scan.tick_batch_minor(self.cfg, raft_batched.to_batch_minor(st), keys,
                                      raft_batched.to_batch_minor(m), self.now,
                                      client_cmd=client_cmd, read_cmd=read_cmd)
                for st, keys, m in zip(self._state, self._keys, self._metrics)]
        self._state = [raft_batched.from_batch_minor(o[0]) for o in outs]
        self._metrics = [raft_batched.from_batch_minor(o[1]) for o in outs]
        info = mesh_mod.concat([o[2] for o in outs], dim=-1)
        self.now += 1
        if self.apply_writer is not None:
            self.apply_writer.update(self.state)
        return info

    def offer(self, value: int, wait: int = 0) -> dict:
        """Offer one client command in place of this tick's scheduled one and
        advance a tick; then step up to `wait` more ticks while clusters
        have yet to commit it. Returns {"accepted", "committed", "waited"}:
        `accepted` counts clusters whose leader appended the value on the
        offer tick; `committed` those whose commit-delta stream (node 0's
        apply stream, serve/deltas.py) delivered the pair (value, offer
        tick + 1) after the offer. Any int32 but NIL/NOOP is a legal value.
        With the offer-tick plane off (no client cadence, no serve_ingest)
        the match is by value alone. Refused while a trace is armed: the
        offer's ticks run outside the windowed loop, so their events would be
        missing from the trace stream, a hole the checker could not see."""
        if self._trace_spec is not None:
            raise RuntimeError("Session.offer() ticks are not covered by the armed trace "
                               "stream; detach the trace, or ingest via run()'s scheduled "
                               "cadence / the serve loop instead")
        from raft_sim_tpu_torch.serve.deltas import DeltaStream
        from raft_sim_tpu_torch.serve.ingest import check_value

        value = check_value(value)
        if self._deltas is None:
            self._deltas = DeltaStream(self.batch, depth=32, device=self.device)
        self._deltas.skip_to_now(self.state)  # only later commits can ack it
        track = self.cfg.track_offer_ticks
        stamp = self.now + 1
        acked: set[int] = set()

        def fresh() -> int:
            for row in self._deltas.drain(self.state):
                for v, tk in zip(row["values"], row["ticks"]):
                    if v == value and (not track or tk == stamp):
                        acked.add(row["cluster"])
            return len(acked)

        info = self._offer_step(client_cmd=value)
        accepted = int(info.cmds_injected.sum())
        committed, waited = fresh(), 0
        # Redirect mode: acceptance trickles in over the bounces, so keep
        # stepping until every cluster committed or the wait runs out.
        goal = self.batch if self.cfg.client_redirect else accepted
        while waited < wait and committed < goal:
            self.run(1, chunk=1)
            waited += 1
            committed = fresh()
        return {"accepted": accepted, "committed": committed, "waited": waited}

    def offer_read(self, wait: int = 0) -> dict:
        """Offer one ReadIndex read in place of this tick's scheduled one and
        advance a tick; then step up to `wait` more ticks while reads are
        unserved. Returns {"captured", "served", "waited"}: `captured` counts
        clusters whose leader took the read on the offer tick, `served` the
        reads served since (the reads_served counter). Needs cfg.read_index;
        refused while a trace is armed, as offer() is."""
        if self._trace_spec is not None:
            raise RuntimeError("Session.offer_read() ticks are not covered by the armed trace "
                               "stream; detach the trace, or ingest reads via the scheduled "
                               "cadence / the serve loop instead")
        if not self.cfg.read_index:
            raise ValueError(
                "offer_read needs the ReadIndex plane: set read_interval > 0 or serve_reads=True")
        before = self.metrics.reads_served.to(torch.int64).clone()
        stamp = self.now + 1
        self._offer_step(read_cmd=1)
        # Captures of this offer only: a fresh capture stamps read_tick with
        # the offer tick + 1.
        captured = int(((self.state.read_idx > 0) & (self.state.read_tick == stamp))
                       .any(dim=1).sum())

        def served_now() -> int:
            return int((self.metrics.reads_served.to(torch.int64) - before).sum())

        served, waited = served_now(), 0
        while waited < wait and served < self.batch:
            self.run(1, chunk=1)
            waited += 1
            served = served_now()
        return {"captured": captured, "served": served, "waited": waited}

    def trace(self, n_ticks: int, cluster: int = 0):
        """Step one cluster `n_ticks` from the session's state with every
        tick's StepInfo and state kept (heavy; for debugging), without
        advancing the session: a B=1 view over `scan.run_traced`, so on the
        card each tick is one launch of the kernel. Returns (stacked StepInfo,
        stacked states), each leaf leading with [n_ticks]."""
        if not 0 <= cluster < self.batch:
            raise IndexError(f"cluster {cluster} out of range for batch {self.batch}")
        one = lambda x: x[cluster:cluster + 1].contiguous()  # noqa: E731
        _, _, (infos, states) = scan.run_traced(
            self.cfg, raft_batched._map(one, self.state), one(self.keys), n_ticks)
        first = lambda tree: raft_batched._map(lambda x: x[0], tree)  # noqa: E731
        return first(infos), first(states)

    def summary(self) -> dict:
        """The fleet rollup (summary.summarize) as a dict, over the gathered
        shards when sharded."""
        return summarize(self.metrics)._asdict()

    def save(self, path: str) -> str:
        return checkpoint.save(path, self.cfg, self.state, self.keys, self.metrics, seed=self.seed)

    @classmethod
    def restore(cls, path: str, device="cuda", devices=None) -> "Session":
        """Resume exactly: state, keys, metrics and the seed come back, so
        runs after the restore equal an uninterrupted session's and reset()
        rebuilds the same experiment. `devices` shards on load: a checkpoint
        does not depend on the layout. A checkpoint that carries a scenario
        is refused: a Session has no scenario path, and running one here
        would continue a different experiment."""
        cfg, state, keys, metrics, seed, scenario = checkpoint.load(path, device)
        if scenario is not None:
            raise ValueError(
                f"checkpoint {path!r} carries scenario {scenario.get('name', '?')!r}: "
                "resume it through the scenario path, not a plain Session"
            )
        self = cls.__new__(cls)
        self.cfg = cfg
        self.batch = state.role.shape[0]
        self.seed = seed
        self.device = state.role.device
        self.devices = devices
        self._mesh = None
        self.apply_writer = None
        self.telemetry = None
        self._tel_recs = None
        self._deltas = None
        self._trace_spec = None
        self._trace_persists = None
        self._trace_trigger = None
        self.perf = None
        self.health = None
        self._health_args = None
        self._live_recs = None
        self.state = state
        self.keys = keys
        self.metrics = metrics
        self.now = int(state.now.reshape(-1)[0]) if self.batch else 0
        self._apply_sharding()
        return self


_FLAG_TYPES = {"int": int, "float": float}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def add_config_flags(p: argparse.ArgumentParser) -> None:
    """One flag per RaftConfig field, defaulting to None (not given)."""
    for f in dataclasses.fields(RaftConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool":
            p.add_argument(flag, type=_parse_bool, default=None, metavar="BOOL")
        else:
            p.add_argument(flag, type=_FLAG_TYPES.get(f.type, str), default=None)


def build_config(args) -> tuple[RaftConfig, int]:
    """(config, batch) from --preset and the field flags; the batch falls
    back to the preset's, then 1."""
    cfg, preset_batch = PRESETS[args.preset] if args.preset else (RaftConfig(), 1)
    batch = args.batch if args.batch is not None else preset_batch
    overrides = {
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(RaftConfig)
        if getattr(args, f.name) is not None
    }
    return (dataclasses.replace(cfg, **overrides) if overrides else cfg), batch


def add_run_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--ticks", type=int, default=1000)
    p.add_argument("--seed", type=int, default=None,
                   help="PRNG seed (default 0; stored in checkpoints, so exclusive with --resume)")
    p.add_argument("--chunk", type=int, default=4096, help="ticks between host callbacks")
    p.add_argument("--progress", action="store_true", help="a line on stderr per chunk")
    p.add_argument("--save", metavar="PATH", help="write a checkpoint at the end")
    p.add_argument("--resume", metavar="PATH", help="start from a checkpoint")
    p.add_argument("--apply-log", metavar="DIR", default=None,
                   help="stream one cluster's committed values to DIR/node_<i>.log")
    p.add_argument("--apply-cluster", type=int, default=0,
                   help="the cluster --apply-log exports (default 0)")
    p.add_argument("--telemetry-dir", metavar="DIR", default=None,
                   help="write windowed fleet telemetry (manifest + windows.jsonl) and the "
                        "flight recordings of violating clusters to DIR")
    p.add_argument("--telemetry-window", type=int, default=64, metavar="W",
                   help="ticks aggregated per telemetry window record (default 64)")
    p.add_argument("--telemetry-ring", type=int, default=32, metavar="K",
                   help="flight-recorder depth: the last K ticks of StepInfo per cluster, "
                        "frozen at the first violation (0 disables; default 32)")
    p.add_argument("--trace", action="store_true",
                   help="protocol trace plane (needs --telemetry-dir): stream each cluster's "
                        "protocol events as trace.jsonl for the whole-history checker "
                        "(python -m raft_sim_tpu_torch.trace.checker DIR); sets "
                        "cfg.track_trace, the trajectory is the untraced one")
    p.add_argument("--trace-depth", type=int, default=128, metavar="R",
                   help="events kept per cluster per telemetry window (overflow is counted "
                        "and the checker then reports the history incomplete; default 128)")
    p.add_argument("--trace-freeze", metavar="KIND", default=None,
                   help="stop a cluster's trace recording after its first event of KIND "
                        "(e.g. 'leader'); the checker reports such a stream undecided")
    p.add_argument("--trace-trigger", metavar="KIND", default=None,
                   help="freeze the flight recorder on the first event of KIND instead of "
                        "the first violation (implies cfg.track_trace)")
    p.add_argument("--trace-ticks", type=int, default=0,
                   help="print per-tick info lines for one cluster (does not run the session)")
    p.add_argument("--trace-events", action="store_true",
                   help="print decoded state-change events for one cluster")
    p.add_argument("--trace-cluster", type=int, default=0)
    p.add_argument("--mutant", default=None, metavar="NAME",
                   help="TEST-ONLY: run a deliberately weakened tick (scenario/mutation.py "
                        "registry, e.g. 'weak-quorum')")
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="shard the cluster batch over N shards: dealt over the cards in turn "
                        "(shards beyond the card count share a card), or N "
                        "shards on the CPU with --device cpu (trajectories and telemetry, "
                        "trace and checkpoint files are shard-count invariant)")
    p.add_argument("--perf", action="store_true",
                   help="per-chunk runtime attribution (obs.ChunkTimer): device-vs-host wall "
                        "split, warmup vs steady state, card memory, the kernel-cache "
                        "watchdog; streams perf.jsonl into --telemetry-dir when given and "
                        "prints the steady-state rollup")
    p.add_argument("--health", nargs="?", const="default", default=None, metavar="SPEC",
                   help="arm the fleet health plane (needs --telemetry-dir): evaluate the SLO "
                        "spec (the built-in default, or a JSON spec file) every eval period, "
                        "streaming health.jsonl and alerts.jsonl; firing burn-rate alerts "
                        "freeze evidence bundles with live flight-ring snapshots")
    add_sanitize_argument(p)
    add_profile_argument(p)
    add_device_arguments(p)
    add_config_flags(p)


def add_sanitize_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sanitize", action="store_true",
                   help="arm the release-poison sanitizer (analysis/sanitizer.py): once each "
                        "chunk is synchronized, the carry its loop handed over is poisoned in "
                        "place, so a late read of it changes the run; the armed run equals the "
                        "unarmed one (the overlap is serialized). One report line on stderr")


def sanitize_ctx(args):
    """The --sanitize arming of run and serve: the sanitizer over every
    registered releasing chunk step, or nothing without the flag. Yields
    the sanitizer's counters (None unarmed)."""
    if not getattr(args, "sanitize", False):
        return contextlib.nullcontext()
    from raft_sim_tpu_torch.analysis import sanitizer

    return sanitizer.armed()


def sanitize_report(san) -> None:
    if san is not None:
        from raft_sim_tpu_torch.analysis import sanitizer

        print(sanitizer.report_line(san), file=sys.stderr)


def add_profile_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="record a torch.profiler trace (CPU activity, and CUDA activity on "
                        "the card) into DIR/torch_trace.json (Chrome trace format); the "
                        "profiled run equals the unprofiled one")


@contextlib.contextmanager
def profile_ctx(path: str | None, device):
    """The --profile capture of run, serve and scenario search/farm: a
    torch.profiler trace of the block, written to `path`/torch_trace.json
    on exit; a no-op without a path."""
    if not path:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, "torch_trace.json"))


# The JAX driver's --backend names and the torch device each runs on: the
# JAX "tpu" and "auto" mean the accelerator, here the card.
BACKENDS = {"auto": "cuda", "tpu": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def add_device_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, choices=sorted(BACKENDS),
                   help="the JAX driver's backend names: auto, tpu, gpu and cuda run on "
                        "the card (and fail without one), cpu on the CPU")


def select_device(ap: argparse.ArgumentParser, args) -> None:
    """Settle `args.device` from --device and --backend (the card when
    neither is given); a --backend that contradicts --device is a usage
    error."""
    mapped = BACKENDS[args.backend] if args.backend else None
    if args.device is None:
        args.device = mapped or "cuda"
    elif mapped and torch.device(args.device).type != mapped:
        ap.error(f"--backend {args.backend} runs on {mapped}, but --device is {args.device}")


def _mutant(ap: argparse.ArgumentParser, name: str | None, cfg: RaftConfig) -> RaftConfig:
    """`cfg` under the named TEST-ONLY mutant (unchanged for None); an unknown
    name is a usage error."""
    if not name:
        return cfg
    from raft_sim_tpu_torch.scenario.mutation import mutant_config

    try:
        return mutant_config(name, cfg)
    except ValueError as ex:
        ap.error(str(ex))


def run(ap: argparse.ArgumentParser, args) -> int:
    """The `run` subcommand: build or restore a Session, run it, print the
    fleet summary with the wall time and the device as one JSON line, and
    save a checkpoint if asked. --trace-ticks / --trace-events print one
    cluster's trajectory instead of running the session."""
    select_device(ap, args)
    traced = args.trace or args.trace_trigger or args.trace_freeze
    if args.resume:
        # A checkpoint IS the experiment: rerunning it under other flags
        # would mislabel the results.
        conflicting = [
            f.name for f in dataclasses.fields(RaftConfig) if getattr(args, f.name) is not None
        ]
        conflicting += [flag for flag in ("preset", "batch", "seed", "mutant")
                        if getattr(args, flag) is not None]
        if traced:
            conflicting.append("trace")  # track_trace is part of the config
        if conflicting:
            ap.error(f"--resume is exclusive with config flags: {', '.join(conflicting)}")
        sess = Session.restore(args.resume, device=args.device)
        # Checkpoint problems (a bad path, a stale format) surface as real
        # errors; only --devices misuse gets the usage-error framing.
        if args.devices is not None:
            try:
                sess.devices = args.devices
                sess._apply_sharding()
            except ValueError as ex:
                ap.error(str(ex))
    else:
        cfg, batch = build_config(args)
        cfg = _mutant(ap, args.mutant, cfg)
        if traced:
            # --trace-trigger / --trace-freeze imply the trace plane: both
            # read the extracted event stream.
            if not args.telemetry_dir:
                ap.error("--trace/--trace-trigger/--trace-freeze need --telemetry-dir (trace "
                         "windows stream through the telemetry sink)")
            cfg = dataclasses.replace(cfg, track_trace=True)
        try:
            sess = Session(cfg, batch=batch, seed=args.seed if args.seed is not None else 0,
                           device=args.device, devices=args.devices)
        except ValueError as ex:
            ap.error(str(ex))
    if args.trace_ticks or args.trace_events:
        if (args.save or args.apply_log or args.telemetry_dir or args.perf or args.health
                or args.profile):
            ap.error("--save/--profile/--apply-log/--telemetry-dir/--perf/--health have no "
                     "effect with --trace-ticks/--trace-events (tracing does not advance the "
                     "session)")
        try:
            infos, states = sess.trace(args.trace_ticks or args.ticks, cluster=args.trace_cluster)
        except IndexError as ex:
            ap.error(str(ex))
        if args.trace_events:
            for t, ev in trace_view.events(states):
                print(f"tick {t:>6}  {ev}")
        else:
            for line in trace_view.info_lines(infos):
                print(line)
        return 0
    if args.apply_log:
        try:
            sess.attach_apply_log(args.apply_log, cluster=args.apply_cluster)
        except IndexError as ex:
            ap.error(str(ex))
    if args.telemetry_dir:
        try:
            sess.attach_telemetry(args.telemetry_dir, window=args.telemetry_window,
                                  ring=args.telemetry_ring)
        except ValueError as ex:
            ap.error(str(ex))
        if traced:
            try:
                sess.attach_trace(depth=args.trace_depth, freeze=args.trace_freeze,
                                  trigger=args.trace_trigger)
            except ValueError as ex:
                ap.error(str(ex))
    if args.perf:
        # After the sink, so perf.jsonl streams into its directory.
        sess.attach_perf()
    if args.health:
        if not args.telemetry_dir:
            ap.error("--health needs --telemetry-dir (the health/alert streams ride the "
                     "telemetry sink directory; Session.attach_health(directory=) is the "
                     "sink-free form)")
        try:
            sess.attach_health(args.health)
        except ValueError as ex:
            ap.error(str(ex))
    t0 = time.perf_counter()
    with profile_ctx(args.profile, sess.device), sanitize_ctx(args) as san:
        sess.run(args.ticks, chunk=args.chunk, progress=args.progress)
        out = sess.summary()  # copies to the host: waits for the device
    dt = time.perf_counter() - t0
    sanitize_report(san)
    out["wall_s"] = dt
    out["cluster_ticks_per_s"] = sess.batch * args.ticks / dt
    out["device"] = _device_name(sess.device)
    if args.perf:
        out["perf"] = sess.perf.finish()  # prints the watchdog's finding, if any
    if sess.health is not None:
        out["health"] = sess.health.finalize()
        print(sess.health.status_line(), file=sys.stderr)
    print(json.dumps(out))
    if args.telemetry_dir:
        fin = sess.finalize_telemetry()
        if fin["flights"]:
            print(f"telemetry: flight recordings exported for clusters {fin['flights']} "
                  f"under {args.telemetry_dir}", file=sys.stderr)
    if args.save:
        sess.save(args.save)
    return 0


def _device_mesh(device, n: int):
    """The cluster mesh of `--mesh n` / `--devices n` on `device`: n shards
    dealt over the cards in turn (the first n cards where there are n; 0:
    every card), so shards beyond the card count share a card as they
    share the CPU; or n shards on the CPU (0: one)."""
    dev = device_mod.resolve(device)
    if n < 0:
        raise ValueError(f"--mesh must be >= 0, got {n}")
    if n == 0:
        n = len(mesh_mod.mesh_devices()) if dev.type == "cuda" else 1
    return mesh_mod.dealt_mesh(n, dev)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def add_serve_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--source", metavar="FILE", default="-",
                   help="JSONL command source: one command per line, a bare int or "
                        "{\"value\": v}; '-' = stdin (default)")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--chunk", type=int, default=256,
                   help="ticks per device chunk (the ingest/export cadence; default 256)")
    p.add_argument("--window", type=int, default=64,
                   help="telemetry window ticks (must divide --chunk; default 64)")
    p.add_argument("--chunks", type=int, default=None,
                   help="stop after N chunks (default: run until the source is exhausted, "
                        "then --drain-chunks more)")
    p.add_argument("--drain-chunks", type=int, default=4,
                   help="offer-free chunks run after the source is exhausted, so trailing "
                        "commits flush through the delta stream (default 4)")
    p.add_argument("--warmup", type=int, default=0, metavar="TICKS",
                   help="ticks simulated before the first offer (elect leaders first)")
    p.add_argument("--tenants", type=int, default=None, metavar="N",
                   help="partition the fleet's clusters among N tenants (per-tenant "
                        "sources, sinks and read demands); the command stream is dealt "
                        "round-robin, weighted by cluster count")
    p.add_argument("--reads-per-tenant", type=int, default=0, metavar="R",
                   help="ReadIndex reads each tenant must get served (re-offered until "
                        "served; needs a read-carrying config, e.g. --preset config9)")
    p.add_argument("--delta-depth", type=int, default=64,
                   help="per-cluster commit-delta buffer per extraction round "
                        "(backpressure, not loss; default 64)")
    p.add_argument("--sink", metavar="DIR", default=None,
                   help="stream telemetry windows (windows.jsonl) and commit deltas "
                        "(deltas.jsonl) to DIR")
    p.add_argument("--progress", action="store_true", help="a line on stderr per chunk")
    p.add_argument("--perf", action="store_true",
                   help="per-chunk runtime attribution of the serving loop (dispatch, export "
                        "and packing inside the host window, device wait; the kernel-cache "
                        "watchdog); streams perf.jsonl into --sink when given")
    p.add_argument("--health", nargs="?", const="default", default=None, metavar="SPEC",
                   help="arm fleet and per-tenant SLO monitors (needs --sink): health.jsonl "
                        "and alerts.jsonl, status lines on stderr, evidence bundles on firing "
                        "alerts; the built-in default spec, or a JSON spec file")
    add_sanitize_argument(p)
    add_profile_argument(p)
    add_device_arguments(p)
    add_config_flags(p)


def _shard_round_robin(it, weights: list[int]):
    """One lazy payload iterator split into len(weights) shard iterators,
    dealt in weighted round-robin order (shard i takes weights[i]
    consecutive commands a cycle), so each tenant's queue stays within one
    chunk's imbalance."""
    from collections import deque

    src = iter(it)
    order = [i for i, w in enumerate(weights) for _ in range(w)]
    queues = [deque() for _ in weights]
    turn = [0]

    def shard(i: int):
        while True:
            if queues[i]:
                yield queues[i].popleft()
                continue
            try:
                v = next(src)
            except StopIteration:
                return
            queues[order[turn[0]]].append(v)
            turn[0] = (turn[0] + 1) % len(order)

    return [shard(i) for i in range(len(weights))]


def serve(ap: argparse.ArgumentParser, args) -> int:
    """The `serve` subcommand: a standing fleet takes streamed client
    commands between chunks and streams telemetry windows and commit deltas
    to the sink; prints the fleet summary with the serve stats, the rates
    and the device as one JSON line. `--tenants N` partitions the clusters;
    `--reads-per-tenant R` adds a read demand per tenant."""
    from raft_sim_tpu_torch.serve import CommandSource, ServeSession, jsonl_commands
    from raft_sim_tpu_torch.serve.loop import serve_config
    from raft_sim_tpu_torch.serve.tenancy import Tenant, split_even
    from raft_sim_tpu_torch.utils.telemetry_sink import TelemetrySink

    select_device(ap, args)
    cfg, batch = build_config(args)
    cfg = serve_config(cfg)
    dev = device_mod.resolve(args.device)
    if args.source != "-":
        try:  # fail before the warmup, not at the first chunk
            open(args.source).close()
        except OSError as ex:
            ap.error(f"--source: {ex}")
    seed = args.seed or 0
    sink = None
    if args.sink:
        sink = TelemetrySink(args.sink, cfg, seed=seed, batch=batch, window=args.window, ring=0,
                             source="serve", backend=dev.type)
    perf = None
    if args.perf:
        from raft_sim_tpu_torch.obs import ChunkTimer

        perf = ChunkTimer(label="serve", batch=batch, sink=sink)
    if args.reads_per_tenant < 0:
        ap.error("--reads-per-tenant must be >= 0")
    if args.tenants is not None and not 1 <= args.tenants <= batch:
        ap.error(f"--tenants must be in [1, batch={batch}]")
    tenants = None
    if args.tenants is None and args.reads_per_tenant:
        # One tenant over the whole fleet whose writes keep the broadcast
        # form: a read demand never reshapes the write path.
        tenants = [Tenant("tenant0", batch, source=jsonl_commands(args.source),
                          reads=args.reads_per_tenant, broadcast=True)]
    elif args.tenants is not None:
        sizes = split_even(batch, args.tenants)
        shards = _shard_round_robin(jsonl_commands(args.source), sizes)
        tenants = [Tenant(f"tenant{i}", sizes[i], source=shards[i], reads=args.reads_per_tenant)
                   for i in range(args.tenants)]
    if args.health and not args.sink:
        ap.error("--health needs --sink (the health/alert streams ride the telemetry sink "
                 "directory)")
    try:
        sess = ServeSession(cfg, batch=batch, seed=seed, chunk=args.chunk, window=args.window,
                            delta_depth=args.delta_depth, sink=sink, warmup_ticks=args.warmup,
                            perf=perf, tenants=tenants, health=args.health, device=dev)
    except ValueError as ex:
        ap.error(str(ex))
    source = None if tenants is not None else CommandSource(jsonl_commands(args.source))

    def progress(st):
        if args.progress:
            print(f"  chunk {st['chunks']}: {st['ticks']} ticks, {st['deltas_exported']} deltas, "
                  f"{st['reads_served']} reads, violations={st['violations']}", file=sys.stderr)

    try:
        with profile_ctx(args.profile, dev), sanitize_ctx(args) as san:
            stats = sess.serve(source, chunks=args.chunks, drain_chunks=args.drain_chunks,
                               progress=progress)
    except ValueError as ex:
        ap.error(str(ex))
    sanitize_report(san)
    out = summarize(sess.metrics)._asdict()
    out.update(stats)
    if stats["wall_s"] > 0:
        out["cluster_ticks_per_s"] = round(batch * stats["ticks"] / stats["wall_s"], 1)
        out["ops_per_s"] = round(stats["ops_done"] / stats["wall_s"], 1)
    if args.sink:
        out["sink"] = args.sink
    out["device"] = _device_name(dev)
    print(json.dumps(out))
    return 0


def run_scenario(cfg: RaftConfig, program, n_ticks: int, state, keys, chunk: int = 4096,
                 callback=None):
    """Run the [B, ...]-leading fleet (`state`, `keys`) `n_ticks` under the
    nemesis `program` (scenario/program.py), every cluster on its genome, in
    chunks; returns (state, RunMetrics of these ticks). The segments follow
    the absolute tick in the state, so a resumed run stays in phase."""
    from raft_sim_tpu_torch.scenario import genome as genome_mod

    batch = state.role.shape[0]
    g = genome_mod.to_device(genome_mod.broadcast(program.genome, batch), state.role.device)
    return chunked.run_chunked(cfg, state, keys, n_ticks, chunk=chunk, callback=callback,
                               genome=g, seg_len=program.seg_len)


def add_scenario_arguments(sc: argparse.ArgumentParser) -> dict:
    """The `scenario` subcommands' parsers, by name (`run`, `search`, `farm`,
    `shrink`)."""
    ssub = sc.add_subparsers(dest="scmd", required=True)
    srun = ssub.add_parser("run", help="run a fleet under a JSON nemesis program")
    srun.add_argument("--scenario", metavar="FILE", default=None,
                      help="declarative scenario file (scenario/program.py schema)")
    srun.add_argument("--preset", choices=sorted(PRESETS), default=None)
    srun.add_argument("--batch", type=int, default=None)
    srun.add_argument("--ticks", type=int, default=1000)
    srun.add_argument("--seed", type=int, default=None)
    srun.add_argument("--chunk", type=int, default=4096)
    srun.add_argument("--progress", action="store_true")
    srun.add_argument("--save", metavar="PATH",
                      help="checkpoint at the end (it records the scenario)")
    srun.add_argument("--resume", metavar="PATH",
                      help="resume a scenario checkpoint (plain checkpoints are refused)")
    add_device_arguments(srun)
    add_config_flags(srun)

    ssearch = ssub.add_parser("search", help="cross-entropy hunt for violating fault genomes")
    ssearch.add_argument("--preset", choices=sorted(PRESETS), default=None)
    # build_config reads args.batch; the search population is the batch.
    ssearch.add_argument("--batch", type=int, default=None, help=argparse.SUPPRESS)
    ssearch.add_argument("--mutant", default=None, metavar="NAME",
                         help="TEST-ONLY: hunt a deliberately weakened tick "
                              "(scenario/mutation.py registry, e.g. 'weak-quorum')")
    ssearch.add_argument("--generations", type=int, default=8)
    ssearch.add_argument("--population", type=int, default=64,
                         help="genomes per generation = fleet batch size")
    ssearch.add_argument("--ticks", type=int, default=512)
    ssearch.add_argument("--window", type=int, default=64,
                         help="telemetry window (fitness resolution)")
    ssearch.add_argument("--elite-frac", type=float, default=0.25)
    ssearch.add_argument("--fitness", choices=("scalar", "coverage"), default="scalar",
                         help="'scalar': the distress weights; 'coverage': transition-coverage "
                              "novelty from the protocol trace plane (violations stay dominant)")
    ssearch.add_argument("--trace-depth", type=int, default=32, metavar="R",
                         help="coverage mode's per-window event-buffer depth (default 32)")
    ssearch.add_argument("--proposal", choices=("gaussian", "coverage-guided"),
                         default="gaussian",
                         help="'gaussian': CE draws; 'coverage-guided': mutate the previous "
                              "generation's novelty-lit parents (needs --fitness coverage)")
    ssearch.add_argument("--seed", type=int, default=None)
    ssearch.add_argument("--out", metavar="FILE", default=None,
                         help="write the first violating hit (feeds `scenario shrink --hit`)")
    add_profile_argument(ssearch)
    add_device_arguments(ssearch)
    add_config_flags(ssearch)

    sfarm = ssub.add_parser("farm", help="the fuzzing farm: portfolio hunts, coverage-guided "
                            "mutation and the self-growing safety corpus (farm/)")
    sfarm.add_argument("--preset", choices=sorted(PRESETS), default=None)
    # build_config reads args.batch; the farm population is the batch.
    sfarm.add_argument("--batch", type=int, default=None, help=argparse.SUPPRESS)
    sfarm.add_argument("--mutant", default=None, metavar="NAME",
                       help="TEST-ONLY: hunt a deliberately weakened tick (scenario/mutation.py "
                            "registry)")
    sfarm.add_argument("--portfolio", default="scalar,coverage", metavar="M1,M2,...",
                       help="fitness members hunted in parallel over disjoint slices of the "
                            "fleet (farm/portfolio.py: scalar, coverage, multi_leader, "
                            "commit_stall, read_staleness, durability; default scalar,coverage)")
    sfarm.add_argument("--budget-gens", type=int, default=8,
                       help="generation budget; spending it without a hit pins a negative "
                            "result (out-dir/negative.json)")
    sfarm.add_argument("--population", type=int, default=64,
                       help="fleet batch, split among the members; under --mesh this is the "
                            "PER-DEVICE population (the total scales with the device count)")
    sfarm.add_argument("--mesh", type=int, default=None, metavar="D",
                       help="shard each generation over D devices (0 = every card; D shards "
                            "on the CPU with --device cpu): one sharded evaluation a "
                            "generation, the same hits at any device count "
                            "(parallel.simulate_windowed_sharded)")
    sfarm.add_argument("--ticks", type=int, default=512)
    sfarm.add_argument("--window", type=int, default=64,
                       help="telemetry window (fitness resolution)")
    sfarm.add_argument("--elite-frac", type=float, default=0.25)
    sfarm.add_argument("--trace-depth", type=int, default=32, metavar="R")
    sfarm.add_argument("--no-guided", action="store_true",
                       help="no coverage-guided mutation (pure per-member CE; a trace-free "
                            "portfolio then runs untraced)")
    sfarm.add_argument("--stop-on", choices=("hit", "frozen", "budget"), default="hit",
                       help="stop at the first processed hit (default), the first newly frozen "
                            "artifact, or never")
    sfarm.add_argument("--seed", type=int, default=None)
    sfarm.add_argument("--out-dir", metavar="DIR", required=True,
                       help="farm output: farm_manifest.json, members/<name>/hunt.jsonl, "
                            "perf.jsonl, negative.json on a hitless budget")
    sfarm.add_argument("--corpus-dir", metavar="DIR", default=None,
                       help="arm the auto-corpus policy against DIR (hits shrunk and dedup'd "
                            "by (kernel, kinds, mechanism-set) signature; e.g. tests/corpus)")
    sfarm.add_argument("--freeze", action="store_true",
                       help="let the farm write new checker-gated, provenance-stamped "
                            "artifacts into --corpus-dir")
    sfarm.add_argument("--health", nargs="?", const="default", default=None, metavar="SPEC",
                       help="arm health monitoring over the hunt fleet: health.jsonl and "
                            "alerts.jsonl into --out-dir")
    add_profile_argument(sfarm)
    add_device_arguments(sfarm)
    add_config_flags(sfarm)

    sshrink = ssub.add_parser("shrink", help="minimize a search hit to a repro artifact")
    sshrink.add_argument("--hit", metavar="FILE", required=True,
                         help="hit file from `scenario search --out`")
    sshrink.add_argument("--out", metavar="FILE", required=True, help="repro artifact path")
    sshrink.add_argument("--halving-rounds", type=int, default=3)
    sshrink.add_argument("--context", type=int, default=30)
    add_device_arguments(sshrink)
    return {"run": srun, "search": ssearch, "farm": sfarm, "shrink": sshrink}


def scenario(parsers: dict, args) -> int:
    """The `scenario` subcommands (`parsers` from add_scenario_arguments)."""
    ap = parsers[args.scmd]
    select_device(ap, args)
    return {"run": _scenario_run, "search": _scenario_search, "farm": _scenario_farm,
            "shrink": _scenario_shrink}[args.scmd](ap, args)


def _scenario_run(ap: argparse.ArgumentParser, args) -> int:
    """`scenario run`: a fleet under a nemesis program; prints the fleet
    summary with the program's shape, the wall time and the device."""
    from raft_sim_tpu_torch.scenario import program as program_mod

    dev = device_mod.resolve(args.device)
    if args.resume:
        conflicting = [f.name for f in dataclasses.fields(RaftConfig)
                       if getattr(args, f.name) is not None]
        conflicting += [flag for flag in ("preset", "scenario", "batch", "seed")
                        if getattr(args, flag) is not None]
        if conflicting:
            ap.error(f"--resume is exclusive with config/scenario flags: {', '.join(conflicting)}")
        cfg, state, keys, metrics, seed, scen = checkpoint.load(args.resume, dev)
        if scen is None:
            ap.error(f"{args.resume!r} is a plain checkpoint (no scenario); resume it with "
                     "`run --resume`")
        prog = program_mod.from_dict(scen, cfg)
    else:
        if not args.scenario:
            ap.error("scenario run needs --scenario FILE (or --resume)")
        cfg, batch = build_config(args)
        try:
            prog = program_mod.load(args.scenario, cfg)
        except ValueError as ex:
            ap.error(f"--scenario {args.scenario}: {ex}")
        seed = args.seed if args.seed is not None else 0
        state, keys = scan.seed_fleet(cfg, seed, batch, dev)
        metrics = scan.init_metrics_batch(batch, dev)
    batch = state.role.shape[0]

    def cb(done, _state, m):
        if args.progress:
            print(f"  {done}/{args.ticks} ticks, violations={int(m.violations.sum())}",
                  file=sys.stderr)
        return False

    t0 = time.perf_counter()
    state, m = run_scenario(cfg, prog, args.ticks, state, keys, chunk=args.chunk, callback=cb)
    metrics = chunked.merge_metrics(metrics, m)
    out = summarize(metrics)._asdict()  # copies to the host: waits for the device
    dt = time.perf_counter() - t0
    out.update(scenario=prog.name, segments=prog.n_segments, seg_len=prog.seg_len, wall_s=dt,
               cluster_ticks_per_s=batch * args.ticks / dt, device=_device_name(dev))
    print(json.dumps(out))
    if args.save:
        # exact=True carries the integer genome leaves: a resumed run draws
        # from the identical thresholds, not a rounding of them.
        checkpoint.save(args.save, cfg, state, keys, metrics, seed=seed,
                        scenario=program_mod.to_dict(prog, exact=True))
    return 0


def _scenario_search(ap: argparse.ArgumentParser, args) -> int:
    """`scenario search`: the cross-entropy hunt; prints the result JSON, and
    with --out writes a replayable hit file for `scenario shrink`."""
    from raft_sim_tpu_torch.scenario import search as search_mod

    cfg, _ = build_config(args)
    cfg = _mutant(ap, args.mutant, cfg)
    spec = search_mod.SearchSpec(
        generations=args.generations, population=args.population, ticks=args.ticks,
        window=args.window, elite_frac=args.elite_frac,
        seed=args.seed if args.seed is not None else 0, fitness=args.fitness,
        proposal=args.proposal, trace_depth=args.trace_depth,
    )
    try:
        with profile_ctx(args.profile, args.device):
            res = search_mod.search(cfg, spec, device=args.device)
    except ValueError as ex:
        ap.error(str(ex))
    doc = {"found": res.hit is not None, "hit": res.hit, "generations": res.generations,
           "spec": res.spec, "mutant": args.mutant}
    if res.hit is not None and args.out:
        with open(args.out, "w") as f:
            json.dump({"config": nondefault_fields(cfg), "mutant": args.mutant, **res.hit}, f,
                      indent=1)
            f.write("\n")
        doc["hit_file"] = args.out
    print(json.dumps(doc))
    return 0


def _scenario_farm(ap: argparse.ArgumentParser, args) -> int:
    """`scenario farm`: the fuzzing farm (farm/core.py); prints its summary
    line, ending in a frozen hit or a pinned negative result."""
    from raft_sim_tpu_torch.farm import FarmSpec, parse_portfolio, run_farm

    cfg, _ = build_config(args)
    cfg = _mutant(ap, args.mutant, cfg)
    mesh = None
    if args.mesh is not None:
        try:
            mesh = _device_mesh(args.device, args.mesh)
        except ValueError as ex:
            ap.error(str(ex))
    try:
        spec = FarmSpec(
            portfolio=parse_portfolio(args.portfolio), budget_gens=args.budget_gens,
            # Under --mesh the population scales with the device count:
            # --population is the per-device share of the fleet.
            population=args.population * (mesh.size if mesh else 1), ticks=args.ticks,
            window=args.window,
            elite_frac=args.elite_frac, seed=args.seed if args.seed is not None else 0,
            trace_depth=args.trace_depth, guided=not args.no_guided, stop_on=args.stop_on,
        )
        with profile_ctx(args.profile, args.device):
            res = run_farm(cfg, spec, mutant=args.mutant, out_dir=args.out_dir,
                           corpus_dir=args.corpus_dir, freeze=args.freeze, health=args.health,
                           mesh=mesh, device=args.device)
    except ValueError as ex:
        ap.error(str(ex))
    print(json.dumps({
        "found": bool(res.hits),
        "hits": res.manifest["hits"],
        "frozen": res.manifest["frozen"],
        "dedup_rejected": res.dedup_rejected,
        "negative": res.negative,
        "generations_run": res.manifest["generations_run"],
        "evaluations": res.manifest["evaluations"],
        "cov_bits_total": res.manifest["cov_bits_total"],
        "manifest_hash": res.manifest["manifest_hash"],
        "out_dir": args.out_dir,
    }))
    return 0


def _scenario_shrink(ap: argparse.ArgumentParser, args) -> int:
    """`scenario shrink`: minimize a hit file to a repro artifact."""
    from raft_sim_tpu_torch.scenario import shrink as shrink_mod

    with open(args.hit) as f:
        hit = json.load(f)
    cfg = _mutant(ap, hit.get("mutant"), RaftConfig(**hit.get("config", {})))
    try:
        art = shrink_mod.shrink(cfg, hit, mutant=hit.get("mutant"),
                                halving_rounds=args.halving_rounds, context=args.context,
                                device=args.device)
    except ValueError as ex:
        ap.error(str(ex))
    shrink_mod.save_artifact(args.out, art)
    print(json.dumps({"artifact": args.out, "tick": art["tick"], "kinds": art["kinds"],
                      "removed": art["removed"], "segments": art["segments"]}))
    return 0
