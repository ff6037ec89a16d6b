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
what the apply log and the progress line ask for.

`add_run_arguments` / `run` are the CLI's `run` subcommand: --preset, one
flag per RaftConfig field (`add_config_flags`, `build_config`), --batch,
--ticks, --seed, --chunk, --save, --resume (exclusive with every flag that
sets the experiment), --apply-log, --apply-cluster, --telemetry-dir,
--telemetry-window, --telemetry-ring, the protocol trace plane (--trace,
--trace-depth, --trace-freeze, --trace-trigger: `Session.attach_trace`;
--trace-ticks, --trace-events, --trace-cluster: `Session.trace`), --mutant
(a TEST-ONLY weakened tick, scenario/mutation.py), --progress, --device and
--backend (`select_device`: the JAX driver's backend names mapped to a torch
device).
`add_serve_arguments` / `serve` are the `serve` subcommand: the standing
fleet of serve/loop.py fed from a JSONL command source.
`add_scenario_arguments` / `scenario` are the `scenario` subcommands: `run`
(a fleet under a JSON nemesis program, `run_scenario`; its checkpoints carry
the program), `search` (the violation hunt, scenario/search.py) and
`shrink` (a hit to a repro artifact, scenario/shrink.py); `search` takes
--fitness coverage, --proposal coverage-guided and --trace-depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import chunked, scan, telemetry
from raft_sim_tpu_torch.sim import trace as trace_view
from raft_sim_tpu_torch.summary import summarize
from raft_sim_tpu_torch.utils import checkpoint
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.apply_log import ApplyLogWriter
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig


class Session:
    """One experiment and the verbs over it: run, reset, summary, save,
    restore, offer, offer_read, the apply-log export and the telemetry
    sink."""

    def __init__(self, cfg: RaftConfig, batch: int = 1, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seed = seed
        self.device = device_mod.resolve(device)
        self.apply_writer = None
        self.telemetry = None  # TelemetrySink (attach_telemetry)
        self._tel_rec = None  # the flight recorder's carry (batch-minor)
        self._deltas = None  # serve.deltas.DeltaStream: offer()'s ack watcher
        self._trace_spec = None  # trace.TraceSpec (attach_trace)
        self._trace_persist = None  # the trace plane's cross-chunk carry (batch-minor)
        self._trace_trigger = None  # the flight recorder's event-kind trigger
        self.reset()

    def reset(self) -> None:
        """Back to tick 0 with the same seed: the same key derivation as
        `scan.simulate`, so a Session's run equals `simulate` leaf for leaf.
        An attached apply log or telemetry sink starts over (files
        truncated)."""
        self.state, self.keys = scan.seed_fleet(self.cfg, self.seed, self.batch, self.device)
        self.metrics = scan.init_metrics_batch(self.batch, self.device)
        self.now = 0
        self._deltas = None
        if self.apply_writer is not None:
            self.attach_apply_log(self.apply_writer.directory, self.apply_writer.cluster)
        if self.telemetry is not None:
            self.attach_telemetry(self.telemetry.directory, window=self.telemetry.window,
                                  ring=self.telemetry.ring)
        # The re-attach truncated the trace files: re-arming rewrites the meta
        # and starts the cross-window carry over.
        self._trace_persist = None
        if self._trace_spec is not None and self.telemetry is not None:
            self.telemetry.write_trace_meta(self._trace_spec)

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
        self._trace_persist = None
        self.telemetry.write_trace_meta(self._trace_spec)

    def run(self, n_ticks: int, chunk: int = 4096, progress: bool = False) -> None:
        """Step the fleet `n_ticks` in chunks of `chunk` ticks through the
        tick kernel (the plain tick on the CPU), folding the metrics; with a
        telemetry sink attached, each chunk's windows stream to it, and with
        a trace armed its trace windows too."""

        def after_chunk(done, state, metrics):
            if self.apply_writer is not None:
                self.apply_writer.update(state)
            if progress:
                v = int(metrics.violations.sum())
                print(f"  {done}/{n_ticks} ticks, violations={v}", file=sys.stderr)
            return False

        if self.telemetry is not None:
            def cb_t(done, state, metrics, records):
                self.telemetry.append_windows(records)
                return after_chunk(done, state, metrics)

            out = telemetry.run_chunked_telemetry(
                self.cfg, self.state, self.keys, n_ticks, window=self.telemetry.window,
                recorder=self._tel_rec, chunk=chunk, callback=cb_t, now=self.now,
                trace_spec=self._trace_spec, trace_persist=self._trace_persist,
                trigger_kind=self._trace_trigger,
                trace_callback=lambda done, traws: self.telemetry.append_trace(traws))
            self.state, m, self._tel_rec = out[:3]
            if self._trace_spec is not None:
                self._trace_persist = out[3]
        else:
            self.state, m = chunked.run_chunked(
                self.cfg, self.state, self.keys, n_ticks, chunk=chunk, callback=after_chunk,
                now=self.now)
        self.metrics = chunked.merge_metrics(self.metrics, m)
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
        if self._tel_rec is not None:
            frozen = np.flatnonzero(self._tel_rec.frozen.cpu().numpy())
            frozen_total = int(frozen.size)
            for cluster in frozen[:max_flights]:
                ticks, infos = telemetry.export_cluster(self._tel_rec, int(cluster))
                self.telemetry.write_flight(int(cluster), ticks, infos)
                flights.append(int(cluster))
            if frozen.size > max_flights:
                print(f"telemetry: {frozen.size} frozen clusters, exported first {max_flights} "
                      f"flight recordings ({frozen.size - max_flights} not exported -- raise "
                      "max_flights to keep them)", file=sys.stderr)
        summary = self.summary()
        summary["flights_frozen"] = frozen_total
        summary["flights_exported"] = len(flights)
        if self._trace_persist is not None:
            from raft_sim_tpu_torch.trace.ring import cov_popcount

            tp = self._trace_persist
            summary["trace"] = {
                "events_emitted": int(tp.total.to(torch.int64).sum()),
                "frozen_clusters": int(tp.frozen.sum()),
                "cov_bits_max": int(cov_popcount(tp.cov).max()),
            }
        path = self.telemetry.write_summary(summary)
        return {"flights": flights, "flights_frozen": frozen_total,
                "flights_exported": len(flights), "summary": path}

    def _offer_step(self, client_cmd=None, read_cmd=None):
        """One tick through the shared tick body with an offer override;
        returns its StepInfo."""
        s, m, info = scan.tick_batch_minor(
            self.cfg, raft_batched.to_batch_minor(self.state), self.keys,
            raft_batched.to_batch_minor(self.metrics), self.now,
            client_cmd=client_cmd, read_cmd=read_cmd)
        self.state = raft_batched.from_batch_minor(s)
        self.metrics = raft_batched.from_batch_minor(m)
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
        """The fleet rollup (summary.summarize) as a dict."""
        return summarize(self.metrics)._asdict()

    def save(self, path: str) -> str:
        return checkpoint.save(path, self.cfg, self.state, self.keys, self.metrics, seed=self.seed)

    @classmethod
    def restore(cls, path: str, device="cuda") -> "Session":
        """Resume exactly: state, keys, metrics and the seed come back, so
        runs after the restore equal an uninterrupted session's and reset()
        rebuilds the same experiment. A checkpoint that carries a scenario
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
        self.apply_writer = None
        self.telemetry = None
        self._tel_rec = None
        self._deltas = None
        self._trace_spec = None
        self._trace_persist = None
        self._trace_trigger = None
        self.state = state
        self.keys = keys
        self.metrics = metrics
        self.now = int(state.now.reshape(-1)[0]) if self.batch else 0
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
    add_device_arguments(p)
    add_config_flags(p)


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
        sess = Session(cfg, batch=batch, seed=args.seed if args.seed is not None else 0,
                       device=args.device)
    if args.trace_ticks or args.trace_events:
        if args.save or args.apply_log or args.telemetry_dir:
            ap.error("--save/--apply-log/--telemetry-dir have no effect with --trace-ticks/"
                     "--trace-events (tracing does not advance the session)")
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
    t0 = time.perf_counter()
    sess.run(args.ticks, chunk=args.chunk, progress=args.progress)
    out = sess.summary()  # copies to the host: waits for the device
    dt = time.perf_counter() - t0
    out["wall_s"] = dt
    out["cluster_ticks_per_s"] = sess.batch * args.ticks / dt
    out["device"] = _device_name(sess.device)
    print(json.dumps(out))
    if args.telemetry_dir:
        fin = sess.finalize_telemetry()
        if fin["flights"]:
            print(f"telemetry: flight recordings exported for clusters {fin['flights']} "
                  f"under {args.telemetry_dir}", file=sys.stderr)
    if args.save:
        sess.save(args.save)
    return 0


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
    try:
        sess = ServeSession(cfg, batch=batch, seed=seed, chunk=args.chunk, window=args.window,
                            delta_depth=args.delta_depth, sink=sink, warmup_ticks=args.warmup,
                            tenants=tenants, device=dev)
    except ValueError as ex:
        ap.error(str(ex))
    source = None if tenants is not None else CommandSource(jsonl_commands(args.source))

    def progress(st):
        if args.progress:
            print(f"  chunk {st['chunks']}: {st['ticks']} ticks, {st['deltas_exported']} deltas, "
                  f"{st['reads_served']} reads, violations={st['violations']}", file=sys.stderr)

    try:
        stats = sess.serve(source, chunks=args.chunks, drain_chunks=args.drain_chunks,
                           progress=progress)
    except ValueError as ex:
        ap.error(str(ex))
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


def _nondefault_config(cfg: RaftConfig) -> dict:
    """cfg's non-default fields: the portable config encoding of hit files
    and repro artifacts (RaftConfig(**this) rebuilds it)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(RaftConfig)
            if getattr(cfg, f.name) != f.default}


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
    """The `scenario` subcommands' parsers, by name (`run`, `search`,
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
    add_device_arguments(ssearch)
    add_config_flags(ssearch)

    sshrink = ssub.add_parser("shrink", help="minimize a search hit to a repro artifact")
    sshrink.add_argument("--hit", metavar="FILE", required=True,
                         help="hit file from `scenario search --out`")
    sshrink.add_argument("--out", metavar="FILE", required=True, help="repro artifact path")
    sshrink.add_argument("--halving-rounds", type=int, default=3)
    sshrink.add_argument("--context", type=int, default=30)
    add_device_arguments(sshrink)
    return {"run": srun, "search": ssearch, "shrink": sshrink}


def scenario(parsers: dict, args) -> int:
    """The `scenario` subcommands (`parsers` from add_scenario_arguments)."""
    ap = parsers[args.scmd]
    select_device(ap, args)
    return {"run": _scenario_run, "search": _scenario_search,
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
        res = search_mod.search(cfg, spec, device=args.device)
    except ValueError as ex:
        ap.error(str(ex))
    doc = {"found": res.hit is not None, "hit": res.hit, "generations": res.generations,
           "spec": res.spec, "mutant": args.mutant}
    if res.hit is not None and args.out:
        with open(args.out, "w") as f:
            json.dump({"config": _nondefault_config(cfg), "mutant": args.mutant, **res.hit}, f,
                      indent=1)
            f.write("\n")
        doc["hit_file"] = args.out
    print(json.dumps(doc))
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
