"""Host driver: `Session` and the `run` subcommand (the port of the plain
path of raft_sim_tpu/driver.py).

`Session` holds one experiment -- a config, a fleet of `batch` clusters from
a seed, its run keys and accumulated metrics -- and steps it in chunks
(sim/chunked.py), optionally exporting one cluster's committed values
(utils/apply_log.py) between chunks, and saving or restoring the whole of it
(utils/checkpoint.py, the JAX package's file format):

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
sets the experiment), --apply-log, --apply-cluster, --progress and --device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from raft_sim_tpu_torch.sim import chunked, scan
from raft_sim_tpu_torch.summary import summarize
from raft_sim_tpu_torch.utils import checkpoint
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.apply_log import ApplyLogWriter
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig


class Session:
    """One experiment and the verbs over it: run, reset, summary, save,
    restore, and the apply-log export."""

    def __init__(self, cfg: RaftConfig, batch: int = 1, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seed = seed
        self.device = device_mod.resolve(device)
        self.apply_writer = None
        self.reset()

    def reset(self) -> None:
        """Back to tick 0 with the same seed: the same key derivation as
        `scan.simulate`, so a Session's run equals `simulate` leaf for leaf.
        An attached apply log starts over (files truncated)."""
        self.state, self.keys = scan.seed_fleet(self.cfg, self.seed, self.batch, self.device)
        self.metrics = scan.init_metrics_batch(self.batch, self.device)
        self.now = 0
        if self.apply_writer is not None:
            self.attach_apply_log(self.apply_writer.directory, self.apply_writer.cluster)

    def attach_apply_log(self, directory: str, cluster: int = 0) -> None:
        """Stream cluster `cluster`'s committed values to
        `directory`/node_<i>.log at every chunk boundary of run(). Keep chunks
        short enough that commit moves less than CAP - compact_margin a
        chunk, or compacted spans show as `# snapshot gap` lines."""
        if not 0 <= cluster < self.batch:
            raise IndexError(f"cluster {cluster} out of range for batch {self.batch}")
        self.apply_writer = ApplyLogWriter(directory, self.cfg, cluster)
        self.apply_writer.update(self.state)  # anything already committed

    def run(self, n_ticks: int, chunk: int = 4096, progress: bool = False) -> None:
        """Step the fleet `n_ticks` in chunks of `chunk` ticks through the
        tick kernel (the plain tick on the CPU), folding the metrics."""

        def cb(done, state, metrics):
            if self.apply_writer is not None:
                self.apply_writer.update(state)
            if progress:
                v = int(metrics.violations.sum())
                print(f"  {done}/{n_ticks} ticks, violations={v}", file=sys.stderr)
            return False

        self.state, m = chunked.run_chunked(
            self.cfg, self.state, self.keys, n_ticks, chunk=chunk, callback=cb, now=self.now
        )
        self.metrics = chunked.merge_metrics(self.metrics, m)
        self.now += n_ticks

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
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_config_flags(p)


def run(ap: argparse.ArgumentParser, args) -> int:
    """The `run` subcommand: build or restore a Session, run it, print the
    fleet summary with the wall time and the device as one JSON line, and
    save a checkpoint if asked."""
    if args.resume:
        # A checkpoint IS the experiment: rerunning it under other flags
        # would mislabel the results.
        conflicting = [
            f.name for f in dataclasses.fields(RaftConfig) if getattr(args, f.name) is not None
        ]
        conflicting += [flag for flag in ("preset", "batch", "seed")
                        if getattr(args, flag) is not None]
        if conflicting:
            ap.error(f"--resume is exclusive with config flags: {', '.join(conflicting)}")
        sess = Session.restore(args.resume, device=args.device)
    else:
        cfg, batch = build_config(args)
        sess = Session(cfg, batch=batch, seed=args.seed if args.seed is not None else 0,
                       device=args.device)
    if args.apply_log:
        try:
            sess.attach_apply_log(args.apply_log, cluster=args.apply_cluster)
        except IndexError as ex:
            ap.error(str(ex))
    t0 = time.perf_counter()
    sess.run(args.ticks, chunk=args.chunk, progress=args.progress)
    out = sess.summary()  # copies to the host: waits for the device
    dt = time.perf_counter() - t0
    out["wall_s"] = dt
    out["cluster_ticks_per_s"] = sess.batch * args.ticks / dt
    dev = sess.device
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(out))
    if args.save:
        sess.save(args.save)
    return 0
