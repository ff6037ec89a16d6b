"""Multi-device execution: shard the independent-cluster batch axis over a
mesh of devices (the port of raft_sim_tpu/parallel/mesh.py).

Clusters are independent, so no tensor crosses shards inside a tick: each
shard inits and runs its contiguous slice of the batch on its own device,
through the same tick as the unsharded path (`scan.tick_batch_minor`; on the
card every tick of every shard is one launch of the Hopper tick kernel,
`kernels/tick_engine.step_cuda`). The shards' launches are interleaved tick
by tick from one host thread, so the work of several cards overlaps. The
only cross-device movement is the gather of the results into cluster order
and the metric gather of `summarize`.

Per-cluster keys are split BEFORE sharding, so a run is bit-identical for
the same (seed, batch) at any shard count -- the property the tests pin
against the unsharded `scan.simulate` and the JAX package's sharded run.

A mesh is a list of torch devices (`Mesh`, `make_mesh`). A device may appear
more than once: the CPU tests run 8 shards on the one `cpu` device, and one
card can carry 4 shards. Across processes, `init_distributed` joins a gloo
group (the control plane and the metric gather; the JAX package's DCN leg):
every process then runs the shards of its own contiguous slice of the global
batch, and `gather_metrics`/`summarize` hand every process the whole fleet's
metrics. A one-card machine proves the partition, the key split and the
multi-process control plane; it cannot prove NCCL or copies between cards.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import scan, telemetry
from raft_sim_tpu_torch.summary import FleetSummary  # noqa: F401 -- re-exported (parallel/__init__)
from raft_sim_tpu_torch.summary import summarize as _summarize
from raft_sim_tpu_torch.types import init_rows
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig

AXIS = "clusters"


class Mesh:
    """Devices over named axes (the JAX `Mesh`): `devices` an object array
    of torch.device shaped by `axis_names`, this process's share of the
    global mesh. Under a process group the global mesh is `n_processes`
    copies of it, and this process is `process_index`."""

    def __init__(self, devices, axis_names: tuple[str, ...], n_processes: int = 1,
                 process_index: int = 0):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        self.n_processes = n_processes
        self.process_index = process_index

    @property
    def shape(self) -> dict:
        """Axis name -> length, this process's share."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        """Shards over the whole (global) mesh."""
        return self.devices.size * self.n_processes

    def flat(self) -> list:
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.flat()]}, axes={self.axis_names}, "
                f"processes={self.n_processes})")


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str = "gloo") -> int:
    """Multi-process bootstrap: join this process to the group (the JAX
    `jax.distributed.initialize`). The address ("host:port") and counts
    fall back to the standard torch.distributed environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK: `env://`). gloo carries the control
    plane and the metric gather only -- never tick traffic. Afterwards
    `make_mesh` builds this process's share of the global mesh,
    `simulate_sharded` runs this process's slice of the global batch, and
    `summarize`/`gather_metrics` gather the whole fleet's metrics on every
    process. Returns this process's index."""
    import torch.distributed as dist

    if coordinator_address is not None:
        host, _, port = coordinator_address.rpartition(":")
        init_method = f"tcp://{host}:{port}"
    else:
        init_method = "env://"
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return dist.get_rank()


def _group() -> tuple[int, int]:
    """(processes, this process's index) of the torch.distributed group, or
    (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_devices(devices=None) -> list[torch.device]:
    """`devices` resolved to torch devices; by default every card
    torch.cuda.device_count() reports (none: a ValueError naming the fix)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise ValueError("no CUDA device for the default mesh; pass devices= (e.g. "
                             "[\"cpu\"] * 8 for 8 shards on the CPU)")
        devices = [torch.device("cuda", i) for i in range(count)]
    return [device_mod.resolve(d) for d in devices]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over a device list; its one axis shards the batch of
    independent clusters. `devices` defaults to every card
    torch.cuda.device_count() reports; an explicit list may name a device
    more than once (several shards on one device). `n_devices` takes the
    first n of them."""
    devices = mesh_devices(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    procs, index = _group()
    return Mesh(devices, (AXIS,), n_processes=procs, process_index=index)


def dealt_mesh(n: int, device) -> Mesh:
    """A mesh of n shards on `device`'s kind: on the card, dealt over the
    cards in turn (the first n cards where there are n), so shards beyond
    the card count share a card; on the CPU, n shards on the one device."""
    dev = device_mod.resolve(device)
    cards = mesh_devices() if dev.type == "cuda" else [dev]
    return make_mesh(devices=[cards[i % len(cards)] for i in range(n)])


def check_batch(batch: int, mesh: Mesh) -> None:
    if batch % mesh.size:
        raise ValueError(f"batch {batch} must divide over {mesh.size} devices")


def shard_rows(batch: int, mesh: Mesh) -> list[tuple[torch.device, int, int]]:
    """(device, lo, hi) of each of this process's shards, in cluster order:
    contiguous equal slices of the global batch."""
    check_batch(batch, mesh)
    per = batch // mesh.size
    first = mesh.process_index * mesh.devices.size
    return [(dev, (first + i) * per, (first + i + 1) * per) for i, dev in enumerate(mesh.flat())]


def take(tree, lo: int, hi: int, dim: int = 0, device=None):
    """Rows [lo, hi) of `dim` of every leaf, contiguous, on `device`."""
    def cut(x):
        x = x.narrow(dim % x.dim(), lo, hi - lo)
        return (x if device is None else x.to(device)).contiguous()

    return raft_batched._map(cut, tree)


def concat(trees: list, dim: int = 0, device=None):
    """Leaf-wise concatenation of same-structured trees along `dim`, on
    `device` (default: the first tree's). One tree with no `device` comes
    back as it is."""
    first = trees[0]
    if len(trees) == 1 and device is None:
        return first
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(concat([getattr(t, f) for t in trees], dim, device)
                             for f in first._fields))
    dev = device if device is not None else first.device
    return torch.cat([t.to(dev) for t in trees], dim % first.dim())


def simulate_sharded(cfg: RaftConfig, seed: int, batch: int, n_ticks: int, mesh: Mesh):
    """Batched simulation sharded over `mesh`: each shard inits its slice of
    the clusters on its device and runs it, the launches interleaved tick
    by tick. Returns (final_state, RunMetrics) of this process's clusters
    (the whole batch in one process), [B, ...]-leading, gathered in cluster
    order onto the mesh's first device. Bit-identical to `scan.simulate`
    for the same (cfg, seed, batch, n_ticks): the per-cluster keys are
    split before sharding."""
    rows = shard_rows(batch, mesh)
    k_init, k_run = scan.fleet_keys(seed, batch, rows[0][0])
    outs = scan.interleave([
        scan.minor_ticks(cfg, raft_batched.to_batch_minor(init_rows(cfg, k_init[lo:hi].to(dev))),
                         k_run[lo:hi].to(dev), n_ticks, 0)
        for dev, lo, hi in rows])
    final = concat([raft_batched.from_batch_minor(s) for s, _ in outs])
    metrics = concat([raft_batched.from_batch_minor(m) for _, m in outs])
    return final, metrics


def simulate_windowed_sharded(cfg: RaftConfig, seed: int, batch: int, n_ticks: int, window: int,
                              mesh: Mesh, genome=None, seg_len: int = 1, trace=None):
    """`telemetry.simulate_windowed` sharded over the cluster axis of
    `mesh`: the farm's per-generation evaluator (farm/core.py). Returns
    (final_state, metrics, records, None), plus (trace windows, trace
    persist) when `trace` (a TraceSpec) is given -- the recorder slot is
    always None (the farm never arms a ring). Every leaf comes back in
    cluster order on the mesh's first device: state, metrics and records
    [B, ...]-leading, the trace legs batch-minor. `genome` rows ([B, S]
    leaves) are cut per shard. Bit-identical to the unsharded call at any
    shard count: the keys are split before sharding, so a hunt's hits,
    manifest hash and artifacts never depend on the mesh."""
    rows = shard_rows(batch, mesh)
    k_init, k_run = scan.fleet_keys(seed, batch, rows[0][0])
    outs = scan.interleave([telemetry.minor_telemetry_ticks(
        cfg, raft_batched.to_batch_minor(init_rows(cfg, k_init[lo:hi].to(dev))),
        k_run[lo:hi].to(dev), n_ticks, window, 0,
        genome=None if genome is None else take(genome, lo, hi, device=dev), seg_len=seg_len,
        trace_spec=trace) for dev, lo, hi in rows])
    final = concat([raft_batched.from_batch_minor(o[0]) for o in outs])
    metrics = concat([raft_batched.from_batch_minor(o[1]) for o in outs])
    records = concat([o[2] for o in outs])
    if trace is None:
        return final, metrics, records, None
    traws = concat([o[4] for o in outs], dim=-1)
    persist = concat([o[5] for o in outs], dim=-1)
    return final, metrics, records, None, traws, persist


def gather_metrics(metrics: scan.RunMetrics) -> scan.RunMetrics:
    """Make a batched RunMetrics the whole fleet's on every process. In one
    process it passes through untouched; under a process group every leaf
    of each process's slice is all-gathered over gloo (every process must
    call this) and comes back on the host in cluster order. The metrics are
    a few int32s a cluster, so the traffic is negligible."""
    procs, _ = _group()
    if procs == 1:
        return metrics
    import torch.distributed as dist

    def gather(x):
        x = x.detach().cpu().contiguous()
        parts = [torch.empty_like(x) for _ in range(procs)]
        dist.all_gather(parts, x)
        return torch.cat(parts, 0)

    return raft_batched._map(gather, metrics)


def summarize(metrics: scan.RunMetrics) -> FleetSummary:
    """Fleet rollup of a batched RunMetrics (summary.summarize), gathered
    first when the metrics are one process's slice of a larger fleet."""
    return _summarize(gather_metrics(metrics))
