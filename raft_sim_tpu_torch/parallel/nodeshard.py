"""Node-axis sharding: one giant-N cluster partitioned row-wise across shards
(the port of raft_sim_tpu/parallel/nodeshard.py).

`parallel/mesh.py` shards the independent-cluster axis, so a whole cluster
must fit one device. This module adds the second mesh axis: the node rows of
every per-node leg (the `[N, N]` bookkeeping planes, the `[N, CAP]` logs,
the `[N]` headers and the writer-major mailbox) are partitioned over a 2-D
(clusters x nodes) mesh, each row on the shard of the node that writes it
(state: the node itself; mailbox: the sender of a request leg, the
responder of a response leg). Second node axes (the peer axis) stay whole,
padded to `n_pad`.

- The node axis pads to `n_pad = shards x ceil(N / shards)`. Pad rows are
  nodes dead every tick (`alive` False, delivery rows zero), so they freeze
  at their boot values; the tick masks the few reductions a pad row could
  skew (`pad_self`, the min-commit sentinel in models/raft_batched.py). The
  packed word count must not change with the padding (`check_shardable`).
- The tick's only collectives, through the shards' exchange
  (parallel/comm.py), are the JAX package's: ONE gather of the outbound
  mailbox a tick, the folds of the per-cluster `[B]` reductions, and -- only
  under `check_invariants` -- one `[n_pad, B]` leaders-by-term gather. The
  `[N, N]` bookkeeping planes never cross shards.
- Inputs are drawn at the real N on every shard from the same per-cluster
  keys (`faults.make_inputs` is pure in (cfg, keys, now)), then padded: no
  exchange, and trajectories are bit-identical to the unsharded tick at any
  shard count.

This path runs the plain PyTorch tick (`raft_batched.step_b` with a
`NodeShardCtx`) on every shard, on the card too, as the JAX package runs
its plain `step_b` under `shard_map` here and never `step_pallas`: the
Hopper tick kernel holds a whole cluster in one thread block and has no
collective inside its body. The shards run SPMD, one host thread each,
taking turns between collectives (`comm.run_spmd`, `comm.Exchange`).

Unsupported (the JAX v1 surface): the reconfiguration plane, leader
transfer, ReadIndex and lease reads, durable storage, the redirect client
and log matching; `check_shardable` names the offending gate.
`compact_planes` configs run the sharded carry dense (`compact_twin`): the
same trajectory.
"""

from __future__ import annotations

import torch

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.models.raft_batched import NodeShardCtx
from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.parallel import comm
from raft_sim_tpu_torch.parallel import mesh as mesh_mod
from raft_sim_tpu_torch.sim import scan, telemetry
from raft_sim_tpu_torch.types import (
    FOLLOWER,
    NIL,
    ClusterState,
    Mailbox,
    StepInputs,
    compact_twin,
    init_rows,
)
from raft_sim_tpu_torch.utils.config import RaftConfig

AXIS = mesh_mod.AXIS  # "clusters": the batch axis, as in parallel/mesh.py
NODE_AXIS = "nodes"

# Per-field pad rule: (node axes of the UNBATCHED leaf, pad fill). The fills
# are types.boot_state's (a pad row is a node frozen at boot); a callable
# takes the config.
_STATE_PAD = {
    "role": ((0,), FOLLOWER),
    "term": ((0,), 1),
    "voted_for": ((0,), NIL),
    "leader_id": ((0,), NIL),
    "votes": ((0,), 0),
    "next_index": ((0, 1), 1),
    "match_index": ((0, 1), 0),
    "ack_age": ((0, 1), lambda cfg: cfg.ack_age_sat),
    "commit_index": ((0,), 0),
    "commit_chk": ((0,), 0),
    "log_base": ((0,), 0),
    "base_term": ((0,), 0),
    "base_chk": ((0,), 0),
    "log_term": ((0,), 0),
    "log_val": ((0,), 0),
    "log_tick": ((0,), 0),
    "log_len": ((0,), 0),
    "dur_len": ((0,), 0),
    "dur_term": ((0,), 1),
    "dur_vote": ((0,), NIL),
    "clock": ((0,), 0),
    "deadline": ((0,), 0),  # expiry is gated on alive: any value is inert
    "heard_clock": ((0,), lambda cfg: -cfg.election_min_ticks),
    "member_old": ((0,), 0),
    "member_new": ((0,), 0),
    "cfg_epoch": ((0,), 0),
    "cfg_pend": ((0,), 0),
    "log_cfg": ((0,), 0),
    "base_mold": ((0,), 0),
    "base_pend": ((0,), 0),
    "base_epoch": ((0,), 0),
    "xfer_to": ((0,), NIL),
    "read_idx": ((0,), 0),
    "read_tick": ((0,), 0),
    "read_acks": ((0,), 0),
    "read_fr": ((0,), 0),
    "client_pend": ((), 0),
    "client_dst": ((), 0),
    "client_tick": ((), 0),
    "lat_frontier": ((), 0),
    "now": ((), 0),
}

_MAILBOX_PAD = {
    "req_type": ((0,), 0),
    "req_term": ((0,), 0),
    "req_commit": ((0,), 0),
    "req_last_index": ((0,), 0),
    "req_last_term": ((0,), 0),
    "ent_start": ((0,), 0),
    "ent_prev_term": ((0,), 0),
    "ent_count": ((0,), 0),
    "ent_term": ((0,), 0),
    "ent_val": ((0,), 0),
    "ent_tick": ((0,), 0),
    "req_base": ((0,), 0),
    "req_base_term": ((0,), 0),
    "req_base_chk": ((0,), 0),
    "xfer_tgt": ((0,), NIL),
    "req_disrupt": ((0,), 0),
    "ent_cfg": ((0,), 0),
    "req_base_mold": ((0,), 0),
    "req_base_pend": ((0,), 0),
    "req_base_epoch": ((0,), 0),
    "req_off": ((0, 1), 0),
    "resp_kind": ((0, 1), 0),
    "pv_grant": ((0,), 0),
    "v_to": ((0,), NIL),
    "a_ok_to": ((0,), NIL),
    "a_match": ((0,), 0),
    "a_hint": ((0,), 0),
    "resp_term": ((0,), 0),
}

_INPUT_PAD = {
    "deliver_mask": ((0,), 0),
    "skew": ((0,), 0),
    "timeout_draw": ((0,), 0),
    "client_cmd": ((), 0),
    "client_target": ((), 0),
    "client_bounce": ((), 0),
    "alive": ((0,), False),
    "restarted": ((0,), False),
    "reconfig_cmd": ((), 0),
    "transfer_cmd": ((), 0),
    "read_cmd": ((), 0),
    "fsync_fire": ((0,), False),
    "torn_drop": ((0,), 0),
}

# A new state/mailbox/input leg without a pad rule would corrupt the sharded
# path; fail at import instead.
assert set(_STATE_PAD) | {"mailbox"} == set(ClusterState._fields)
assert set(_MAILBOX_PAD) == set(Mailbox._fields)
assert set(_INPUT_PAD) == set(StepInputs._fields)


def _pad_leaf(x: torch.Tensor, axes, fill, pad_n: int, lead: int) -> torch.Tensor:
    if not axes or not pad_n:
        return x
    shape = list(x.shape)
    for ax in axes:
        shape[ax + lead] += pad_n
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, d) for d in x.shape)] = x
    return out


def _pad_tree(cfg: RaftConfig, tree, table, pad_n: int, lead: int) -> dict:
    out = {}
    for f, (axes, fill) in table.items():
        fill_v = fill(cfg) if callable(fill) else fill
        out[f] = _pad_leaf(getattr(tree, f), axes, fill_v, pad_n, lead)
    return out


def pad_state(cfg: RaftConfig, state: ClusterState, n_pad: int, lead: int = 1) -> ClusterState:
    """Pad every node axis of a dense state (batch-leading when lead=1) from
    n_nodes to n_pad with the boot fills. The packed-word axes need no
    padding (`check_shardable`)."""
    pad_n = n_pad - cfg.n_nodes
    kw = _pad_tree(cfg, state, _STATE_PAD, pad_n, lead)
    kw["mailbox"] = Mailbox(**_pad_tree(cfg, state.mailbox, _MAILBOX_PAD, pad_n, lead))
    return ClusterState(**kw)


def pad_inputs(cfg: RaftConfig, inp: StepInputs, n_pad: int, lead: int = 1) -> StepInputs:
    """Pad the per-node input legs to n_pad: pad nodes are dead (alive
    False) with all-zero delivery rows. `lead` counts the axes before the
    node axis: 1 batch-leading, 0 batch-minor."""
    return StepInputs(**_pad_tree(cfg, inp, _INPUT_PAD, n_pad - cfg.n_nodes, lead))


def unshard_state(cfg: RaftConfig, state: ClusterState) -> ClusterState:
    """Padded writer-major sharded final state (batch-leading) -> the dense
    [B, N, ...] form `scan.simulate` returns: the node axes cut back to
    n_nodes and the two transposed mailbox legs reoriented."""
    n = cfg.n_nodes
    n_pad = state.role.shape[1]

    def cut(x, axes, lead=1):
        for ax in axes:
            x = x.narrow(ax + lead, 0, n)
        return x.contiguous()

    kw = {f: cut(getattr(state, f), axes) for f, (axes, _) in _STATE_PAD.items()}
    mkw = {f: cut(getattr(state.mailbox, f), axes) for f, (axes, _) in _MAILBOX_PAD.items()}
    # The sharded carry stores responder-major response planes; the dense
    # convention is receiver-major (raft_batched._gather_mailbox).
    mkw["resp_kind"] = cut(state.mailbox.resp_kind.transpose(1, 2), (0, 1))
    if cfg.pre_vote:
        pv = bitplane.unpack(state.mailbox.pv_grant, n_pad, axis=2)  # [B, voter, cand]
        mkw["pv_grant"] = bitplane.pack(cut(pv.transpose(1, 2), (0, 1)), axis=2)
    kw["mailbox"] = Mailbox(**mkw)
    return ClusterState(**kw)


def check_shardable(cfg: RaftConfig, n_shards: int) -> int:
    """Validate cfg against the node-sharded surface and return n_pad."""
    unsupported = [
        name
        for name, on in [
            ("reconfig", cfg.reconfig),
            ("leader_transfer", cfg.leader_transfer),
            ("read_index", cfg.read_index),
            ("read_lease", cfg.read_lease),
            ("durable_storage", cfg.durable_storage),
            ("client_redirect", cfg.client_redirect),
            ("check_log_matching", cfg.check_log_matching),
        ]
        if on
    ]
    if unsupported:
        raise ValueError(
            f"node sharding does not support {unsupported} (see the "
            "raft_sim_tpu_torch/parallel/nodeshard.py module docstring)"
        )
    n = cfg.n_nodes
    n_pad = n_shards * -(-n // n_shards)
    if bitplane.n_words(n_pad) != bitplane.n_words(n):
        raise ValueError(
            f"padding N={n} to {n_pad} over {n_shards} shards crosses a packed "
            "word boundary (n_words changes); use a shard count dividing 32"
        )
    return n_pad


def make_node_mesh(n_node_shards: int | None = None, n_cluster_shards: int = 1,
                   devices=None) -> mesh_mod.Mesh:
    """2-D (clusters, nodes) mesh: the batch over the first axis, node rows
    over the second. `devices` defaults to every card; an explicit list may
    repeat a device. Defaults to all of them on the node axis."""
    devices = mesh_mod.mesh_devices(devices)
    if n_node_shards is None:
        n_node_shards = len(devices) // n_cluster_shards
    need = n_cluster_shards * n_node_shards
    if need > len(devices):
        raise ValueError(
            f"mesh {n_cluster_shards}x{n_node_shards} needs {need} devices, "
            f"only {len(devices)} available"
        )
    grid = [devices[c * n_node_shards:(c + 1) * n_node_shards] for c in range(n_cluster_shards)]
    return mesh_mod.Mesh(grid, (AXIS, NODE_AXIS))


def _shard_rows(tree, table, lo: int, hi: int, lead: int = 1) -> dict:
    """Each leaf's rows [lo, hi) of its first node axis (leaves with no node
    axis whole)."""
    return {f: (getattr(tree, f).narrow(lead, lo, hi - lo) if axes else getattr(tree, f))
            for f, (axes, _) in table.items()}


def _local_state(state: ClusterState, lo: int, hi: int) -> ClusterState:
    kw = _shard_rows(state, _STATE_PAD, lo, hi)
    kw["mailbox"] = Mailbox(**_shard_rows(state.mailbox, _MAILBOX_PAD, lo, hi))
    return ClusterState(**kw)


def _join_state(parts: list[ClusterState]) -> ClusterState:
    """Node shards' local states (batch-leading) -> the padded writer-major
    [B, n_pad, ...] state, on the first shard's device."""
    def join(table, trees):
        return {f: (mesh_mod.concat([getattr(t, f) for t in trees], 1) if axes
                    else getattr(trees[0], f))
                for f, (axes, _) in table.items()}

    kw = join(_STATE_PAD, parts)
    kw["mailbox"] = Mailbox(**join(_MAILBOX_PAD, [p.mailbox for p in parts]))
    return ClusterState(**kw)


def _run(cfg: RaftConfig, seed: int, batch: int, n_ticks: int, mesh: mesh_mod.Mesh,
         window: int | None, timeout: float):
    """The node-sharded run behind both entry points: the plain loop, or the
    windowed one with `window`. Returns (padded final state, metrics,
    [records,] collective counts)."""
    cfg = compact_twin(cfg, False)  # sharded carries run dense (module docstring)
    n_cshards, n_nshards = mesh.devices.shape
    n_pad = check_shardable(cfg, n_nshards)
    nl = n_pad // n_nshards
    if batch % n_cshards:
        raise ValueError(f"batch {batch} must divide over {n_cshards} cluster shards")
    if window is not None and n_ticks % window:
        raise ValueError(f"n_ticks {n_ticks} must divide by window {window}")
    per = batch // n_cshards
    dev0 = mesh.devices[0, 0]
    k_init, k_run = scan.fleet_keys(seed, batch, dev0)
    full = pad_state(cfg, init_rows(cfg, k_init), n_pad)
    exchanges = [comm.Exchange(n_nshards, timeout) for _ in range(n_cshards)]

    def shard(rank: int):
        c, j = divmod(rank, n_nshards)
        dev = mesh.devices[c, j]
        sh = NodeShardCtx(exchange=exchanges[c], rank=j, nl=nl, n_pad=n_pad)
        lo, hi = c * per, (c + 1) * per
        local = mesh_mod.take(_local_state(full, j * nl, (j + 1) * nl), lo, hi, device=dev)
        keys = k_run[lo:hi].to(dev)

        def step(cfg_, s, inp, now):  # inputs drawn at the real N, padded (batch-minor)
            return raft_batched.step_b(cfg_, s, pad_inputs(cfg_, inp, n_pad, lead=0), now, sh)

        s = raft_batched.to_batch_minor(local)
        with sh.exchange.shard(j):
            if window is None:
                s, m = scan.run_minor(cfg, s, keys, n_ticks, 0, step_fn=step)
                return raft_batched.from_batch_minor(s), raft_batched.from_batch_minor(m)
            s, m, recs, _ = telemetry.run_minor_telemetry(cfg, s, keys, n_ticks, window, 0,
                                                          step_fn=step)
            return raft_batched.from_batch_minor(s), raft_batched.from_batch_minor(m), recs

    outs = comm.run_spmd(shard, n_cshards * n_nshards, exchanges, grace=timeout)
    groups = [outs[c * n_nshards:(c + 1) * n_nshards] for c in range(n_cshards)]
    # Every node shard of a cluster group folds to the same metrics: take
    # the first's.
    final = mesh_mod.concat([_join_state([o[0] for o in g]) for g in groups], 0, dev0)
    metrics = mesh_mod.concat([g[0][1] for g in groups], 0, dev0)
    counts = dict(exchanges[0].counts, meetings=exchanges[0].meetings)
    if window is None:
        return final, metrics, counts
    return final, metrics, mesh_mod.concat([g[0][2] for g in groups], 0, dev0), counts


def simulate_node_sharded(cfg: RaftConfig, seed: int, batch: int, n_ticks: int,
                          mesh: mesh_mod.Mesh, timeout: float = comm.DEFAULT_TIMEOUT,
                          counts: dict | None = None):
    """`scan.simulate` with the node axis sharded over `mesh`'s "nodes"
    axis (and the batch over "clusters"). Returns (final_state, RunMetrics):
    the metrics and the `unshard_state` view of the final state are
    bit-identical to the unsharded run for the same (cfg, seed, batch,
    n_ticks) at any mesh shape. The returned state is PADDED writer-major
    [B, n_pad, ...], gathered onto the mesh's first device -- pass it through
    `unshard_state` for the dense view. `timeout` bounds each collective's
    wait; `counts`, if given, receives the first cluster group's collective
    counts by kind (comm.Exchange.counts) and its barrier crossings
    ("meetings")."""
    final, metrics, got = _run(cfg, seed, batch, n_ticks, mesh, None, timeout)
    if counts is not None:
        counts.update(got)
    return final, metrics


def simulate_node_sharded_windowed(cfg: RaftConfig, seed: int, batch: int, n_ticks: int,
                                   window: int, mesh: mesh_mod.Mesh,
                                   timeout: float = comm.DEFAULT_TIMEOUT):
    """`telemetry.simulate_windowed` (no recorder, no trace plane) with the
    node axis sharded: returns (final_state, metrics, records), records in
    the public [B, n_windows, ...] layout and bit-identical to the unsharded
    windowed run. n_ticks must divide by window."""
    final, metrics, records, _ = _run(cfg, seed, batch, n_ticks, mesh, window, timeout)
    return final, metrics, records

