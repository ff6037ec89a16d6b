"""Long-horizon runs: the tick loop in chunks, with a host callback between
them (the port of raft_sim_tpu/sim/chunked.py).

`run_chunked` runs `n_ticks` in chunks of `chunk` ticks and merges the
per-chunk RunMetrics (`merge_metrics`); between chunks it calls
`callback(ticks_done, state, merged_metrics)`, which may stop the run early
by returning True (progress lines, checkpoints, the apply-log export, an
abort on a violation). The merge is exact because the metric fold records
absolute tick numbers (`state.now`), which the state carries across chunks.

The JAX loop donates each chunk's state to the next and takes one copy up
front so the caller's arrays stay valid. Here every tick is out of place, so
the caller's state is never written and no copy is taken. The state moves
batch-minor once at entry, stays so through every tick, and crosses back to
the [B, ...] layout once per chunk, for the callback. The lockstep tick
`now` lives on the host: it is read from the state once (or passed in), and
nothing is read back from the device per chunk unless the callback asks
(or a chunk timer is armed: `perf`, obs/timer.py, syncs once a chunk).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.types import ClusterState
from raft_sim_tpu_torch.utils.config import RaftConfig


def merge_metrics(a: scan.RunMetrics, b: scan.RunMetrics) -> scan.RunMetrics:
    """Combine the metrics of two consecutive run segments (a, then b).
    Elementwise, so any layout of the per-cluster leaves works."""
    return scan.RunMetrics(
        violations=a.violations + b.violations,
        first_leader_tick=torch.minimum(a.first_leader_tick, b.first_leader_tick),
        last_leaderless_tick=torch.maximum(a.last_leaderless_tick, b.last_leaderless_tick),
        max_term=torch.maximum(a.max_term, b.max_term),
        max_commit=torch.maximum(a.max_commit, b.max_commit),
        min_commit=b.min_commit,  # "at the final tick": the later segment's
        total_msgs=a.total_msgs + b.total_msgs,
        total_cmds=a.total_cmds + b.total_cmds,
        lat_sum=a.lat_sum + b.lat_sum,
        lat_cnt=a.lat_cnt + b.lat_cnt,
        lat_hist=a.lat_hist + b.lat_hist,
        lat_excluded=a.lat_excluded + b.lat_excluded,
        noop_blocked=a.noop_blocked + b.noop_blocked,
        lm_skipped_pairs=a.lm_skipped_pairs + b.lm_skipped_pairs,
        reads_served=a.reads_served + b.reads_served,
        read_lat_sum=a.read_lat_sum + b.read_lat_sum,
        read_hist=a.read_hist + b.read_hist,
        fsync_lag_sum=a.fsync_lag_sum + b.fsync_lag_sum,
        fsync_lag_max=torch.maximum(a.fsync_lag_max, b.fsync_lag_max),
        multi_leader=a.multi_leader + b.multi_leader,
        ticks=a.ticks + b.ticks,
    )


def run_chunked(
    cfg: RaftConfig,
    state: ClusterState,
    keys: torch.Tensor,
    n_ticks: int,
    chunk: int = 1024,
    callback: Callable[[int, ClusterState, scan.RunMetrics], bool] | None = None,
    now: int | None = None,
    genome=None,
    seg_len: int = 1,
    perf=None,
):
    """Run the [B, ...]-leading `state` forward `n_ticks` in chunks of
    `chunk` ticks; returns (final state, merged RunMetrics), [B, ...]-leading.
    `callback(ticks_done, state, merged_metrics)` runs after each chunk on
    that chunk's state; returning True stops the run there. `now` is the
    host's copy of the state's tick (read once from the state when not
    given). Each tick is `scan.tick_batch_minor` through the kernel wrapper
    (the plain tick for CPU tensors). `genome` ([B, S] rows on the state's
    device) and `seg_len` select the scenario input path; segments follow
    the absolute tick, so chunking never shifts a phase. `perf` (an
    obs.ChunkTimer) gets one row a chunk: begun before its first launch,
    dispatched after its last, closed after the callback on a host copy of
    the chunk's `metrics.ticks` (the device wait). None leaves the loop as
    it was."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    batch = state.role.shape[0]
    if now is None:
        now = int(state.now.reshape(-1)[0]) if batch else 0
    metrics = scan.init_metrics_batch(batch, state.role.device)
    s = raft_batched.to_batch_minor(state)
    out = state
    done = 0
    if perf is not None:
        perf.watch(state.role.device)
    while done < n_ticks:
        n = min(chunk, n_ticks - done)
        if perf is not None:
            perf.begin(n)
        s, m = scan.run_minor(cfg, s, keys, n, now + done, genome=genome, seg_len=seg_len)
        if perf is not None:
            perf.dispatched()
        metrics = merge_metrics(metrics, raft_batched.from_batch_minor(m))
        done += n
        out = raft_batched.from_batch_minor(s)
        # The callback's host work is this chunk's; the row closes after it.
        stop = callback is not None and callback(done, out, metrics)
        if perf is not None:
            perf.end(sync=lambda: m.ticks.cpu())
        if stop:
            break
    return out, metrics
