"""The tick loop with per-cluster metrics (the port of raft_sim_tpu/sim/scan.py's
batch-minor path).

`simulate(cfg, seed, batch, n_ticks)` is the main path: init from the seed,
then `n_ticks` of `tick_batch_minor` -- input draws
(kernels/draw_engine.draw_cuda: the Hopper draw kernel for CUDA keys, the
plain draws of sim/faults.py for CPU keys), the tick
(kernels/tick_engine.step_cuda: the Hopper kernel for CUDA tensors, the plain
PyTorch step for CPU tensors) and the metric fold. The JAX `lax.scan` becomes a
Python loop. All clusters run in lockstep, so the loop keeps `now` on the host
and reads nothing back from the device per tick.

The scenario path: `genome` ([B, S] ScenarioGenome leaves on the fleet's
device, scenario/genome.py) and `seg_len` switch the input draws to each
cluster's own fault setting (faults.make_inputs); `simulate_scenario` is
`simulate` through it, and `run_traced` replays one cluster tick by tick with
its states (the JAX `run(..., trace_states=True, genome=...)`), as a B=1 view
of the same batch-minor path, so on the card it runs the kernel.

`run(cfg, state, key, n_ticks, ...)` and `run_batch` are the JAX package's
single-cluster API (one unbatched cluster; a leading batch of them), as B=1
and B-wide views of the same batch-minor path.

`tick_batch_minor(..., events=True)` also extracts the tick's protocol events
(trace/events.py) for the trace plane's loops (sim/telemetry.py).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.types import LAT_HIST_BINS, NIL, ClusterState, StepInfo, init_rows
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils import threefry
from raft_sim_tpu_torch.utils.config import RaftConfig

NEVER = 2**31 - 1
_BIG = NEVER


class RunMetrics(NamedTuple):
    """Per-cluster run summary; fields, dtypes and meaning as the JAX
    RunMetrics. Public layout [B] ([B, BINS] for the histograms)."""

    violations: torch.Tensor
    first_leader_tick: torch.Tensor
    last_leaderless_tick: torch.Tensor
    max_term: torch.Tensor
    max_commit: torch.Tensor
    min_commit: torch.Tensor
    total_msgs: torch.Tensor
    total_cmds: torch.Tensor
    lat_sum: torch.Tensor
    lat_cnt: torch.Tensor
    lat_hist: torch.Tensor
    lat_excluded: torch.Tensor
    noop_blocked: torch.Tensor
    lm_skipped_pairs: torch.Tensor
    reads_served: torch.Tensor
    read_lat_sum: torch.Tensor
    read_hist: torch.Tensor
    fsync_lag_sum: torch.Tensor
    fsync_lag_max: torch.Tensor
    multi_leader: torch.Tensor
    ticks: torch.Tensor


def init_metrics_batch(batch: int, device="cpu") -> RunMetrics:
    """Zeroed RunMetrics with a leading [batch] axis."""
    z = lambda v=0: torch.full((batch,), v, dtype=torch.int32, device=device)  # noqa: E731
    h = lambda: torch.zeros((batch, LAT_HIST_BINS), dtype=torch.int32, device=device)  # noqa: E731
    return RunMetrics(
        violations=z(),
        first_leader_tick=z(NEVER),
        last_leaderless_tick=z(-1),
        max_term=z(),
        max_commit=z(),
        min_commit=z(),
        total_msgs=z(),
        total_cmds=z(),
        lat_sum=z(),
        lat_cnt=z(),
        lat_hist=h(),
        lat_excluded=z(),
        noop_blocked=z(),
        lm_skipped_pairs=z(),
        reads_served=z(),
        read_lat_sum=z(),
        read_hist=h(),
        fsync_lag_sum=z(),
        fsync_lag_max=z(),
        multi_leader=z(),
        ticks=z(),
    )


def step_bad(info: StepInfo) -> torch.Tensor:
    """Per-tick any-invariant-tripped predicate (the JAX step_bad). The port's
    step emits real zero tensors for gated-off legs, where JAX emits host
    constants and skips their folds; folding those zeros leaves the JAX values."""
    return (
        info.viol_election_safety
        | info.viol_commit
        | info.viol_log_matching
        | info.viol_read_stale
    )


def _accumulate(m: RunMetrics, info: StepInfo, tick: torch.Tensor) -> RunMetrics:
    has_leader = info.leader != NIL
    i32 = torch.int32
    return RunMetrics(
        violations=m.violations + step_bad(info).to(i32),
        first_leader_tick=torch.minimum(
            m.first_leader_tick, torch.where(has_leader, tick, _BIG)
        ),
        last_leaderless_tick=torch.maximum(
            m.last_leaderless_tick, torch.where(has_leader, -1, tick)
        ),
        max_term=torch.maximum(m.max_term, info.max_term),
        max_commit=torch.maximum(m.max_commit, info.max_commit),
        min_commit=info.min_commit,
        total_msgs=m.total_msgs + info.msgs_delivered,
        total_cmds=m.total_cmds + info.cmds_injected,
        lat_sum=m.lat_sum + info.lat_sum,
        lat_cnt=m.lat_cnt + info.lat_cnt,
        lat_hist=m.lat_hist + info.lat_hist,
        lat_excluded=m.lat_excluded + info.lat_excluded,
        noop_blocked=m.noop_blocked + info.noop_blocked,
        lm_skipped_pairs=m.lm_skipped_pairs + info.lm_skipped_pairs,
        reads_served=m.reads_served + info.reads_served,
        read_lat_sum=m.read_lat_sum + info.read_lat_sum,
        read_hist=m.read_hist + info.read_hist,
        fsync_lag_sum=m.fsync_lag_sum + info.fsync_lag_sum,
        fsync_lag_max=torch.maximum(m.fsync_lag_max, info.fsync_lag_max),
        multi_leader=m.multi_leader + (info.n_leaders >= 2).to(i32),
        ticks=m.ticks + 1,
    )


def _override(plane: torch.Tensor, value) -> torch.Tensor:
    """`value` (a scalar, or a [B] tensor or array) broadcast over the [B]
    input `plane`, in its dtype and on its device."""
    v = torch.as_tensor(value, dtype=plane.dtype, device=plane.device)
    return v.expand(plane.shape).contiguous()


def tick_batch_minor(cfg, s, keys, metrics, now: int, step_fn=None, client_cmd=None,
                     read_cmd=None, genome=None, seg_len: int = 1, inputs=None,
                     events: bool = False, facts=None, draw_fn=None):
    """ONE tick of the batch-minor path: input draws, step, metric fold.
    `s`/`metrics` are batch-minor, `keys` [B, 2], `now` the host's copy of the
    lockstep tick. `client_cmd` replaces the scheduled client input this
    tick, and `read_cmd` the scheduled ReadIndex offer: each a scalar (one
    offer fleet-wide, Session.offer/offer_read) or a [B] plane (one slot per
    cluster, NIL = none: the serve loop). A read plane needs cfg.read_index.
    `genome`/`seg_len` select the scenario input path; `inputs` (this tick's
    batch-minor StepInputs, drawn ahead by `input_ticks`) replaces the draw.
    `draw_fn` overrides the draws as `step_fn` does the tick (default:
    kernels/draw_engine.draw_cuda). Returns (state, metrics, StepInfo), all
    batch-minor.

    `events=True` (the trace plane, cfg.track_trace) also extracts the tick's
    protocol events from the state delta (trace/events.py) and returns
    (state, metrics, StepInfo, TickEvents); the first three are the same
    either way. The fault facts (`faults.trace_fault_inputs`) come with the
    input draw (`draw_fn(..., facts=True)`), or as `facts` with `inputs`
    drawn ahead (`input_ticks(..., trace=True)`)."""
    if step_fn is None:
        step_fn = tick_engine.step_cuda
    if draw_fn is None:
        draw_fn = draw_engine.draw_cuda
    if inputs is not None:
        inp_t = inputs
        if facts is None and events:  # inputs drawn ahead without them
            facts = draw_fn(cfg, keys, now, genome=genome, seg_len=seg_len, facts=True)[1]
    elif events:
        inp_t, facts = draw_fn(cfg, keys, now, genome=genome, seg_len=seg_len, facts=True)
    else:
        inp_t = draw_fn(cfg, keys, now, genome=genome, seg_len=seg_len)
    if client_cmd is not None:
        inp_t = inp_t._replace(client_cmd=_override(inp_t.client_cmd, client_cmd))
    if read_cmd is not None:
        inp_t = inp_t._replace(read_cmd=_override(inp_t.read_cmd, read_cmd))
    s2, info = step_fn(cfg, s, inp_t, now)
    m2 = _accumulate(metrics, info, s.now)
    if not events:
        return s2, m2, info
    from raft_sim_tpu_torch.trace import events as tev

    crashed, cut_now, cut_prev = facts
    ev = tev.extract(cfg, s, s2, inp_t, info, crashed, cut_now, cut_prev)
    return s2, m2, info, ev


def run_batch_minor(
    cfg: RaftConfig,
    state: ClusterState,
    keys: torch.Tensor,
    n_ticks: int,
    step_fn=None,
    now: int | None = None,
    genome=None,
    seg_len: int = 1,
):
    """`n_ticks` ticks from a [B, ...]-leading `state`; returns (final state,
    RunMetrics), both [B, ...]-leading. The batch axis moves minor once at
    entry and back once at exit. `now` is the host's copy of the state's tick
    (read once from the state when not given). `genome` ([B, S] rows) and
    `seg_len` select the scenario input path."""
    batch = state.role.shape[0]
    if now is None:
        now = int(state.now.reshape(-1)[0]) if batch else 0
    s, m = run_minor(cfg, raft_batched.to_batch_minor(state), keys, n_ticks, now, step_fn,
                     genome=genome, seg_len=seg_len)
    return raft_batched.from_batch_minor(s), raft_batched.from_batch_minor(m)


def run_minor(cfg: RaftConfig, s: ClusterState, keys: torch.Tensor, n_ticks: int, now: int,
              step_fn=None, genome=None, seg_len: int = 1):
    """`n_ticks` ticks from a batch-minor state `s` whose lockstep tick is the
    host's `now`; returns (state, RunMetrics of these ticks), batch-minor."""
    loop = minor_ticks(cfg, s, keys, n_ticks, now, step_fn, genome, seg_len)
    del s  # the loop holds the only reference, so each tick frees the last state
    return interleave([loop])[0]


def minor_ticks(cfg: RaftConfig, s: ClusterState, keys: torch.Tensor, n_ticks: int, now: int,
                step_fn=None, genome=None, seg_len: int = 1):
    """`run_minor`'s loop as a generator, one step a tick; its return value
    is run_minor's result."""
    batch = s.role.shape[-1]
    m = raft_batched.to_batch_minor(init_metrics_batch(batch, s.role.device))
    for t in range(now, now + n_ticks):
        s, m, _ = tick_batch_minor(cfg, s, keys, m, t, step_fn=step_fn, genome=genome,
                                   seg_len=seg_len)
        yield
    return s, m


def interleave(loops: list) -> list:
    """Drive tick-loop generators (`minor_ticks`,
    telemetry.minor_telemetry_ticks) in turns, one tick of each a round,
    until all are done; returns their results in order. The shards of a
    batch (parallel/mesh.py) run so, their launches interleaved tick by
    tick; one loop is simply run to its end."""
    out = [None] * len(loops)
    live = list(range(len(loops)))
    while live:
        still = []
        for i in live:
            try:
                next(loops[i])
                still.append(i)
            except StopIteration as stop:
                out[i] = stop.value
        live = still
    return out


SPAN_ROWS = 16384  # (tick, cluster) rows a span of scenario draws holds (`input_ticks`)


def spans_pay(batch: int) -> bool:
    """Whether drawing a fleet's scenario inputs a span of ticks at a time
    (`input_ticks`) beats drawing them tick by tick: at least 8 ticks a span."""
    return batch * 8 <= SPAN_ROWS


def input_ticks(cfg: RaftConfig, keys: torch.Tensor, t0: int, n_ticks: int, genome,
                seg_len: int = 1, trace: bool = False):
    """Each tick's batch-minor scenario-path inputs for ticks t0 ..
    t0 + n_ticks - 1, drawn a span at a time (`draw_engine.draw_span`, at
    most SPAN_ROWS rows a call): equal to drawing them tick by tick, at a
    fraction of the launches when B is small (a replay, a shrink trial).
    With `trace` each tick comes as (inputs, fault facts): the trace plane's
    `faults.trace_fault_inputs`, drawn with them (`facts=True`). On the card
    each span is one launch of the draw kernel."""
    block = max(1, SPAN_ROWS // max(keys.shape[0], 1))
    for a in range(t0, t0 + n_ticks, block):
        k_n = min(block, t0 + n_ticks - a)
        span = draw_engine.draw_span(cfg, keys, a, k_n, genome, seg_len, facts=trace)
        inps, facts = span if trace else (span, None)
        for k in range(k_n):
            inp = type(inps)(*(x[k] for x in inps))
            yield (inp, tuple(x[k] for x in facts)) if trace else inp


def run_traced(cfg: RaftConfig, state: ClusterState, keys: torch.Tensor, n_ticks: int,
               genome=None, seg_len: int = 1, step_fn=None, keep_states: bool = True):
    """Replay clusters tick by tick, keeping every tick's StepInfo and
    post-tick state: the JAX `run(..., trace_states=True, genome=...)` for
    each cluster of a [B, ...]-leading `state` (one cluster: B = 1) with
    `keys` [B, 2] and `genome` [B, S] rows. Returns (final state, RunMetrics,
    (infos, states)) where infos and states lead with [B, T] -- row b is the
    stacked trajectory `sim/trace.py` renders for cluster b (states None
    without `keep_states`). With a genome the inputs are drawn a span of
    ticks at a time (`input_ticks`)."""
    batch = state.role.shape[0]
    now = int(state.now.reshape(-1)[0]) if batch else 0
    s = raft_batched.to_batch_minor(state)
    m = raft_batched.to_batch_minor(init_metrics_batch(batch, s.role.device))
    infos, states = [], []
    drawn = (input_ticks(cfg, keys, now, n_ticks, genome, seg_len) if genome is not None
             else itertools.repeat(None))
    for t, inp in zip(range(now, now + n_ticks), drawn):
        s, m, info = tick_batch_minor(cfg, s, keys, m, t, step_fn=step_fn, genome=genome,
                                      seg_len=seg_len, inputs=inp)
        infos.append(info)
        if keep_states:
            states.append(s)
    return (raft_batched.from_batch_minor(s), raft_batched.from_batch_minor(m),
            (_stack_leaf(infos), _stack_leaf(states) if keep_states else None))


def run_batch(cfg: RaftConfig, state: ClusterState, keys: torch.Tensor, n_ticks: int,
              trace: bool = False, genome=None, seg_len: int = 1, step_fn=None):
    """The JAX `run_batch`: `n_ticks` ticks of each cluster of a
    [B, ...]-leading `state` with `keys` [B, 2] (and `genome` [B, S] rows).
    Returns (final state, RunMetrics, outs), outs None or, with `trace`, the
    stacked StepInfo [B, T, ...]."""
    if not trace:
        final, metrics = run_batch_minor(cfg, state, keys, n_ticks, step_fn=step_fn,
                                         genome=genome, seg_len=seg_len)
        return final, metrics, None
    final, metrics, (infos, _) = run_traced(cfg, state, keys, n_ticks, genome=genome,
                                            seg_len=seg_len, step_fn=step_fn, keep_states=False)
    return final, metrics, infos


def run(cfg: RaftConfig, state: ClusterState, key: torch.Tensor, n_ticks: int,
        trace: bool = False, trace_states: bool = False, genome=None, seg_len: int = 1,
        step_fn=None):
    """The JAX `run`: one unbatched cluster `state` with its `[2]` key
    forward `n_ticks` (its inputs under `genome`, `[S]` leaves, with
    `seg_len`). Returns (final state, RunMetrics, outs): outs None, the
    stacked StepInfo [T, ...] (`trace`), or (StepInfo, stacked states)
    (`trace_states`). A B=1 view of `run_batch`."""
    one = lambda tree: raft_batched._map(lambda x: x.unsqueeze(0), tree)  # noqa: E731
    first = lambda tree: raft_batched._map(lambda x: x[0], tree)  # noqa: E731
    g = None if genome is None else one(genome)
    if trace_states:
        final, metrics, (infos, states) = run_traced(cfg, one(state), key.unsqueeze(0), n_ticks,
                                                     genome=g, seg_len=seg_len, step_fn=step_fn)
        outs = (first(infos), first(states))
    else:
        final, metrics, outs = run_batch(cfg, one(state), key.unsqueeze(0), n_ticks, trace=trace,
                                         genome=g, seg_len=seg_len, step_fn=step_fn)
        outs = None if outs is None else first(outs)
    return first(final), first(metrics), outs


def simulate(
    cfg: RaftConfig, seed: int, batch: int, n_ticks: int, device="cuda", step_fn=None
):
    """One-call batched simulation from a seed: init + `n_ticks` ticks, on
    `device`. Same key derivation as the JAX `simulate` (root key, split into
    init and run streams), so the result equals it leaf for leaf. `step_fn`
    overrides the tick (default: kernels/tick_engine.step_cuda)."""
    state, keys = seed_fleet(cfg, seed, batch, device_mod.resolve(device))
    return run_batch_minor(cfg, state, keys, n_ticks, step_fn=step_fn, now=0)


def _stack_leaf(leaves):
    """T batch-minor leaves (or NamedTuples of them, nested) -> [B, T, ...]."""
    if isinstance(leaves[0], tuple) and hasattr(leaves[0], "_fields"):
        return type(leaves[0])(*(_stack_leaf([getattr(x, f) for x in leaves])
                                 for f in leaves[0]._fields))
    return torch.stack([x.movedim(-1, 0) for x in leaves], dim=1)


def simulate_scenario(cfg: RaftConfig, seed: int, batch: int, n_ticks: int, genome,
                      seg_len: int = 1, device="cuda", step_fn=None):
    """`simulate` through the scenario path: cluster b under genome row b
    ([B, S] leaves, moved to the fleet's device). The same init and key
    derivation as `simulate`, so a homogeneous genome (genome.from_config)
    reproduces `simulate(cfg, seed, ...)` bit for bit."""
    dev = device_mod.resolve(device)
    state, keys = seed_fleet(cfg, seed, batch, dev)
    genome = type(genome)(*(leaf.to(dev) for leaf in genome))
    return run_batch_minor(cfg, state, keys, n_ticks, step_fn=step_fn, now=0, genome=genome,
                           seg_len=seg_len)


def seed_fleet(cfg: RaftConfig, seed: int, batch: int, device):
    """(state, keys) of a fresh fleet on `device` (`fleet_keys`,
    types.init_rows), so runs from it equal the JAX package's on the same
    seed."""
    k_init, k_run = fleet_keys(seed, batch, device)
    return init_rows(cfg, k_init), k_run


def fleet_keys(seed: int, batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-cluster (init, run) keys of a fleet, [batch, 2] each: the JAX
    key derivation (the root key split into init and run streams, each split
    per cluster). A sharded run (parallel/) splits them before sharding, so
    its trajectories do not depend on the shard count."""
    k_init, k_run = threefry.split(threefry.key(seed, device), 2).unbind(dim=-2)
    return threefry.split(k_init, batch), threefry.split(k_run, batch)


def stable_leader_ticks(metrics: RunMetrics) -> torch.Tensor:
    """Ticks-to-stable-leader per cluster (_BIG if the run ended leaderless)."""
    ended_with_leader = metrics.last_leaderless_tick < metrics.ticks - 1
    return torch.where(ended_with_leader, metrics.last_leaderless_tick + 1, _BIG)
