"""Fleet telemetry: windowed aggregation, a violation flight recorder and the
trace plane's window loop (the port of raft_sim_tpu/sim/telemetry.py).

Three mechanisms over the same tick as the main path (`scan.tick_batch_minor`,
so telemetry never observes another trajectory than the one it reports):

1. **Windowed aggregation** (`run_batch_minor_telemetry`): each tick's
   StepInfo folds into a window-local RunMetrics, and every `window` ticks one
   `WindowRecord` comes out -- [T/W] records instead of [T] rows. Every fold
   is associative across window cuts, so merging the records with
   `chunked.merge_metrics` gives the run's RunMetrics exactly
   (`reduce_records`). `first_viol_tick` adds when, inside the window, the
   first invariant tripped (NEVER if none did).

2. **Flight recorder** (`FlightRecorder`): a K-deep ring of the last K ticks'
   StepInfo per cluster that freezes on the first tick any `viol_*` flag
   fires, that tick included (written first, then latched).

The loops keep `now` on the host, as sim/scan.py does; the per-window and
per-tick values that land in the records come from the state's own `now`
leaf, as in the JAX package. Every loop takes the scenario input path
(`genome`: [B, S] rows on the fleet's device, with `seg_len`;
scenario/search.py's fitness reads these windows); a small fleet on it (a
replay) draws its inputs a span of ticks at a time (`scan.input_ticks`).

3. **The protocol trace plane** (raft_sim_tpu_torch/trace; needs
   cfg.track_trace): `trace_spec` extracts each tick's events, folds them
   into the window's event buffer and the coverage bitmap, and exports one
   `TraceWindowOut` per window; `trigger_kind` freezes the flight recorder
   on the first event of that kind instead of the first violation. The
   tick, and so the trajectory, is the same either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raft_sim_tpu_torch.models import raft_batched
from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.sim.chunked import merge_metrics
from raft_sim_tpu_torch.types import LAT_HIST_BINS, StepInfo
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig

NEVER = scan.NEVER


class WindowRecord(NamedTuple):
    """One W-tick window's telemetry for every cluster (public layout after a
    run: every leaf leads with [batch, n_windows, ...])."""

    start: torch.Tensor  # int32: absolute tick of the window's first tick
    first_viol_tick: torch.Tensor  # int32: first violating tick in the window, or NEVER
    metrics: scan.RunMetrics  # this window's RunMetrics


class FlightRecorder(NamedTuple):
    """Ring of the last K ticks' StepInfo per cluster, frozen at the first
    violation; batch-minor (`ring` leaves [K, ..., B])."""

    ring: StepInfo  # each StepInfo leaf stacked K deep along axis 0
    tick: torch.Tensor  # [K, B] int32: the tick each slot holds (-1 = empty)
    pos: torch.Tensor  # [B] int32: ticks recorded so far (next slot = pos % K)
    frozen: torch.Tensor  # [B] bool: latched by the first viol_* tick


def init_recorder(cfg: RaftConfig, k: int, batch: int, device="cpu") -> FlightRecorder:
    """Zeroed K-deep recorder, batch-minor ([..., B] trailing on every leaf)."""

    def leaf(name):
        dtype = torch.bool if name.startswith("viol") else torch.int32
        mid = (LAT_HIST_BINS,) if name.endswith("_hist") else ()
        return torch.zeros((k, *mid, batch), dtype=dtype, device=device)

    return FlightRecorder(
        ring=StepInfo(**{f: leaf(f) for f in StepInfo._fields}),
        tick=torch.full((k, batch), -1, dtype=torch.int32, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        frozen=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def _record(rec: FlightRecorder, info: StepInfo, now: torch.Tensor, k: int,
            trig: torch.Tensor) -> FlightRecorder:
    """Write one tick's StepInfo into slot pos % K of each unfrozen cluster,
    then latch `frozen` where `trig` fired, so the triggering tick is the
    ring's newest entry."""
    slot = rec.pos % k  # [B]
    write = ~rec.frozen  # [B]
    ks = torch.arange(k, dtype=torch.int32, device=slot.device)
    oh1 = (ks[:, None] == slot[None, :]) & write[None, :]

    def upd(leaf, val):
        oh = oh1.reshape((k,) + (1,) * (leaf.dim() - 2) + oh1.shape[-1:])
        return torch.where(oh, val[None], leaf)

    ring = StepInfo(*(upd(leaf, v) for leaf, v in zip(rec.ring, info)))
    return FlightRecorder(
        ring=ring,
        tick=upd(rec.tick, now),
        pos=rec.pos + write.to(torch.int32),
        frozen=rec.frozen | (write & trig),
    )


def _stack_records(recs: list[WindowRecord]) -> WindowRecord:
    """Per-window batch-minor records -> one record in the public
    [B, n_windows, ...] layout."""
    stacked = WindowRecord(
        start=torch.stack([r.start for r in recs]),
        first_viol_tick=torch.stack([r.first_viol_tick for r in recs]),
        metrics=scan.RunMetrics(*(torch.stack(leaves) for leaves in zip(*(r.metrics for r in recs)))),
    )
    return raft_batched.from_batch_minor(stacked)


def run_minor_telemetry(cfg: RaftConfig, s, keys: torch.Tensor, n_ticks: int, window: int,
                        now: int, recorder: FlightRecorder | None = None, step_fn=None,
                        cmds=None, reads=None, genome=None, seg_len: int = 1, trace_spec=None,
                        trace_persist=None, trigger_kind: int | None = None):
    """The windowed loop (`minor_telemetry_ticks`, run to its end)."""
    loop = minor_telemetry_ticks(cfg, s, keys, n_ticks, window, now, recorder, step_fn, cmds,
                                 reads, genome, seg_len, trace_spec, trace_persist, trigger_kind)
    # The loop holds the only references to the carries it replaces tick by
    # tick, so each tick frees the last.
    del s, recorder, trace_persist
    return scan.interleave([loop])[0]


def minor_telemetry_ticks(cfg: RaftConfig, s, keys: torch.Tensor, n_ticks: int, window: int,
                          now: int, recorder: FlightRecorder | None = None, step_fn=None,
                          cmds=None, reads=None, genome=None, seg_len: int = 1, trace_spec=None,
                          trace_persist=None, trigger_kind: int | None = None):
    """The windowed loop as a generator, one step a tick (the sharded
    evaluator, parallel/mesh.py, interleaves the shards' loops by it:
    scan.interleave); its return value is the loop's result. The loop runs
    on a batch-minor state `s` whose lockstep tick is the host's `now` and
    returns (state, RunMetrics of these ticks, records, recorder) -- state and metrics batch-minor, records public -- plus
    (trace windows, trace persist) when `trace_spec` is given: the windows a
    stacked TraceWindowOut (leaves [n_windows, ..., B]), the persist carried
    from `trace_persist` (None starts fresh). `cmds` and `reads` ([n_ticks, B]
    planes or None) are the per-tick offer overrides of the serve loop
    (serve/loop.py); `genome`/`seg_len` select the scenario input path.
    `trigger_kind` freezes the recorder on an event kind (trace/events.py)
    instead of the first violation. `n_ticks` must divide by `window`."""
    if n_ticks % window:
        raise ValueError(f"n_ticks {n_ticks} must divide by window {window}")
    need_events = trace_spec is not None or trigger_kind is not None
    if need_events and not cfg.track_trace:
        raise ValueError(
            "protocol tracing / event triggers need cfg.track_trace=True (a telemetry run "
            "of an untraced config carries no trace leg)")
    batch = s.role.shape[-1]
    dev = s.role.device
    ring_k = 0 if recorder is None else recorder.tick.shape[0]
    if need_events:
        from raft_sim_tpu_torch.trace import events as tev
        from raft_sim_tpu_torch.trace import ring as tring
    tp = trace_persist
    if trace_spec is not None and tp is None:
        tp = tring.init_persist(trace_spec, batch, dev)
    # A small fleet on the scenario path (a replay) draws its inputs a span
    # of ticks at a time; a served loop overrides them tick by tick.
    drawn = None
    if genome is not None and cmds is None and reads is None and scan.spans_pay(batch):
        drawn = scan.input_ticks(cfg, keys, now, n_ticks, genome, seg_len, trace=need_events)
    m0 = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
    metrics = m0
    recs, traws = [], []
    t = now
    for _ in range(n_ticks // window):
        start = s.now
        wm = m0
        fv = torch.full((batch,), NEVER, dtype=torch.int32, device=dev)
        if trace_spec is not None:
            tw = tring.init_window(trace_spec, batch, dev)
        for _ in range(window):
            tick_now = s.now
            inp = facts = None
            if drawn is not None:
                inp = next(drawn)
                if need_events:
                    inp, facts = inp
            out = scan.tick_batch_minor(
                cfg, s, keys, wm, t, step_fn=step_fn,
                client_cmd=None if cmds is None else cmds[t - now],
                read_cmd=None if reads is None else reads[t - now],
                genome=genome, seg_len=seg_len, inputs=inp, events=need_events, facts=facts,
            )
            s, wm, info = out[:3]
            bad = scan.step_bad(info)
            fv = torch.minimum(fv, torch.where(bad, tick_now, NEVER))
            if ring_k:
                trig = bad if trigger_kind is None else tev.any_of_kind(cfg, out[3], trigger_kind)
                recorder = _record(recorder, info, tick_now, ring_k, trig)
            if trace_spec is not None:
                tw, tp = tring.record(cfg, trace_spec, tw, tp, out[3], tick_now)
            t += 1
            yield
        recs.append(WindowRecord(start=start, first_viol_tick=fv, metrics=wm))
        if trace_spec is not None:
            traws.append(tring.TraceWindowOut(win=tw, cov=tp.cov))
        metrics = merge_metrics(metrics, wm)
    base = (s, metrics, _stack_records(recs), recorder)
    if trace_spec is None:
        return base
    return base + (tring.stack_windows(traws), tp)


def run_batch_minor_telemetry(cfg: RaftConfig, state, keys: torch.Tensor, n_ticks: int,
                              window: int, recorder: FlightRecorder | None = None,
                              step_fn=None, genome=None, seg_len: int = 1, trace_spec=None,
                              trace_persist=None, trigger_kind: int | None = None,
                              now: int | None = None):
    """The windowed run from a [B, ...]-leading `state`: the same trajectory
    as `scan.run_batch_minor`, plus [n_ticks/window] WindowRecords and the
    optional flight recorder (batch-minor in and out). Returns (final_state,
    metrics, records, recorder); state, metrics and records [B, ...]-leading,
    with (trace windows, trace persist) appended when `trace_spec` is given
    (both batch-minor, as `run_minor_telemetry` returns them). `now` is the
    host's copy of the state's tick (read once when not given). `genome`
    ([B, S] rows) and `seg_len` select the scenario input path."""
    batch = state.role.shape[0]
    if now is None:
        now = int(state.now.reshape(-1)[0]) if batch else 0
    out = run_minor_telemetry(
        cfg, raft_batched.to_batch_minor(state), keys, n_ticks, window, now, recorder, step_fn,
        genome=genome, seg_len=seg_len, trace_spec=trace_spec, trace_persist=trace_persist,
        trigger_kind=trigger_kind)
    s, metrics = out[:2]
    return (raft_batched.from_batch_minor(s), raft_batched.from_batch_minor(metrics)) + out[2:]


def simulate_windowed(cfg: RaftConfig, seed: int, batch: int, n_ticks: int, window: int,
                      ring: int = 0, genome=None, seg_len: int = 1, trace=None,
                      trigger_kind: int | None = None, device="cuda", step_fn=None):
    """`scan.simulate` with telemetry: the same key derivation and
    trajectory, returning (final_state, metrics, records, recorder), plus
    (trace windows, trace persist) when `trace` (a TraceSpec; needs
    cfg.track_trace) is given. `ring` > 0 arms the flight recorder at that
    depth, and `trigger_kind` freezes it on an event kind. `genome` ([B, S]
    rows, moved to the fleet's device) runs a heterogeneous fleet, cluster b
    under row b, each segment `seg_len` ticks."""
    dev = device_mod.resolve(device)
    state, keys = scan.seed_fleet(cfg, seed, batch, dev)
    rec = init_recorder(cfg, ring, batch, dev) if ring else None
    if genome is not None:
        genome = type(genome)(*(leaf.to(dev) for leaf in genome))
    return run_batch_minor_telemetry(cfg, state, keys, n_ticks, window, rec, step_fn=step_fn,
                                     genome=genome, seg_len=seg_len, trace_spec=trace,
                                     trigger_kind=trigger_kind, now=0)


def run_chunked_telemetry(cfg: RaftConfig, state, keys: torch.Tensor, n_ticks: int,
                          window: int, recorder: FlightRecorder | None = None,
                          chunk: int = 4096, callback=None, genome=None, seg_len: int = 1,
                          perf=None, trace_spec=None, trace_persist=None,
                          trigger_kind: int | None = None, trace_callback=None,
                          chunk_hook=None, now: int | None = None):
    """Long telemetry runs: `chunked.run_chunked` with the window records
    handed to the host between chunks. Chunks are whole windows; a final
    window shorter than `window` closes a run that does not divide
    (`metrics.ticks` carries each window's width).
    `callback(ticks_done, state, merged_metrics, records)` gets each chunk's
    records in the public layout; returning True stops the run. Returns
    (final_state, merged_metrics, recorder), with the trace persist appended
    when `trace_spec` is given. The trace plane streams like the records:
    each chunk's stacked TraceWindowOut goes to `trace_callback(ticks_done,
    trace_windows)` (the sink's `append_trace`) before `callback`, and the
    persist threads from chunk to chunk. The caller's `state` is never
    written (every tick is out of place). `genome`/`seg_len` select the
    scenario input path. `chunk_hook(ticks_done, recorder)` sees the carried
    flight recorder (batch-minor) after each chunk, before the callbacks:
    the health plane's evidence hook, read-only. `perf` (an obs.ChunkTimer)
    gets one row a chunk, as in `chunked.run_chunked`: closed after the
    callbacks on a host copy of the chunk's `metrics.ticks`.

    As in `chunked.run_chunked`, `state` and `keys` (and `genome`,
    `recorder` and `trace_persist`, if given) may be lists: the shards of
    the batch in cluster order, each on its own device
    (`driver.Session(devices=)`). Each shard then runs its own windowed
    loop (`minor_telemetry_ticks`), the loops interleaved tick by tick
    (`scan.interleave`), and the records and trace windows come out
    gathered in cluster order (onto the first shard's device), so the sink
    sees the unsharded stream. State, metrics, recorders and persists stay
    per shard: the callback and `chunk_hook` get them as lists, and so does
    the result."""
    from raft_sim_tpu_torch.parallel.mesh import concat  # the shards in cluster order

    sharded = isinstance(state, list)
    if sharded:
        states = state
        n = len(states)
        recorders = recorder if recorder is not None else [None] * n
        persists = trace_persist if trace_persist is not None else [None] * n
        genomes = genome if isinstance(genome, list) else [genome] * n
    else:
        states, keys, recorders, persists, genomes = (
            [state], [keys], [recorder], [trace_persist], [genome])
    if now is None:
        now = int(states[0].now.reshape(-1)[0]) if states[0].role.shape[0] else 0
    if trace_spec is not None:
        from raft_sim_tpu_torch.trace import ring as tring

        persists = [tring.init_persist(trace_spec, st.role.shape[0], st.role.device)
                    if tp is None else tp for st, tp in zip(states, persists)]
    win_per_chunk = max(1, chunk // window)
    metrics = [scan.init_metrics_batch(st.role.shape[0], st.role.device) for st in states]
    ss = [raft_batched.to_batch_minor(st) for st in states]
    out = states
    done = 0
    if perf is not None:
        perf.watch(states[0].role.device)
    while done < n_ticks:
        left = n_ticks - done
        if left >= window:
            n = min(win_per_chunk, left // window) * window
            w = window
        else:
            n = w = left  # the remainder: one final short window
        if perf is not None:
            perf.begin(n)
        loops = [minor_telemetry_ticks(cfg, s, k, n, w, now + done, rec, genome=g,
                                       seg_len=seg_len, trace_spec=trace_spec,
                                       trace_persist=tp, trigger_kind=trigger_kind)
                 for s, k, rec, g, tp in zip(ss, keys, recorders, genomes, persists)]
        # The loops hold the only references to the carries they replace
        # tick by tick, so each tick frees the last.
        ss = recorders = persists = None
        res = scan.interleave(loops)
        if perf is not None:
            perf.dispatched()
        ss = [r[0] for r in res]
        recorders = [r[3] for r in res]
        persists = [r[5] if trace_spec is not None else None for r in res]
        metrics = [merge_metrics(a, raft_batched.from_batch_minor(r[1]))
                   for a, r in zip(metrics, res)]
        recs = concat([r[2] for r in res])
        done += n
        out = [raft_batched.from_batch_minor(s) for s in ss]
        if trace_spec is not None and trace_callback is not None:
            trace_callback(done, concat([r[4] for r in res], dim=-1))
        if chunk_hook is not None:
            chunk_hook(done, recorders if sharded else recorders[0])
        stop = callback is not None and (callback(done, out, metrics, recs) if sharded
                                         else callback(done, out[0], metrics[0], recs))
        if perf is not None:
            perf.end(sync=lambda: [r[1].ticks.cpu() for r in res])
        if stop:
            break
    result = (out, metrics, recorders) if sharded else (out[0], metrics[0], recorders[0])
    if trace_spec is not None:
        return result + ((persists if sharded else persists[0]),)
    return result


def reduce_records(records: WindowRecord) -> scan.RunMetrics:
    """Fold a stacked WindowRecord (leaves [B, n_windows, ...]) back into the
    run-level RunMetrics ([B, ...]): equal to the run's metrics exactly."""
    n_windows = records.start.shape[1]
    take = lambda w: scan.RunMetrics(*(x[:, w] for x in records.metrics))  # noqa: E731
    m = take(0)
    for w in range(1, n_windows):
        m = merge_metrics(m, take(w))
    return m


def window_cluster_counters(records: WindowRecord) -> list[dict]:
    """A stacked WindowRecord (public layout) as one dict of per-cluster
    numpy counters per window -- the health plane's window units.
    `leaderless` marks clusters that saw no leader in that window."""
    if isinstance(records.start, torch.Tensor):
        records = device_mod.host_numpy(*device_mod.to_host_async(records))
    start = np.asarray(records.start)
    m = {
        f: np.asarray(getattr(records.metrics, f))
        for f in ("ticks", "violations", "first_leader_tick", "total_cmds", "reads_served",
                  "lat_sum", "lat_cnt", "lat_hist", "read_hist", "fsync_lag_sum",
                  "fsync_lag_max")
    }
    units = []
    for w in range(start.shape[1]):
        units.append({
            "start": int(start[0, w]),
            "ticks": int(m["ticks"][0, w]),
            "violations": m["violations"][:, w].astype(np.int64),
            "leaderless": m["first_leader_tick"][:, w] == NEVER,
            "cmds": m["total_cmds"][:, w].astype(np.int64),
            "reads": m["reads_served"][:, w].astype(np.int64),
            "lat_sum": m["lat_sum"][:, w].astype(np.int64),
            "lat_cnt": m["lat_cnt"][:, w].astype(np.int64),
            "lat_hist": m["lat_hist"][:, w].astype(np.int64),
            "read_hist": m["read_hist"][:, w].astype(np.int64),
            "fsync_lag_sum": m["fsync_lag_sum"][:, w].astype(np.int64),
            "fsync_lag_max": m["fsync_lag_max"][:, w].astype(np.int64),
        })
    return units


def export_cluster(recorder: FlightRecorder, cluster: int):
    """One cluster's ring, oldest tick first, empty slots dropped:
    (ticks [k_valid] numpy, StepInfo of numpy leaves with a leading
    [k_valid] axis). For a frozen cluster the last row is the violation."""

    def leaf(x):  # [K, ..., B] -> this cluster's [K, ...]
        return np.moveaxis(x.detach().cpu().numpy(), -1, 0)[cluster]

    ticks = leaf(recorder.tick)
    order = np.argsort(ticks, kind="stable")
    order = order[ticks[order] >= 0]
    return ticks[order], StepInfo(*(leaf(x)[order] for x in recorder.ring))
