"""Per-tick input generation, as pure data (the port of the scalar-config path
of raft_sim_tpu/sim/faults.py `make_inputs`).

Everything is a function of (cluster key, tick), drawn from the same threefry
streams as the JAX package (utils/threefry.py), so `make_inputs` here equals
`jax.vmap(faults.make_inputs)` leaf for leaf. Bernoulli events are uint32
threshold compares (`bits < threshold`, unsigned): draws are int64 values in
[0, 2^32), so a plain compare is the unsigned one.

Ported: message drop (with the per-cluster uniform rate), rolling partitions,
clock skew, election-timeout draws, the client's cadence, the crash schedule
(`alive_at`: the `alive` and `restarted` legs), the redirect client's
routing draws (`client_target`, `client_bounce`), the reconfiguration
plane's admin commands (`reconfig_cmd`, `transfer_cmd`, `read_cmd`) and the
storage plane's disk draws (`fsync_fire`, `torn_drop`). Gated-off fields come
out exactly as the JAX function emits them (zeros / NIL). Under the compacted
layout (`compact_planes`, ops/tile.py) the delivery mask ships flat: `[B, N*W]`
instead of `[B, N, W]`, the same words.

The scenario path (`genome=`, `seg_len=`; scenario/genome.py) takes each
cluster's fault parameters from its row of a `[B, S]` genome, the segment
active at `now` (`genome_at`): per-cluster drop, partition period and
threshold (so each cluster has its own partition window), crash threshold and
down-span, skew, the client cadence, the three admin cadences and the disk
draws. It draws every mechanism from the same key streams as the scalar path,
even those the scalar path gates off, so a homogeneous genome built from a
config (`genome.from_config`) reproduces the scalar path bit for bit.
Thresholds ride int64 tensors holding the uint32 values, the draws' own form.

`make_inputs(..., facts=True)` (and `draw_span`'s) also returns the fault
facts the trace plane needs and the inputs do not carry (`trace_fault_inputs`):
the crash edge and the partition's cut-edge counts at now and now - 1, from
the liveness and cut draws the inputs make.
"""

from __future__ import annotations

import torch

from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.types import NIL, StepInputs
from raft_sim_tpu_torch.utils import threefry
from raft_sim_tpu_torch.utils.config import RaftConfig
from raft_sim_tpu_torch.utils.rng import draw_timeouts

HALF_U32 = 1 << 31


def p_to_u32(p: float) -> int:
    """Probability -> uint32 Bernoulli threshold (P(fire) = threshold / 2^32)."""
    return max(0, min((1 << 32) - 1, int(round(p * (1 << 32)))))


def bern_u32(key: torch.Tensor, thresh, shape=()) -> torch.Tensor:
    """Bernoulli(thresh / 2^32) per key: `[..., 2]` keys -> `[..., *shape]` bool.
    `thresh` is a Python int or a tensor broadcastable against the draws."""
    return threefry.bits(key, shape) < thresh


def _mask(cfg: RaftConfig, deliver: torch.Tensor) -> torch.Tensor:
    """The [B, N, N] delivery plane packed over the source axis: [B, N, W]
    words, shipped flat ([B, N*W]) under the compacted layout."""
    words = bitplane.pack(deliver, axis=2)
    return words.reshape(words.shape[0], -1) if cfg.compact_planes else words


def _partition_cut(n: int, k_part: torch.Tensor, now, period, part_t):
    """[B, N, N] bool: edges cut by the rolling partition this tick. `now`,
    `period` and `part_t` are ints, or [B] tensors on the scenario path."""
    if isinstance(period, torch.Tensor):
        window = now // period.clamp(min=1)
    else:
        window = now // max(period, 1)
    wkey = threefry.fold_in(k_part, window)
    k_group, k_active = threefry.split(wkey, 2).unbind(dim=-2)
    group = bern_u32(k_group, HALF_U32, (n,))  # [B, N]
    active = bern_u32(k_active, part_t) & (period > 0)  # [B]
    same_side = group[:, :, None] == group[:, None, :]
    return ~same_side & active[:, None, None]


def _skew_draw(n: int, k_skew: torch.Tensor, skew_t) -> torch.Tensor:
    """[B, N] int32 clock increments: 0 below skew_t >> 1, 2 below skew_t, else 1
    (`skew_t` an int, or a [B, 1] tensor on the scenario path)."""
    r = threefry.bits(k_skew, (n,))
    one = torch.ones_like(r)
    return torch.where(
        r < (skew_t >> 1), 0 * one, torch.where(r < skew_t, 2 * one, one)
    ).to(torch.int32)


def crash_key(keys: torch.Tensor) -> torch.Tensor:
    """The crash-schedule stream of each cluster key ([..., 2]):
    fold_in(split(key, 3)[2], -1), with -1 taken as uint32."""
    return threefry.fold_in(threefry.split(keys, 3)[..., 2, :], -1)


def _alive_at_t(cfg: RaftConfig, ckey: torch.Tensor, now, crash_t, crash_down):
    """The windowed renewal body `alive_at` runs, with the tick, the crash
    threshold and the down-span bound as ints or as per-cluster [B] tensors
    (the scenario path); the window stays cfg.crash_period. A tick below 0
    reports alive."""
    n = cfg.n_nodes
    lead = ckey.shape[:-1]
    per_row = isinstance(now, torch.Tensor)
    if not per_row and now < 0:
        return torch.ones(lead + (n,), dtype=torch.bool, device=ckey.device)
    period = cfg.crash_period
    window = now // period
    off = now - window * period
    if per_row:
        off = off[..., None]
    wkey = threefry.fold_in(ckey, window)
    k_sel, k_start, k_dur = threefry.split(wkey, 3).unbind(dim=-2)
    if isinstance(crash_t, torch.Tensor):
        crash_t = crash_t[..., None]
        crash_down = crash_down[..., None]
    crashed = bern_u32(k_sel, crash_t, (n,))
    start = threefry.randint(k_start, (n,), 0, period)
    dur = threefry.randint(k_dur, (n,), 1, crash_down + 1)
    down = crashed & (off >= start) & (off < start + dur)
    if per_row:
        down = down & (now >= 0)[..., None]
    return ~down


def alive_at(cfg: RaftConfig, ckey: torch.Tensor, now: int) -> torch.Tensor:
    """[..., N] bool node liveness at tick `now` (the JAX `alive_at`): in
    window w = now // crash_period each node crashes with prob crash_prob and
    is down over [start, start + dur) of the window, start uniform in
    [0, period), dur uniform in [1, crash_down_ticks]. A tick below 0 reports
    alive, so tick 0 is never a restart."""
    if cfg.crash_prob <= 0:
        return torch.ones(ckey.shape[:-1] + (cfg.n_nodes,), dtype=torch.bool, device=ckey.device)
    return _alive_at_t(cfg, ckey, now, p_to_u32(cfg.crash_prob), cfg.crash_down_ticks)


def _client_routing(cfg: RaftConfig, tkey: torch.Tensor):
    """(client_target [B], client_bounce [B, K]) for the redirect client: one
    random target node per offer and one bounce node per pipeline slot, from
    fold_in(tick key, 3)."""
    n = cfg.n_nodes
    k_tgt, k_bnc = threefry.split(threefry.fold_in(tkey, 3), 2).unbind(dim=-2)
    return threefry.randint(k_tgt, (), 0, n), threefry.randint(k_bnc, (cfg.client_pipeline,), 0, n)


def _admin_cmds(cfg: RaftConfig, tkey: torch.Tensor, now: int):
    """(reconfig_cmd, transfer_cmd, read_cmd), each [B] int32: the
    reconfiguration plane's admin offers. The toggle and transfer targets
    are drawn every tick from split(fold_in(tick key, 5)) and offered on
    their cadence from tick 1; a read is offered on its cadence from tick 0.
    A disabled plane gives NIL."""
    n = cfg.n_nodes
    k_rcfg, k_xfer = threefry.split(threefry.fold_in(tkey, 5), 2).unbind(dim=-2)
    nil = torch.full(tkey.shape[:-1], NIL, dtype=torch.int32, device=tkey.device)

    def offer(interval: int, key: torch.Tensor) -> torch.Tensor:
        tgt = threefry.randint(key, (), 0, n)
        on = interval > 0 and now % interval == 0 and now > 0
        return tgt if on else nil

    reconfig_cmd = offer(cfg.reconfig_interval, k_rcfg) if cfg.reconfig else nil
    transfer_cmd = offer(cfg.transfer_interval, k_xfer) if cfg.leader_transfer else nil
    ri = cfg.read_interval
    read_on = cfg.read_index and ri > 0 and now % ri == 0
    read_cmd = torch.ones_like(nil) if read_on else nil
    return reconfig_cmd, transfer_cmd, read_cmd


def _storage_draws(cfg: RaftConfig, tkey: torch.Tensor, now: int):
    """(fsync_fire [B, N] bool, torn_drop [B, N] int32): the storage plane's
    disk draws from split(fold_in(tick key, 7), 3). A node's flush completes
    on the fsync cadence tick unless its jitter draw stalls it; torn_drop is
    the torn tail (1..lost_suffix_span entries, with prob torn_tail_prob) a
    restart would lose, drawn every tick on every node and read by the tick
    only on restarts. Gate off: zeros."""
    n = cfg.n_nodes
    lead = tkey.shape[:-1]
    if not cfg.durable_storage:
        return (torch.zeros(lead + (n,), dtype=torch.bool, device=tkey.device),
                torch.zeros(lead + (n,), dtype=torch.int32, device=tkey.device))
    k_jit, k_torn, k_span = threefry.split(threefry.fold_in(tkey, 7), 3).unbind(dim=-2)
    if now % cfg.fsync_interval == 0:  # the jitter stall matters on cadence ticks only
        fire = ~bern_u32(k_jit, p_to_u32(cfg.fsync_jitter_prob), (n,))
    else:
        fire = torch.zeros(lead + (n,), dtype=torch.bool, device=tkey.device)
    torn = bern_u32(k_torn, p_to_u32(cfg.torn_tail_prob), (n,))
    extra = threefry.randint(k_span, (n,), 1, cfg.lost_suffix_span + 1)
    return fire, torch.where(torn, extra, 0).to(torch.int32)


def genome_at(genome, now, seg_len: int):
    """The segment of a `[B, S]` genome active at tick `now` (an int, or a
    [B] tensor of per-row ticks): each leaf's column clip(now // seg_len, 0,
    S - 1), so the final segment holds past the program's end. Returns the
    genome with [B] leaves."""
    s_count = genome.drop.shape[-1]
    if isinstance(now, torch.Tensor):
        seg = (now // seg_len).clamp(0, s_count - 1).long()[:, None]
        return type(genome)(*(leaf.gather(-1, seg)[:, 0] for leaf in genome))
    seg = min(max(now // seg_len, 0), s_count - 1)
    return type(genome)(*(leaf[..., seg] for leaf in genome))


def _cadence(interval: torch.Tensor, now) -> torch.Tensor:
    """[B] bool: a per-cluster cadence `interval` (0 = off) fires at `now`."""
    return (interval > 0) & (now % interval.clamp(min=1) == 0)


def _genome_inputs(cfg: RaftConfig, keys, k_part, tkey, k_drop, k_skew, now, g):
    """The scenario path's per-cluster draws (`g`: the genome's [B] leaves at
    `now`, an int or a [B] tensor): (deliver, skew, client_cmd, alive,
    restarted, reconfig_cmd, transfer_cmd, read_cmd, fsync_fire, torn_drop),
    then the liveness at now - 1 and the partition's cut edges, which the
    trace plane's fault facts reuse."""
    n = cfg.n_nodes
    nil = torch.full(g.drop.shape, NIL, dtype=torch.int32, device=keys.device)
    cut = _partition_cut(n, k_part, now, g.part_period, g.part)
    deliver = ~bern_u32(k_drop, g.drop[:, None, None], (n, n)) & ~cut
    skew = _skew_draw(n, k_skew, g.skew[:, None])
    client_cmd = torch.where(_cadence(g.client_interval, now), now + 1, nil)
    ckey = crash_key(keys)
    alive = _alive_at_t(cfg, ckey, now, g.crash, g.crash_down)
    # The restart edge reads both ticks under the segment active at `now`.
    alive_prev = _alive_at_t(cfg, ckey, now - 1, g.crash, g.crash_down)
    restarted = alive & ~alive_prev
    k_rcfg, k_xfer = threefry.split(threefry.fold_in(tkey, 5), 2).unbind(dim=-2)
    reconfig_cmd = torch.where(_cadence(g.reconfig_interval, now) & (now > 0),
                               threefry.randint(k_rcfg, (), 0, n), nil)
    transfer_cmd = torch.where(_cadence(g.transfer_interval, now) & (now > 0),
                               threefry.randint(k_xfer, (), 0, n), nil)
    read_cmd = torch.where(_cadence(g.read_interval, now), 1, nil).to(torch.int32)
    k_jit, k_torn, k_span = threefry.split(threefry.fold_in(tkey, 7), 3).unbind(dim=-2)
    stall = bern_u32(k_jit, g.fsync_jitter[:, None], (n,))
    fsync_fire = _cadence(g.fsync_interval, now)[:, None] & ~stall
    torn = bern_u32(k_torn, g.torn[:, None], (n,))
    extra = threefry.randint(k_span, (n,), 1, g.torn_span[:, None] + 1)
    torn_drop = torch.where(torn, extra, 0).to(torch.int32)
    return (deliver, skew, client_cmd, alive, restarted, reconfig_cmd, transfer_cmd, read_cmd,
            fsync_fire, torn_drop), (alive_prev, cut)


def _count_cut(cut: torch.Tensor, now) -> torch.Tensor:
    """[B] int32 edges of a [B, N, N] cut plane at tick `now` (an int or a [B]
    tensor), 0 before tick 0: window -1's layout is no partition onset."""
    count = cut.sum(dim=(-2, -1), dtype=torch.int32)
    if isinstance(now, torch.Tensor):
        return torch.where(now >= 0, count, 0)
    return count if now >= 0 else torch.zeros_like(count)


def _cut_count(n: int, k_part: torch.Tensor, now, period, part_t) -> torch.Tensor:
    """[B] int32 edges cut by the rolling partition at tick `now`."""
    return _count_cut(_partition_cut(n, k_part, now, period, part_t), now)


def trace_fault_inputs(cfg: RaftConfig, keys: torch.Tensor, now, genome=None,
                       seg_len: int = 1):
    """(crashed [B, N] bool, cut_now [B] int32, cut_prev [B] int32): the fault
    facts event extraction (trace/events.py) needs that StepInputs does not
    carry -- the crash edge (down now, up the tick before) and the partition's
    cut-edge counts at `now` and `now - 1` -- from the same key streams and
    draws as `make_inputs` (`make_inputs(..., facts=True)` returns both). On
    the genome path both ticks read the segment active at `now`."""
    return make_inputs(cfg, keys, now, genome=genome, seg_len=seg_len, facts=True)[1]


def draw_span(cfg: RaftConfig, keys: torch.Tensor, t0: int, n_ticks: int, genome,
              seg_len: int = 1, facts: bool = False):
    """The scenario-path inputs of ticks t0 .. t0 + n_ticks - 1 for the
    clusters keyed by `keys` ([B, 2]) under `genome` ([B, S]), drawn in one
    call with a row per (tick, cluster): each leaf [n_ticks, B, ...], row t
    equal to `make_inputs(cfg, keys, t0 + t, genome, seg_len)`. A replay of a
    few clusters is launch-bound per call, so a span of ticks costs about
    what one tick does. With `facts`, returns (inputs, fault facts), the facts
    `trace_fault_inputs`'s drawn the same way."""
    b = keys.shape[0]
    now = torch.arange(t0, t0 + n_ticks, dtype=torch.int32, device=keys.device)
    rows = lambda x: x.repeat((n_ticks,) + (1,) * (x.dim() - 1))  # noqa: E731
    out = make_inputs(cfg, rows(keys), now.repeat_interleave(b),
                      genome=type(genome)(*(rows(leaf) for leaf in genome)), seg_len=seg_len,
                      facts=facts)
    split = lambda x: x.reshape((n_ticks, b) + tuple(x.shape[1:]))  # noqa: E731
    if not facts:
        return StepInputs(*(split(x) for x in out))
    return StepInputs(*(split(x) for x in out[0])), tuple(split(x) for x in out[1])


def _uniform_rate(cfg: RaftConfig, k_rate: torch.Tensor) -> torch.Tensor:
    base = min(p_to_u32(cfg.drop_prob), (1 << 32) - 2)
    return threefry.bits(k_rate, ()) % (base + 1)


def uniform_drop_rate(cfg: RaftConfig, keys: torch.Tensor) -> torch.Tensor:
    """[B] int64: each cluster's hidden drop threshold under
    drop_prob_uniform (uniform in [0, p_to_u32(drop_prob)], drawn once a
    run from the cluster's rate key), as `make_inputs` draws it."""
    return _uniform_rate(cfg, threefry.split(keys, 3).unbind(dim=-2)[1])


def make_inputs(cfg: RaftConfig, keys: torch.Tensor, now: int, genome=None,
                seg_len: int = 1, facts: bool = False):
    """Inputs at tick `now` for the clusters keyed by `keys` ([B, 2]), batch-
    leading ([B, ...]) like `jax.vmap(make_inputs)`. All clusters run in
    lockstep, so `now` is one host int. `genome` (a ScenarioGenome with
    [B, S] leaves on the keys' device) switches to the scenario path, each
    segment `seg_len` ticks long; there `now` may also be a [B] int32 tensor
    of per-row ticks (`draw_span`: many ticks of one fleet in one call).
    With `facts`, returns (StepInputs, fault facts): `trace_fault_inputs`'s
    (crashed, cut_now, cut_prev), from the liveness and cut draws the inputs
    already make (the JAX program shares them the same way)."""
    n = cfg.n_nodes
    bsz = keys.shape[0]
    dev = keys.device
    k_ticks, k_rate, k_part = threefry.split(keys, 3).unbind(dim=-2)
    tkey = threefry.fold_in(k_ticks, now)
    k_drop, k_timeout, k_skew = threefry.split(tkey, 3).unbind(dim=-2)

    timeout_draw = draw_timeouts(cfg, k_timeout, n)
    if cfg.client_redirect:
        client_target, client_bounce = _client_routing(cfg, tkey)
    else:
        client_target = torch.zeros((bsz,), dtype=torch.int32, device=dev)
        client_bounce = torch.zeros((bsz, cfg.client_pipeline), dtype=torch.int32, device=dev)
    if genome is None and isinstance(now, torch.Tensor):
        raise TypeError("make_inputs: per-row ticks are taken on the scenario path only")
    if genome is not None:
        g = genome_at(genome, now, seg_len)
        ((deliver, skew, client_cmd, alive, restarted, reconfig_cmd, transfer_cmd, read_cmd,
          fsync_fire, torn_drop), (alive_prev, cut)) = _genome_inputs(
            cfg, keys, k_part, tkey, k_drop, k_skew, now, g)
        inp = StepInputs(
            deliver_mask=_mask(cfg, deliver), skew=skew, timeout_draw=timeout_draw,
            client_cmd=client_cmd, client_target=client_target, client_bounce=client_bounce,
            alive=alive, restarted=restarted, reconfig_cmd=reconfig_cmd,
            transfer_cmd=transfer_cmd, read_cmd=read_cmd, fsync_fire=fsync_fire,
            torn_drop=torn_drop,
        )
        if not facts:
            return inp
        return inp, (alive_prev & ~alive, _count_cut(cut, now),
                     _cut_count(n, k_part, now - 1, g.part_period, g.part))

    if cfg.drop_prob > 0:
        if cfg.drop_prob_uniform:
            p_t = _uniform_rate(cfg, k_rate)[:, None, None]
        else:
            p_t = p_to_u32(cfg.drop_prob)
        deliver = ~bern_u32(k_drop, p_t, (n, n))
    else:
        deliver = torch.ones((bsz, n, n), dtype=torch.bool, device=dev)
    zero = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    cut_now = cut_prev = zero
    if cfg.partition_period > 0:
        part_t = p_to_u32(cfg.partition_prob)
        cut = _partition_cut(n, k_part, now, cfg.partition_period, part_t)
        deliver = deliver & ~cut
        if facts:
            cut_now = _count_cut(cut, now)
            cut_prev = _cut_count(n, k_part, now - 1, cfg.partition_period, part_t)

    if cfg.clock_skew_prob > 0:
        skew = _skew_draw(n, k_skew, p_to_u32(cfg.clock_skew_prob))
    else:
        skew = torch.ones((bsz, n), dtype=torch.int32, device=dev)

    ci = cfg.client_interval
    cmd = now + 1 if ci > 0 and now % ci == 0 else NIL

    if cfg.crash_prob > 0:
        ckey = crash_key(keys)
        alive = alive_at(cfg, ckey, now)
        alive_prev = alive_at(cfg, ckey, now - 1)
        restarted, crashed = alive & ~alive_prev, alive_prev & ~alive
    else:
        alive = torch.ones((bsz, n), dtype=torch.bool, device=dev)
        restarted = crashed = torch.zeros((bsz, n), dtype=torch.bool, device=dev)

    reconfig_cmd, transfer_cmd, read_cmd = _admin_cmds(cfg, tkey, now)
    fsync_fire, torn_drop = _storage_draws(cfg, tkey, now)

    def full(shape, value, dtype=torch.int32):
        return torch.full((bsz,) + shape, value, dtype=dtype, device=dev)

    inp = StepInputs(
        deliver_mask=_mask(cfg, deliver),
        skew=skew,
        timeout_draw=timeout_draw,
        client_cmd=full((), cmd),
        client_target=client_target,
        client_bounce=client_bounce,
        alive=alive,
        restarted=restarted,
        reconfig_cmd=reconfig_cmd,
        transfer_cmd=transfer_cmd,
        read_cmd=read_cmd,
        fsync_fire=fsync_fire,
        torn_drop=torn_drop,
    )
    return (inp, (crashed, cut_now, cut_prev)) if facts else inp
