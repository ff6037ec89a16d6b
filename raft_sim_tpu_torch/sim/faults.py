"""Per-tick input generation, as pure data (the port of the scalar-config path
of raft_sim_tpu/sim/faults.py `make_inputs`).

Everything is a function of (cluster key, tick), drawn from the same threefry
streams as the JAX package (utils/threefry.py), so `make_inputs` here equals
`jax.vmap(faults.make_inputs)` leaf for leaf. Bernoulli events are uint32
threshold compares (`bits < threshold`, unsigned): draws are int64 values in
[0, 2^32), so a plain compare is the unsigned one.

Ported: message drop (with the per-cluster uniform rate), rolling partitions,
clock skew, election-timeout draws and the direct client's cadence. Gated-off
fields come out exactly as the JAX function emits them (zeros / NIL). Crash
schedules (`alive_at`), the redirect client's routing draws, the
reconfiguration plane's admin commands and the storage plane's draws are later
slices; a config that turns one on raises NotImplementedError naming it.
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


def unsupported_input_gates(cfg: RaftConfig) -> list[str]:
    """Input mechanisms of `cfg` this slice does not draw yet."""
    gates = []
    if cfg.crash_prob > 0:
        gates.append("crash_prob (alive_at)")
    if cfg.client_redirect:
        gates.append("client_redirect")
    if cfg.reconfig:
        gates.append("reconfig")
    if cfg.leader_transfer:
        gates.append("transfer")
    if cfg.read_index:
        gates.append("reads")
    if cfg.durable_storage:
        gates.append("durable_storage")
    if cfg.compact_planes:
        gates.append("compact_planes")
    return gates


def _partition_cut(n: int, k_part: torch.Tensor, now: int, period: int, part_t: int):
    """[B, N, N] bool: edges cut by the rolling partition this tick."""
    window = now // max(period, 1)
    wkey = threefry.fold_in(k_part, window)
    k_group, k_active = threefry.split(wkey, 2).unbind(dim=-2)
    group = bern_u32(k_group, HALF_U32, (n,))  # [B, N]
    active = bern_u32(k_active, part_t) & (period > 0)  # [B]
    same_side = group[:, :, None] == group[:, None, :]
    return ~same_side & active[:, None, None]


def _skew_draw(n: int, k_skew: torch.Tensor, skew_t: int) -> torch.Tensor:
    """[B, N] int32 clock increments: 0 below skew_t >> 1, 2 below skew_t, else 1."""
    r = threefry.bits(k_skew, (n,))
    one = torch.ones_like(r)
    return torch.where(
        r < (skew_t >> 1), 0 * one, torch.where(r < skew_t, 2 * one, one)
    ).to(torch.int32)


def make_inputs(cfg: RaftConfig, keys: torch.Tensor, now: int) -> StepInputs:
    """Inputs at tick `now` for the clusters keyed by `keys` ([B, 2]), batch-
    leading ([B, ...]) like `jax.vmap(make_inputs)`. All clusters run in
    lockstep, so `now` is one host int."""
    gates = unsupported_input_gates(cfg)
    if gates:
        raise NotImplementedError(
            f"make_inputs does not support {', '.join(gates)} yet"
        )
    n = cfg.n_nodes
    bsz = keys.shape[0]
    dev = keys.device
    k_ticks, k_rate, k_part = threefry.split(keys, 3).unbind(dim=-2)
    tkey = threefry.fold_in(k_ticks, now)
    k_drop, k_timeout, k_skew = threefry.split(tkey, 3).unbind(dim=-2)

    timeout_draw = draw_timeouts(cfg, k_timeout, n)

    if cfg.drop_prob > 0:
        if cfg.drop_prob_uniform:
            base = min(p_to_u32(cfg.drop_prob), (1 << 32) - 2)
            p_t = (threefry.bits(k_rate, ()) % (base + 1))[:, None, None]
        else:
            p_t = p_to_u32(cfg.drop_prob)
        deliver = ~bern_u32(k_drop, p_t, (n, n))
    else:
        deliver = torch.ones((bsz, n, n), dtype=torch.bool, device=dev)
    if cfg.partition_period > 0:
        deliver = deliver & ~_partition_cut(
            n, k_part, now, cfg.partition_period, p_to_u32(cfg.partition_prob)
        )

    if cfg.clock_skew_prob > 0:
        skew = _skew_draw(n, k_skew, p_to_u32(cfg.clock_skew_prob))
    else:
        skew = torch.ones((bsz, n), dtype=torch.int32, device=dev)

    ci = cfg.client_interval
    cmd = now + 1 if ci > 0 and now % ci == 0 else NIL

    def full(shape, value, dtype=torch.int32):
        return torch.full((bsz,) + shape, value, dtype=dtype, device=dev)

    return StepInputs(
        deliver_mask=bitplane.pack(deliver, axis=2),
        skew=skew,
        timeout_draw=timeout_draw,
        client_cmd=full((), cmd),
        client_target=full((), 0),
        client_bounce=full((cfg.client_pipeline,), 0),
        alive=full((n,), True, torch.bool),
        restarted=full((n,), False, torch.bool),
        reconfig_cmd=full((), NIL),
        transfer_cmd=full((), NIL),
        read_cmd=full((), NIL),
        fsync_fire=full((n,), False, torch.bool),
        torn_drop=full((n,), 0),
    )
