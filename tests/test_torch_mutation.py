"""The TEST-ONLY mutant hooks (K1-d) in the port's plain tick, against the JAX
package: raft_sim_tpu_torch/scenario/mutation.py's registry against
raft_sim_tpu/scenario/mutation.py's, and for each of the ten registry names
the port's `step_b` against the JAX `step_b` every tick of a fuzzed
trajectory on a config that makes the hook's plane live (the rows' JAX and
port configs are the same class of mutant). Each row also shows that the hook
fires there (the mutant's trajectory leaves the production one's), and the
storage and read rows that every site of their hook is reached: the three
sites of `durable_acks` (a leader's own slot in the commit quorum, the ack
clamp at the watermark, the late vote response) and both of `read_confirm`
(the confirmation round, the current-term-commit capture gate).

Tolerance: exact equality (value, dtype, shape) of every ClusterState and
StepInfo leaf; the tick is integer-only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.models import raft_batched as jrb
from raft_sim_tpu.scenario import mutation as jmut
from raft_sim_tpu.sim import faults as jfaults
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.scenario import mutation as tmut
from raft_sim_tpu_torch.utils import config as tconfig
from tests.test_torch_cuda import MUTANT_ROWS

torch.set_num_threads(1)

HOOKS = ("joint_consensus", "act_on_append", "truncation_rollback", "read_confirm",
         "xfer_election", "lease_skew_safe", "durable_acks", "persist_vote")

# A config per registry name on which its hook's plane runs and the hook
# fires within the rows' 150 ticks at 8 clusters.
ROWS = MUTANT_ROWS
BATCH, TICKS, SEED = 8, 150, 3


def _hooks_off(cfg) -> dict:
    base = type(cfg).__mro__[-2]  # the package's RaftConfig
    prod = base(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    out = {h: getattr(cfg, h) for h in HOOKS if getattr(cfg, h) != getattr(prod, h)}
    if cfg.quorum != prod.quorum:
        out["quorum"] = cfg.quorum
    return out


def test_registry_matches_jax():
    """The same ten names, each weakening the same rule (the hook it turns
    off, or the quorum) on the same fields."""
    assert list(tmut.MUTANTS) == list(jmut.MUTANTS)
    for name in jmut.MUTANTS:
        jc = jmut.mutant_config(name, rst.RaftConfig(**ROWS[name]))
        tc = tmut.mutant_config(name, tconfig.RaftConfig(**ROWS[name]))
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        assert _hooks_off(tc) == _hooks_off(jc) != {}, name
        assert isinstance(tc, tconfig.RaftConfig) and type(tc).__name__ == type(jc).__name__
    with pytest.raises(ValueError, match="unknown mutant"):
        tmut.mutant_config("no-such-mutant", tconfig.RaftConfig())


def _port_trajectory(cfg, states_in, inputs):
    """The port's plain tick along given inputs from the first given state;
    returns its states."""
    s, out = states_in, []
    for t, inp in enumerate(inputs):
        s, _ = trb.step_b(cfg, s, inp, t)
        out.append(s)
    return out


def _mutant_trajectory(name):
    """Hold the port's step_b to the JAX step_b every tick under mutant
    `name`; returns (port cfg, port initial state, port inputs per tick,
    JAX-equal port states per tick)."""
    jcfg = jmut.mutant_config(name, rst.RaftConfig(**ROWS[name]))
    tcfg = tmut.mutant_config(name, tconfig.RaftConfig(**ROWS[name]))
    rng = np.random.default_rng(SEED)
    st = jrb.to_batch_minor(rst.init_batch(jcfg, jax.random.key(SEED), BATCH))
    keys = jax.random.split(jax.random.key(SEED + 1), BATCH)
    jstep = jax.jit(lambda s, i: jrb.step_b(jcfg, s, i))
    draw = jax.jit(lambda k, now: jrb.to_batch_minor(
        jax.vmap(lambda kk: jfaults.make_inputs(jcfg, kk, now))(k)))
    s0 = bridge.to_port(jax.device_get(st), ttypes.ClusterState)
    inputs, states = [], []
    for t in range(TICKS):
        inp = draw(keys, jnp.int32(t))
        # Crash/restart edges beyond the schedule, so recovery runs often.
        alive = rng.random(inp.alive.shape) >= 0.05
        inp = inp._replace(alive=jnp.asarray(alive),
                           restarted=jnp.asarray(alive & (rng.random(alive.shape) < 0.05)))
        want_s, want_i = jax.device_get(jstep(st, inp))
        s_np, i_np = jax.device_get((st, inp))
        t_inp = bridge.to_port(i_np, ttypes.StepInputs)
        got_s, got_i = trb.step_b(tcfg, bridge.to_port(s_np, ttypes.ClusterState), t_inp, t)
        diff = bridge.first_difference(want_s, got_s) or bridge.first_difference(want_i, got_i)
        assert diff is None, f"{name} tick {t}: {diff}"
        inputs.append(t_inp)
        states.append(got_s)
        st = jstep(st, inp)[0]
    return tcfg, s0, inputs, states


def _sites(cfg, s0, inputs, states) -> dict:
    """How often the production tick reaches each site of the durability
    gate and of ReadIndex confirmation along the trajectory (states before
    and after each tick)."""
    from raft_sim_tpu_torch.types import LEADER, NIL, REQ_VOTE, RESP_VOTE

    out = dict.fromkeys(("self_slot", "ack_clamp", "late_vote", "confirm_wait", "capture_gate"), 0)
    prev = s0
    for t, (inp, new) in enumerate(zip(inputs, states)):
        if cfg.durable_storage:
            lead = (new.role == LEADER) & inp.alive
            out["self_slot"] += int((lead & (new.dur_len < new.log_len)).sum())
            mb = new.mailbox
            held = ((mb.a_ok_to.to(torch.int32) != NIL) & (mb.a_match.to(torch.int32) == new.dur_len)
                    & (new.dur_len < new.log_len))
            out["ack_clamp"] += int(held.sum())
            late = (mb.resp_kind == RESP_VOTE) & (prev.mailbox.req_type != REQ_VOTE)[:, None, :]
            out["late_vote"] += int(late.sum())
        if cfg.read_index:
            lead = (prev.role == LEADER) & inp.alive
            out["confirm_wait"] += int((lead & (prev.read_idx > 0) & (new.read_idx == prev.read_idx)
                                        & (new.role == LEADER)).sum())
            # A read offered to an idle live leader whose commit is not of
            # its term: the capture gate turns it away.
            c = prev.commit_index.clamp(min=1) - 1
            tc = torch.gather(prev.log_term, 1, c[:, None, :].long()).squeeze(1)
            stale = (prev.commit_index == 0) | (tc != prev.term)
            offer = (inp.read_cmd != NIL)[None, :]
            out["capture_gate"] += int((offer & lead & (prev.read_idx == 0) & stale).sum())
        prev = new
    return out


@pytest.mark.parametrize("name", list(jmut.MUTANTS))
def test_plain_step_matches_jax_under_mutant(name):
    tcfg, s0, inputs, states = _mutant_trajectory(name)
    # The hook fires: the production tick on the same inputs leaves the
    # mutant's trajectory.
    prod = tconfig.RaftConfig(**ROWS[name])
    ref = _port_trajectory(prod, s0, inputs)
    assert any(bridge.first_difference(a, b) is not None for a, b in zip(ref, states)), name
    if name == "ack-before-fsync":
        sites = _sites(prod, s0, inputs, ref)
        assert sites["self_slot"] > 0 and sites["ack_clamp"] > 0 and sites["late_vote"] > 0, sites
    if name == "stale-read":
        sites = _sites(prod, s0, inputs, ref)
        assert sites["confirm_wait"] > 0 and sites["capture_gate"] > 0, sites


def test_lease_window_is_the_mutants_bound():
    """lease_skew_safe off widens the lease window to election_min_ticks + 2
    (the kernel gets it as TickParams.lease_ticks)."""
    cfg = tconfig.RaftConfig(**ROWS["lease-skew"])
    assert trb.lease_window(cfg) == cfg.read_lease_ticks
    assert trb.lease_window(tmut.mutant_config("lease-skew", cfg)) == cfg.election_min_ticks + 2
