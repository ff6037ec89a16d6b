"""Log-carried configuration: per-node membership derived from the log prefix
(the port of raft_sim_tpu/models/cfglog.py, batch-minor form only).

Each node's configuration is a function of its own log: `derive` recomputes
(member_old, member_new, cfg_pend, cfg_epoch, cfg_hi) at the end of every
tick from the config-entry plane `log_cfg`, the log bounds and the snapshot
config context (base_mold, base_pend, base_epoch), so applying an entry on
append and rolling it back on truncation are one code path. `fold_span`
advances the snapshot context across a compaction rebase.

Entry encoding: 0 none, +(v+1) a joint entry toggling node v (member_new
diverges, quorums go dual), -(v+1) the final entry completing that toggle
(member_old absorbs it). C_old at the prefix end is base_mold XOR the parity
fold of the final-entry toggles in the live range; the latest live entry's
sign alone decides jointness. Read the JAX module for the reasoning.

Shapes: log_cfg [N, CAP, B]; vectors [N, B]; member rows [N, W, B] packed
words (int32 carriers of the JAX uint32 bit patterns, ops/bitplane.py).

TEST-ONLY mutant hooks (scenario/mutation.py) weaken one rule each:
`act_on_append` off derives from the committed prefix, `joint_consensus` off
makes every entry final at append (the single-server change);
`truncation_rollback` is applied by the caller (models/raft_batched.py).
"""

from __future__ import annotations

import torch

from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.utils.config import RaftConfig

I32 = torch.int32


def _abs1(cfg: RaftConfig, base: torch.Tensor, n: int, cap: int, b: int) -> torch.Tensor:
    """[N, CAP, B] 1-based absolute entry index of each log slot: ring-aware
    under compaction, slot + 1 otherwise."""
    sl = torch.arange(cap, dtype=I32, device=base.device)[None, :, None]
    if cfg.compaction:
        bb = base[:, None, :]
        return bb + (sl - bb) % cap + 1
    return (sl + 1).expand(n, cap, b)


def _one_bit_rows(v: torch.Tensor, n: int) -> torch.Tensor:
    """Packed one-hot rows: v [N, B] -> [N, W, B] (all-zero where v is out
    of [0, n))."""
    return bitplane.one_bit(v, n).movedim(0, 1)


def _fold_core(cfg: RaftConfig, log_cfg, anchor, lo, hi):
    """The masked parity fold over config entries with absolute index in
    (lo, hi], slots anchored at `anchor`. Returns (fold [N, W, B]: XOR of
    the final entries' toggles; hi_idx [N, B]: the latest entry's absolute
    index, 0 when none; code_hi: its command; count: entries in the span)."""
    n, cap = cfg.n_nodes, cfg.log_capacity
    b = log_cfg.shape[-1]
    abs1 = _abs1(cfg, anchor, n, cap, b)
    span = (abs1 > lo[:, None, :]) & (abs1 <= hi[:, None, :])
    code = torch.where(span, log_cfg, 0)
    is_cfg = code != 0
    # Final entries fold into C_old; under the single-server mutant every
    # entry is final.
    fold_mask = (code < 0) if cfg.joint_consensus else is_cfg
    vfold = code.abs() - 1
    tgt = torch.arange(n, dtype=I32, device=log_cfg.device)[None, None, :, None]
    hits = fold_mask[:, :, None, :] & (vfold[:, :, None, :] == tgt)  # [N, CAP, n, B]
    par = (hits.sum(1) % 2) != 0  # [N, n, B]
    fold = bitplane.pack(par, axis=1)
    hi_idx = torch.where(is_cfg, abs1, 0).amax(1)
    code_hi = torch.where(is_cfg & (abs1 == hi_idx[:, None, :]), code, 0).sum(1).to(I32)
    count = is_cfg.sum(1).to(I32)
    return fold, hi_idx, code_hi, count


def derive(cfg: RaftConfig, log_cfg, log_len, base, base_mold, base_pend, base_epoch,
           commit=None):
    """Each node's effective configuration from its log prefix (base, log_len]
    and snapshot context: (member_old, member_new [N, W, B], cfg_pend,
    cfg_epoch, cfg_hi [N, B]). cfg_hi is the latest live config entry's
    index (base when none): the removed-leader stepdown compares commit
    against it. `commit` ([N, B]) is read only by the act-on-commit mutant,
    whose prefix ends at min(commit, log_len)."""
    n = cfg.n_nodes
    horizon = log_len if cfg.act_on_append else torch.minimum(commit, log_len)
    fold, hi, code_hi, count = _fold_core(cfg, log_cfg, base, base, horizon)
    m_old = base_mold ^ fold
    if cfg.joint_consensus:
        has = hi > 0
        # No live entry: the snapshot context rules.
        pend_code = torch.where(has, code_hi, base_pend)
        joint = pend_code > 0
        pend_idx = torch.where(has, hi, base.clamp(min=1))
        m_new = torch.where(joint[:, None, :], m_old ^ _one_bit_rows(pend_code - 1, n), m_old)
        cfg_pend = torch.where(joint, pend_idx, 0)
    else:  # the single-server mutant: never joint
        m_new = m_old
        cfg_pend = torch.zeros_like(hi)
    cfg_epoch = base_epoch + count
    cfg_hi = torch.maximum(hi, base)
    return m_old, m_new, cfg_pend, cfg_epoch, cfg_hi


def fold_span(cfg: RaftConfig, log_cfg, b0, b1, base_mold, base_pend, base_epoch):
    """Advance the snapshot config context across a rebase from b0 to b1:
    fold the entries in (b0, b1] (final toggles into base_mold, the latest
    entry's jointness into base_pend, the count into base_epoch). Slots are
    anchored at b0, the pre-advance base."""
    fold, hi, code_hi, count = _fold_core(cfg, log_cfg, b0, b0, b1)
    if cfg.joint_consensus:
        new_pend = torch.where(hi > 0, torch.where(code_hi > 0, code_hi, 0), base_pend)
    else:  # the single-server mutant: never joint
        new_pend = base_pend
    return base_mold ^ fold, new_pend, base_epoch + count
