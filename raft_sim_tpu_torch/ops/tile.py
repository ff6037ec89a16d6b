"""The compacted carry layout (cfg.compact_planes): the port of
raft_sim_tpu/ops/tile.py. Read the JAX module for why the layout exists; this
one restates what it does.

  - "pack" legs: the per-edge value planes (next_index, match_index, ack_age,
    mailbox req_off and resp_kind), flattened row-major over their leading
    (node, node) axes and packed k = 32 // bits values a word, bits sized to
    the leg's config-bounded value range (`pack_width_table`).
  - "flat" legs: already word-packed or narrow-window planes (votes [N, W],
    the mailbox entry windows [N, E]) flattened to one leading axis.

Under compaction next_index and match_index carry absolute unbounded
indices, so they stay dense int32 and the table has no entry for them.

The layout is physical only: the tick unpacks at entry, runs the dense body
and repacks at exit (models/raft_batched.py `step_b`, kernels/tick_engine.py
`step_cuda`), so every trajectory equals the dense layout's. Mailbox legs
whose gate is off pass through verbatim (`pack_state(..., reuse=)`).

Carriers: the JAX words are uint32; here they ride int32 bit patterns, as
every uint32 leg of the port does (types.py). Values are shifted into place
with `<<` (a shift into bit 31 wraps to the same pattern) and read back by
shifting first and masking second: `>>` on int32 is arithmetic, and the bits
kept lie below its sign fill because bits * j + bits <= 32.
`packed_carry_dtypes` names the JAX dtypes, so the numpy edge (bridge.py,
utils/checkpoint.py) knows which legs go back to uint32.

Layout: the functions pack along the leading axis, as JAX does, so a
per-cluster `[M]` leg and a batch-minor `[M, B]` leg pack alike. `lead`
(pack_state, unpack_state) names leading batch axes to skip, for the port's
`[B, ...]`-leading boot state: the words equal JAX's vmapped ones.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_sim_tpu_torch.ops import bitplane
from raft_sim_tpu_torch.utils.config import RaftConfig

WORD = 32
RESP_BITS = 2  # RESP_* is 0..3 (types.py)


def bits_for(n_values: int) -> int:
    """Bits needed to store values 0 .. n_values-1 (>= 1)."""
    return max(1, (n_values - 1).bit_length())


def index_bits(cfg: RaftConfig) -> int:
    """Bits of a packed log-index entry (non-compaction configs only:
    next_index <= cap + 1, match_index <= cap)."""
    return bits_for(cfg.log_capacity + 2)


def age_bits(cfg: RaftConfig) -> int:
    """Bits of a packed ack_age entry (saturates at cfg.ack_age_sat)."""
    return bits_for(cfg.ack_age_sat + 1)


def off_bits(cfg: RaftConfig) -> int:
    """Bits of a packed req_off entry: -1 .. E, stored with a +1 bias."""
    return bits_for(cfg.max_entries_per_rpc + 2)


def pack_width_table(cfg: RaftConfig) -> dict[str, tuple[int, int, int, int]]:
    """field -> (bits, bias, lo, hi) for every bit-packed leg: lo..hi is the
    dense value range, stored = value + bias with 0 <= stored < 2**bits."""
    cap, sat, e = cfg.log_capacity, cfg.ack_age_sat, cfg.max_entries_per_rpc
    table = {}
    if not cfg.compaction:
        table["next_index"] = (index_bits(cfg), 0, 1, cap + 1)
        table["match_index"] = (index_bits(cfg), 0, 0, cap)
    table["ack_age"] = (age_bits(cfg), 0, 0, sat)
    table["mb.req_off"] = (off_bits(cfg), 1, -1, e)
    table["mb.resp_kind"] = (RESP_BITS, 0, 0, 3)
    return table


def words_for(m: int, bits: int) -> int:
    """Words holding m packed values at `bits` bits (whole values a word)."""
    return -(-m // (WORD // bits))


def pack_words(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[M, *rest] non-negative ints (< 2**bits) -> [ceil(M/k), *rest] int32
    words (uint32 patterns), k = 32 // bits values a word, value i at word
    i // k, lane (i % k) * bits."""
    k = WORD // bits
    m, rest = x.shape[0], tuple(x.shape[1:])
    w = -(-m // k)
    xu = x.to(torch.int32)
    if w * k > m:
        xu = torch.cat([xu, xu.new_zeros((w * k - m,) + rest)])
    xu = xu.reshape((w, k) + rest)
    out = xu[:, 0].clone()
    for j in range(1, k):
        out |= xu[:, j] << (bits * j)
    return out


def unpack_words(words: torch.Tensor, bits: int, m: int, dtype) -> torch.Tensor:
    """Inverse of `pack_words`: [W, *rest] words -> [m, *rest] `dtype`."""
    k = WORD // bits
    w = words.shape[0]
    assert w == words_for(m, bits), f"{w} words cannot hold {m} x {bits}-bit"
    mask = (1 << bits) - 1
    parts = torch.stack([(words >> (bits * j)) & mask for j in range(k)], dim=1)
    return parts.reshape((w * k,) + tuple(words.shape[1:]))[:m].to(dtype)


def state_plan(cfg: RaftConfig):
    """[(field, mode, lead_shape, bits, bias, dense_dtype)] of the
    ClusterState legs the layout transforms; mode "pack" or "flat"."""
    from raft_sim_tpu_torch import types

    n = cfg.n_nodes
    widths = pack_width_table(cfg)
    plan = [("votes", "flat", (n, bitplane.n_words(n)), 0, 0, torch.int32)]
    if not cfg.compaction:
        idt = types.index_dtype(cfg)
        plan += [
            ("next_index", "pack", (n, n), widths["next_index"][0], 0, idt),
            ("match_index", "pack", (n, n), widths["match_index"][0], 0, idt),
        ]
    plan.append(("ack_age", "pack", (n, n), widths["ack_age"][0], 0, types.ack_dtype(cfg)))
    return plan


def mailbox_plan(cfg: RaftConfig):
    """The Mailbox legs the layout transforms (the `state_plan` tuples)."""
    n, e = cfg.n_nodes, cfg.max_entries_per_rpc
    off, bias = pack_width_table(cfg)["mb.req_off"][:2]
    return [
        ("req_off", "pack", (n, n), off, bias, torch.int8),
        ("resp_kind", "pack", (n, n), RESP_BITS, 0, torch.int8),
        ("ent_term", "flat", (n, e), 0, 0, torch.int32),
        ("ent_val", "flat", (n, e), 0, 0, torch.int32),
        ("ent_tick", "flat", (n, e), 0, 0, torch.int32),
        ("ent_cfg", "flat", (n, e), 0, 0, torch.int32),
    ]


def _mailbox_gates(cfg: RaftConfig) -> dict[str, bool]:
    """Mailbox legs whose gate can be off (then passed through verbatim)."""
    return {"ent_tick": cfg.track_offer_ticks, "ent_cfg": cfg.reconfig}


def packed_carry_dtypes(cfg: RaftConfig) -> dict[str, np.dtype]:
    """Leg name (state bare, mailbox `mb.<f>`) -> its JAX dtype under the
    layout: uint32 for the packed legs and votes, the dense dtype for the
    flat windows. The port carries the uint32 ones as int32 patterns."""
    out = {f: np.dtype(np.uint32) for f, *_ in state_plan(cfg)}
    for f, mode, *_ in mailbox_plan(cfg):  # the flat mailbox windows are int32
        out[f"mb.{f}"] = np.dtype(np.uint32 if mode == "pack" else np.int32)
    return out


def _pack_leg(x, mode, lead_shape, bits, bias, lead):
    flat = x.reshape(tuple(x.shape[:lead]) + (-1,) + tuple(x.shape[lead + len(lead_shape):]))
    if mode == "flat":
        return flat
    if bias:
        flat = flat + bias
    return pack_words(flat.movedim(lead, 0), bits).movedim(0, lead).contiguous()


def _unpack_leg(x, mode, lead_shape, bits, bias, dense_dtype, lead):
    shape = tuple(x.shape[:lead]) + tuple(lead_shape) + tuple(x.shape[lead + 1:])
    if mode == "flat":
        return x.reshape(shape).to(dense_dtype)
    m = int(np.prod(lead_shape))
    vals = unpack_words(x.movedim(lead, 0), bits, m, torch.int32)
    if bias:
        vals = vals - bias
    return vals.to(dense_dtype).movedim(0, lead).reshape(shape).contiguous()


def pack_state(cfg: RaftConfig, dense, reuse=None, lead: int = 0):
    """Dense ClusterState -> the compacted carry form. `reuse` (the tick's
    input, compacted) supplies the gated-off mailbox legs verbatim; `lead`
    leading batch axes are skipped."""
    reps = {f: _pack_leg(getattr(dense, f), mode, shape, bits, bias, lead)
            for f, mode, shape, bits, bias, _dt in state_plan(cfg)}
    gates = _mailbox_gates(cfg)
    mb = {}
    for f, mode, shape, bits, bias, _dt in mailbox_plan(cfg):
        if reuse is not None and not gates.get(f, True):
            mb[f] = getattr(reuse.mailbox, f)
        else:
            mb[f] = _pack_leg(getattr(dense.mailbox, f), mode, shape, bits, bias, lead)
    return dense._replace(mailbox=dense.mailbox._replace(**mb), **reps)


def unpack_state(cfg: RaftConfig, s, lead: int = 0):
    """Compacted carry form -> the dense ClusterState (contiguous leaves, as
    the kernel takes them). Exact inverse of `pack_state` for in-range
    values."""
    reps = {f: _unpack_leg(getattr(s, f), mode, shape, bits, bias, dt, lead)
            for f, mode, shape, bits, bias, dt in state_plan(cfg)}
    mb = {f: _unpack_leg(getattr(s.mailbox, f), mode, shape, bits, bias, dt, lead)
          for f, mode, shape, bits, bias, dt in mailbox_plan(cfg)}
    return s._replace(mailbox=s.mailbox._replace(**mb), **reps)


def through_dense(cfg: RaftConfig, s, inp, tick):
    """The layout's boundary around a dense tick (the JAX `step_b`'s):
    `tick(dense_cfg, dense_state, dense_inputs)` on the unpacked view, under
    the config's dense twin, and its new state repacked with the gated-off
    legs of `s`. Returns (packed state, StepInfo)."""
    from raft_sim_tpu_torch import types

    s2, info = tick(types.compact_twin(cfg, on=False), unpack_state(cfg, s),
                    unpack_inputs(cfg, inp))
    return pack_state(cfg, s2, reuse=s), info


def unpack_inputs(cfg: RaftConfig, inp):
    """Compacted StepInputs -> the dense view: the delivery mask ships flat
    ([N*W, ...], sim/faults.py) and reshapes back to the [N, W] word plane."""
    n = cfg.n_nodes
    dm = inp.deliver_mask
    return inp._replace(deliver_mask=dm.reshape((n, bitplane.n_words(n)) + tuple(dm.shape[1:])))
