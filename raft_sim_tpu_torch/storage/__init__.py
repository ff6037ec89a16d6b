"""Durable storage plane: the per-node fsync/WAL model (the port of
raft_sim_tpu/storage). Three rules, stated once in `plane` for the plain tick
and restated in the kernel body (csrc/tick.cuh):

1. Watermarks. Each node carries a durable snapshot of its persistent triple:
   `dur_len` (fsynced log prefix), `dur_term`, `dur_vote`. It advances only
   when the node's flush completes (the fsync cadence minus a jitter stall,
   sim/faults `_storage_draws`), snapping to the node's final live state that
   tick; an AppendEntries truncation clamps `dur_len`.
2. The durability gate (`cfg.durable_acks`). What a node exposes reflects
   durable state only: AppendEntries acks clamp to `dur_len`, a leader's own
   slot in the commit quorum is its durable length, and a vote grant is sent
   once the (term, votedFor) it commits to is durable -- a flush that covers
   it on a later tick sends the withheld RESP_VOTE then.
3. Recovery. A restart rewinds term and vote to the durable snapshot and keeps
   `max(dur_len, log_len - torn_drop)` entries: the fsynced prefix is a floor,
   and a torn tail eats up to `lost_suffix_span` entries of the rest.

Gate: `cfg.durable_storage` (fsync_interval > 0). Off, the legs pass through
and the disk is perfect.
"""

from raft_sim_tpu_torch.storage.plane import (  # noqa: F401
    covered,
    flush,
    recover,
    recovered_log_len,
)
