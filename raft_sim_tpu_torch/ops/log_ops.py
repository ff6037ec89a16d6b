"""Fixed-capacity replicated-log ops, batch-minor prefix and ring forms.

The port of the batch-minor half of raft_sim_tpu/ops/log_ops.py: a log is
`[N, CAP, B]` terms/values plus `[N, B]` lengths, 1-based entry i at slot
i-1, index 0 meaning "no entry". Under compaction (the `_rb` ring forms) entry
i lives at slot (i - 1) mod CAP, the live entries are (log_base, log_len], and
entries at or below log_base exist only as (log_base, base_term, base_chk).
The JAX forms are one-hot compare-and-reduce passes (TPU gathers along the
lane axis serialize); these are gathers with the same values, including the
out-of-range conventions each JAX form documents. `%` is floor modulo on both
sides, as in JAX.

Checksums wrap mod 2^32: they are computed in int64 with masking and returned
as int32-carried uint32 bit patterns (ops/bitplane.py `i32`).
"""

from __future__ import annotations

import torch

from raft_sim_tpu_torch.ops.bitplane import MASK32, i32


def iota(shape, d, device="cpu") -> torch.Tensor:
    """int32 iota of `shape` counting along axis `d`."""
    n = shape[d]
    view = [1] * len(shape)
    view[d] = n
    return torch.arange(n, dtype=torch.int32, device=device).reshape(view).expand(shape)


def term_at_b(log_term: torch.Tensor, index1: torch.Tensor) -> torch.Tensor:
    """Term of the 1-based `index1`-th entry. log_term [N, CAP, B]; index1
    [N, B] -> [N, B]. 0 where index1 is 0, negative or above CAP (the one-hot
    form matches no slot there)."""
    cap = log_term.shape[1]
    idx = (index1.to(torch.int64) - 1).clamp(0, cap - 1)
    got = torch.gather(log_term, 1, idx[:, None, :]).squeeze(1)
    ok = (index1 >= 1) & (index1 <= cap)
    return torch.where(ok, got, torch.zeros_like(got))


def last_index_term_b(log_term: torch.Tensor, log_len: torch.Tensor):
    """(last 1-based index, its term) per node. log_len [N, B]."""
    return log_len, term_at_b(log_term, log_len)


def window_b(arr: torch.Tensor, start0: torch.Tensor, e: int) -> torch.Tensor:
    """out[n, k, b] = arr[n, clip(start0[n, b] + k, 0, CAP-1), b].
    arr [N, CAP, B]; start0 [N, B] -> [N, E, B]."""
    cap = arr.shape[1]
    ks = torch.arange(e, dtype=torch.int64, device=arr.device)[None, :, None]
    pos = (start0.to(torch.int64)[:, None, :] + ks).clamp(0, cap - 1)
    return torch.gather(arr, 1, pos)


def write_window_b(arr, start0, vals, gate, count) -> torch.Tensor:
    """Where gate[n, b]: arr[n, start0 + k, b] = vals[n, k, b] for
    k < min(count, E); writes past CAP drop. arr [N, CAP, B]; vals [N, E, B];
    start0/gate/count [N, B]. Returns a new tensor."""
    cap = arr.shape[1]
    e = vals.shape[1]
    cnt = torch.where(gate, count, torch.zeros_like(count)).clamp(max=e).to(torch.int64)
    s0 = start0.to(torch.int64)[:, None, :]
    cs = torch.arange(cap, dtype=torch.int64, device=arr.device)[None, :, None]
    hit = (cs >= s0) & (cs < s0 + cnt[:, None, :])
    rel = (cs - s0).clamp(0, e - 1).expand(arr.shape)
    val = torch.gather(vals, 1, rel).to(arr.dtype)
    return torch.where(hit, val, arr)


def chk_weights_at(abs0: torch.Tensor):
    """Odd uint32 mixing weights (terms, values) for absolute 0-based entry
    indices, as int64 values in [0, 2^32)."""
    a = abs0.to(torch.int64) & MASK32
    w_term = ((a * 2654435761 + 0x9E3779B9) & MASK32) | 1
    w_val = ((a * 0x85EBCA77 + 0xC2B2AE3D) & MASK32) | 1
    return w_term, w_val


def chk_weights(cap: int, device="cpu"):
    """Per-slot weights for the prefix layout (slot k holds entry k)."""
    return chk_weights_at(torch.arange(cap, dtype=torch.int64, device=device))


def prefix_chk2_b(log_term, log_val, upto_a, upto_b):
    """Checksums of the prefixes below 1-based counts `upto_a` and `upto_b`, in
    one pass. log_term/log_val [N, CAP, B]; upto_* [N, B] -> (int32, int32)
    uint32 bit patterns [N, B]."""
    cap = log_term.shape[1]
    w_t, w_v = chk_weights(cap, log_term.device)
    contrib = (
        (log_term.to(torch.int64) & MASK32) * w_t[None, :, None]
        + (log_val.to(torch.int64) & MASK32) * w_v[None, :, None]
    ) & MASK32
    ks = torch.arange(cap, dtype=torch.int64, device=log_term.device)[None, :, None]
    z = torch.zeros((), dtype=torch.int64, device=log_term.device)
    in_a = ks < upto_a.to(torch.int64)[:, None, :]
    in_b = ks < upto_b.to(torch.int64)[:, None, :]
    return (
        i32(torch.where(in_a, contrib, z).sum(1)),
        i32(torch.where(in_b, contrib, z).sum(1)),
    )


def term_at_rb(log_term, base, base_term, index1) -> torch.Tensor:
    """Ring term_at. log_term [N, CAP, B]; base/base_term/index1 [N, B] ->
    [N, B]: 0 for index1 == 0, base_term for index1 <= base (the compacted
    prefix), else the term at slot (index1 - 1) mod CAP."""
    cap = log_term.shape[1]
    idx = (index1.to(torch.int64) - 1) % cap
    got = torch.gather(log_term, 1, idx[:, None, :]).squeeze(1)
    return torch.where(
        index1 == 0, torch.zeros_like(got), torch.where(index1 <= base, base_term, got)
    )


def window_rb(arr: torch.Tensor, start0: torch.Tensor, e: int) -> torch.Tensor:
    """Ring window: out[n, k, b] = arr[n, (start0[n, b] + k) mod CAP, b].
    arr [N, CAP, B]; start0 [N, B] -> [N, E, B]."""
    cap = arr.shape[1]
    ks = torch.arange(e, dtype=torch.int64, device=arr.device)[None, :, None]
    return torch.gather(arr, 1, (start0.to(torch.int64)[:, None, :] + ks) % cap)


def write_window_rb(arr, start0, vals, gate, lo, count) -> torch.Tensor:
    """Where gate[n, b]: vals[n, k, b] -> arr[n, (start0 + k) mod CAP, b] for
    lo <= k < min(count, E). The `lo` bound skips shipped entries at or below
    the receiver's log_base. arr [N, CAP, B]; vals [N, E, B]; start0/gate/lo/
    count [N, B]. Returns a new tensor."""
    cap = arr.shape[1]
    e = vals.shape[1]
    cnt = torch.where(gate, count, torch.zeros_like(count)).clamp(max=e).to(torch.int64)
    lo = lo.clamp(0, e).to(torch.int64)
    cs = torch.arange(cap, dtype=torch.int64, device=arr.device)[None, :, None]
    rel = (cs - start0.to(torch.int64)[:, None, :]) % cap  # the slot's window offset
    hit = (rel >= lo[:, None, :]) & (rel < cnt[:, None, :])
    val = torch.gather(vals, 1, rel.clamp(max=e - 1).expand(arr.shape)).to(arr.dtype)
    return torch.where(hit, val, arr)


def ring_contrib(log_term, log_val, base):
    """(abs0, contrib): the 0-based absolute entry index of each ring slot,
    and the slot's checksum term at that index, as int64 in [0, 2^32).
    log_term/log_val [N, CAP, B]; base [N, B] -> two [N, CAP, B]."""
    cap = log_term.shape[1]
    s = torch.arange(cap, dtype=torch.int64, device=log_term.device)[None, :, None]
    b64 = base.to(torch.int64)[:, None, :]
    abs0 = b64 + (s - b64) % cap
    w_t, w_v = chk_weights_at(abs0)
    contrib = (
        (log_term.to(torch.int64) & MASK32) * w_t + (log_val.to(torch.int64) & MASK32) * w_v
    ) & MASK32
    return abs0, contrib


def ring_chk_b(log_term, log_val, base, uptos):
    """Checksums over the live ring entries (base, upto] for each upto in
    `uptos`, weighted by absolute entry index (the ring form of prefix_chk2_b;
    equal to it for base == 0). log_term/log_val [N, CAP, B]; base and each
    upto [N, B] -> a tuple of int32-carried uint32 [N, B]."""
    abs0, contrib = ring_contrib(log_term, log_val, base)
    z = torch.zeros((), dtype=torch.int64, device=log_term.device)
    return tuple(
        i32(torch.where(abs0 < u.to(torch.int64)[:, None, :], contrib, z).sum(1)) for u in uptos
    )


def log2_bin(v: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Elementwise floor(log2(v)) clamped to [0, n_bins); v in {0, 1} -> 0."""
    bl = torch.zeros_like(v)
    for sft in (16, 8, 4, 2, 1):
        m_ = v >= (1 << sft)
        bl = bl + m_.to(v.dtype) * sft
        v = torch.where(m_, v >> sft, v)
    return bl.clamp(max=n_bins - 1)
