"""Packed boolean bit-planes: `[..., n, ...] bool` <-> `[..., W, ...]` words.

The port of raft_sim_tpu/ops/bitplane.py. Bit j of word w along the packed
axis holds index `32*w + j`; padding bits of the last word stay zero
(canonical planes), so popcounts are exact.

The JAX package's words are uint32. Here they ride `torch.int32` holding the
same bit patterns (torch's CPU uint32 lacks add/lt/rshift/sum): `u32`/`i32`
convert between that carrier and int64 values in [0, 2^32). `&`, `|`, `^` and
`~` act on the bit patterns identically in either dtype.
"""

from __future__ import annotations

import torch

WORD = 32
MASK32 = 0xFFFFFFFF


def n_words(n: int) -> int:
    """Words needed for an n-bit row: ceil(n / 32)."""
    return -(-n // WORD)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2^32) -> int32 bit patterns."""
    return (((x & MASK32) + 2**31) & MASK32).sub(2**31).to(torch.int32)


def pack(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack bools along `axis` into int32-carried words: n -> ceil(n/32)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    w = n_words(n)
    xm = x.movedim(ax, -1).to(torch.int64)
    pad = w * WORD - n
    if pad:
        xm = torch.constant_pad_nd(xm, (0, pad), 0)  # an int fill: F.pad's is a float
    xm = xm.reshape(xm.shape[:-1] + (w, WORD))
    weights = torch.ones(WORD, dtype=torch.int64, device=x.device) << torch.arange(
        WORD, dtype=torch.int64, device=x.device
    )
    return i32((xm * weights).sum(-1)).movedim(-1, ax)


def unpack(words: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """Inverse of `pack`: words along `axis` -> n bools there."""
    ax = axis % words.ndim
    w = words.shape[ax]
    assert w == n_words(n), f"{w} words cannot hold {n} bits"
    wm = u32(words.movedim(ax, -1))
    sh = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bitsx = ((wm[..., None] >> sh) & 1).reshape(wm.shape[:-1] + (w * WORD,))
    return (bitsx[..., :n] != 0).movedim(-1, ax)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count, elementwise (int32)."""
    sh = torch.arange(WORD, dtype=torch.int64, device=words.device)
    return ((u32(words)[..., None] >> sh) & 1).sum(-1).to(torch.int32)


def count(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row popcount: total set bits along the word axis, int32."""
    return popcount(words).sum(axis % words.ndim).to(torch.int32)


def andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a & ~b. Canonical whenever `a` is canonical."""
    return a & ~b


def full_row(n: int, device="cpu") -> torch.Tensor:
    """[W] words with every valid bit set."""
    return pack(torch.ones((n,), dtype=torch.bool, device=device))


def bit_row(i: int, n: int, device="cpu") -> torch.Tensor:
    """[W] words with only bit `i` set."""
    x = torch.zeros((n,), dtype=torch.bool, device=device)
    x[i] = True
    return pack(x)


def eye(n: int, device="cpu") -> torch.Tensor:
    """[N, W] packed identity: row i holds exactly bit i."""
    return pack(torch.eye(n, dtype=torch.bool, device=device), axis=1)


def one_bit(i: torch.Tensor, n: int) -> torch.Tensor:
    """[W, *i.shape] words with only bit `i` set; out-of-range `i` (the NIL
    sentinel, say) yields the all-zero row."""
    i = i.to(torch.int64)
    w = torch.arange(n_words(n), dtype=torch.int64, device=i.device).reshape(
        (n_words(n),) + (1,) * i.ndim
    )
    hit = (w == torch.div(i, WORD, rounding_mode="floor")) & (i >= 0) & (i < n)
    return torch.where(hit, i32(1 << (i % WORD)), torch.zeros((), dtype=torch.int32, device=i.device))


def set_bit(plane: torch.Tensor, row, col, value: bool = True) -> torch.Tensor:
    """Copy of a [N, W] packed plane with bit `col` of row `row` set (cleared)."""
    out = plane.clone()
    b = i32(torch.tensor(1 << (col % WORD), dtype=torch.int64))
    w = col // WORD
    out[row, w] = (out[row, w] | b) if value else (out[row, w] & ~b)
    return out


def get_bit(plane: torch.Tensor, row, col) -> torch.Tensor:
    """Test bit `col` of `plane[row]` on a [N, W] packed plane -> bool."""
    return ((u32(plane[row, col // WORD]) >> (col % WORD)) & 1) != 0


def np_popcount_u32(arr):
    """Host-side per-word popcount of a numpy array of uint32 words (int32
    bit patterns are taken as their uint32 view): the numpy counterpart of
    `popcount` for exported planes (the sink's coverage rollup, the coverage
    search)."""
    import numpy as np

    a = np.ascontiguousarray(arr)
    if a.dtype == np.int32:
        a = a.view(np.uint32)
    a = a.astype(np.uint32, copy=False)
    bytes_ = a.view(np.uint8).reshape(a.shape + (4,))
    return np.unpackbits(bytes_, axis=-1).sum(axis=-1, dtype=np.int64)
