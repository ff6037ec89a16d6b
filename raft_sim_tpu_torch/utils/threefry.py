"""The parts of `jax.random` the main path calls, under partitionable threefry2x32.

The JAX package pins the partitionable key derivation
(raft_sim_tpu/__init__.py sets `jax_threefry_partitionable`), and bit parity
with it needs the same streams, so the port computes them itself:

  key(seed)            raw key (0, seed mod 2^32) -- threefry_seed of an int32 seed
  fold_in(k, d)        threefry2x32(k, (0, uint32(d)))
  split(k, n)[i]       threefry2x32(k, (0, i))  (the fold-like split: split(k, n)[i]
                       == fold_in(k, i), prefix-stable in n)
  bits(k, shape)       bits1 ^ bits2 of threefry2x32(k, (hi, lo)) over the flat
                       row-major position hi:lo of each element (iota_2x32_shape)
  randint(k, shape, lo, hi)
                       jax's two-draw algorithm (int or per-key tensor
                       bounds): split(k) -> two bits draws,
                       offset = (higher % span * multiplier + lower % span) % span
                       with multiplier = ((2^16 % span)^2 mod 2^32) % span, all
                       wrapping uint32

A key is a `[..., 2]` int64 tensor holding two uint32 words; every function is
vectorised over the leading `...` batch of keys (the key for cluster b is row b)
and returns draws of shape `[..., *shape]`. uint32 words ride int64 with explicit
masking, because torch's CPU uint32 lacks add/lt/rshift; the returned bits are
int64 values in [0, 2^32), so unsigned compares against thresholds are plain
compares.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 block (jax/_src/prng.py
    `_threefry2x32_lowering`). All operands int64 in [0, 2^32), broadcastable;
    returns the two output words."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & MASK32)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.key(seed)` as raw words: the seed rides int32, so the high
    word is 0 and the low word is the seed's uint32 bit pattern."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)` with `data` taken as uint32 (a Python int
    or an integer tensor broadcastable to k's batch shape)."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & MASK32
    else:
        d = torch.tensor(int(data) & MASK32, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(k, n)`: `[..., 2]` keys -> `[..., n, 2]`."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    b1, b2 = threefry2x32(
        k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i
    )
    return torch.stack([b1, b2], dim=-1)


def bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """`jax.random.bits(k, shape, uint32)`: int64 values in [0, 2^32)."""
    shape = tuple(shape)
    size = math.prod(shape)
    pos = torch.arange(size, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(lead + (1,))
    k2 = k[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, pos >> 32, pos & MASK32)
    return (b1 ^ b2).reshape(lead + shape)


def randint(k: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """`jax.random.randint(k, shape, minval, maxval, int32)`: the
    split-then-two-draws algorithm, wrapping uint32. The bounds are Python
    ints inside int32, or integer tensors broadcastable against the draws (a
    per-key bound of the scenario path, as JAX takes traced bounds)."""
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        lo = torch.as_tensor(minval, dtype=torch.int64, device=k.device)
        hi = torch.as_tensor(maxval, dtype=torch.int64, device=k.device)
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi - lo))
    else:
        lo = minval
        span = maxval - minval if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span  # the square wraps, as uint32
    k_hi, k_lo = split(k, 2).unbind(dim=-2)
    higher = bits(k_hi, shape)
    lower = bits(k_lo, shape)
    off = ((higher % span) * multiplier + lower % span) & MASK32
    return (off % span + lo).to(torch.int32)
