"""Carry state between the JAX package and the port, through numpy.

The JAX package's pytrees (`ClusterState` with its `mailbox`, `StepInputs`,
`StepInfo`, `RunMetrics`) are NamedTuples; `jax.device_get` turns them into
NamedTuples of numpy arrays. `to_port` builds the port's NamedTuple of the same
field names from any such object (or a dict), on a given device; `to_numpy`
goes back. uint32 legs cross as `.view(np.int32)` / `.view(np.uint32)`, since
the port carries them as int32 bit patterns (types.py); `to_numpy` and
`first_difference` take the names of those legs as `u32` (default
types.U32_LEAVES; `types.u32_leaves(cfg)` adds a compacted carry's packed
legs). Conversion is leaf by
leaf and keeps every shape, so both the batch-leading and the batch-minor
layouts cross unchanged.

`first_difference` compares two such trees leaf by leaf -- dtype, shape and
exact values, nested NamedTuples included (a WindowRecord's metrics, a flight
recorder's ring) -- and names the first differing leaf and index. Nothing here
imports jax: the tests that need both packages hand numpy trees across.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_sim_tpu_torch.types import U32_LEAVES, Mailbox


def _fields(obj):
    if isinstance(obj, dict):
        return obj.items()
    return ((f, getattr(obj, f)) for f in obj._fields)


def _leaf_to_torch(name: str, x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif name in U32_LEAVES and a.dtype != np.int32:
        raise TypeError(f"{name}: expected uint32 or int32, got {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_port(obj, cls, device="cpu"):
    """Build port NamedTuple `cls` from `obj` (NamedTuple or dict of numpy-able
    leaves with the same field names; a `mailbox` field becomes a Mailbox)."""
    vals = dict(_fields(obj))
    out = {}
    for f in cls._fields:
        x = vals[f]
        out[f] = to_port(x, Mailbox, device) if f == "mailbox" else _leaf_to_torch(f, x, device)
    return cls(**out)


def to_numpy(tree, u32=U32_LEAVES):
    """Port NamedTuple -> the same NamedTuple type holding numpy arrays, with
    the uint32 legs (named in `u32`) viewed back as uint32."""
    out = {}
    for f, x in _fields(tree):
        if f == "mailbox":
            out[f] = to_numpy(x, u32)
            continue
        a = x.detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f in u32 else a
    return type(tree)(**out)


def _as_numpy(name, x, u32):
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return a.view(np.uint32) if name in u32 else a
    return np.asarray(x)


def first_difference(a, b, prefix: str = "", u32=U32_LEAVES) -> str | None:
    """None when trees `a` and `b` agree exactly on every leaf (same field
    names, dtypes, shapes and values); else a line naming the first leaf that
    differs and, for values, its first differing index. Leaves may be numpy
    arrays or port tensors (the legs named in `u32` compared as uint32)."""
    fa, fb = dict(_fields(a)), dict(_fields(b))
    if list(fa) != list(fb):
        return f"{prefix or 'tree'}: fields {list(fa)} != {list(fb)}"
    for f in fa:
        name = f"{prefix}.{f}" if prefix else f
        if f == "mailbox" or hasattr(fa[f], "_fields"):
            d = first_difference(fa[f], fb[f], name, u32)
            if d:
                return d
            continue
        x, y = fa[f], fb[f]
        if (
            isinstance(x, torch.Tensor)
            and isinstance(y, torch.Tensor)
            and x.device == y.device
            and x.dtype == y.dtype
            and x.shape == y.shape
            and torch.equal(x, y)
        ):
            continue  # equal where they lie: no copy to the host
        x, y = _as_numpy(f, x, u32), _as_numpy(f, y, u32)
        if x.dtype != y.dtype:
            return f"{name}: dtype {x.dtype} != {y.dtype}"
        if x.shape != y.shape:
            return f"{name}: shape {x.shape} != {y.shape}"
        bad = np.argwhere(x != y)
        if bad.size:
            idx = tuple(int(i) for i in bad[0])
            return f"{name}{list(idx)}: {x[idx]} != {y[idx]} ({len(bad)} differing)"
    return None
