"""The port's storage-plane rules (raft_sim_tpu_torch/storage/plane.py)
against the JAX package's `storage.plane`, elementwise on random batch-minor
[N, B] inputs: restarts and torn spans of every size (past the log too), NIL
votes on both sides, watermarks at and below the log.

Tolerance: exact equality (value, dtype, shape) -- the rules are integer
selects.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.storage import plane as jplane
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.storage import plane as tplane
from raft_sim_tpu_torch.utils import config as tconfig


def _inputs(n, b, seed):
    rng = np.random.default_rng(seed)
    i32 = lambda lo, hi: rng.integers(lo, hi, (n, b)).astype(np.int32)  # noqa: E731
    log_len = i32(0, 17)
    term = i32(1, 6)
    return {
        "rs": rng.random((n, b)) < 0.5,
        "fire": rng.random((n, b)) < 0.5,
        "torn": i32(0, 20),  # may exceed the log
        "log_len": log_len,
        "dur_len": np.minimum(i32(0, 17), log_len),
        "dur_mid": np.minimum(i32(0, 17), log_len),
        "term": term,
        "dur_term": np.minimum(i32(1, 6), term),
        "vote": i32(-1, n),  # -1 is NIL
        "dur_vote": i32(-1, n),
    }


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _same(want, got):
    assert bridge.first_difference({"x": np.asarray(want)}, {"x": got}) is None


@pytest.mark.parametrize("n,b,seed", [(5, 64, 0), (31, 16, 1), (33, 16, 2)])
def test_plane_helpers_match_jax(n, b, seed):
    x = {k: _both(v) for k, v in _inputs(n, b, seed).items()}
    j = {k: v[0] for k, v in x.items()}
    t = {k: v[1] for k, v in x.items()}
    _same(jplane.recovered_log_len(j["dur_len"], j["log_len"], j["torn"]),
          tplane.recovered_log_len(t["dur_len"], t["log_len"], t["torn"]))
    jcfg = rst.RaftConfig(n_nodes=n, fsync_interval=3)
    tcfg = tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    args = ("rs", "torn", "dur_len", "dur_term", "dur_vote", "term", "vote", "log_len")
    for w, g in zip(jplane.recover(jcfg, *(j[a] for a in args)),
                    tplane.recover(tcfg, *(t[a] for a in args))):
        _same(w, g)
    args = ("dur_term", "dur_vote", "term", "vote")
    want = jplane.covered(*(j[a] for a in args))
    got = tplane.covered(*(t[a] for a in args))
    _same(want, got)
    # Both outcomes and a NIL-vote row occurred, so every branch was compared.
    assert got.any() and (~got).any() and (t["vote"] == -1).any()
    args = ("fire", "dur_mid", "dur_term", "dur_vote", "log_len", "term", "vote")
    for w, g in zip(jplane.flush(*(j[a] for a in args)), tplane.flush(*(t[a] for a in args))):
        _same(w, g)


def test_covered_never_covers_a_nil_vote():
    nil = torch.full((4, 3), -1, dtype=torch.int32)
    term = torch.ones((4, 3), dtype=torch.int32)
    assert not tplane.covered(term, nil, term, nil).any()
