"""The port's log-carried configuration (raft_sim_tpu_torch/models/cfglog.py)
against the JAX package's models/cfglog.py (`derive`, `fold_span`, batch-minor
form), on random config-entry planes made from a numpy seed, at the packed
word boundaries N = 5, 31, 32, 33 (and 64, the kernel's limit), on the plain
log and on the compaction ring.

Tolerance: exact equality (member rows compared as uint32 words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.models import cfglog as jcfglog
from raft_sim_tpu.ops import bitplane as jbp
from raft_sim_tpu_torch.models import cfglog as tcfglog
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)


def _case(n, cap, comp, seed):
    """(JAX cfg, port cfg, numpy leaves) for B=6 clusters: a config plane with
    joint (+) and final (-) entries, zeros and stale slots, live ranges
    (base, log_len] anywhere on the ring, random snapshot contexts."""
    kw = dict(n_nodes=n, log_capacity=cap, reconfig_interval=10, compact_margin=2 if comp else 0)
    rng = np.random.default_rng(seed)
    b = 6
    w = jbp.n_words(n)
    v = rng.integers(0, n, (n, cap, b))
    sign = rng.choice([-1, 0, 0, 1], (n, cap, b))
    log_cfg = (sign * (v + 1)).astype(np.int32)
    if comp:
        base = rng.integers(0, 3 * cap, (n, b)).astype(np.int32)
        log_len = (base + rng.integers(0, cap + 1, (n, b))).astype(np.int32)
    else:
        base = np.zeros((n, b), np.int32)
        log_len = rng.integers(0, cap + 1, (n, b)).astype(np.int32)
    mold = rng.integers(0, 2**32, (n, w, b), dtype=np.uint32)
    if n % 32:  # canonical rows: no bits past n
        mold[:, -1] &= np.uint32((1 << (n % 32)) - 1)
    leaves = dict(
        log_cfg=log_cfg, log_len=log_len, commit=np.minimum(base + 1, log_len).astype(np.int32),
        base=base, base_mold=mold,
        base_pend=(rng.integers(0, n, (n, b)) * rng.integers(0, 2, (n, b))).astype(np.int32),
        base_epoch=rng.integers(0, 9, (n, b)).astype(np.int32),
    )
    return rst.RaftConfig(**kw), tconfig.RaftConfig(**kw), leaves


def _port(leaves):
    return {k: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            for k, a in leaves.items()}


def _check(want, got):
    for k, (x, y) in enumerate(zip(want, got)):
        y = y.numpy()
        x = np.asarray(x)
        np.testing.assert_array_equal(y.view(np.uint32) if x.dtype == np.uint32 else y, x, err_msg=str(k))


@pytest.mark.parametrize("comp", [False, True], ids=["plain", "ring"])
@pytest.mark.parametrize("n", [5, 31, 32, 33, 64])
def test_derive_matches_jax(n, comp):
    jcfg, tcfg, lv = _case(n, 8 if n > 8 else 12, comp, seed=n)
    j = {k: jnp.asarray(a) for k, a in lv.items()}
    want = jcfglog.derive(jcfg, j["log_cfg"], j["log_len"], j["commit"], j["base"],
                          j["base_mold"], j["base_pend"], j["base_epoch"], batched=True)
    t = _port(lv)
    got = tcfglog.derive(tcfg, t["log_cfg"], t["log_len"], t["base"],
                         t["base_mold"], t["base_pend"], t["base_epoch"])
    _check(want, got)
    assert np.asarray(want[2]).any()  # some node's prefix ends joint


@pytest.mark.parametrize("n", [5, 31, 32, 33, 64])
def test_fold_span_matches_jax(n):
    jcfg, tcfg, lv = _case(n, 8 if n > 8 else 12, True, seed=100 + n)
    rng = np.random.default_rng(n)
    b1 = (lv["base"] + rng.integers(0, 5, lv["base"].shape)).astype(np.int32)
    j = {k: jnp.asarray(a) for k, a in lv.items()}
    want = jcfglog.fold_span(jcfg, j["log_cfg"], j["base"], jnp.asarray(b1), j["base_mold"],
                             j["base_pend"], j["base_epoch"], batched=True)
    t = _port(lv)
    got = tcfglog.fold_span(tcfg, t["log_cfg"], t["base"], torch.from_numpy(b1), t["base_mold"],
                            t["base_pend"], t["base_epoch"])
    _check(want, got)
