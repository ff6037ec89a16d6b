"""The port's threefry2x32 (raft_sim_tpu_torch/utils/threefry.py) against
`jax.random` under the partitionable key derivation the JAX package pins
(raft_sim_tpu/__init__.py).

Tolerance: exact equality of every uint32 word and every drawn integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.utils import rng as jrng
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import rng as trng
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)
SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, -99] + [
    int(s) for s in np.random.default_rng(0).integers(-(2**31), 2**31, 8)
]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_partitionable_mode_is_pinned():
    assert rst  # importing the JAX package pins the mode
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k, kt = jax.random.key(seed), threefry.key(seed)
    np.testing.assert_array_equal(kt.numpy(), _kd(k))
    for n in (1, 2, 3, 5, 64):
        np.testing.assert_array_equal(threefry.split(kt, n).numpy(), _kd(jax.random.split(k, n)))
    for d in (0, 1, 5, 7, 31, 2**31 - 1, -1):
        np.testing.assert_array_equal(
            threefry.fold_in(kt, d).numpy(), _kd(jax.random.fold_in(k, jnp.int32(d)))
        )


@pytest.mark.parametrize("shape", [(), (1,), (5,), (7, 7), (51, 51), (2, 3, 4)])
def test_bits(shape):
    for seed in SEEDS[:6]:
        k = jax.random.key(seed)
        want = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(threefry.bits(threefry.key(seed), shape).numpy(), want)


@pytest.mark.parametrize(
    "lo,hi",
    [(6, 12), (12, 20), (0, 3), (0, 4), (0, 5), (0, 7), (0, 51), (0, 64), (1, 13), (1, 4), (5, 5), (9, 2)],
)
def test_randint(lo, hi):
    """jax's two-draw algorithm over the ranges the path uses: election
    windows [min, min + range), node ranges [0, n), crash-period-like spans."""
    for seed in SEEDS[:8]:
        k = jax.random.key(seed)
        want = np.asarray(jax.random.randint(k, (9,), lo, hi, jnp.int32))
        got = threefry.randint(threefry.key(seed), (9,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_batched_keys_are_rows():
    """A [B, 2] key batch draws row b from key b (the vmap the JAX path uses)."""
    keys = jax.random.split(jax.random.key(3), 6)
    tkeys = threefry.split(threefry.key(3), 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (4, 4), jnp.uint32))(keys))
    np.testing.assert_array_equal(threefry.bits(tkeys, (4, 4)).numpy(), want.astype(np.int64))
    want = jax.vmap(lambda k: jax.random.fold_in(k, 9))(keys)
    np.testing.assert_array_equal(threefry.fold_in(tkeys, 9).numpy(), _kd(want))


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4", "config5"])
def test_draw_timeouts(name):
    jcfg, _ = rst.PRESETS[name]
    tcfg, _ = tconfig.PRESETS[name]
    keys = jax.random.split(jax.random.key(11), 5)
    want = np.asarray(jax.vmap(lambda k: jrng.draw_timeouts(jcfg, k, jcfg.n_nodes))(keys))
    got = trng.draw_timeouts(tcfg, threefry.split(threefry.key(11), 5), tcfg.n_nodes)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(tconfig.PRESETS))
def test_init_batch_deadlines(name):
    """init_batch's initial deadlines equal the JAX package's for every preset."""
    from raft_sim_tpu_torch import types as ttypes

    jcfg, _ = rst.PRESETS[name]
    tcfg, _ = tconfig.PRESETS[name]
    want = np.asarray(
        jax.vmap(lambda k: jrng.draw_timeouts(jcfg, k, jcfg.n_nodes))(
            jax.random.split(jax.random.key(4), 3)
        )
    )
    if not tcfg.compact_planes:
        want_state = rst.init_batch(jcfg, jax.random.key(4), 3)
        np.testing.assert_array_equal(np.asarray(want_state.deadline), want)
        got = ttypes.init_batch(tcfg, threefry.key(4), 3).deadline
    else:
        got = trng.draw_timeouts(tcfg, threefry.split(threefry.key(4), 3), tcfg.n_nodes)
    np.testing.assert_array_equal(got.numpy(), want)
