"""The port's bit-plane and log ops (raft_sim_tpu_torch/ops/) against the JAX
package's ops/bitplane.py and ops/log_ops.py, on random inputs made from a
numpy seed.

Tolerance: exact equality (uint32 words compared as uint32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_sim_tpu.ops import bitplane as jbp
from raft_sim_tpu.ops import log_ops as jlo
from raft_sim_tpu_torch.ops import bitplane as tbp
from raft_sim_tpu_torch.ops import log_ops as tlo

torch.set_num_threads(1)


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [2, 3, 5, 7, 31, 32, 33, 51, 64])
def test_bitplane_matches_jax(n):
    rng = np.random.default_rng(n)
    x3 = rng.random((4, n, 3)) < 0.5
    for x, axis in ((x3, 1), (np.ascontiguousarray(np.moveaxis(x3, 1, 0)), 0)):
        want = np.asarray(jbp.pack(jnp.asarray(x), axis=axis))
        got = tbp.pack(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(_u32(got), want)
        np.testing.assert_array_equal(tbp.unpack(got, n, axis=axis).numpy(), x)
        np.testing.assert_array_equal(
            tbp.count(got, axis=axis).numpy(), np.asarray(jbp.count(jnp.asarray(want), axis=axis))
        )
    words = rng.integers(0, 2**32, (5, tbp.n_words(n)), dtype=np.uint32)
    tw = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(tbp.popcount(tw).numpy(), np.asarray(jbp.popcount(jnp.asarray(words))))
    other = torch.from_numpy(rng.integers(0, 2**32, words.shape, dtype=np.uint32).view(np.int32))
    np.testing.assert_array_equal(
        _u32(tbp.andnot(tw, other)), np.asarray(jbp.andnot(jnp.asarray(words), jnp.asarray(_u32(other))))
    )
    assert tbp.n_words(n) == jbp.n_words(n)
    np.testing.assert_array_equal(_u32(tbp.full_row(n)), np.asarray(jbp.full_row(n)))
    np.testing.assert_array_equal(_u32(tbp.eye(n)), np.asarray(jbp.eye(n)))
    for i in (0, n // 2, n - 1):
        np.testing.assert_array_equal(_u32(tbp.bit_row(i, n)), np.asarray(jbp.bit_row(i, n)))
        plane = tbp.set_bit(tbp.eye(n), 1, i)
        want_plane = jbp.set_bit(jbp.eye(n), 1, i)
        np.testing.assert_array_equal(_u32(plane), np.asarray(want_plane))
        assert bool(tbp.get_bit(plane, 1, i)) == bool(jbp.get_bit(want_plane, 1, i))
        cleared = tbp.set_bit(plane, 1, i, value=False)
        np.testing.assert_array_equal(_u32(cleared), np.asarray(jbp.set_bit(want_plane, 1, i, False)))
    ids = np.array([-1, 0, n - 1, n, n // 2], np.int32)
    np.testing.assert_array_equal(
        _u32(tbp.one_bit(torch.from_numpy(ids), n)), np.asarray(jbp.one_bit(jnp.asarray(ids), n))
    )


@pytest.mark.parametrize("cap,e", [(6, 2), (8, 4), (16, 4), (32, 8), (2048, 8)])
def test_log_ops_match_jax(cap, e):
    rng = np.random.default_rng(cap + e)
    n, b = 5, 7
    log_term = rng.integers(-3, 1000, (n, cap, b), dtype=np.int32)
    log_val = rng.integers(-(2**31), 2**31, (n, cap, b), dtype=np.int32)
    idx = rng.integers(-2, cap + 3, (n, b), dtype=np.int32)
    tt, tv, ti = (torch.from_numpy(a) for a in (log_term, log_val, idx))
    np.testing.assert_array_equal(
        tlo.term_at_b(tt, ti).numpy(), np.asarray(jlo.term_at_b(jnp.asarray(log_term), jnp.asarray(idx)))
    )
    start = rng.integers(0, cap + 2, (n, b), dtype=np.int32)
    np.testing.assert_array_equal(
        tlo.window_b(tt, torch.from_numpy(start), e).numpy(),
        np.asarray(jlo.window_b(jnp.asarray(log_term), jnp.asarray(start), e)),
    )
    vals = rng.integers(0, 99, (n, e, b), dtype=np.int32)
    gate = rng.random((n, b)) < 0.7
    count = rng.integers(0, e + 2, (n, b), dtype=np.int32)
    want = jlo.write_window_b(
        jnp.asarray(log_term), jnp.asarray(start), jnp.asarray(vals), jnp.asarray(gate), jnp.asarray(count)
    )
    got = tlo.write_window_b(tt, torch.from_numpy(start), torch.from_numpy(vals),
                             torch.from_numpy(gate), torch.from_numpy(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    upto_a = rng.integers(0, cap + 1, (n, b), dtype=np.int32)
    want_a, want_b = jlo.prefix_chk2_b(jnp.asarray(log_term), jnp.asarray(log_val),
                                       jnp.asarray(upto_a), jnp.asarray(idx))
    got_a, got_b = tlo.prefix_chk2_b(tt, tv, torch.from_numpy(upto_a), ti)
    np.testing.assert_array_equal(_u32(got_a), np.asarray(want_a))
    np.testing.assert_array_equal(_u32(got_b), np.asarray(want_b))
    w_t, w_v = tlo.chk_weights(cap)
    jw_t, jw_v = jlo.chk_weights(cap)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(jw_t).astype(np.int64))
    np.testing.assert_array_equal(w_v.numpy(), np.asarray(jw_v).astype(np.int64))
    np.testing.assert_array_equal(
        tlo.iota((n, cap, b), 1).numpy(), np.asarray(jlo.iota((n, cap, b), 1))
    )


def test_log2_bin_matches_jax():
    v = np.concatenate([np.arange(0, 70000, 7, dtype=np.int32), np.array([2**31 - 1, 65535, 65536], np.int32)])
    np.testing.assert_array_equal(
        tlo.log2_bin(torch.from_numpy(v), 16).numpy(), np.asarray(jlo.log2_bin(jnp.asarray(v), 16))
    )


@pytest.mark.parametrize("cap,e", [(8, 2), (8, 4), (32, 4), (16, 8)])
def test_ring_log_ops_match_jax(cap, e):
    """The four ring forms (compaction) on random rings with nonzero bases:
    indices below, at and above each node's base, across the wrap."""
    rng = np.random.default_rng(100 + cap + e)
    n, b = 5, 9
    log_term = rng.integers(-3, 1000, (n, cap, b), dtype=np.int32)
    log_val = rng.integers(-(2**31), 2**31, (n, cap, b), dtype=np.int32)
    base = rng.integers(0, 5 * cap, (n, b), dtype=np.int32)
    base_term = rng.integers(0, 50, (n, b), dtype=np.int32)
    idx = np.where(rng.random((n, b)) < 0.1, 0, base + rng.integers(-cap, cap + 1, (n, b))).astype(np.int32)
    idx = np.maximum(idx, 0)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    np.testing.assert_array_equal(
        tlo.term_at_rb(t(log_term), t(base), t(base_term), t(idx)).numpy(),
        np.asarray(jlo.term_at_rb(j(log_term), j(base), j(base_term), j(idx))),
    )
    start = (base + rng.integers(0, cap, (n, b))).astype(np.int32)
    np.testing.assert_array_equal(
        tlo.window_rb(t(log_term), t(start), e).numpy(),
        np.asarray(jlo.window_rb(j(log_term), j(start), e)),
    )
    vals = rng.integers(0, 99, (n, e, b), dtype=np.int32)
    gate = rng.random((n, b)) < 0.7
    lo = rng.integers(-1, e + 2, (n, b), dtype=np.int32)
    count = rng.integers(0, e + 2, (n, b), dtype=np.int32)
    want = jlo.write_window_rb(j(log_term), j(start), j(vals), j(gate), j(lo), j(count))
    got = tlo.write_window_rb(t(log_term), t(start), t(vals), t(gate), t(lo), t(count))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    uptos = tuple(
        (base + rng.integers(0, cap + 1, (n, b))).astype(np.int32) for _ in range(3)
    )
    want_c = jlo.ring_chk_b(j(log_term), j(log_val), j(base), tuple(j(u) for u in uptos))
    got_c = tlo.ring_chk_b(t(log_term), t(log_val), t(base), tuple(t(u) for u in uptos))
    for w, g in zip(want_c, got_c):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    # With base 0 the ring checksum is the prefix checksum.
    z = np.zeros((n, b), np.int32)
    ring0 = tlo.ring_chk_b(t(log_term), t(log_val), t(z), (t(uptos[0] % (cap + 1)),))[0]
    pre0 = tlo.prefix_chk2_b(t(log_term), t(log_val), t(z), t(uptos[0] % (cap + 1)))[1]
    np.testing.assert_array_equal(ring0.numpy(), pre0.numpy())
