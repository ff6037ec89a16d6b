"""The PyTorch port's config, dtype tiers and state containers against the JAX
package's (raft_sim_tpu_torch/utils/config.py, types.py).

Tolerance: exact equality everywhere -- configs are Python values, and leaf
names, shapes and dtypes must match one for one (uint32 legs ride int32 bit
patterns in the port, by design: types.U32_LEAVES).
"""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu import types as jtypes
from raft_sim_tpu.utils import config as jconfig
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
PROPERTIES = (
    "quorum", "ack_age_sat", "compaction", "track_offer_ticks", "reconfig",
    "leader_transfer", "read_index", "read_lease", "durable_storage",
    "joint_consensus", "act_on_append", "truncation_rollback", "read_confirm",
    "xfer_election", "lease_skew_safe", "durable_acks", "persist_vote",
)
DTYPES = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32, torch.bool: np.bool_}


def _port_cfg(jcfg):
    return tconfig.RaftConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    )


def test_fields_and_defaults_match():
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(jconfig.RaftConfig)]
    tf = [(f.name, f.default, f.type) for f in dataclasses.fields(tconfig.RaftConfig)]
    assert tf == jf
    assert tconfig.RaftConfig.__dataclass_params__.frozen


def test_module_constants_match():
    for name in ("ACK_AGE_SAT", "ACK_AGE_SAT_NARROW", "MAX_LOG_CAPACITY"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    for dmax in (127, 32767, 2**31 - 1):
        assert tconfig.max_log_capacity_for(dmax) == jconfig.max_log_capacity_for(dmax)
        assert tconfig.max_nodes_for(dmax) == jconfig.max_nodes_for(dmax)
        assert tconfig.window_min_encoding_max(dmax) == jconfig.window_min_encoding_max(dmax)
    for name in ("FOLLOWER", "CANDIDATE", "LEADER", "PRECANDIDATE", "NIL", "NOOP",
                 "LAT_HIST_BINS", "REQ_VOTE", "REQ_APPEND", "REQ_PREVOTE",
                 "REQ_TIMEOUT_NOW", "RESP_VOTE", "RESP_APPEND", "RESP_PREVOTE",
                 "MAX_INT8_LOG_CAPACITY", "MAX_INT8_NODES"):
        assert getattr(ttypes, name) == getattr(jtypes, name), name


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_preset_and_properties_match(name):
    jcfg, jbatch = jconfig.PRESETS[name]
    tcfg, tbatch = tconfig.PRESETS[name]
    assert tbatch == jbatch
    assert tcfg == _port_cfg(jcfg)
    for prop in PROPERTIES:
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    for fn in ("index_dtype", "ack_dtype", "node_dtype"):
        assert DTYPES[getattr(ttypes, fn)(tcfg)] == np.dtype(getattr(jtypes, fn)(jcfg)), fn


def test_default_config_properties_match():
    for prop in PROPERTIES:
        assert getattr(tconfig.RaftConfig(), prop) == getattr(jconfig.RaftConfig(), prop)


@pytest.mark.parametrize(
    "bad",
    [
        dict(n_nodes=1),
        dict(election_min_ticks=3),
        dict(ack_timeout_ticks=5),
        dict(client_pipeline=2),
        dict(log_capacity=5000),
        dict(torn_tail_prob=0.1),
        dict(read_lease_ticks=2),
    ],
    ids=lambda d: next(iter(d)),
)
def test_validator_rejects_like_jax(bad):
    with pytest.raises(AssertionError):
        jconfig.RaftConfig(**bad)
    with pytest.raises(AssertionError):
        tconfig.RaftConfig(**bad)


def _leaf_sig(tree, prefix="", u32=ttypes.U32_LEAVES):
    out = []
    for f in tree._fields:
        x = getattr(tree, f)
        if hasattr(x, "_fields"):
            out += _leaf_sig(x, prefix + f + ".", u32)
        else:
            a = np.asarray(x) if not isinstance(x, torch.Tensor) else x
            if isinstance(a, torch.Tensor):
                dt = np.uint32 if f in u32 else DTYPES[a.dtype]
            else:
                dt = a.dtype
            out.append((prefix + f, tuple(a.shape), np.dtype(dt)))
    return out


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_init_batch_leaves_match(name):
    """Leaf names, shapes and dtypes of init_batch equal the JAX package's,
    the compacted carry layout (config5c, config7x: packed legs uint32)
    included."""
    jcfg, _ = jconfig.PRESETS[name]
    tcfg, _ = tconfig.PRESETS[name]
    want = jax.device_get(rst.init_batch(jcfg, jax.random.key(0), 3))
    got = ttypes.init_batch(tcfg, threefry.key(0), 3)
    assert _leaf_sig(got, u32=ttypes.u32_leaves(tcfg)) == _leaf_sig(want)
    assert len(jax.tree.leaves(want)) == 69


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4", "config5"])
def test_init_batch_values_match(name):
    """Boot state values, deadlines included, equal the JAX package's."""
    jcfg, _ = jconfig.PRESETS[name]
    tcfg, _ = tconfig.PRESETS[name]
    want = jax.device_get(rst.init_batch(jcfg, jax.random.key(5), 4))
    got = ttypes.init_batch(tcfg, threefry.key(5), 4)
    assert bridge.first_difference(want, got) is None


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "raft_sim_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "raft_sim_tpu"), f"{path}: imports {mod}"


@pytest.mark.parametrize("name", ["config1", "config4", "config5"])
def test_init_state_matches_jax(name):
    """The single-cluster init_state from one key equals the JAX package's."""
    jcfg, _ = jconfig.PRESETS[name]
    tcfg, _ = tconfig.PRESETS[name]
    want = jax.device_get(rst.init_state(jcfg, jax.random.key(9)))
    assert bridge.first_difference(want, ttypes.init_state(tcfg, threefry.key(9))) is None
