"""The port's checkpoints (raft_sim_tpu_torch/utils/checkpoint.py, through
driver.Session save/restore) against the JAX package's: the same file
format, so a run saved by either package resumes in the other, on the CPU at
small size, on config6 (the compacting ring), config8 (uint32 member rows)
and config10 (the storage plane's watermarks).

Tolerance: exact equality of every ClusterState and RunMetrics leaf, and of
every array's dtype and shape between the two packages' files.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.driver import Session as JSession
from raft_sim_tpu.utils import checkpoint as jcheckpoint
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch.driver import Session
from raft_sim_tpu_torch.utils import checkpoint
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

BATCH = 4
PRESETS = [
    # config6's CAP=32 ring wraps near tick 130; config8's transfers land at
    # ticks 61 and 122, its first membership toggle at 97; config10's first
    # crash window ends at 64.
    pytest.param("config6", 80, id="config6"),
    pytest.param("config8", 60, id="config8"),
    pytest.param("config10", 60, id="config10"),
]


def _port_cfg(jcfg):
    return tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _jax_run(jcfg, ticks, k):
    """A JAX Session of BATCH clusters (seed 2) run `ticks` in chunks of `k`."""
    s = JSession(jcfg, batch=BATCH, seed=2)
    s.run(ticks, chunk=k)
    return s


def _same_run(jsess, sess):
    assert bridge.first_difference(jax.device_get(jsess.state), sess.state) is None
    assert bridge.first_difference(jax.device_get(jsess.metrics), sess.metrics) is None


@pytest.mark.parametrize("name,k", PRESETS)
def test_jax_checkpoint_resumes_in_the_port(tmp_path, name, k):
    """k JAX ticks, a JAX save, a port restore and k port ticks equal 2k
    JAX ticks, leaf for leaf (the metrics of the first half ride along)."""
    jcfg = rst.PRESETS[name][0]
    path = _jax_run(jcfg, k, k).save(str(tmp_path / "jax"))
    sess = Session.restore(path, device="cpu")
    assert sess.cfg == _port_cfg(jcfg) and sess.seed == 2 and sess.now == k
    sess.run(k, chunk=k)
    _same_run(_jax_run(jcfg, 2 * k, k), sess)


@pytest.mark.parametrize("name,k", PRESETS)
def test_port_checkpoint_resumes_in_jax(tmp_path, name, k):
    """The other way round: k port ticks, a port save, a JAX restore and k
    JAX ticks equal 2k JAX ticks; and the port's file holds the JAX file's
    arrays with the same names, dtypes and shapes."""
    jcfg = rst.PRESETS[name][0]
    sess = Session(_port_cfg(jcfg), batch=BATCH, seed=2, device="cpu")
    sess.run(k, chunk=k)
    path = sess.save(str(tmp_path / "port"))
    jsess = JSession.restore(path)
    assert jsess.cfg == jcfg and jsess.seed == 2
    jsess.run(k, chunk=k)
    want = _jax_run(jcfg, 2 * k, k)
    assert bridge.first_difference(jax.device_get(want.state), jax.device_get(jsess.state)) is None
    assert bridge.first_difference(jax.device_get(want.metrics), jax.device_get(jsess.metrics)) is None
    jpath = _jax_run(jcfg, k, k).save(str(tmp_path / "jax"))
    with np.load(path) as zp, np.load(jpath) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for f in zj.files:
            assert (zp[f].dtype, zp[f].shape) == (zj[f].dtype, zj[f].shape), f
            if f != "config_json":  # the same run: every array equal too
                assert np.array_equal(zp[f], zj[f]), f
        assert jcheckpoint._FORMAT_VERSION == checkpoint.FORMAT_VERSION == int(zp["__version__"])


def _rewrite(src, dst, **changes):
    with np.load(src) as z:
        arrays = {f: z[f] for f in z.files}
    arrays.update(changes)
    np.savez_compressed(dst, **arrays)
    return dst


def test_load_refuses_another_format_version(tmp_path):
    cfg = tconfig.PRESETS["config2"][0]
    sess = Session(cfg, batch=2, seed=0, device="cpu")
    sess.run(5)
    path = sess.save(str(tmp_path / "ck"))
    for v in (24, 26):
        bad = _rewrite(path, str(tmp_path / f"v{v}.npz"), __version__=np.int32(v))
        with pytest.raises(ValueError, match=f"format v{v}"):
            checkpoint.load(bad, device="cpu")


def test_restore_refuses_a_scenario_checkpoint(tmp_path):
    """A file recording a nemesis program is refused by a plain Session, as
    the JAX Session refuses it."""
    cfg = tconfig.PRESETS["config2"][0]
    sess = Session(cfg, batch=2, seed=0, device="cpu")
    path = sess.save(str(tmp_path / "ck"))
    assert checkpoint.load(path, device="cpu")[5] is None
    scen = _rewrite(path, str(tmp_path / "scen.npz"),
                    scenario_json=np.bytes_(b'{"name": "rolling-partitions"}'))
    assert checkpoint.load(scen, device="cpu")[5] == {"name": "rolling-partitions"}
    with pytest.raises(ValueError, match="rolling-partitions"):
        Session.restore(scen, device="cpu")
    with pytest.raises(ValueError, match="scenario"):
        JSession.restore(scen)


def test_save_refuses_a_leaf_of_another_dtype(tmp_path):
    """A leaf the port computed in a wider dtype would reach a JAX load as a
    silently widened array; save refuses it."""
    cfg = tconfig.PRESETS["config2"][0]
    sess = Session(cfg, batch=2, seed=0, device="cpu")
    sess.metrics = sess.metrics._replace(total_cmds=sess.metrics.total_cmds.to(torch.int64))
    with pytest.raises(TypeError, match="total_cmds"):
        sess.save(str(tmp_path / "ck"))
