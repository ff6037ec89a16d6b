"""The port's apply-log stream (raft_sim_tpu_torch/utils/apply_log.py, driven
by driver.Session between chunks) against the JAX package's writer: on the
same trajectory both write the same `node_<i>.log` files, byte for byte --
on healthy chunks (no gaps), and on one chunk wide enough that compaction
outruns the export (`# snapshot gap` lines). On the CPU at small size.
"""

import dataclasses
from pathlib import Path

import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.driver import Session as JSession
from raft_sim_tpu_torch.driver import Session
from raft_sim_tpu_torch.types import init_batch
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry
from raft_sim_tpu_torch.utils.apply_log import ApplyLogWriter

torch.set_num_threads(1)

# tests/test_apply_log.py's ring (CAP=32, margin 8, a client every 4 ticks),
# and an 8-slot ring with crash churn whose commit outruns a 160-tick chunk.
RING = rst.RaftConfig(n_nodes=5, log_capacity=32, compact_margin=8, max_entries_per_rpc=4,
                      client_interval=4)
FAST_RING = dataclasses.replace(rst.PRESETS["config6"][0], log_capacity=8, compact_margin=4,
                                max_entries_per_rpc=2, client_interval=2, check_log_matching=True)


def _port_cfg(jcfg):
    return tconfig.RaftConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


@pytest.mark.parametrize(
    "jcfg,ticks,chunk,gaps",
    [
        pytest.param(RING, 192, 16, False, id="ring-no-gaps"),
        pytest.param(FAST_RING, 160, 160, True, id="fast-ring-snapshot-gaps"),
    ],
)
def test_apply_log_files_match_jax_byte_for_byte(tmp_path, jcfg, ticks, chunk, gaps):
    jsess = JSession(jcfg, batch=2, seed=1)
    jsess.attach_apply_log(str(tmp_path / "jax"), cluster=1)
    jsess.run(ticks, chunk=chunk)
    sess = Session(_port_cfg(jcfg), batch=2, seed=1, device="cpu")
    sess.attach_apply_log(str(tmp_path / "port"), cluster=1)
    sess.run(ticks, chunk=chunk)
    n_values = 0
    for i in range(jcfg.n_nodes):
        want = (tmp_path / "jax" / f"node_{i}.log").read_bytes()
        got = (tmp_path / "port" / f"node_{i}.log").read_bytes()
        assert got == want, f"node_{i}.log"
        n_values += len(sess.apply_writer.values(i))
        assert sess.apply_writer.gaps(i) == jsess.apply_writer.gaps(i)
    assert n_values > 0
    assert any(sess.apply_writer.gaps(i) for i in range(jcfg.n_nodes)) == gaps


def test_update_rejects_overwide_committed_window(tmp_path):
    """A state whose committed window is wider than the ring (ticks ran past
    a chunk boundary before the export) raises instead of exporting
    unrelated slots."""
    cfg = _port_cfg(RING)
    state = init_batch(cfg, threefry.key(0), 1)
    bad = state._replace(commit_index=torch.full_like(state.commit_index, cfg.log_capacity + 1))
    w = ApplyLogWriter(str(tmp_path), cfg, cluster=0)
    with pytest.raises(RuntimeError, match="compacted slots"):
        w.update(bad)


def test_reset_restarts_the_export_stream(tmp_path):
    """Session.reset truncates the files and zeroes the frontier, so the
    same seed writes the same stream again."""
    sess = Session(_port_cfg(RING), batch=1, seed=0, device="cpu")
    sess.attach_apply_log(str(tmp_path), cluster=0)
    sess.run(120, chunk=24)
    first = Path(tmp_path / "node_0.log").read_bytes()
    assert first.count(b"\n") > 10
    sess.reset()
    sess.run(120, chunk=24)
    assert Path(tmp_path / "node_0.log").read_bytes() == first
