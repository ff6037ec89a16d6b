"""The Hopper tick kernel's own logic, on the CPU: csrc/tick.cuh (the scalar
per-cluster body the CUDA kernel runs) compiled with g++ through the plain C
harness csrc/tick_host.cpp, loaded with ctypes, and driven through the same
leaf checks and pointer table as the CUDA wrapper (kernels/tick_engine.py
`step_host`). It is held against the plain PyTorch tick, which
tests/test_torch_step.py holds against the JAX package.

Tolerance: exact equality of every ClusterState and StepInfo leaf.
Skips only where no g++ is installed.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.sim import faults
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("tick_host") / "libtick_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared", "-fPIC",
         "-o", str(out), str(tick_engine.CSRC / "tick_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    return tick_engine.load_host(out)


def test_ptr_enum_matches_wrapper_order():
    """csrc/tick.cuh's Ptr enum lists the leaves in PTR_ORDER's order."""
    src = (tick_engine.CSRC / "tick.cuh").read_text()
    body = src[src.index("enum Ptr {"):src.index("N_PTR")]
    names = re.findall(r"\b([A-Z]+)_([A-Z_]+)\b", body)
    prefix = {"S": "state", "M": "mailbox", "I": "inputs", "O": "state_out",
              "OM": "mailbox_out", "F": "info_out"}
    got = [(prefix[p], n.lower()) for p, n in names]
    assert got == list(tick_engine.PTR_ORDER)


def _fuzz(inp, rng, p_down):
    alive = torch.from_numpy(rng.random(tuple(inp.alive.shape)) >= p_down)
    restarted = alive & torch.from_numpy(rng.random(tuple(inp.alive.shape)) < p_down)
    return inp._replace(alive=alive, restarted=restarted)


ROWS = [
    pytest.param(tconfig.RaftConfig(n_nodes=3, log_capacity=8, max_entries_per_rpc=2), 8, 120, 0.0, id="n3-small"),
    pytest.param(tconfig.RaftConfig(n_nodes=5, client_interval=4, drop_prob=0.2), 8, 120, 0.0, id="n5-faults"),
    pytest.param(tconfig.PRESETS["config4"][0], 8, 120, 0.0, id="config4"),
    pytest.param(tconfig.PRESETS["config2"][0], 5, 120, 0.0, id="config2-ragged-b5"),
    pytest.param(tconfig.PRESETS["config1"][0], 1, 120, 0.0, id="config1-int16"),
    pytest.param(tconfig.PRESETS["config5"][0], 3, 64, 0.0, id="config5-n51"),
    pytest.param(
        tconfig.RaftConfig(n_nodes=5, log_capacity=6, client_interval=1, drop_prob=0.25, clock_skew_prob=0.2),
        8, 150, 0.08, id="n5-tiny-log-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=7, log_capacity=12, client_interval=2, drop_prob=0.2,
                           check_log_matching=True, check_invariants=True, ack_timeout_ticks=7),
        6, 150, 0.05, id="n7-crash-fuzz",
    ),
    pytest.param(
        tconfig.RaftConfig(n_nodes=4, client_interval=3, check_invariants=False, ack_timeout_ticks=200),
        6, 100, 0.03, id="n4-no-invariants-ack-int16",
    ),
]


@pytest.mark.parametrize("cfg,batch,ticks,p_down", ROWS)
def test_tick_body_matches_plain_step(host_lib, cfg, batch, ticks, p_down):
    rng = np.random.default_rng(5)
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(2), batch))
    keys = threefry.split(threefry.key(3), batch)
    led = 0
    for t in range(ticks):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
        if p_down:
            inp = _fuzz(inp, rng, p_down)
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_host(host_lib, cfg, s, inp, t)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        led += int(want[1].n_leaders.sum() > 0)
        s = want[0]
    assert led > 0


def test_wrapper_rejects_bad_leaves(host_lib):
    cfg = tconfig.PRESETS["config2"][0]
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0), 4))
    inp = trb.to_batch_minor(faults.make_inputs(cfg, threefry.split(threefry.key(1), 4), 0))
    with pytest.raises(ValueError, match="next_index"):
        tick_engine.step_host(host_lib, cfg, s._replace(next_index=s.next_index.to(torch.int16)), inp, 0)
    with pytest.raises(ValueError, match="not contiguous"):
        tick_engine.step_host(host_lib, cfg, s._replace(log_term=s.log_term.transpose(0, 1).contiguous().transpose(0, 1)), inp, 0)
    with pytest.raises(ValueError, match="skew"):
        tick_engine.step_host(host_lib, cfg, s, inp._replace(skew=inp.skew[:, :2]), 0)
    with pytest.raises(NotImplementedError, match="n_nodes"):
        tick_engine.check_supported(tconfig.RaftConfig(n_nodes=101))
