"""The Hopper tick kernel on the card (marker `cuda`): `step_cuda` on CUDA
tensors against the plain PyTorch tick on the same CUDA tensors, tick by tick,
and `simulate` on the card against the port on the CPU. Skips where torch sees
no CUDA device; on a machine with one H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: exact equality of every leaf.
"""

import pytest
import torch

from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import types as ttypes
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.models import raft_batched as trb
from raft_sim_tpu_torch.sim import faults, scan
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("torch sees no CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "name", ["config1", "config2", "config3", "config4", "config5", "config3p", "config6", "config6r",
             "config8", "config9", "config10"]
)
def test_step_cuda_matches_plain_step(card, name):
    cfg, _ = tconfig.PRESETS[name]
    batch = 1 if name == "config1" else 200  # ragged batches: the test below
    # config6's CAP=32 ring wraps near tick 130; config8's first toggle lands
    # at tick 97 and its transfers at 61 and 122; config10's crash windows
    # end at 64 and 128.
    ticks = 400 if cfg.compaction else 200 if cfg.reconfig or cfg.durable_storage else 64
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0, card), batch))
    keys = threefry.split(threefry.key(1, card), batch)
    before = tick_engine.step_cuda.launches
    for t in range(ticks):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_cuda(cfg, s, inp, t)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        s = got[0]
    assert tick_engine.step_cuda.launches == before + ticks
    if cfg.compaction:
        assert int(s.log_base.min()) > 0  # every node of every cluster compacted


@pytest.mark.parametrize(
    "name,batch",
    [("config1", 1)] + [(name, 45) for name in ("config2", "config5", "config3p", "config6", "config6r",
                                                  "config8", "config9", "config10")],
)
def test_step_cuda_matches_plain_step_on_small_and_ragged_batches(card, name, batch):
    """One cluster, and 45 clusters (a ragged last block at every block
    shape): at N=5 and at N=51 with two nodes a thread, on each gate set.
    Small enough for a race checker:
    compute-sanitizer --tool racecheck --kernel-name kns=tick_kernel
        python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -k ragged"""
    cfg, _ = tconfig.PRESETS[name]
    s = trb.to_batch_minor(ttypes.init_batch(cfg, threefry.key(0, card), batch))
    keys = threefry.split(threefry.key(1, card), batch)
    for t in range(96):
        inp = trb.to_batch_minor(faults.make_inputs(cfg, keys, t))
        want = trb.step_b(cfg, s, inp, t)
        got = tick_engine.step_cuda(cfg, s, inp, t)
        diff = bridge.first_difference(want[0], got[0]) or bridge.first_difference(want[1], got[1])
        assert diff is None, f"tick {t}: {diff}"
        s = got[0]


@pytest.mark.parametrize("name", ["config2", "config4", "config6r", "config8", "config9", "config10"])
def test_simulate_card_matches_cpu(card, name):
    cfg, _ = tconfig.PRESETS[name]
    got = scan.simulate(cfg, 3, 32, 80, device=card)
    want = scan.simulate(cfg, 3, 32, 80, device="cpu")
    assert bridge.first_difference(want[0], got[0]) is None
    assert bridge.first_difference(want[1], got[1]) is None
