"""The port's device parity check (raft_sim_tpu_torch/device_parity_check.py)
on the CPU: its CPU leg -- the run it holds the card against -- equals JAX
`scan.simulate` on all five configs, every non-mailbox state leaf and every
metric; the comparison names a flipped leaf; the entry point exits
non-zero with no card.

Sizes: each config at batch 8 and 128 ticks, cut from the tool's 8-64
clusters and 200-500 ticks to keep the plain tick's CPU time down (the
card run in chip_smoke.py runs them at the tool's own sizes).

Tolerance: exact equality (dtype, shape, value) of every leaf.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from raft_sim_tpu import RaftConfig as JConfig
from raft_sim_tpu.sim import scan as jscan
from raft_sim_tpu_torch import device_parity_check as dpc

torch.set_num_threads(1)
BATCH, TICKS = 8, 128


def _jax_leaves(name):
    kwargs, seed, _, _ = dpc.CONFIGS[name]
    f, m = jax.device_get(jscan.simulate(JConfig(**kwargs), seed, BATCH, TICKS))
    out = {f"s_{k}": np.asarray(v) for k, v in zip(f._fields, f) if k != "mailbox"}
    out.update({f"m_{k}": np.asarray(v) for k, v in zip(m._fields, m)})
    return out


@pytest.mark.parametrize("name", list(dpc.CONFIGS))
def test_cpu_leg_equals_jax(name):
    got = dpc.leaves(name, "cpu", BATCH, TICKS)
    want = _jax_leaves(name)
    assert dpc.mismatches(got, want) == []
    assert got["m_ticks"].tolist() == [TICKS] * BATCH


def test_comparison_names_a_flipped_leaf(capsys, monkeypatch):
    a = dpc.leaves("reliable+client", "cpu", 4, 32)
    b = copy.deepcopy(a)
    b["s_term"][2, 1] ^= 1
    b["m_total_cmds"][0] += 1
    assert dpc.mismatches(a, b) == ["total_cmds", "term"]
    # check() names the leaves on its line: here the "card" leg (the first
    # run) comes back flipped.
    runs = iter((b, a))
    monkeypatch.setattr(dpc, "leaves", lambda *args: next(runs))
    res = dpc.check(["reliable+client"], 4, 32, device="cpu")
    assert res == {"reliable+client": ["total_cmds", "term"]}
    assert "MISMATCH in ['total_cmds', 'term']" in capsys.readouterr().out


def test_cli_exits_non_zero_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs the check")
    assert dpc.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    # Like the JAX tool it takes no flags: there is no CPU-against-CPU run.
    for flags in (["--device", "cpu"], ["--configs", "reliable+client"]):
        with pytest.raises(SystemExit) as ex:
            dpc.main(flags)
        assert ex.value.code == 2
