"""Card-against-CPU trajectory parity (the port of tools/tpu_parity_check.py).

The tests hold the port's CPU path (the plain PyTorch tick) bit for bit
against the JAX package, and the kernel's body against the plain tick
through its host build; what they cannot see is the card itself: the
kernel's int8/int16 arithmetic, uint32 wraparound in the commit checksum
and reduction order as the H100 runs them. This tool runs the JAX tool's
five seeded configs through `scan.simulate` on the card (every tick one
launch of the tick kernel, kernels/tick_engine.step_cuda) and on the CPU
(the plain tick), in one process, and compares every non-mailbox state
leaf and every metric bit for bit. The JAX leg lives in the CPU tests
(tests/test_torch_device_parity.py): they hold this tool's CPU run equal
to JAX's on the same configs.

    python -m raft_sim_tpu_torch.device_parity_check    # exit 1 on any mismatch

Like the JAX tool it takes no flags: the five configs at their own sizes.
It prints one line a config (the leaves that differ, or OK) and a JSON
summary line. Unlike the JAX tool, which exits 0 on a CPU-only host, it
needs the card: with none it exits 2 saying so. `check()` takes cut sizes
for callers that want a shorter run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.types import u32_leaves
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig

CONFIGS = {
    # name -> (RaftConfig kwargs, seed, batch, ticks): the JAX tool's.
    "reliable+client": (dict(n_nodes=5, client_interval=8), 42, 64, 300),
    "kitchen-sink": (
        dict(n_nodes=9, log_capacity=16, client_interval=4, drop_prob=0.3, partition_period=32,
             partition_prob=0.5, crash_prob=0.3, crash_period=40, crash_down_ticks=15,
             clock_skew_prob=0.1, check_log_matching=True),
        77, 32, 400),
    "wide-n51": (dict(n_nodes=51, log_capacity=16, partition_period=32, partition_prob=0.5),
                 7, 8, 200),
    # Ring compaction with snapshot catch-up and the redirect client with a
    # 3-deep pipeline: wide index planes, absolute-index checksums, routing.
    "compaction+redirect": (
        dict(n_nodes=5, log_capacity=16, compact_margin=8, max_entries_per_rpc=4,
             client_interval=2, client_redirect=True, client_pipeline=3, drop_prob=0.15,
             crash_prob=0.3, crash_period=32, crash_down_ticks=10),
        11, 32, 500),
    # PreVote probe rounds under churn: the packed per-edge grant bits.
    "prevote-churn": (
        dict(n_nodes=5, log_capacity=8, client_interval=3, pre_vote=True, drop_prob=0.25,
             crash_prob=0.4, crash_period=16, crash_down_ticks=8),
        13, 32, 400),
}


def leaves(name: str, device, batch: int | None = None, ticks: int | None = None) -> dict:
    """One config's run on `device` as {"s_<leaf>" / "m_<field>": numpy
    array}: every non-mailbox state leaf and every metric (the JAX tool's
    comparison set). `batch`/`ticks` cut the config's sizes."""
    kwargs, seed, b, t = CONFIGS[name]
    cfg = RaftConfig(**kwargs)
    final, metrics = scan.simulate(cfg, seed, batch or b, ticks or t, device=device)
    u32 = u32_leaves(cfg)  # int32-carried uint32 legs, viewed back
    out = {f"s_{k}": v.cpu().numpy().view(np.uint32) if k in u32 else v.cpu().numpy()
           for k, v in zip(final._fields, final) if k != "mailbox"}
    out.update({f"m_{k}": v.cpu().numpy() for k, v in zip(metrics._fields, metrics)})
    return out


def mismatches(a: dict, b: dict) -> list[str]:
    """The leaves (state leaf or metric names, without their prefix) whose
    dtype, shape or value differ between two `leaves` results."""
    bad = [k for k in sorted(set(a) | set(b)) if k not in a or k not in b
           or a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    return [k[2:] for k in bad]


def check(names=None, batch: int | None = None, ticks: int | None = None,
          device="cuda") -> dict:
    """Run each config on `device` and on the CPU and compare, printing a
    line a config; returns {name: mismatching leaves}."""
    dev = device_mod.resolve(device)
    result = {}
    for name in names or CONFIGS:
        t0 = time.perf_counter()
        bad = mismatches(leaves(name, dev, batch, ticks), leaves(name, "cpu", batch, ticks))
        result[name] = bad
        print(f"{name} ({dev.type} vs cpu): {'MISMATCH in ' + str(bad) if bad else 'OK'} "
              f"({time.perf_counter() - t0:.1f} s)")
    return result


def main(argv=None) -> int:
    argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch.device_parity_check",
                            description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the parity check holds the card against the CPU and needs "
              "the card", file=sys.stderr)
        return 2
    result = check()
    print(json.dumps({"configs": len(result), "mismatched": {k: v for k, v in result.items()
                                                            if v}}))
    return 1 if any(result.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
