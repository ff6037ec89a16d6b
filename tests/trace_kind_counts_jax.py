"""The JAX package's per-kind protocol event counts on chip_smoke.py's trace
(a) rows, written to tests/trace_kind_counts_jax.json, which chip_smoke.py
holds the card's counts to (the card has no JAX). Each row runs the JAX
batch-minor tick with event extraction (sim/scan.py `tick_batch_minor(...,
events=True)`) from the row's seeded state, keys and genome, and sums each
kind's events over every cluster and tick. Run on the CPU:

    JAX_PLATFORMS=cpu python tests/trace_kind_counts_jax.py
"""

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from raft_sim_tpu.models import raft_batched as jrb  # noqa: E402
from raft_sim_tpu.scenario import genome as jgenome  # noqa: E402
from raft_sim_tpu.sim import scan as jscan  # noqa: E402
from raft_sim_tpu.trace import events as jev  # noqa: E402
from raft_sim_tpu.types import init_batch  # noqa: E402
from raft_sim_tpu.utils.config import RaftConfig  # noqa: E402


def counts(cfg, batch, ticks, genome, seg_len):
    """{kind name: events} over `ticks` ticks of `batch` clusters."""
    state = jrb.to_batch_minor(init_batch(cfg, jax.random.key(chip_smoke.SEED), batch))
    keys = jax.random.split(jax.random.key(chip_smoke.SEED + 1), batch)
    kinds = jnp.asarray(jev.slot_kinds(cfg.n_nodes))
    m0 = jrb.to_batch_minor(jscan.init_metrics_batch(batch))

    def body(carry, _):
        s, acc = carry
        s2, _, _, ev = jscan.tick_batch_minor(cfg, s, keys, m0, genome=genome, seg_len=seg_len,
                                              events=True)
        per_slot = ev.flags.sum(axis=1, dtype=jnp.int32)
        return (s2, acc.at[kinds].add(per_slot)), None

    run = jax.jit(lambda s: jax.lax.scan(body, (s, jnp.zeros(jev.N_KINDS, jnp.int32)), None,
                                         length=ticks)[0][1])
    total = np.asarray(run(state))
    return {name: int(total[code]) for name, code in sorted(jev.KINDS.items())}


def main() -> int:
    out = {}
    for name, cfg, batch, ticks, genome, seg_len in chip_smoke.trace_rows("cpu"):
        t0 = time.perf_counter()
        jcfg = RaftConfig(**dataclasses.asdict(cfg))
        jg = None
        if genome is not None:
            jg = jgenome.ScenarioGenome(**{
                f: jnp.asarray(getattr(genome, f).numpy().astype(
                    np.uint32 if f in jgenome.U32_FIELDS else np.int32))
                for f in jgenome.ScenarioGenome._fields})
        out[name] = {"batch": batch, "ticks": ticks,
                     "counts": counts(jcfg, batch, ticks, jg, seg_len)}
        print(name, f"{time.perf_counter() - t0:.1f}s", out[name]["counts"], flush=True)
    path = os.path.join(ROOT, chip_smoke.TRACE_COUNTS)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
