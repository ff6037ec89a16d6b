"""Committed-value export stream: the `node_<id>.log` files (the port of
raft_sim_tpu/utils/apply_log.py, which gives the reference's reasons).

An `ApplyLogWriter` follows ONE cluster of the fleet and appends each node's
newly committed values to `node_<i>.log` in a directory, one value a line,
at chunk boundaries (driver.Session.run calls `update` between chunks). Two
rules beyond a plain tail, as in the JAX writer:

  - leader no-op entries (types.NOOP) are protocol filler, not client
    values, and are skipped;
  - entries compacted away before the writer saw them appear as one
    `# snapshot gap A..B` line (1-based, inclusive): a node that caught up
    through a snapshot never holds them.

Each `update` reads the selected cluster's commit indices, bases and value
ring with one small device-to-host copy.
"""

from __future__ import annotations

import os

import torch

from raft_sim_tpu_torch.types import NOOP
from raft_sim_tpu_torch.utils.config import RaftConfig


class ApplyLogWriter:
    """Appends newly committed values of one cluster to per-node files.
    `update(state)` exports everything committed since the last call; the
    files are truncated when the writer is made."""

    def __init__(self, directory: str, cfg: RaftConfig, cluster: int = 0):
        self.cfg = cfg
        self.cluster = cluster
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.paths = [os.path.join(directory, f"node_{i}.log") for i in range(cfg.n_nodes)]
        for p in self.paths:
            open(p, "w").close()
        # Last exported 1-based entry index per node (monotone: a restarted
        # node's regressed commit exports nothing new).
        self.frontier = [0] * cfg.n_nodes

    def update(self, state) -> int:
        """Export entries committed since the last call from the [B, ...]
        `state`; returns the number of values written."""
        c, n, cap = self.cluster, self.cfg.n_nodes, self.cfg.log_capacity
        row = torch.cat(
            [state.commit_index[c], state.log_base[c], state.log_val[c].reshape(-1)]
        ).tolist()  # the one device-to-host copy
        commits, bases, vals = row[:n], row[n:2 * n], row[2 * n:]
        written = 0
        for i in range(n):
            commit, base = commits[i], bases[i]
            # Every entry in (base, commit] must still be live in the ring;
            # if not, the reads below would decode unrelated slots.
            if commit - base > cap:
                raise RuntimeError(
                    f"apply-log export would read compacted slots: node {i} "
                    f"commit {commit} - base {base} > capacity {cap} "
                    "(state advanced past a chunk boundary before update()?)"
                )
            f = self.frontier[i]
            if commit <= f:
                continue
            with open(self.paths[i], "a") as fh:
                if f < base:
                    fh.write(f"# snapshot gap {f + 1}..{base}\n")
                    f = base
                for idx1 in range(f + 1, commit + 1):
                    v = vals[i * cap + (idx1 - 1) % cap]
                    if v != NOOP:
                        fh.write(f"{v}\n")
                        written += 1
            self.frontier[i] = commit
        return written

    def values(self, node: int) -> list[int]:
        """The exported value stream of one node (gap markers excluded)."""
        with open(self.paths[node]) as fh:
            return [int(line) for line in fh if not line.startswith("#")]

    def gaps(self, node: int) -> list[tuple[int, int]]:
        """(first, last) 1-based index spans lost to compaction at `node`."""
        out = []
        with open(self.paths[node]) as fh:
            for line in fh:
                if line.startswith("# snapshot gap "):
                    a, b = line.split()[-1].split("..")
                    out.append((int(a), int(b)))
        return out
