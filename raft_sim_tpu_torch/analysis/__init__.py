"""The port's analyzer: the invariants the docstrings state, checked by
machine (the port of the JAX package's analysis/).

  Pass A (`op_audit`)    runs one tick of each tier's programs under a
                         recording dispatch mode and audits the aten ops
                         (float ops, plane widening, carry dtypes and
                         passthrough, large constants, recompile forks, the
                         node-shard exchange whitelist) -- where JAX walks
                         lowered jaxprs.
  Pass B (`ast_lint`)    AST rules over the package source (host syncs in
                         tick code, float literals) and the contract checks
                         (types.py comments, the checkpoint pin and round
                         trip).
  Pass C (`cost_model`)  carry and input bytes per cluster-tick, a tick's live
                         peak, the chunk loops' release, K1's bytes over the
                         H100's rate, the node-shard bytes -- against the
                         port's own pins (tests/golden_torch_cost.json) --
                         and, on the card, K1's ptxas resources.
  Pass D (`race_audit`,  use-after-release dataflow over the chunk loops, the
  `sanitizer`)           serve loop's overlap window, threefry key reuse,
                         single-writer sinks; at run time the release-poison
                         sanitizer (`--dynamic`, `run/serve --sanitize`).
  Pass E (`range_audit`) the ceilings, pack widths and wrap horizons, and the
                         value checks of real audit ticks (narrowing casts,
                         index bounds, declared ranges) against
                         tests/golden_torch_ranges.json.

Findings are schema'd JSON (`findings`); intentional exceptions carry
one-line justifications in `analysis/waivers.json`. CLI: `python -m
raft_sim_tpu_torch check --all --device cpu`.
"""

from raft_sim_tpu_torch.analysis import (
    ast_lint, cost_model, findings, op_audit, policy, race_audit, range_audit, run, sanitizer,
)

__all__ = ["ast_lint", "cost_model", "findings", "op_audit", "policy", "race_audit",
           "range_audit", "run", "sanitizer"]
