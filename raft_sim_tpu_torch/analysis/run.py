"""Orchestration: run the passes, apply the waivers, time each pass (the port
of the JAX package's analysis/run.py).

`raft_sim_tpu_torch/check.py` (`python -m raft_sim_tpu_torch check`) is the
CLI face; this module is the library face the tests call. The default
waiver file is `analysis/waivers.json` beside it.
"""

from __future__ import annotations

import os
import time

from raft_sim_tpu_torch.analysis import ast_lint, cost_model, op_audit, race_audit, range_audit
from raft_sim_tpu_torch.analysis import findings as F

DEFAULT_WAIVERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "waivers.json")

ALL_RULES = (ast_lint.RULES | op_audit.RULES | cost_model.RULES | race_audit.RULES
             | range_audit.RULES)


def package_root() -> str:
    """The raft_sim_tpu_torch package directory (the source passes' root)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _range_pass(config_names, device: str):
    """Pass E in a worker process: (findings, seconds)."""
    import torch

    torch.set_num_threads(1)
    t0 = time.monotonic()
    return range_audit.run_pass(config_names, device=device), round(time.monotonic() - t0, 2)


def run_all(*, do_ast: bool = True, do_ops: bool = True, do_cost: bool = True,
            do_race: bool = True, do_range: bool = True, do_dynamic: bool = False,
            config_names=op_audit.AUDIT_CONFIGS, waivers_path: str | None = DEFAULT_WAIVERS,
            device: str = "cpu"):
    """Run the selected passes. Returns (findings, unused_waivers, problems,
    timings, info): `problems` are waiver-file format errors (fatal for the
    CLI), `timings` {pass: wall seconds}, `info` the dynamic leg's counters
    and, on the card, K1's passthrough note. The audit ticks and the dynamic
    leg run on `device`. Pass E runs in a worker process beside the others
    (the passes share nothing)."""
    found: list[F.Finding] = []
    active: set[str] = set()
    timings: dict[str, float] = {}
    info: dict = {}

    def timed(name, rules, fn):
        t0 = time.monotonic()
        found.extend(fn())
        timings[name] = round(time.monotonic() - t0, 2)
        active.update(rules)

    pool = fut = None
    if do_range:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        fut = pool.submit(_range_pass, tuple(config_names), device)
    if do_ast:
        timed("ast", ast_lint.RULES, lambda: ast_lint.run_pass(package_root()))
    if do_ops:
        timed("ops", op_audit.RULES, lambda: op_audit.run_pass(
            config_names, device=device, collectives=device == "cpu"))
        if device.startswith("cuda"):
            info["k1_passthrough"] = op_audit.k1_notes(config_names, device)
    if do_cost:
        timed("cost", cost_model.RULES, lambda: cost_model.run_pass(config_names, device=device))
    if do_race:
        def race():
            out = race_audit.run_pass(package_root())
            if do_dynamic:
                from raft_sim_tpu_torch.analysis import sanitizer

                dyn, info["dynamic"] = sanitizer.run_dynamic(device)
                out.extend(dyn)
            return out

        timed("race", race_audit.RULES, race)
    if fut is not None:
        with pool:
            range_found, timings["range"] = fut.result()
        found.extend(range_found)
        active.update(range_audit.RULES)
    unused: list[dict] = []
    problems: list[str] = []
    if waivers_path:
        entries, problems = F.load_waivers(waivers_path)
        unused = F.apply_waivers(found, entries)
        # A waiver is stale only if the pass owning its rule ran; a rule no
        # pass knows (a typo) is stale whenever the full gate ran.
        full = do_ast and do_ops and do_cost and do_race and do_range
        unused = [w for w in unused
                  if w.get("rule") in active or (full and w.get("rule") not in ALL_RULES)]
    return found, unused, problems, timings, info
