"""The analyzer's gate: `python -m raft_sim_tpu_torch check` (the port of
tools/check.py).

Five passes (raft_sim_tpu_torch/analysis): Pass A runs one tick of each
tier's programs under a recording dispatch mode and audits the aten ops;
Pass B lints the package source and checks the types.py comments and the
checkpoint pin; Pass C prices the carry, the inputs, a tick's live bytes,
the chunk loops' release and K1's bytes against tests/golden_torch_cost.json;
Pass D audits the host/device concurrency of the chunk loops (with the
runtime release-poison leg under --dynamic); Pass E proves value ranges
with an interval interpreter over a captured graph of each tier's tick
(analysis/interval.py), holds the values of real audit ticks to the proof,
and checks the ceilings, pack widths and horizons against
tests/golden_torch_ranges.json. The audit ticks and the dynamic leg run on
--device: the card by default, which fails without one, as every entry
point of the package does; pass --device cpu to run on the CPU.

    python -m raft_sim_tpu_torch check --all --device cpu     # every pass
    python -m raft_sim_tpu_torch check --all --format json --device cpu
    python -m raft_sim_tpu_torch check --ast --device cpu     # source and contracts
    python -m raft_sim_tpu_torch check --ops --configs config3,config5 --device cpu
    python -m raft_sim_tpu_torch check --race --dynamic       # + the sanitizer, on the card
    python -m raft_sim_tpu_torch check --cost-diff --device cpu
    python -m raft_sim_tpu_torch check --range --device cpu   # Pass E: the proof and its witness
    python -m raft_sim_tpu_torch check --range-diff --device cpu
    python -m raft_sim_tpu_torch check --update-goldens --device cpu

Exit codes: 0 = no unwaived findings, 1 = unwaived findings (or a stale or
malformed waiver file), 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch check",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true", help="run all passes (default)")
    ap.add_argument("--ast", action="store_true", help="Pass B only (source and contracts)")
    ap.add_argument("--ops", action="store_true", help="Pass A only (the recorded op audit)")
    ap.add_argument("--cost", action="store_true", help="Pass C only (cost model)")
    ap.add_argument("--race", action="store_true",
                    help="Pass D only (use-after-release dataflow, overlap window, key reuse, "
                         "sink writers)")
    ap.add_argument("--range", action="store_true", dest="range_",
                    help="Pass E only (the interval proof, its witness run, ceilings, pack "
                         "widths, horizons)")
    ap.add_argument("--dynamic", action="store_true",
                    help="with the race pass: also run the release-poison sanitizer over short "
                         "sessions of each chunk loop, armed against unarmed")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--configs", default=None,
                    help="comma-separated presets for the op, cost and range passes (default: "
                         "analysis.op_audit.AUDIT_CONFIGS)")
    ap.add_argument("--waivers", default=None,
                    help="waiver file (default: raft_sim_tpu_torch/analysis/waivers.json); "
                         "'none' disables waiving")
    ap.add_argument("--device", default="cuda",
                    help="where the audit ticks and the dynamic leg run (default: the card)")
    ap.add_argument("--update-goldens", action="store_true",
                    help="regenerate tests/golden_torch_cost.json and tests/golden_torch_ranges.json "
                         "from the tree and exit")
    ap.add_argument("--cost-diff", action="store_true",
                    help="print the pinned-against-current cost table and exit 0")
    ap.add_argument("--range-diff", action="store_true",
                    help="print the pinned-against-current range table and exit 0")
    ap.add_argument("--cost-report", default=None, metavar="PATH",
                    help="also write the derived cost document as JSON to PATH")
    ap.add_argument("--range-report", default=None, metavar="PATH",
                    help="also write the derived range document as JSON to PATH")
    args = ap.parse_args(argv)

    import torch

    from raft_sim_tpu_torch.analysis import cost_model, op_audit, range_audit, run
    from raft_sim_tpu_torch.analysis import findings as F
    from raft_sim_tpu_torch.utils import device as device_mod
    from raft_sim_tpu_torch.utils.config import PRESETS

    try:
        device = str(device_mod.resolve(args.device))
    except RuntimeError as ex:
        print(str(ex), file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # the audits run small tensors: threads only add overhead
    config_names = op_audit.AUDIT_CONFIGS
    if args.configs:
        config_names = tuple(c.strip() for c in args.configs.split(","))
        unknown = [c for c in config_names if c not in PRESETS]
        if unknown:
            print(f"unknown preset(s) {unknown}", file=sys.stderr)
            return 2

    if args.update_goldens:
        if args.configs:
            print("--update-goldens ignores --configs: the golden files pin all audited tiers",
                  file=sys.stderr)
        try:
            paths = (range_audit.update_golden(), cost_model.update_golden())
        except range_audit.UnexplainedDivergence as ex:
            print(f"refused: {ex}", file=sys.stderr)
            return 1
        for path in paths:
            print(f"wrote {path} (torch {torch.__version__})")
        print("review the diff and commit the files alongside the change they pin")
        return 0

    if args.cost_diff:
        golden, problem = cost_model.load_golden()
        if problem is not None:
            print(problem.message, file=sys.stderr)
        cost_model.diff_table(cost_model.derive_all(config_names, device), golden or {})
        return 0

    if args.range_diff:
        derived = range_audit.report(config_names, device)
        try:
            with open(range_audit.golden_path()) as f:
                golden = json.load(f)
        except (OSError, json.JSONDecodeError) as ex:
            print(f"golden range file unreadable: {ex}", file=sys.stderr)
            golden = {}
        range_audit.diff_table(derived, golden)
        return 0

    picked = args.ast or args.ops or args.cost or args.race or args.range_
    do = {k: args.all or getattr(args, a) or not picked
          for k, a in (("ast", "ast"), ("ops", "ops"), ("cost", "cost"), ("race", "race"),
                       ("range", "range_"))}
    if args.dynamic and not do["race"]:
        print("--dynamic needs the race pass (add --race or --all)", file=sys.stderr)
        return 2
    waivers_path = run.DEFAULT_WAIVERS
    if args.waivers:
        waivers_path = None if args.waivers == "none" else args.waivers

    t0 = time.time()
    found, unused, problems, timings, info = run.run_all(
        do_ast=do["ast"], do_ops=do["ops"], do_cost=do["cost"], do_race=do["race"],
        do_range=do["range"], do_dynamic=args.dynamic, config_names=config_names,
        waivers_path=waivers_path, device=device)
    elapsed = time.time() - t0
    unwaived = [f for f in found if not f.waived]

    for flag, key, derive in (
            (args.cost_report, "cost", lambda: cost_model.derive_all(config_names, device)),
            (args.range_report, "range", lambda: range_audit.report(config_names, device))):
        if flag and do[key]:
            with open(flag, "w") as f:
                json.dump(derive(), f, indent=1, sort_keys=True)
                f.write("\n")
        elif flag:
            print(f"--{key}-report ignored: the {key} pass is not selected", file=sys.stderr)

    if args.format == "json":
        doc = F.report(found, unused_waivers=unused, extras={
            "elapsed_s": round(elapsed, 2), "pass_elapsed_s": timings,
            "waiver_problems": problems, "device": device, "info": info})
        print(json.dumps(doc, indent=2))
    else:
        for f in found:
            tag = f"WAIVED ({f.waiver_reason})" if f.waived else "FAIL"
            print(f"[{tag}] {f.rule} {f.location()}\n    {f.message}")
        for w in unused:
            print(f"[STALE WAIVER] {w.get('rule')} {w.get('path')}: matched no finding -- "
                  f"remove it ({w.get('reason')})")
        for p in problems:
            print(f"[WAIVER FILE ERROR] {p}")
        per_pass = " ".join(f"{k}={v:.1f}s" for k, v in timings.items())
        print(f"{len(found)} finding(s): {len(unwaived)} unwaived, {len(found) - len(unwaived)} "
              f"waived, {len(unused)} stale waiver(s) ({elapsed:.1f}s on {device}: {per_pass})")
    return 1 if (unwaived or unused or problems) else 0


if __name__ == "__main__":
    sys.exit(main())
