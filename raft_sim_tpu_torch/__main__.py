"""Command line: `python -m raft_sim_tpu_torch run|serve|scenario|bench|presets|check`.

`run`, `serve` and `presets` are the port of raft_sim_tpu/driver.py's
subcommands: `run` drives a `driver.Session` (chunked runs, checkpoints with
--save and --resume, the apply-log stream, the telemetry sink, one flag per
RaftConfig field) and prints the fleet summary as one JSON line, with the
wall time and the device it ran on (driver.py); `serve` runs the standing
fleet of serve/loop.py on a JSONL command source (tenants, read demands, the
telemetry and delta streams); `scenario run|search|farm|shrink` is the
scenario engine (scenario/: nemesis programs, the violation hunt, repro
artifacts) and the fuzzing farm (farm/). `run` and `serve` take --perf (the
chunk timer, obs/) and --health (the SLO monitors, health/); they and
`scenario search|farm` take --profile DIR (a torch.profiler trace).
`check` is the analyzer's gate (check.py: the five passes of
raft_sim_tpu_torch/analysis, the port of tools/check.py). `run` and `serve`
take --sanitize (the release-poison sanitizer, analysis/sanitizer.py).
`bench` is the port of bench.py (bench.py in
this package): one JSON document of bench rows, or with --measurement-pass
--out P the measurement pass (the A/B pairs, the mesh-scaling leg and the
reconciliation against the card's roofline for K1's bytes). `run --devices
N` shards the fleet, telemetry, trace and offers included. The default
device is the card; with none present `run`, `serve` and `bench` fail
rather than running on the CPU (pass --device cpu for that); so does
`scenario`.

The tools run as modules of the package, each on the card unless given
--device cpu where it runs a tick:
  python -m raft_sim_tpu_torch.repro                the first violation of a seeded run;
                                                    --scenario/--corpus replay artifacts
  python -m raft_sim_tpu_torch.metrics_report       render, validate and diff telemetry
                                                    directories and measurement documents
  python -m raft_sim_tpu_torch.device_parity_check  the card against the CPU, bit for bit
  python -m raft_sim_tpu_torch.traffic_audit        bytes per cluster-tick, leaf by leaf
  python -m raft_sim_tpu_torch.multihost_check      two processes against one run
  python -m raft_sim_tpu_torch.kernel_times         the kernel's time per cell (the card)
  python -m raft_sim_tpu_torch.profile              a torch.profiler trace of a run
"""

from __future__ import annotations

import argparse
import sys

from raft_sim_tpu_torch import bench, driver
from raft_sim_tpu_torch.utils.config import PRESETS


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["check"]:
        from raft_sim_tpu_torch import check

        return check.main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m raft_sim_tpu_torch", formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="tools: " + __doc__[__doc__.index("The tools run"):])
    sub = ap.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run", help="simulate a batch of clusters")
    driver.add_run_arguments(run_p)
    serve_p = sub.add_parser("serve", help="standing-fleet service loop: streamed client "
                             "commands in, telemetry windows and commit deltas out")
    driver.add_serve_arguments(serve_p)
    sc_p = sub.add_parser("scenario", help="the scenario engine: phased nemesis runs, the "
                          "violation-hunting search and hit shrinking")
    sc_parsers = driver.add_scenario_arguments(sc_p)
    bench_p = sub.add_parser("bench", help="cluster-ticks/s and quality rows per preset")
    bench.add_arguments(bench_p)
    sub.add_parser("presets", help="list the config presets")
    sub.add_parser("check", help="the analyzer's gate (raft_sim_tpu_torch/check.py; "
                   "`check --help` for its flags)")
    args = ap.parse_args(argv)

    if args.cmd == "bench":
        return bench.run(bench_p, args)
    if args.cmd == "serve":
        return driver.serve(serve_p, args)
    if args.cmd == "scenario":
        return driver.scenario(sc_parsers, args)
    if args.cmd == "presets":
        for name, (cfg, batch) in sorted(PRESETS.items()):
            print(f"{name}: batch={batch} {cfg}")
        return 0
    return driver.run(run_p, args)


if __name__ == "__main__":
    sys.exit(main())
