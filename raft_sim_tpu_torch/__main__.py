"""Command line: `python -m raft_sim_tpu_torch run|serve|scenario|bench|presets`.

`run`, `serve` and `presets` are the port of raft_sim_tpu/driver.py's
subcommands: `run` drives a `driver.Session` (chunked runs, checkpoints with
--save and --resume, the apply-log stream, the telemetry sink, one flag per
RaftConfig field) and prints the fleet summary as one JSON line, with the
wall time and the device it ran on (driver.py); `serve` runs the standing
fleet of serve/loop.py on a JSONL command source (tenants, read demands, the
telemetry and delta streams); `scenario run|search|shrink` is the scenario
engine (scenario/: nemesis programs, the violation hunt, repro artifacts).
`bench` is the port of bench.py (bench.py in
this package): one JSON document of bench rows. The default device is the
card; with none present `run`, `serve` and `bench` fail rather than running
on the CPU (pass --device cpu for that); so does `scenario`.
"""

from __future__ import annotations

import argparse
import sys

from raft_sim_tpu_torch import bench, driver
from raft_sim_tpu_torch.utils.config import PRESETS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch")
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
