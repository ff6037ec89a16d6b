"""Command line: `python -m raft_sim_tpu_torch run|bench|presets`.

`run` and `presets` are the port of raft_sim_tpu/driver.py's subcommands:
`run` drives a `driver.Session` (chunked runs, checkpoints with --save and
--resume, the apply-log stream, one flag per RaftConfig field) and prints the
fleet summary as one JSON line, with the wall time and the device it ran on
(driver.py). `bench` is the port of bench.py (bench.py in this package): one
JSON document of bench rows. The default device is the card; with none
present `run` and `bench` fail rather than running on the CPU (pass --device
cpu for that).
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
    bench_p = sub.add_parser("bench", help="cluster-ticks/s and quality rows per preset")
    bench.add_arguments(bench_p)
    sub.add_parser("presets", help="list the config presets")
    args = ap.parse_args(argv)

    if args.cmd == "bench":
        return bench.run(bench_p, args)
    if args.cmd == "presets":
        for name, (cfg, batch) in sorted(PRESETS.items()):
            print(f"{name}: batch={batch} {cfg}")
        return 0
    return driver.run(run_p, args)


if __name__ == "__main__":
    sys.exit(main())
