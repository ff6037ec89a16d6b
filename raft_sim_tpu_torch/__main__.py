"""Command line: `python -m raft_sim_tpu_torch run|bench|presets`.

`run` and `presets` are the port of raft_sim_tpu/driver.py's subcommands, cut
down to --preset/--batch/--ticks/--seed/--device: `run` calls
sim.scan.simulate and prints the fleet summary as one JSON line, with the wall
time and the device it ran on. `bench` is the port of bench.py (bench.py in
this package): one JSON document of bench rows. The default device is the
card; with none present `run` and `bench` fail rather than running on the CPU
(pass --device cpu for that).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from raft_sim_tpu_torch import bench
from raft_sim_tpu_torch.sim import scan
from raft_sim_tpu_torch.summary import summarize
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run", help="simulate a batch of clusters")
    run_p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    run_p.add_argument("--batch", type=int, default=None)
    run_p.add_argument("--ticks", type=int, default=1000)
    run_p.add_argument("--seed", type=int, default=0)
    run_p.add_argument("--device", default="cuda")
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

    cfg, batch = PRESETS[args.preset] if args.preset else (RaftConfig(), 1)
    if args.batch is not None:
        batch = args.batch
    dev = device_mod.resolve(args.device)
    t0 = time.perf_counter()
    _, metrics = scan.simulate(cfg, args.seed, batch, args.ticks, device=dev)
    out = summarize(metrics)._asdict()  # copies to the host: waits for the device
    dt = time.perf_counter() - t0
    out["wall_s"] = dt
    out["cluster_ticks_per_s"] = batch * args.ticks / dt
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
