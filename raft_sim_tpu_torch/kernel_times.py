"""Time the tick kernel of one checkout at full width, per cell, on one card.

    python3 raft_sim_tpu_torch/kernel_times.py [--root DIR]

Imports `raft_sim_tpu_torch` from `--root` (default: the checkout holding
this file), so one call can time two checkouts of the port -- this one and
an older one unpacked beside it -- on one card, in turns (old, new, new,
old), each in its own process. Both build their states the same way: the
preset's own batch, `simulate` through the kernel for WARM_TICKS ticks from
seed 0, then the next tick's inputs; the port is bit-exact, so both time the
same state. A cell the checkout's kernel refuses prints one "refused" line.
Cells are presets, config6-lm: config6 with log matching every tick
(the ring form, K1-b), and config4c-trace: config4c with `track_trace`, the
coverage hunt's tick (`--cells` picks some).
Per cell it prints one JSON line: device ms per launch (CUDA
events over REPS back-to-back launches, `tick_engine.time_kernel`, as
chip_smoke.py's full-width phase times it), the
bound (bytes read + written once over 3.35 TB/s), the plain PyTorch step's
ms (host clock to a synchronize, PLAIN_REPS calls) and, where the checkout
has them, the block shape and shared-memory bytes. The last line names the card
and its power limit. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# Run as a script from inside the package: drop this directory from the
# path, or the package's own modules (profile.py) shadow the standard library's.
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [q for q in sys.path if os.path.abspath(q or os.curdir) != HERE]

BW_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
WARM_TICKS = 200  # ticks simulated before timing (config5's full-width run is 200 long)
REPS = 20  # launches timed per cell
PLAIN_REPS = 3  # plain steps timed per cell
CELLS = ("config2", "config3", "config4", "config5", "config3p", "config6", "config6r", "config8",
         "config9", "config10", "config4c", "config7", "config6-lm", "config4c-trace")
# A cell's suffix: the config field it turns on.
SUFFIXES = {"-lm": "check_log_matching", "-trace": "track_trace"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(HERE), help="the checkout to time")
    ap.add_argument("--cells", default=",".join(CELLS), metavar="A,B,...",
                    help="the cells to time (default: all)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import raft_sim_tpu_torch
    from raft_sim_tpu_torch import bench
    from raft_sim_tpu_torch.kernels import tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import faults, scan
    from raft_sim_tpu_torch.utils import threefry
    from raft_sim_tpu_torch.utils.config import PRESETS

    if not os.path.abspath(raft_sim_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"raft_sim_tpu_torch imported from {raft_sim_tpu_torch.__file__}, not {root}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tick_engine.build()
    tick_engine._load_cuda()
    print(json.dumps({"root": root, "build_s": time.perf_counter() - t0}), flush=True)
    for name in args.cells.split(","):
        base, field = name, None
        for suffix, f in SUFFIXES.items():
            if name.endswith(suffix):
                base, field = name.removesuffix(suffix), f
        cfg, batch = PRESETS[base]
        if field:
            cfg = dataclasses.replace(cfg, **{field: True})
        try:
            tick_engine.check_supported(cfg)
        except NotImplementedError as e:  # an older checkout's kernel refuses the cell
            print(json.dumps({"preset": name, "refused": str(e)}), flush=True)
            continue
        final, _ = scan.simulate(cfg, 0, batch, WARM_TICKS, device=dev)
        s = raft_batched.to_batch_minor(final)
        keys = threefry.split(threefry.split(threefry.key(0, dev), 2)[1], batch)
        inp = raft_batched.to_batch_minor(faults.make_inputs(cfg, keys, WARM_TICKS))
        ms = tick_engine.time_kernel(cfg, s, inp, reps=REPS, now=WARM_TICKS)
        rd, wr = tick_engine.traffic_bytes(cfg, batch)
        raft_batched.step_b(cfg, s, inp, WARM_TICKS)  # warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PLAIN_REPS):
            raft_batched.step_b(cfg, s, inp, WARM_TICKS)
        torch.cuda.synchronize()
        row = {"preset": name, "batch": batch, "warm_ticks": WARM_TICKS, "kernel_ms": ms,
               "bound_ms": (rd + wr) / BW_BYTES_PER_S * 1e3,
               "plain_ms": (time.perf_counter() - t1) * 1e3 / PLAIN_REPS}
        if hasattr(tick_engine, "launch_shape"):
            row["shape"] = tick_engine.launch_shape(cfg, batch, dev)
        print(json.dumps(row), flush=True)
        del final, s, inp
        torch.cuda.empty_cache()
    print(json.dumps({"card": bench.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
