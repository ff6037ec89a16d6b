"""Where one tick's time goes on the card: `python -m raft_sim_tpu_torch.profile`.

    python -m raft_sim_tpu_torch.profile --preset config3 --ticks 20

Warms a fleet up for --warmup ticks of the main path (sim/scan.py `simulate`,
its wall ms a tick and then `summarize`'s ms on its metrics, host clock to a
synchronize, reported as `warmup`), then traces --ticks more with
torch.profiler and prints one JSON line:

  - window: host wall ms per tick (to a synchronize), device kernel ms per
    tick, the device's busy share of the window (kernel time over wall time;
    one stream, so kernels never overlap), kernel launches per tick, and the
    kernels with the most device time;
  - parts: the same device ms and launches per tick for each part of the tick
    traced on its own -- the input draws (kernels/draw_engine.draw_cuda: the
    draw kernel, as the main path draws), the plain draws beside them
    (`inputs`: draw_engine.draw_plain),
    the step (kernels/tick_engine.step_cuda) and the metric fold
    (scan._accumulate).

Needs a CUDA device; exits 2 without one. Where the profiler sees no device
time, the device fields are null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _device_us(prof) -> tuple[float, int, list]:
    """(total kernel device microseconds, kernel launches, top kernels).
    Only device-side rows count: the aten operator rows repeat their kernels'
    device time."""
    from torch.autograd import DeviceType

    timed = [
        e for e in prof.key_averages() if float(getattr(e, "self_device_time_total", 0.0) or 0.0) > 0
    ]
    kernels = [e for e in timed if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not kernels:  # profilers that tag no row by device: drop the operator rows
        kernels = [e for e in timed if not e.key.startswith("aten::")]
    rows = sorted(
        ((float(e.self_device_time_total), e.key, int(e.count)) for e in kernels), reverse=True
    )
    return sum(r[0] for r in rows), sum(r[2] for r in rows), rows


def _trace(fn, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    total_us, launches, rows = _device_us(prof)
    seen = total_us > 0
    return {
        "wall_ms": wall_ms,
        "device_ms": total_us / 1e3 / reps if seen else None,
        "busy_share": (total_us / 1e3 / reps) / wall_ms if seen else None,
        "launches": launches / reps if seen else None,
        "top": [
            {"kernel": k[:80], "ms": us / 1e3 / reps, "count": c / reps} for us, k, c in rows[:6]
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch.profile")
    ap.add_argument("--preset", default="config3")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: torch sees no CUDA device", file=sys.stderr)
        return 2

    from raft_sim_tpu_torch.kernels import draw_engine, tick_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.summary import summarize
    from raft_sim_tpu_torch.utils import threefry
    from raft_sim_tpu_torch.utils.config import PRESETS

    cfg, batch = PRESETS[args.preset]
    batch = args.batch or batch
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = scan.simulate(cfg, args.seed, batch, args.warmup, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    summarize(metrics)
    warmup = {"ticks": args.warmup, "ms_per_tick": (t1 - t0) * 1e3 / max(args.warmup, 1),
              "summarize_ms": (time.perf_counter() - t1) * 1e3}
    keys = threefry.split(threefry.split(threefry.key(args.seed, dev), 2)[1], batch)
    s = raft_batched.to_batch_minor(state)
    m = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
    loop = {"s": s, "m": m, "now": args.warmup}

    def tick():
        loop["s"], loop["m"], _ = scan.tick_batch_minor(cfg, loop["s"], keys, loop["m"], loop["now"])
        loop["now"] += 1

    now = args.warmup
    inp = draw_engine.draw_plain(cfg, keys, now)
    _, info = tick_engine.step_cuda(cfg, s, inp, now)
    out = {
        "preset": args.preset, "batch": batch, "ticks": args.ticks,
        "device": torch.cuda.get_device_name(0), "warmup": warmup,
        "window": _trace(tick, args.ticks),
        "parts": {
            "draws": _trace(lambda: draw_engine.draw_cuda(cfg, keys, now), args.ticks),
            "inputs": _trace(lambda: draw_engine.draw_plain(cfg, keys, now), args.ticks),
            "step": _trace(lambda: tick_engine.step_cuda(cfg, s, inp, now), args.ticks),
            "accumulate": _trace(lambda: scan._accumulate(m, info, s.now), args.ticks),
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
