"""Multi-process proof: two cooperating OS processes, one global mesh (the
port of tools/multihost_check.py).

It spawns TWO processes that join a torch.distributed gloo group over a
localhost address (`parallel.init_distributed`), each running
`parallel.simulate_sharded` on its half of a global 8-shard cluster mesh (4
shards a process), gathers the metrics to every process
(`parallel.gather_metrics`, the path `summarize` takes for a slice of a
larger fleet), and checks process 0's result against a single-process run
of the same (cfg, seed, batch, ticks) on 8 shards, bit for bit. gloo
carries the control plane and the metric gather only; no tick traffic
crosses processes.

    python -m raft_sim_tpu_torch.multihost_check               # both processes on the
                                                               # first card (each shard's
                                                               # ticks through the kernel);
                                                               # one JSON verdict line,
                                                               # exit 0 on a match
    python -m raft_sim_tpu_torch.multihost_check --device cpu  # the same on the CPU
    python -m raft_sim_tpu_torch.multihost_check --ticks 64    # a shorter workload
    python -m raft_sim_tpu_torch.multihost_check --out P       # and write the multichip-v2
                                                               # artifact to P
                                                               # (telemetry_sink.validate_multichip)

On one card both processes share it: that proves the partition, the key
split and the multi-process control plane, not NCCL or copies between
cards. Each process has `--timeout` seconds (default 480); on a timeout or
a failure every process is stopped and the verdict says which.

Internal modes (spawned by the orchestrator, each a fresh interpreter):
    _MH_MODE=child _MH_PID={0,1} _MH_PORT=...   one process of the group
    _MH_MODE=local                              the single-process reference
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX tool's workload: faults, client traffic and invariants over the
# compaction ring with snapshot catch-up and the redirect client.
CFG_KW = dict(
    n_nodes=5,
    log_capacity=16,
    compact_margin=4,
    client_interval=4,
    client_redirect=True,
    drop_prob=0.1,
    clock_skew_prob=0.1,
)
SEED, BATCH, TICKS = 0, 16, 200
N_PROCESSES, LOCAL_SHARDS = 2, 4
GLOBAL_SHARDS = N_PROCESSES * LOCAL_SHARDS


def _run_and_dump(device: str, shards: int, ticks: int) -> dict:
    """Run the sharded simulation on this process's share of the global mesh
    (`shards` shards on `device`) and return every RunMetrics field as
    lists, the fleet summary and a timed second run (cluster-ticks/s)."""
    import torch

    from raft_sim_tpu_torch.parallel import gather_metrics, make_mesh, simulate_sharded, summarize
    from raft_sim_tpu_torch.utils.config import RaftConfig

    cfg = RaftConfig(**CFG_KW)
    mesh = make_mesh(devices=[device] * shards)
    assert mesh.size == GLOBAL_SHARDS, mesh
    _, metrics = simulate_sharded(cfg, SEED, BATCH, ticks, mesh)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m2 = simulate_sharded(cfg, SEED, BATCH, ticks, mesh)
    m2.ticks.cpu()
    wall = time.perf_counter() - t0
    summary = summarize(metrics)._asdict()  # the gather path itself
    m = gather_metrics(metrics)
    fields = {f: v.cpu().numpy().tolist() for f, v in zip(m._fields, m)}
    local = BATCH // N_PROCESSES if mesh.n_processes > 1 else BATCH
    return {"metrics": fields, "summary": summary,
            "throughput_ticks_per_s": round(local * ticks / wall, 1)}


def _per_device_bytes() -> float:
    """Bytes one shard's slice of the batch moves a tick: the tick kernel's
    reads and writes (kernels/tick_engine.traffic_bytes) at the slice's
    batch -- cluster sharding moves no plane between shards."""
    from raft_sim_tpu_torch.kernels import tick_engine
    from raft_sim_tpu_torch.utils.config import RaftConfig

    rd, wr = tick_engine.traffic_bytes(RaftConfig(**CFG_KW), BATCH // GLOBAL_SHARDS)
    return float(rd + wr)


def _parity_hash(out: dict) -> str:
    """sha256 over the gathered metrics' JSON: equal across processes iff the
    trajectories matched bit for bit."""
    return hashlib.sha256(json.dumps(out["metrics"], sort_keys=True).encode()).hexdigest()


def child(pid: int, port: str, device: str, ticks: int) -> None:
    import torch.distributed as dist

    from raft_sim_tpu_torch.parallel import init_distributed

    got = init_distributed(f"127.0.0.1:{port}", N_PROCESSES, pid)
    assert got == pid, (got, pid)
    out = _run_and_dump(device, LOCAL_SHARDS, ticks)
    if pid == 0:
        print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def local(device: str, ticks: int) -> None:
    print(json.dumps(_run_and_dump(device, GLOBAL_SHARDS, ticks)), flush=True)


def _emit_artifact(out_path: str, verdict: dict, parity_hash: str, throughput: float,
                   reference: float, platform: str) -> None:
    doc = {
        "schema": "multichip-v2",  # telemetry_sink.MULTICHIP_SCHEMA
        "match": verdict["match"],
        "n_devices": GLOBAL_SHARDS,
        "n_processes": N_PROCESSES,
        "batch": BATCH,
        "ticks": verdict["ticks"],
        "violations": verdict["violations"],
        # Cluster-ticks/s of one process's slice in the sharded run, with
        # the single-process reference's whole-batch rate beside it.
        "throughput_ticks_per_s": throughput,
        "reference_ticks_per_s": reference,
        "per_device_bytes_per_tick": _per_device_bytes(),
        "parity_hash": parity_hash,
        "platform": platform,
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def _free_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    return port


def orchestrate(device: str, out_path: str | None, timeout: float, ticks: int = TICKS) -> int:
    port = _free_port()

    def spawn(mode: str, pid: int | None = None):
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env.update(_MH_MODE=mode, _MH_PORT=port, _MH_DEVICE=device, _MH_TICKS=str(ticks))
        if pid is not None:
            env["_MH_PID"] = str(pid)
        return subprocess.Popen([sys.executable, "-u", "-m", "raft_sim_tpu_torch.multihost_check"],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, cwd=ROOT)

    procs = [spawn("child", pid) for pid in range(N_PROCESSES)] + [spawn("local")]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                print(json.dumps({"match": False, "error": f"process {i} timed out"}))
                return 1
            if p.returncode != 0:
                print(json.dumps({"match": False, "error": f"process {i} rc={p.returncode}",
                                  "stderr_tail": err[-2000:]}))
                return 1
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # The JSON payload is each process's last stdout line.
    got = json.loads(outs[0].strip().splitlines()[-1])  # process 0 of the group
    want = json.loads(outs[-1].strip().splitlines()[-1])  # the single-process reference
    # Parity is over the metrics and the summary only: the timed sample is
    # machine noise.
    h_got, h_want = _parity_hash(got), _parity_hash(want)
    match = h_got == h_want and got["summary"] == want["summary"]
    verdict = {
        "match": match,
        "n_processes": N_PROCESSES,
        "global_devices": GLOBAL_SHARDS,
        "device": device,
        "batch": BATCH,
        "ticks": ticks,
        "violations": sum(got["metrics"]["violations"]),
        "summary": got["summary"],
    }
    print(json.dumps(verdict))
    if out_path is not None:
        import torch

        _emit_artifact(out_path, verdict, h_got, got["throughput_ticks_per_s"],
                       want["throughput_ticks_per_s"], torch.device(device).type)
    return 0 if match else 1


def main(argv=None) -> int:
    mode = os.environ.get("_MH_MODE")
    if mode == "child":
        child(int(os.environ["_MH_PID"]), os.environ["_MH_PORT"], os.environ["_MH_DEVICE"],
              int(os.environ["_MH_TICKS"]))
        return 0
    if mode == "local":
        local(os.environ["_MH_DEVICE"], int(os.environ["_MH_TICKS"]))
        return 0
    ap = argparse.ArgumentParser(prog="python -m raft_sim_tpu_torch.multihost_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: where every "
                    "shard of both processes runs")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the multichip-v2 artifact here")
    ap.add_argument("--ticks", type=int, default=TICKS,
                    help=f"ticks of the workload (default {TICKS}, the JAX tool's)")
    ap.add_argument("--timeout", type=float, default=480.0,
                    help="seconds the processes get, all together (default 480)")
    args = ap.parse_args(argv)
    from raft_sim_tpu_torch.utils import device as device_mod

    device = str(device_mod.resolve(args.device))  # no card: raise here, not in three children
    return orchestrate(device, args.out, args.timeout, args.ticks)


if __name__ == "__main__":
    sys.exit(main())
