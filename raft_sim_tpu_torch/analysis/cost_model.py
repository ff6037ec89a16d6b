"""Pass C: the port's cost model (the counterpart of
the JAX package's analysis/cost_model.py, which prices lowered jaxprs against
TPU-padded pins).

The port prices what its own structures and its recorded ticks say, without
TPU padding, against its own pins in tests/golden_torch_cost.json
(`python -m raft_sim_tpu_torch check --update-goldens` regenerates them).
Nothing here reads the JAX package's cost pins or a TPU bench artifact:
those are TPU numbers.

  cost-carry-bytes        per-leg logical bytes per cluster-tick of the carry
                          (state, mailbox, metrics) and of StepInputs, for
                          each tier in its layout (dense, or compacted under
                          compact_planes): a new or grown leg is a finding.
  cost-live-peak          the live bytes of one recorded tick: on the CPU the
                          recorder's allocation ledger (op_audit.OpRecorder,
                          deterministic for a given op stream); on the card
                          `torch.cuda.max_memory_allocated` around the audit
                          ticks (chip_smoke.py reports it; never pinned).
  cost-release            the counterpart of cost-donation: at each chunk
                          boundary a registered loop (policy.
                          releasing_entry_points) holds no more than the
                          running carry and the next one -- a loop that keeps
                          earlier chunks' carries grows here.
  cost-roofline           K1's bytes per cluster-tick (`tick_engine.
                          traffic_bytes`, each live leg read once and written
                          once) over the H100's 3.35 TB/s, as obs/reconcile.py
                          prices a row: a bytes growth is a finding.
  cost-mesh-bytes         the node-sharded program's per-shard carry bytes and
                          mailbox/leaders gather bytes per cluster-tick for
                          the giant-N tiers over their MESH_TIERS shards.
  cost-golden             a missing or stale pin, or a failed derivation: a
                          regression fires the rule above it, an improvement
                          fires this one (the pin is stale), as in JAX.
  cost-kernel-resources   the card-only rule: ptxas's registers, stack and
                          spill bytes of each K1 instantiation of the build
                          against the pins (checked where nvcc runs:
                          chip_smoke.py, tests/test_torch_cuda.py, and
                          `check --device cuda`).
"""

from __future__ import annotations

import functools
import json
import math
import os
import re

import torch

from raft_sim_tpu_torch import types as port_types
from raft_sim_tpu_torch.analysis import op_audit, policy
from raft_sim_tpu_torch.analysis.findings import Finding
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

RULES = frozenset({
    "cost-carry-bytes", "cost-live-peak", "cost-release", "cost-roofline",
    "cost-mesh-bytes", "cost-golden", "cost-kernel-resources",
})

DEFAULT_TOLERANCE = {"carry_bytes": 0.01, "live_peak": 0.05, "roofline": 0.02}

# NVIDIA H100 SXM HBM3, the data sheet's rate (obs/reconcile.py prices rows
# on the same number).
HBM_BYTES_PER_S = 3.35e12

MESH_TIERS: tuple[tuple[str, int], ...] = (("config7", 8), ("config7x", 8))

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_REGEN = "regenerate with `python -m raft_sim_tpu_torch check --update-goldens` if intended"


def golden_path() -> str:
    return os.path.join(_REPO_ROOT, "tests", "golden_torch_cost.json")


def _leaf_bytes(x: torch.Tensor) -> int:
    """Bytes per cluster of a [1, ...]-leading leaf."""
    return policy.logical_bytes(tuple(x.shape[1:]), x.element_size())


def carry_legs(cfg: RaftConfig) -> dict[str, int]:
    """{carry leg: logical bytes per cluster} in the config's layout: state
    and mailbox legs, then the metric legs."""
    from raft_sim_tpu_torch.sim import scan

    state, _, _ = policy.state_shapes(cfg)
    legs = {leg: _leaf_bytes(x) for leg, x in policy.state_leaves(state).items()}
    for f, x in zip(scan.RunMetrics._fields, scan.init_metrics_batch(1)):
        legs[f"metric.{f}"] = _leaf_bytes(x)
    return legs


def input_legs(cfg: RaftConfig) -> dict[str, int]:
    """{StepInputs leg: logical bytes per cluster} of one tick's inputs."""
    _, inputs, _ = policy.state_shapes(cfg)
    return {f: _leaf_bytes(getattr(inputs, f)) for f in inputs._fields}


def k1_bytes(cfg: RaftConfig, batch: int) -> float:
    """K1's bytes per cluster-tick at `batch` (read + written, dense view:
    the kernel runs on it under compact_planes)."""
    from raft_sim_tpu_torch.kernels import tick_engine

    dense = port_types.compact_twin(cfg, False)
    rd, wr = tick_engine.traffic_bytes(dense, batch)
    return (rd + wr) / batch


def node_shard_model(name: str, n_shards: int) -> dict:
    """Per-shard logical bytes of the node-sharded tick for one preset's
    dense twin: the moving carry legs (twice: read and written) at the
    row-partitioned shapes (first node axis nl = n_pad / shards, peer axes
    n_pad), and the gather traffic a tick -- the mailbox legs `_gather_mailbox`
    gathers and, under check_invariants, the [n_pad] leaders by term -- per
    cluster. Shape arithmetic only."""
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.parallel import nodeshard

    cfg = port_types.compact_twin(PRESETS[name][0], False)
    n_pad = nodeshard.check_shardable(cfg, n_shards)
    nl = n_pad // n_shards
    state, _, _ = policy.state_shapes(cfg)
    leaves = policy.state_leaves(state)
    axes_of = {f: a for f, (a, _) in nodeshard._STATE_PAD.items()}
    axes_of.update({f"mb.{f}": a for f, (a, _) in nodeshard._MAILBOX_PAD.items()})
    moving = set(leaves) - policy.invariant_leaves(cfg)

    def shaped(leg: str, first: int) -> int:
        shape = list(leaves[leg].shape[1:])
        for ax in axes_of.get(leg, ()):
            shape[ax] = first if ax == 0 else n_pad
        return policy.logical_bytes(tuple(shape), leaves[leg].element_size())

    carry = sum(2 * shaped(leg, nl) for leg in sorted(moving))
    gathered = list(raft_batched._GATHERED)
    if cfg.track_offer_ticks:
        gathered.append("ent_tick")
    if cfg.compaction:
        gathered += ["req_base", "req_base_term", "req_base_chk"]
    if cfg.pre_vote:
        gathered.append("pv_grant")
    legs_out = {f"mb.{f}": shaped(f"mb.{f}", n_pad) for f in gathered}
    if cfg.check_invariants:
        legs_out["leaders_by_term"] = n_pad * 4
    gather = sum(legs_out.values())
    return {
        "n_nodes": cfg.n_nodes, "n_shards": n_shards, "n_pad": n_pad, "nl": nl,
        "per_shard_carry_bytes": carry,
        "gather_bytes_per_tick": gather,
        "gathered_legs": legs_out,
    }


def derive_tier(name: str, cfg: RaftConfig, batch: int, device: str = "cpu") -> dict:
    """One tier's derived cost entry."""
    legs = carry_legs(cfg)
    ins = input_legs(cfg)
    peaks = {v: op_audit.program(name, cfg, v, device).live_peak for v in op_audit.VARIANTS}
    kb = k1_bytes(cfg, batch)
    return {
        "layout": "compact" if cfg.compact_planes else "dense",
        "batch": batch,
        "carry_legs": legs,
        "carry_bytes": sum(legs.values()),
        "input_legs": ins,
        "input_bytes": sum(ins.values()),
        "live_peak": peaks,
        "live_peak_batch": op_audit.AUDIT_BATCH,
        "k1_bytes_per_cluster_tick": kb,
        "k1_bound_ns_per_cluster_tick": kb / HBM_BYTES_PER_S * 1e9,
    }


@functools.lru_cache(maxsize=4)
def _derive_all(config_names: tuple, device: str) -> dict:
    tiers, errors = {}, {}
    for name in config_names:
        cfg, batch = PRESETS[name]
        try:
            tiers[name] = derive_tier(name, cfg, batch, device)
        except Exception as ex:  # a derivation failure must be visible
            errors[name] = f"{type(ex).__name__}: {ex}"
    mesh = {f"{name}@{d}": node_shard_model(name, d) for name, d in MESH_TIERS
            if name in config_names}
    return {"torch_version": torch.__version__, "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "tiers": tiers, "mesh": mesh, "errors": errors}


def derive_all(config_names=op_audit.AUDIT_CONFIGS, device: str = "cpu") -> dict:
    """The derived cost document for the audited tiers (cached; read-only)."""
    return _derive_all(tuple(config_names), device)


def _tol(golden: dict, key: str) -> float:
    return float((golden.get("tolerance") or {}).get(key, DEFAULT_TOLERANCE[key]))


def _bytes_rule(rule: str, path: str, what: str, got: float, pin: float, tol: float) -> list:
    """A regression fires `rule`; an improvement fires cost-golden."""
    if got > pin * (1 + tol):
        return [Finding(rule=rule, path=path,
                        message=(f"{what} grew {pin:,.1f} -> {got:,.1f} B (>{100 * tol:.0f}% "
                                 f"tolerance) -- {_REGEN}"))]
    if got < pin * (1 - tol):
        return [Finding(rule="cost-golden", path=path,
                        message=(f"{what} improved {pin:,.1f} -> {got:,.1f} B: the pin is stale "
                                 f"-- {_REGEN} to lock in the win"))]
    return []


def compare_tier(name: str, d: dict, g: dict, golden: dict) -> list[Finding]:
    """One tier's findings against its pin."""
    path = f"cost:{name}"
    out: list[Finding] = []
    tol_b = _tol(golden, "carry_bytes")
    for group in ("carry_legs", "input_legs"):
        pins = g.get(group) or {}
        for leg, b in d[group].items():
            if leg not in pins:
                out.append(Finding(
                    rule="cost-carry-bytes", path=path,
                    message=(f"{group[:-5]} leg '{leg}' ({b} B a cluster-tick) is new: the pinned "
                             f"set does not include it -- {_REGEN}")))
            else:
                out.extend(_bytes_rule("cost-carry-bytes", path, f"{group[:-5]} leg '{leg}'", b,
                                       pins[leg], tol_b))
        for leg in pins:
            if leg not in d[group]:
                out.append(Finding(
                    rule="cost-golden", path=path,
                    message=f"pinned {group[:-5]} leg '{leg}' is gone: the pin is stale -- {_REGEN}"))
    tol_p = _tol(golden, "live_peak")
    for v, peak in d["live_peak"].items():
        pin = (g.get("live_peak") or {}).get(v)
        if pin is None:
            out.append(Finding(rule="cost-golden", path=f"{path}/{v}",
                               message=f"no pinned live peak -- {_REGEN}"))
        else:
            out.extend(_bytes_rule("cost-live-peak", f"{path}/{v}",
                                   f"live peak of one tick at B={d['live_peak_batch']}", peak, pin,
                                   tol_p))
    pin = g.get("k1_bytes_per_cluster_tick")
    if pin is None:
        out.append(Finding(rule="cost-golden", path=path, message=f"no pinned K1 bytes -- {_REGEN}"))
    else:
        out.extend(_bytes_rule(
            "cost-roofline", path,
            f"K1 bytes per cluster-tick (bound {d['k1_bound_ns_per_cluster_tick']:.4f} ns at "
            "3.35 TB/s)", d["k1_bytes_per_cluster_tick"], pin, _tol(golden, "roofline")))
    return out


def compare(derived: dict, golden: dict, *, full: bool = True) -> list[Finding]:
    """All pinned Pass C findings. `full`: every audited tier was derived,
    so a pinned tier with no derived entry is stale."""
    out: list[Finding] = []
    for name, err in derived["errors"].items():
        out.append(Finding(rule="cost-golden", path=f"cost:{name}",
                           message=(f"cost derivation failed ({err}): this tier's pins are NOT "
                                    "being checked")))
    g_tiers = golden.get("tiers") or {}
    for name, d in derived["tiers"].items():
        g = g_tiers.get(name)
        if g is None:
            out.append(Finding(rule="cost-golden", path=f"cost:{name}",
                               message=f"tier has no golden cost pin -- {_REGEN}"))
            continue
        out.extend(compare_tier(name, d, g, golden))
    g_mesh = golden.get("mesh") or {}
    tol_b = _tol(golden, "carry_bytes")
    for key, d in derived["mesh"].items():
        g = g_mesh.get(key)
        if g is None:
            out.append(Finding(rule="cost-golden", path=f"cost:mesh/{key}",
                               message=f"mesh tier has no golden cost pin -- {_REGEN}"))
            continue
        for k in ("per_shard_carry_bytes", "gather_bytes_per_tick"):
            out.extend(_bytes_rule("cost-mesh-bytes", f"cost:mesh/{key}", k, d[k], g[k], tol_b))
    if full:
        for name in g_tiers:
            if name not in derived["tiers"] and name not in derived["errors"]:
                out.append(Finding(rule="cost-golden", path=f"cost:{name}",
                                   message=f"golden pins a tier no longer derived -- {_REGEN}"))
        for key in g_mesh:
            if key not in derived["mesh"]:
                out.append(Finding(rule="cost-golden", path=f"cost:mesh/{key}",
                                   message=f"golden pins a mesh tier no longer derived -- {_REGEN}"))
    return out


# ------------------------------------------------------------- cost-release

RELEASE_CHUNKS = 4
RELEASE_BATCH = 2


def _tiny_cfg() -> RaftConfig:
    return RaftConfig(n_nodes=3, log_capacity=4, max_entries_per_rpc=1, client_interval=2)


def release_boundaries(loop: str) -> tuple[list[int], int]:
    """Run one registered loop tiny on the CPU under the allocation ledger
    and return (live bytes at each chunk boundary, bytes of one carry: the
    fleet state plus its metrics). The fleet is seeded outside the ledger,
    so only what the loop allocates is counted."""
    from raft_sim_tpu_torch.serve.ingest import CommandSource
    from raft_sim_tpu_torch.serve.loop import ServeSession
    from raft_sim_tpu_torch.sim import chunked, scan, telemetry

    cfg = _tiny_cfg()
    state, keys = scan.seed_fleet(cfg, 0, RELEASE_BATCH, torch.device("cpu"))
    carry = op_audit._tree_bytes((state, scan.init_metrics_batch(RELEASE_BATCH)))
    rec = op_audit.OpRecorder(cfg.n_nodes)
    live: list[int] = []

    def at_boundary(*args):
        # The window records a telemetry chunk hands its callback are its
        # output, not carry.
        exported = op_audit._tree_bytes(args[3]) if len(args) > 3 else 0
        live.append(rec.live - exported)
        return False

    ticks = 2 * RELEASE_CHUNKS
    with rec:
        if loop == "run_chunked":
            chunked.run_chunked(cfg, state, keys, ticks, chunk=2, callback=at_boundary)
        elif loop == "run_chunked_telemetry":
            telemetry.run_chunked_telemetry(cfg, state, keys, ticks, 2, chunk=2,
                                            callback=at_boundary)
        else:
            sess = ServeSession(cfg, batch=RELEASE_BATCH, seed=0, chunk=2, window=2,
                                delta_depth=2, device="cpu")
            sess.serve(CommandSource(iter([7, 1, 2, 9])), chunks=RELEASE_CHUNKS,
                       progress=at_boundary)
    return live, carry


RELEASE_LOOPS = {
    "run_chunked": f"{policy.PKG}/sim/chunked.py",
    "run_chunked_telemetry": f"{policy.PKG}/sim/telemetry.py",
    "serve": f"{policy.PKG}/serve/loop.py",
}


def check_release(boundaries=None) -> list[Finding]:
    """Rule cost-release: at every chunk boundary of each registered loop
    the ledger holds at most two carries (the running one and the next)
    and no more than at the first boundary. `boundaries` ({loop: (live,
    carry)}) is injectable for tests."""
    out = []
    for loop, path in RELEASE_LOOPS.items():
        live, carry = boundaries[loop] if boundaries is not None else release_boundaries(loop)
        if len(live) < 2:
            out.append(Finding(rule="cost-release", path=path,
                               message=f"{loop}: {len(live)} chunk boundaries seen, expected >= 2"))
            continue
        worst = max(live)
        if worst > 2 * carry or worst > live[0]:
            out.append(Finding(
                rule="cost-release", path=path,
                message=(f"{loop} holds {live} B at its chunk boundaries against a carry of "
                         f"{carry} B: more than the running carry and the next one, or growing "
                         "chunk by chunk -- a reference to a released carry outlives its chunk"),
            ))
    return out


# ----------------------------------------------------- cost-kernel-resources

# ptxas's (registers, stack, spill stores, spill loads) by K1 instantiation
# class (width tier, nodes a thread, body), each a [lo, hi] range over the
# index/ack/node dtype variants: the build of the library PRs 9-14 run
# (libtick_7fc5b57fb78f60fd; PERF.md section 6 quotes the width-2 one-node
# and width-8 rows).
KERNEL_RESOURCE_KEYS = ("registers", "stack", "spill_stores", "spill_loads")
_MANGLED = re.compile(r"tick_kernelI([a-z])([a-z])([a-z])Li(\d+)ELi(\d+)ELi(\d+)E")


def instantiation_class(name: str) -> str | None:
    """'w2_npt1_lean' for a mangled K1 name, None for another function."""
    m = _MANGLED.search(name)
    if m is None:
        return None
    from raft_sim_tpu_torch.kernels import tick_engine

    return f"w{m[4]}_npt{m[5]}_{tick_engine.BODIES[int(m[6])]}"


def check_kernel_resources(report: dict, pins: dict) -> list[Finding]:
    """Rule cost-kernel-resources: every K1 instantiation in a ptxas report
    (`tick_engine.ptxas_report()`) sits inside its class's pinned ranges,
    and every pinned class was built."""
    out, seen = [], set()
    path = f"{policy.PKG}/csrc/tick.cu"
    for name, res in sorted(report.items()):
        cls = instantiation_class(name)
        if cls is None:
            continue
        seen.add(cls)
        pin = pins.get(cls)
        if pin is None:
            out.append(Finding(rule="cost-kernel-resources", path=path,
                               message=f"{cls} ({name}) has no pinned ptxas resources -- {_REGEN}"))
            continue
        for k in KERNEL_RESOURCE_KEYS:
            lo, hi = pin[k]
            if not lo <= res.get(k, 0) <= hi:
                out.append(Finding(
                    rule="cost-kernel-resources", path=path,
                    message=(f"{cls} ({name}): ptxas {k} {res.get(k, 0)} outside the pinned "
                             f"[{lo}, {hi}] -- a register, stack or spill regression of K1")))
    for cls in sorted(set(pins) - seen):
        out.append(Finding(rule="cost-kernel-resources", path=path,
                           message=f"pinned instantiation class {cls} was not built"))
    return out


# ------------------------------------------------------------- entry points


def load_golden(path: str | None = None):
    """(golden document or None, problem finding or None)."""
    path = path or golden_path()
    rel = os.path.relpath(path, _REPO_ROOT)
    try:
        with open(path) as f:
            return json.load(f), None
    except FileNotFoundError:
        return None, Finding(rule="cost-golden", path=rel,
                             message=f"no golden cost pins: {_REGEN.replace('if intended', '')}"
                                     "and commit the file")
    except (OSError, json.JSONDecodeError) as ex:
        return None, Finding(rule="cost-golden", path=rel, message=f"golden cost file unreadable: {ex}")


def run_pass(config_names=op_audit.AUDIT_CONFIGS, golden_file: str | None = None,
             device: str = "cpu") -> list[Finding]:
    """The full cost pass: derive, compare with the pins, the release check,
    and on the card the kernel-resource pins of the build."""
    golden, problem = load_golden(golden_file)
    findings = check_release()
    if golden is None:
        return findings + [problem]
    derived = derive_all(config_names, device)
    full = tuple(config_names) == tuple(op_audit.AUDIT_CONFIGS)
    if device != "cpu":
        derived = dict(derived, tiers={k: dict(v, live_peak={}) for k, v in derived["tiers"].items()})
    findings += compare(derived, golden, full=full)
    if torch.device(device).type == "cuda":
        from raft_sim_tpu_torch.kernels import tick_engine

        tick_engine.build()
        findings += check_kernel_resources(tick_engine.ptxas_report(),
                                           golden.get("kernel_resources") or {})
    return findings


def update_golden(path: str | None = None, config_names=op_audit.AUDIT_CONFIGS) -> str:
    """Regenerate tests/golden_torch_cost.json from the tree (CPU). Tuned
    tolerances and the kernel-resource pins (which only a build on the card
    can produce) survive regeneration."""
    path = path or golden_path()
    derived = derive_all(config_names, "cpu")
    old: dict = {}
    try:
        with open(path) as f:
            old = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    doc = {
        "torch_version": derived["torch_version"],
        "hbm_bytes_per_s": HBM_BYTES_PER_S,
        "tolerance": dict(DEFAULT_TOLERANCE, **(old.get("tolerance") or {})),
        "tiers": {name: {k: v for k, v in d.items() if k != "k1_bound_ns_per_cluster_tick"}
                  for name, d in derived["tiers"].items()},
        "mesh": {k: {kk: vv for kk, vv in v.items() if kk != "gathered_legs"}
                 for k, v in derived["mesh"].items()},
        "kernel_resources": old.get("kernel_resources") or {},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def diff_table(derived: dict, golden: dict, out=None) -> None:
    """Pinned against current, the entries that moved."""
    import sys

    out = out or sys.stdout
    g_tiers = golden.get("tiers") or {}
    print(f"{'tier/entry':48} {'pinned':>16} {'current':>16}", file=out)
    for name, d in sorted(derived["tiers"].items()):
        g = g_tiers.get(name) or {}
        rows = [("carry_bytes", g.get("carry_bytes"), d["carry_bytes"]),
                ("input_bytes", g.get("input_bytes"), d["input_bytes"]),
                ("k1_bytes_per_cluster_tick", g.get("k1_bytes_per_cluster_tick"),
                 d["k1_bytes_per_cluster_tick"])]
        rows += [(f"live_peak/{v}", (g.get("live_peak") or {}).get(v), p)
                 for v, p in d["live_peak"].items()]
        for group in ("carry_legs", "input_legs"):
            rows += [(f"{group}/{leg}", (g.get(group) or {}).get(leg), b)
                     for leg, b in d[group].items()]
        for key, pin, cur in rows:
            if pin is None or not math.isclose(pin, cur):
                print(f"{name + '/' + key:48} {str(pin):>16} {cur:>16}", file=out)
    for key, d in sorted(derived["mesh"].items()):
        g = (golden.get("mesh") or {}).get(key) or {}
        for k in ("per_shard_carry_bytes", "gather_bytes_per_tick"):
            if g.get(k) != d[k]:
                print(f"{'mesh/' + key + '/' + k:48} {str(g.get(k)):>16} {d[k]:>16}", file=out)
