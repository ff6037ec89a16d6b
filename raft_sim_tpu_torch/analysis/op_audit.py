"""Pass A: run the audited tick programs under a recording dispatch mode and
audit the aten ops they issue (the counterpart of
the JAX package's analysis/jaxpr_audit.py, which walks lowered jaxprs).

torch has no jaxpr. What stands in for one is the op stream of a real tick:
`OpRecorder`, a `TorchDispatchMode`, sees every aten op the tick issues with
its input and output dtypes and shapes (and, for the cost pass, each new
allocation). A program is one tick at B = AUDIT_BATCH of a tier in
AUDIT_CONFIGS: the input draws, the plain tick `step_b` and the metric fold
(`scan.tick_batch_minor`), in four variants as the JAX package audits them:
the scalar path (`simulate`), the genome path (`scenario_simulate`), the
served tick under `serve_config` with offer planes (`serve_simulate`), and
the traced tick under `track_trace` with the event fold (`trace_simulate`).
The tick runs on the device the caller names: the CPU in the tests, the
card in `chip_smoke.py`, where the op dtypes must equal the CPU's.

  float-op           any floating dtype in or out of an op, or a Python
                     float argument: the protocol path is integer-only.
  plane-widening     an op whose [N, N] (batch-minor [N, N, B]) integer
                     output is wider than every tensor it read, by type
                     promotion, unless only reductions consume it:
                     `torch.where` of two Python scalars returns int64
                     (ROADMAP, the first trap). Reductions and explicit
                     casts (`.to`, deliberate; carry-dtype guards what
                     persists) are exempt, and the rule is scoped to planes:
                     masked int64 carries uint32 elsewhere. JAX flags the
                     explicit convert instead: XLA fuses promotions away.
  carry-dtype        every carried state and metric leaf leaves the tick at
                     its input's dtype and the declared one (types.py, or
                     the packed word's carrier under compact_planes).
  carry-passthrough  the legs the tier's gates leave untouched
                     (policy.invariant_leaves) come back from `step_b` as the
                     same tensors. K1 (`step_cuda`) returns fresh buffers by
                     design (the trace extractor reads the pre-tick state):
                     on the card the rule records, as a note, the bytes K1
                     rewrites for those legs (`k1_passthrough_note`).
  large-constant     a factory op (a fill or a literal table, no tensor
                     input) inside the tick whose output is over
                     LARGE_CONST_BYTES.
  recompile-fork     each FORK_PAIRS tuning change gives the same op-sequence
                     hash (names, dtypes and shapes; values ignored) in the
                     scalar, genome and traced ticks, and the same K1
                     instantiation
                     (`tick_engine.kernel_report`: the card's library, or
                     the g++ host build of the same body on the CPU).
  node-collectives   a node-sharded tick (config7x's dense twin over 2 CPU
                     shards) takes only the exchanges parallel/comm.py
                     declares: one mailbox gather and at most one leaders
                     gather a tick, and the folds, counted by kind.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import shutil
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from raft_sim_tpu_torch import types as port_types
from raft_sim_tpu_torch.analysis import policy
from raft_sim_tpu_torch.analysis.findings import Finding
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

RULES = frozenset({
    "float-op", "plane-widening", "carry-dtype", "carry-passthrough",
    "large-constant", "recompile-fork", "node-collectives",
})

# Reductions a widened plane may legally feed: the widening is then an
# accumulator, never a materialized wider plane.
REDUCERS = frozenset({
    "sum", "amax", "amin", "max", "min", "any", "all", "prod", "argmax", "argmin",
    "count_nonzero",
})
# Explicit casts (`.to`): deliberate, and carry-dtype guards what persists.
CASTS = frozenset({"_to_copy", "to", "type_as", "_to_dtype"})
# Factory ops: a tensor from no tensor input -- a fill or a literal table.
# Iotas (`arange`, `eye`) are computed in place, as JAX's iota is, and are no
# baked constant (threefry's counter plane is one).
FACTORIES = frozenset({
    "full", "zeros", "ones", "empty", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "empty_strided", "new_full", "new_zeros", "new_ones", "new_empty",
})
# Baked-in constants above this are flagged (the JAX package's threshold).
LARGE_CONST_BYTES = 64 * 1024

AUDIT_BATCH = 4  # clusters of an audited tick: shapes scale, op streams do not
AUDIT_SEGMENTS = 2  # genome segments of the scenario variant
AUDIT_SEG_LEN = 16
AUDIT_TRACE_DEPTH = 32
VARIANTS = ("simulate", "scenario_simulate", "serve_simulate", "trace_simulate")
# The fork guard's variants: the scalar and genome input paths and the traced
# tick (the served tick is the scalar one with offer planes).
FORK_VARIANTS = ("simulate", "scenario_simulate", "trace_simulate")
LITERALS = frozenset({"lift_fresh", "lift_fresh_copy"})

# The config tiers audited by default: one per structural family (the JAX
# package's AUDIT_CONFIGS).
AUDIT_CONFIGS = (
    "config1", "config3", "config4", "config5", "config5c", "config6",
    "config6r", "config7", "config7x", "config8", "config9", "config10",
)

# (preset, replacements) pairs for recompile-fork: pure tuning changes that
# must leave every program's op stream and K1's instantiation as they are
# (the JAX package's FORK_PAIRS).
FORK_PAIRS: tuple[tuple[str, dict], ...] = (
    ("config2", {"client_interval": 12}),
    ("config3", {"heartbeat_ticks": 4, "ack_timeout_ticks": 16}),
    ("config4", {"drop_prob": 0.23, "clock_skew_prob": 0.13}),
    ("config5", {"partition_prob": 0.4}),
    ("config5c", {"partition_prob": 0.4}),
    ("config6", {"crash_prob": 0.2, "drop_prob": 0.15}),
    ("config6r", {"client_interval": 8, "crash_down_ticks": 10}),
    ("config8", {"reconfig_interval": 53, "transfer_interval": 31, "read_interval": 5,
                 "drop_prob": 0.15}),
    ("config9", {"read_lease_ticks": 3, "read_interval": 5, "client_interval": 6,
                 "clock_skew_prob": 0.2}),
    ("config10", {"fsync_interval": 5, "fsync_jitter_prob": 0.35, "torn_tail_prob": 0.15,
                  "lost_suffix_span": 5, "crash_prob": 0.2}),
)


def _op_name(func) -> str:
    """'add' for aten.add.Tensor."""
    return func._overloadpacket.__name__


_DTYPE_NAMES: dict = {}
_SCALARS = frozenset({int, float, bool, str, type(None)})


def _sig(x):
    if type(x) in _SCALARS:  # before isinstance(x, torch.Tensor), which is slow for them
        return type(x).__name__
    if isinstance(x, torch.Tensor):
        name = _DTYPE_NAMES.get(x.dtype)
        if name is None:
            name = _DTYPE_NAMES[x.dtype] = policy.dtype_name(x.dtype)
        return (name, tuple(x.shape))
    if isinstance(x, (torch.dtype, torch.layout, torch.memory_format)):
        return str(x)
    return type(x).__name__  # a device too: the card's stream must hash as the CPU's


def _flat(args, kwargs) -> list:
    """The leaves of an aten call's arguments (lists of tensors unpacked)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


@dataclasses.dataclass
class OpRecord:
    """One aten op of a recorded tick: its name, its arguments' signatures
    ((dtype, shape) a tensor, the type name of a scalar) and its outputs'."""

    name: str
    ins: tuple
    outs: tuple
    factory_bytes: int = 0  # output bytes of a factory op
    consumers: list = dataclasses.field(default_factory=list)
    widening: tuple | None = None  # (from dtype, to dtype, shape) of a widened plane
    float_arg: bool = False
    moves: bool = False  # a copy between devices (a host table to the card)


class OpRecorder(TorchDispatchMode):
    """Records every aten op issued inside it (`records`), tracks which later
    ops consume each op's outputs, and keeps an allocation ledger: the bytes
    of every new storage an op creates, released when its last tensor dies
    (`live_peak`). `n` is the node count whose [N, N] planes the widening
    rule watches."""

    def __init__(self, n: int, light: bool = False):
        super().__init__()
        self.n = n
        self.light = light  # names and signatures only (the fork guard's variants)
        self.records: list[OpRecord] = []
        self._producer: dict[int, tuple] = {}  # id(tensor) -> (weakref, record)
        self._seen: dict[int, weakref.ref] = {}  # storages allocated inside, by pointer
        self.live = 0
        self.live_peak = 0

    def _plane(self, shape) -> bool:
        n = self.n
        return any(shape[i] == n and shape[i + 1] == n for i in range(len(shape) - 1))

    def _alloc(self, t: torch.Tensor) -> None:
        if t._base is not None:
            return  # a view: its base holds the storage
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr == 0 or ptr in self._seen:
            return
        nbytes = st.nbytes()
        self._seen[ptr] = weakref.ref(t, self._freer(ptr, nbytes))
        self.live += nbytes
        if self.live > self.live_peak:
            self.live_peak = self.live

    def _freer(self, ptr: int, nbytes: int):
        ledger = weakref.ref(self)

        def free(_ref):
            rec = ledger()
            if rec is not None:
                rec.live -= nbytes
                rec._seen.pop(ptr, None)

        return free

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = _flat(args, kwargs)
        out = func(*args, **kwargs)
        flat_out = ([out] if isinstance(out, torch.Tensor) else
                    [x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)])
        name = _op_name(func)
        rec = OpRecord(name, tuple(_sig(x) for x in flat_in), tuple(_sig(x) for x in flat_out))
        self.records.append(rec)
        if name in CASTS | {"copy_"} and isinstance(flat_in[0], torch.Tensor) and flat_out:
            rec.moves = flat_in[0].device != flat_out[0].device
        if self.light:
            return out
        rec.float_arg = any(isinstance(x, float) for x in flat_in)
        tensors_in = [x for x in flat_in if isinstance(x, torch.Tensor)]
        for x in tensors_in:
            hit = self._producer.get(id(x))
            if hit is not None and hit[0]() is x:
                hit[1].consumers.append(name)
        if not tensors_in and name in FACTORIES:
            rec.factory_bytes = sum(x.numel() * x.element_size() for x in flat_out)
        planes_in = [x for x in tensors_in if x.dim() > 0]
        if flat_out and planes_in and name not in CASTS | REDUCERS:
            # Promotion, not a cast: the first output (a sort's values, not
            # its indices) wider than every tensor the op read.
            x, widest = flat_out[0], max(t.element_size() for t in planes_in)
            if (x.element_size() > widest and not x.dtype.is_floating_point
                    and x.dtype != torch.bool and self._plane(x.shape)):
                src = max(planes_in, key=lambda t: t.element_size()).dtype
                rec.widening = (policy.dtype_name(src), policy.dtype_name(x.dtype), tuple(x.shape))
        for x in flat_out:
            self._producer[id(x)] = (weakref.ref(x), rec)
            self._alloc(x)
        return out


def _structural(r: OpRecord) -> bool:
    """Whether an op counts in an op stream's hash and histogram: not a fill
    (no tensor input), a literal table (a `torch.tensor` lift) or its copy
    to the card -- a table built once and cached (trace/events.py's slot
    table) appears in the first tick only, and only the card copies it."""
    return r.name not in LITERALS and not r.moves and any(isinstance(x, tuple) for x in r.ins)


def op_hash(records: list[OpRecord]) -> str:
    """Hash of an op stream: names, dtypes and shapes in order, values
    ignored (a scalar contributes its type only), `_structural` ops only."""
    h = hashlib.sha256()
    for r in records:
        hash_op(h, r)
    return h.hexdigest()[:16]


def hash_op(h, r: OpRecord) -> None:
    """Fold one op into `h`, a running op_hash (a recorder that keeps no
    records)."""
    if _structural(r):
        h.update(repr((r.name, r.ins, r.outs)).encode())


def op_dtypes(records: list[OpRecord]) -> list[tuple[str, int]]:
    """The (op, output dtypes) histogram of an op stream's `_structural`
    ops, sorted: what a tick's ops compute in, on any device."""
    hist: dict[str, int] = {}
    for r in records:
        if _structural(r):
            key = f"{r.name} {'/'.join(o[0] for o in r.outs)}"
            hist[key] = hist.get(key, 0) + 1
    return sorted(hist.items())


# ------------------------------------------------------------- the programs


def serve_variant(cfg: RaftConfig) -> RaftConfig:
    from raft_sim_tpu_torch.serve.loop import serve_config

    return serve_config(cfg)


def trace_variant(cfg: RaftConfig) -> RaftConfig:
    return dataclasses.replace(cfg, track_trace=True)


def variant_config(cfg: RaftConfig, variant: str) -> RaftConfig:
    """The config a variant's tick runs (and its rules check) under."""
    if variant == "serve_simulate":
        return serve_variant(cfg)
    if variant == "trace_simulate":
        return trace_variant(cfg)
    return cfg


def audit_genome(cfg: RaftConfig, batch: int, device):
    """The scenario variant's genome: AUDIT_SEGMENTS segments of `cfg`'s own
    fault settings, every cluster the same ([B, S] leaves)."""
    from raft_sim_tpu_torch.scenario import genome as gmod

    seg = gmod.segment(
        drop_prob=cfg.drop_prob, partition_period=cfg.partition_period,
        partition_prob=cfg.partition_prob, crash_prob=cfg.crash_prob,
        crash_down_ticks=cfg.crash_down_ticks if cfg.crash_prob > 0 else 1,
        clock_skew_prob=cfg.clock_skew_prob, client_interval=cfg.client_interval,
        reconfig_interval=cfg.reconfig_interval, transfer_interval=cfg.transfer_interval,
        read_interval=cfg.read_interval, fsync_interval=cfg.fsync_interval,
        fsync_jitter_prob=cfg.fsync_jitter_prob, torn_tail_prob=cfg.torn_tail_prob,
        lost_suffix_span=cfg.lost_suffix_span)
    return gmod.broadcast(gmod.from_segments([seg] * AUDIT_SEGMENTS, device), batch)


@dataclasses.dataclass
class Program:
    """One recorded tick: its op stream, the carry it took and returned
    (batch-minor), and the allocation ledger's peak over the tick plus the
    bytes of the carry it read."""

    label: str
    cfg: RaftConfig
    records: list
    state_in: object
    state_out: object
    metrics_in: object
    metrics_out: object
    live_peak: int
    carry_bytes: int


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def run_tick(cfg: RaftConfig, variant: str, device="cpu", batch: int = AUDIT_BATCH,
             label: str = "", tick_fn=None, light: bool = False) -> Program:
    """Record one tick of `variant` (VARIANTS) at `cfg` on `device`: the
    fleet is seeded, and the tick run once, outside the recorder; the tick
    then runs again inside it. `tick_fn` replaces `scan.tick_batch_minor`
    (the tests' seeded faults)."""
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan

    dev = torch.device(device)
    vcfg = variant_config(cfg, variant)
    state, keys = scan.seed_fleet(vcfg, 0, batch, dev)
    s = raft_batched.to_batch_minor(state)
    m = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
    from raft_sim_tpu_torch.kernels import draw_engine

    # The plain draws and tick on either device, so the card's op stream is
    # the CPU's (the kernels' launches are no torch ops).
    kw: dict = {"step_fn": raft_batched.step_b, "draw_fn": draw_engine.draw_plain}
    if variant == "scenario_simulate":
        kw.update(genome=audit_genome(vcfg, batch, dev), seg_len=AUDIT_SEG_LEN)
    elif variant == "serve_simulate":
        kw["client_cmd"] = torch.arange(1, batch + 1, dtype=torch.int32, device=dev)
        if vcfg.read_index:
            kw["read_cmd"] = torch.ones(batch, dtype=torch.int32, device=dev)
    elif variant == "trace_simulate":
        kw["events"] = True
    tick = scan.tick_batch_minor if tick_fn is None else tick_fn

    def program_tick():
        out = tick(vcfg, s, keys, m, 0, **kw)
        if variant == "trace_simulate":
            from raft_sim_tpu_torch.trace import ring as tring

            spec = tring.TraceSpec(depth=AUDIT_TRACE_DEPTH)
            tring.record(vcfg, spec, tring.init_window(spec, batch, dev),
                         tring.init_persist(spec, batch, dev), out[3], s.now)
        return out

    # Once unrecorded first: tables the tick builds once and caches
    # (trace/events.py's slot table) then exist before the recorder starts,
    # so the op stream and the allocation ledger do not depend on what ran
    # earlier in the process.
    program_tick()
    rec = OpRecorder(vcfg.n_nodes, light)
    with rec:
        out = program_tick()
    return Program(label or f"ops:{variant}", vcfg, rec.records, s, out[0], m, out[1],
                   rec.live_peak + _tree_bytes((s, m, keys)), _tree_bytes((s, m)))


@functools.lru_cache(maxsize=256)
def program(name: str, cfg: RaftConfig, variant: str, device: str = "cpu") -> Program:
    """The recorded tick of tier `name` (cached: Passes A and C and the fork
    guard read the same programs)."""
    return run_tick(cfg, variant, device, label=f"ops:{name}/{variant}")


def programs(name: str, cfg: RaftConfig, device: str = "cpu"):
    """The audited programs of one tier, one per variant."""
    return [program(name, cfg, v, device) for v in VARIANTS]


# -------------------------------------------------------------------- rules


def check_float_ops(prog: Program) -> list[Finding]:
    """Rule float-op."""
    out = []
    for r in prog.records:
        floats = [s for s in (*r.ins, *r.outs)
                  if isinstance(s, tuple) and s[0] in ("float16", "bfloat16", "float32", "float64")]
        if floats or r.float_arg:
            what = f"{floats[0][0]} (shape {floats[0][1]})" if floats else "a Python float argument"
            out.append(Finding(
                rule="float-op", path=prog.label,
                message=(f"{what} at aten op '{r.name}': the protocol-state path is "
                         "integer-only (types.py)"),
            ))
    return out


def check_plane_widening(prog: Program) -> list[Finding]:
    """Rule plane-widening: a widened [N, N] plane that something other than
    a reduction consumes (or the tick returns)."""
    out = []
    for r in prog.records:
        if r.widening is None:
            continue
        if r.consumers and all(c in REDUCERS for c in r.consumers):
            continue
        src, dst, shape = r.widening
        out.append(Finding(
            rule="plane-widening", path=prog.label,
            message=(f"[N,N] plane widened {src} -> {dst} by '{r.name}' (shape {shape}, "
                     f"consumers {sorted(set(r.consumers)) or ['<returned>']}): the policy "
                     "dtypes (types.index_dtype/ack_dtype) must persist; widening is only "
                     "legal straight into a reduction"),
        ))
    return out


def expected_dtypes(cfg: RaftConfig) -> dict[str, set]:
    """{carry leg: the dtypes it may carry} under `cfg`: the types.py
    contract at the int32 carrier of uint32, or under compact_planes the
    packed word's carrier for the packed legs."""
    specs, _ = policy.parse_types_comments()
    want = {}
    for leg in policy.carry_leaf_names():
        if leg.startswith("metric."):
            want[leg] = {torch.int32}
            continue
        cls, f = ("Mailbox", leg[3:]) if leg.startswith("mb.") else ("ClusterState", leg)
        spec = specs.get(cls, {}).get(f)
        if spec is not None:
            want[leg] = policy.resolve_dtypes(spec, cfg)
    if cfg.compact_planes:
        from raft_sim_tpu_torch.ops import tile

        for leg in tile.packed_carry_dtypes(cfg):
            want[leg] = {torch.int32}
    return want


def check_carry(prog: Program) -> list[Finding]:
    """Rules carry-dtype and carry-passthrough on a recorded tick."""
    cfg = prog.cfg
    out = []
    ins = dict(policy.state_leaves(prog.state_in))
    outs = dict(policy.state_leaves(prog.state_out))
    from raft_sim_tpu_torch.sim.scan import RunMetrics

    for f in RunMetrics._fields:
        ins[f"metric.{f}"] = getattr(prog.metrics_in, f)
        outs[f"metric.{f}"] = getattr(prog.metrics_out, f)
    want = expected_dtypes(cfg)
    for leg, x in outs.items():
        bad = x.dtype != ins[leg].dtype or (leg in want and x.dtype not in want[leg])
        if bad:
            out.append(Finding(
                rule="carry-dtype", path=prog.label,
                message=(f"carried leg '{leg}' leaves the tick as {policy.dtype_name(x.dtype)}, "
                         f"entered as {policy.dtype_name(ins[leg].dtype)}; the policy dtype is "
                         f"{sorted(policy.dtype_name(d) for d in want.get(leg, ()))} (types.py)"),
            ))
    for leg in sorted(policy.invariant_leaves(cfg)):
        if outs[leg] is not ins[leg]:
            out.append(Finding(
                rule="carry-passthrough", path=prog.label,
                message=(f"carry leg '{leg}' is loop-invariant under this config's gates but "
                         "step_b returns a new tensor for it: pass the old one through "
                         "untouched, so the tick neither copies nor rewrites it"),
            ))
    return out


def check_large_constants(prog: Program) -> list[Finding]:
    """Rule large-constant."""
    return [Finding(
        rule="large-constant", path=prog.label,
        message=(f"factory op '{r.name}' makes a {r.factory_bytes}-byte constant (shape "
                 f"{r.outs[0][1] if r.outs else '?'}) inside the tick, over "
                 f"{LARGE_CONST_BYTES} B: compute it once outside the tick, carry it, or feed "
                 "it as an input"),
    ) for r in prog.records if r.factory_bytes > LARGE_CONST_BYTES]


def k1_passthrough_note(cfg: RaftConfig, s, inp) -> dict:
    """On the card: the bytes K1 (`step_cuda`, fresh output buffers by
    design) writes for the legs `step_b` passes through, one tick of the
    batch-minor state `s` -- a note, not a finding."""
    from raft_sim_tpu_torch.kernels import tick_engine

    s2, _ = tick_engine.step_cuda(cfg, s, inp)
    ins, outs = policy.state_leaves(s), policy.state_leaves(s2)
    legs = sorted(leg for leg in policy.invariant_leaves(cfg) if outs[leg] is not ins[leg])
    return {"legs": legs,
            "bytes_rewritten": sum(outs[leg].numel() * outs[leg].element_size() for leg in legs)}


def k1_notes(config_names=AUDIT_CONFIGS, device: str = "cuda") -> dict:
    """{tier: k1_passthrough_note} at AUDIT_BATCH on the card, from a fresh
    fleet's first tick."""
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import faults, scan

    out = {}
    for name in config_names:
        cfg, _ = PRESETS[name]
        state, keys = scan.seed_fleet(cfg, 0, AUDIT_BATCH, torch.device(device))
        inp = raft_batched.to_batch_minor(faults.make_inputs(cfg, keys, 0))
        out[name] = k1_passthrough_note(cfg, raft_batched.to_batch_minor(state), inp)
    return out


# ------------------------------------------------------------ recompile fork


@functools.lru_cache(maxsize=1)
def host_kernel_library():
    """The g++ build of K1's body (kernels/tick_engine.host_library), or None
    where no C++ compiler is found."""
    from raft_sim_tpu_torch.kernels import tick_engine

    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    return tick_engine.load_host(tick_engine.host_library(cxx))


def kernel_instantiation(cfg: RaftConfig, state_minor, device: str = "cpu") -> str | None:
    """K1's instantiation for one batch-minor state: the mangled kernel name
    `tick_engine.kernel_report` derives (dtype tiers, width tier, nodes per
    thread, body), through the card's library on the card and the host
    build of the same body on the CPU. None where neither is available, and
    under compact_planes the dense view's."""
    from raft_sim_tpu_torch.kernels import tick_engine
    from raft_sim_tpu_torch.ops import tile

    if cfg.compact_planes:
        cfg, state_minor = dataclasses.replace(cfg, compact_planes=False), \
            tile.unpack_state(cfg, state_minor)
    if torch.device(device).type == "cuda":
        lib = None
    else:
        lib = host_kernel_library()
        if lib is None:
            return None
    n = cfg.n_nodes
    s_slots = n if n <= 32 else 16 * tick_engine.width_tier(n)  # tick_engine.block_shape's s
    return tick_engine.kernel_report(cfg, state_minor, -(-n // s_slots), lib=lib)["instantiation"]


def check_recompile_forks(pairs=FORK_PAIRS, device: str = "cpu") -> list[Finding]:
    """Rule recompile-fork: each (preset, tuning change) pair records the
    same op stream in every FORK_VARIANTS program, and K1's instantiation
    is the same."""
    out = []
    for name, repl in pairs:
        base, _ = PRESETS[name]
        variant_cfg = dataclasses.replace(base, **repl)
        for v in FORK_VARIANTS:
            a = program(name, base, v, device)
            b = run_tick(variant_cfg, v, device, light=True)
            ha, hb = op_hash(a.records), op_hash(b.records)
            if ha != hb:
                out.append(Finding(
                    rule="recompile-fork", path=f"ops:{name}/{v}",
                    message=(f"tuning-only change {repl} changed the tick's op stream "
                             f"({ha} -> {hb}, {len(a.records)} -> {len(b.records)} ops): a Python "
                             "branch or a shape now depends on a tuned value"),
                ))
        ka = kernel_instantiation(base, program(name, base, "simulate", device).state_in, device)
        kb = kernel_instantiation(variant_cfg, run_tick(variant_cfg, "simulate", device,
                                                        light=True).state_in, device)
        if ka != kb:
            out.append(Finding(
                rule="recompile-fork", path=f"ops:{name}/k1",
                message=(f"tuning-only change {repl} changed K1's instantiation ({ka} -> {kb}): "
                         "a tuned value now picks the kernel's template"),
            ))
    return out


# ---------------------------------------------------------- node collectives

NODE_COLLECTIVE_CONFIG = "config7x"
NODE_SHARDS = 2
NODE_TICKS = 2


def node_collective_counts(name: str = NODE_COLLECTIVE_CONFIG, shards: int = NODE_SHARDS,
                           ticks: int = NODE_TICKS, batch: int = 2) -> tuple[RaftConfig, dict]:
    """(config, collective counts by kind) of a node-sharded run of `name`'s
    dense twin over `shards` CPU shards (parallel/nodeshard.py)."""
    from raft_sim_tpu_torch.parallel import nodeshard

    cfg = port_types.compact_twin(PRESETS[name][0], False)
    mesh = nodeshard.make_node_mesh(shards, devices=["cpu"] * shards)
    counts: dict = {}
    nodeshard.simulate_node_sharded(cfg, 0, batch, ticks, mesh, counts=counts)
    return cfg, counts


def check_node_collectives(cfg: RaftConfig, counts: dict, ticks: int,
                           name: str = NODE_COLLECTIVE_CONFIG) -> list[Finding]:
    """Rule node-collectives over one run's counts (`node_collective_counts`)."""
    from raft_sim_tpu_torch.parallel import comm

    path = f"ops:{name}/node_sharded"
    kinds = {k: v for k, v in counts.items() if k != "meetings"}
    out = []
    bad = sorted(set(kinds) - comm.DECLARED_KINDS)
    if bad:
        out.append(Finding(
            rule="node-collectives", path=path,
            message=(f"node-sharded tick took undeclared exchange(s) {bad}: the shards may "
                     f"meet only at the kinds parallel/comm.py declares "
                     f"({sorted(comm.DECLARED_KINDS)})"),
        ))
    want = dict(comm.GATHERS_PER_TICK)
    if not cfg.check_invariants:
        want["leaders_gather"] = 0  # the leaders gather serves the invariant checks alone
    for kind, per_tick in want.items():
        got = kinds.get(kind, 0)
        if got != per_tick * ticks:
            out.append(Finding(
                rule="node-collectives", path=path,
                message=(f"{kind}: {got} in {ticks} ticks, declared {per_tick} a tick "
                         "(parallel/comm.py GATHERS_PER_TICK)"),
            ))
    return out


# --------------------------------------------------------------- entry point


def run_pass(config_names=AUDIT_CONFIGS, fork_pairs=FORK_PAIRS, device: str = "cpu",
             collectives: bool = True) -> list[Finding]:
    """The full op pass: the per-program rules over every tier's variants,
    the fork guard, and (on the CPU) the node-collective whitelist."""
    out: list[Finding] = []
    for name in config_names:
        cfg, _ = PRESETS[name]
        for prog in programs(name, cfg, device):
            out.extend(check_float_ops(prog))
            out.extend(check_plane_widening(prog))
            out.extend(check_carry(prog))
            out.extend(check_large_constants(prog))
    out.extend(check_recompile_forks(fork_pairs, device))
    if collectives and "config7x" in config_names:
        cfg, counts = node_collective_counts()
        out.extend(check_node_collectives(cfg, counts, NODE_TICKS))
    return out
