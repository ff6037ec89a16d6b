"""The machine-readable form of the port's dtype, carry and release policy
(the port of the JAX package's analysis/policy.py).

`types.py` states the invariants in its field comments (`# [N, N]
index_dtype in [1, cap+1]`), the loop docstrings state which carries a chunk
loop lets go of, and `utils/checkpoint.py` pins the file's schema. This
module turns each of them into data the passes check:

  - `parse_types_comments()` parses the `# [shape] dtype` comments of the
    `ClusterState` / `Mailbox` / `StepInfo` / `StepInputs` fields out of the
    port's `types.py` source (the same grammar as the JAX package's, so the
    two contracts parse to the same specs), and `resolve_dtypes()` maps
    policy names (`index_dtype`, `ack_dtype`, `node_dtype`) to the torch
    dtypes a config picks -- a uint32 leg to its int32 carrier
    (`types.u32_leaves`);
  - `state_shapes()` runs one tiny CPU tick (`init_rows`, `make_inputs`,
    `step_b`) for the live per-cluster shapes and dtypes: torch has no
    `eval_shape`;
  - `invariant_leaves()` names the carry legs a config's gates leave
    untouched (the JAX package's set, minus the metric legs: the port's
    metric fold always adds its zeros);
  - `schema_fingerprint()` hashes the checkpoint's field set as the JAX
    package does, with the uint32 legs under their public dtype, so both
    packages pin the same value for the file format they share;
  - `releasing_entry_points()` is the release registry, the counterpart of
    JAX's `donating_entry_points`: the chunk steps that take over the carry
    of a standing loop, where JAX donates it.

Nothing here runs more than one tick of a tiny fleet on the CPU.
"""

from __future__ import annotations

import ast
import functools
import hashlib
import inspect
import math
import re

import torch

from raft_sim_tpu_torch import types as port_types
from raft_sim_tpu_torch.sim.scan import RunMetrics
from raft_sim_tpu_torch.types import ClusterState, Mailbox, StepInfo, StepInputs
from raft_sim_tpu_torch.utils.config import RaftConfig

PKG = "raft_sim_tpu_torch"


def logical_bytes(shape, itemsize: int) -> int:
    """shape x itemsize; a scalar is one element."""
    return math.prod(shape) * itemsize if shape else itemsize


def dtype_name(dtype: torch.dtype) -> str:
    """'int32' for torch.int32."""
    return str(dtype).removeprefix("torch.")


# Dtype tokens legal in a types.py field comment: a concrete dtype or the
# name of a policy function in types.py that picks one per config.
CONCRETE_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint32")
POLICY_DTYPES = ("index_dtype", "ack_dtype", "node_dtype")

# The comment grammar (the JAX package's): optional shape (`[N, W]` /
# `scalar`), one or more dtype tokens separated by `/`, optionally a
# parenthesized policy name, optionally a value-range clause `in [lo, hi]`
# (a closed interval over the config symbols below), then prose.
_DTYPE_TOKEN = "|".join(CONCRETE_DTYPES + POLICY_DTYPES)
_COMMENT_RE = re.compile(
    r"^(?:\[(?P<shape>[^\]]*)\]|(?P<scalar>scalar))?\s*"
    rf"(?P<dtypes>(?:{_DTYPE_TOKEN})(?:/(?:{_DTYPE_TOKEN}))*)"
    rf"(?:\s*\((?P<policy>{'|'.join(POLICY_DTYPES)})\))?"
    r"(?:\s+in\s+\[(?P<lo>[^,\[\]]+),\s*(?P<hi>[^,\[\]]+)\])?"
)
_FIELD_RE = re.compile(r"^\s*(\w+):\s*torch\.Tensor(?:\s*=\s*[\w.+-]+)?\s*#\s*(.*)$")
_RANGE_SYMBOLS = ("cap", "sat", "E", "N", "K", "NIL")


def _range_symbols(cfg: RaftConfig) -> dict[str, int]:
    return {
        "cap": cfg.log_capacity,
        "sat": cfg.ack_age_sat,
        "E": cfg.max_entries_per_rpc,
        "N": cfg.n_nodes,
        "K": cfg.client_pipeline,
        "NIL": port_types.NIL,
    }


def parse_range_expr(expr: str) -> ast.expr:
    """Validate a range-clause bound: integer + - * over int literals and the
    config symbols. Returns the parsed AST; raises ValueError otherwise."""
    try:
        node = ast.parse(expr.strip(), mode="eval").body
    except SyntaxError as e:
        raise ValueError(f"range bound {expr!r} is not an expression: {e}")
    for sub in ast.walk(node):
        if isinstance(sub, ast.BinOp):
            if not isinstance(sub.op, (ast.Add, ast.Sub, ast.Mult)):
                raise ValueError(f"range bound {expr!r}: operator not in + - *")
        elif isinstance(sub, ast.UnaryOp):
            if not isinstance(sub.op, ast.USub):
                raise ValueError(f"range bound {expr!r}: unary op not -")
        elif isinstance(sub, ast.Constant):
            if not isinstance(sub.value, int):
                raise ValueError(f"range bound {expr!r}: non-integer literal")
        elif isinstance(sub, ast.Name):
            if sub.id not in _RANGE_SYMBOLS:
                raise ValueError(
                    f"range bound {expr!r}: unknown symbol {sub.id!r} "
                    f"(legal: {', '.join(_RANGE_SYMBOLS)})")
        elif not isinstance(sub, (ast.Add, ast.Sub, ast.Mult, ast.USub, ast.Load)):
            raise ValueError(f"range bound {expr!r}: {type(sub).__name__} not allowed")
    return node


def resolve_range_expr(expr: str, cfg: RaftConfig) -> int:
    """Evaluate a validated range bound under `cfg`'s symbol values."""
    node = parse_range_expr(expr)
    syms = _range_symbols(cfg)
    ops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b}

    def ev(n):
        if isinstance(n, ast.Constant):
            return n.value
        if isinstance(n, ast.Name):
            return syms[n.id]
        if isinstance(n, ast.UnaryOp):
            return -ev(n.operand)
        return ops[type(n.op)](ev(n.left), ev(n.right))

    return ev(node)


# Capacity-bounded range clauses are the non-compaction contract: under
# cfg.compaction the same legs carry absolute indices with no static bound
# (index_dtype widens them to int32 for that reason).
CAPACITY_RANGE_LEGS = frozenset({
    "next_index", "match_index", "commit_index", "log_len", "dur_len",
    "mb.a_match", "mb.a_hint", "mb.ent_start",
})


def range_applies(leg: str, cfg: RaftConfig) -> bool:
    """Whether `leg`'s declared range clause is in force under `cfg`."""
    return not (leg in CAPACITY_RANGE_LEGS and cfg.compaction)


class FieldSpec:
    """One parsed field-comment contract: declared ndim (None = unchecked),
    the dtype tokens the comment admits, and the optional declared range."""

    def __init__(self, name: str, line: int, ndim: int | None, dtypes: tuple[str, ...],
                 lo: str | None = None, hi: str | None = None):
        self.name = name
        self.line = line
        self.ndim = ndim
        self.dtypes = dtypes
        self.lo = lo
        self.hi = hi

    def key(self) -> tuple:
        """What the contract says, without where it says it."""
        return (self.ndim, self.dtypes, self.lo, self.hi)

    def __repr__(self):  # test/debug readability only
        rng = f", in=[{self.lo}, {self.hi}]" if self.lo is not None else ""
        return f"FieldSpec({self.name!r}, ndim={self.ndim}, dtypes={self.dtypes}{rng})"


def parse_types_comments(source: str | None = None, field_re=_FIELD_RE):
    """Parse the dtype contracts out of types.py's field comments. Returns
    ({class: {field: FieldSpec}}, problems), `problems` a list of (line,
    message) for comments that do not parse -- an unparseable comment is a
    finding. `field_re` matches a field declaration line (the JAX package's
    declares `jax.Array`; the parity tests parse its source with it)."""
    if source is None:
        source = inspect.getsource(port_types)
    tree = ast.parse(source)
    lines = source.splitlines()
    out: dict[str, dict[str, FieldSpec]] = {}
    problems: list[tuple[int, str]] = []
    for node in tree.body:
        if not (isinstance(node, ast.ClassDef) and node.name in (
                "ClusterState", "Mailbox", "StepInfo", "StepInputs")):
            continue
        fields: dict[str, FieldSpec] = {}
        for lineno in range(node.lineno, node.end_lineno + 1):
            m = field_re.match(lines[lineno - 1])
            if not m:
                continue
            name, comment = m.groups()
            cm = _COMMENT_RE.match(comment.strip())
            if not cm:
                problems.append((lineno, f"{node.name}.{name}: comment {comment!r} does not "
                                         "parse as `[shape] dtype` (see analysis/policy.py)"))
                continue
            if cm.group("shape") is not None:
                shape = cm.group("shape")
                ndim = shape.count(",") + 1 if shape.strip() else 0
            elif cm.group("scalar"):
                ndim = 0
            else:
                ndim = None
            dtypes = tuple(cm.group("dtypes").split("/"))
            if cm.group("policy"):
                dtypes = dtypes + (cm.group("policy"),)
            lo, hi = cm.group("lo"), cm.group("hi")
            if lo is not None:
                try:
                    parse_range_expr(lo)
                    parse_range_expr(hi)
                except ValueError as e:
                    problems.append((lineno, f"{node.name}.{name}: {e}"))
                    lo = hi = None
            elif comment.strip()[cm.end():].lstrip().startswith("in ["):
                problems.append((lineno, f"{node.name}.{name}: range clause in comment "
                                         f"{comment!r} does not parse as `in [lo, hi]`"))
            fields[name] = FieldSpec(name, lineno, ndim, dtypes, lo=lo, hi=hi)
        out[node.name] = fields
    return out, problems


def declared_ranges(cfg: RaftConfig, specs=None) -> dict[str, tuple[int, int]]:
    """Carry-leg name -> (lo, hi) declared range under `cfg`, for every state
    and mailbox field whose comment carries a range clause in force."""
    if specs is None:
        specs, _problems = parse_types_comments()
    out: dict[str, tuple[int, int]] = {}
    for cls, prefix in (("ClusterState", ""), ("Mailbox", "mb.")):
        for f, spec in specs.get(cls, {}).items():
            if spec.lo is None or not range_applies(prefix + f, cfg):
                continue
            out[prefix + f] = (resolve_range_expr(spec.lo, cfg), resolve_range_expr(spec.hi, cfg))
    return out


_POLICY_FNS = {
    "index_dtype": port_types.index_dtype,
    "ack_dtype": port_types.ack_dtype,
    "node_dtype": port_types.node_dtype,
}
_TORCH_DTYPES = {n: getattr(torch, n) for n in CONCRETE_DTYPES}


def resolve_dtypes(spec: FieldSpec, cfg: RaftConfig, carrier: bool = True) -> set[torch.dtype]:
    """The torch dtypes a field comment admits under `cfg`: a policy token
    narrows the concrete alternatives to the one the policy picks. With
    `carrier`, uint32 maps to the int32 that carries its bit patterns."""
    policy = [t for t in spec.dtypes if t in POLICY_DTYPES]
    if policy:
        return {_POLICY_FNS[t](cfg) for t in policy}
    out = {_TORCH_DTYPES[t] for t in spec.dtypes}
    if carrier and torch.uint32 in out:
        out = (out - {torch.uint32}) | {torch.int32}
    return out


def _batch_minor(tree):
    from raft_sim_tpu_torch.models import raft_batched

    return raft_batched.to_batch_minor(tree)


@functools.lru_cache(maxsize=32)
def state_shapes(cfg: RaftConfig):
    """(ClusterState, StepInputs, StepInfo) of one cluster after one tick on
    the CPU, leaves [1, ...]-leading: the shapes and dtypes the comment
    contracts are checked against (the JAX `state_avals`)."""
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import faults, scan

    state, keys = scan.seed_fleet(cfg, 0, 1, torch.device("cpu"))
    inputs = faults.make_inputs(cfg, keys, 0)
    _, info = raft_batched.step_b(cfg, _batch_minor(state), _batch_minor(inputs), 0)
    return state, inputs, raft_batched.from_batch_minor(info)


def invariant_leaves(cfg: RaftConfig) -> set[str]:
    """State and mailbox legs the tick leaves untouched under `cfg`'s gates
    (the JAX package's `invariant_leaves`, state fields bare, mailbox fields
    `mb.<f>`). The JAX set also names metric legs, whose folds its scan
    skips; the port's `_accumulate` adds the real zeros the tick emits, so
    they are left out here."""
    inv = set()
    if not cfg.pre_vote:
        inv |= {"mb.pv_grant"}
        if not cfg.read_lease and not cfg.reconfig:
            inv |= {"heard_clock"}
    if not cfg.compaction:
        inv |= {"mb.req_base", "mb.req_base_term", "mb.req_base_chk",
                "log_base", "base_term", "base_chk"}
    if not cfg.client_redirect:
        inv |= {"client_pend", "client_dst"}
    if not cfg.track_offer_ticks:
        inv |= {"log_tick", "mb.ent_tick", "client_tick", "lat_frontier"}
    elif not cfg.client_redirect:
        inv |= {"client_tick"}
    if not cfg.reconfig:
        inv |= {"member_old", "member_new", "cfg_epoch", "cfg_pend", "log_cfg", "mb.ent_cfg"}
    if not (cfg.reconfig and cfg.compaction):
        inv |= {"base_mold", "base_pend", "base_epoch",
                "mb.req_base_mold", "mb.req_base_pend", "mb.req_base_epoch"}
    if not (cfg.leader_transfer and (cfg.reconfig or cfg.read_lease)):
        inv |= {"mb.req_disrupt"}
    if not cfg.leader_transfer:
        inv |= {"xfer_to", "mb.xfer_tgt"}
    if not cfg.read_index:
        inv |= {"read_idx", "read_tick", "read_acks"}
    if not cfg.read_lease:
        inv |= {"read_fr"}
    if not cfg.durable_storage:
        inv |= {"dur_len", "dur_term", "dur_vote"}
    return inv


def carry_leaf_names() -> list[str]:
    """Leaf names of the tick loop's carry (state, metrics) in field order:
    state fields bare, mailbox fields `mb.<f>`, metrics `metric.<f>`."""
    names = []
    for f in ClusterState._fields:
        if f == "mailbox":
            names.extend(f"mb.{m}" for m in Mailbox._fields)
        else:
            names.append(f)
    names.extend(f"metric.{m}" for m in RunMetrics._fields)
    return names


def trace_carry_leaf_names() -> list[str]:
    """Leaf names of the traced loop's carry: the (state, metrics) legs, the
    window's first-violation tick, then the trace ring's window and persist
    legs (trace/ring.py), `trace.<f>` (the JAX package's names)."""
    from raft_sim_tpu_torch.trace.ring import TracePersist, TraceWin

    return (carry_leaf_names() + ["first_viol"]
            + [f"trace.{f}" for f in TraceWin._fields]
            + [f"trace.{f}" for f in TracePersist._fields])


def state_leaves(state: ClusterState) -> dict[str, torch.Tensor]:
    """{carry leaf name: tensor} of a state (`carry_leaf_names` order)."""
    out = {f: getattr(state, f) for f in ClusterState._fields if f != "mailbox"}
    out.update({f"mb.{f}": getattr(state.mailbox, f) for f in Mailbox._fields})
    return out


def public_dtype(leg: str, dtype: torch.dtype, cfg: RaftConfig) -> str:
    """A leg's dtype as the JAX package and the checkpoint file have it: the
    int32 carrier of a uint32 leg (`types.u32_leaves`) maps back."""
    if leg.removeprefix("mb.") in port_types.u32_leaves(cfg):
        return "uint32"
    return dtype_name(dtype)


# The fingerprint's canonical config (the JAX package's, pinned explicitly).
_FINGERPRINT_CFG = dict(n_nodes=5, log_capacity=32, max_entries_per_rpc=4)


def schema_fingerprint() -> str:
    """sha256 over the serialized schema: the ordered field names of
    (ClusterState, Mailbox, RunMetrics), each leaf's rank per cluster and
    public dtype under the canonical config -- the rows and hash the JAX
    package's analysis/policy.py computes, so the port's pin equals the JAX
    pin for the v25 file both load."""
    from raft_sim_tpu_torch.sim import scan

    cfg = RaftConfig(**_FINGERPRINT_CFG)
    state, _ = scan.seed_fleet(cfg, 0, 1, torch.device("cpu"))
    metrics = scan.init_metrics_batch(1)
    rows = [(leg, v.dim() - 1, public_dtype(leg, v.dtype, cfg))
            for leg, v in state_leaves(state).items()]
    for f, v in zip(RunMetrics._fields, metrics):
        rows.append((f"metric.{f}", v.dim() - 1, dtype_name(v.dtype)))
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def expected_checkpoint_keys() -> set[str]:
    """The npz key set `checkpoint.save` must write, derived from the field
    sets as save() derives it (rule `checkpoint-serialization`)."""
    keys = {"__version__", "seed", "config_json", "scenario_json", "keys"}
    keys |= {f"state_{f}" for f in ClusterState._fields if f != "mailbox"}
    keys |= {f"mb_{f}" for f in Mailbox._fields}
    keys |= {f"metrics_{f}" for f in RunMetrics._fields}
    return keys


# ------------------------------------------------------------ release registry

class ReleasingEntry:
    """One chunk step covered by the release policy: `label` names it,
    `path`/`func` locate its definition, `released_param` is the parameter
    whose carry it takes over (None: the caller's input stays the caller's),
    `loops` the functions that call it -- the scopes where a reference to the
    released carry kept past the call is a use-after-release."""

    def __init__(self, label: str, path: str, func: str, released_param: str | None,
                 expected: str, loops: tuple[str, ...] = ()):
        self.label = label
        self.path = path
        self.func = func
        self.released_param = released_param
        self.expected = expected
        self.loops = loops

    def __repr__(self):  # test/debug readability only
        return f"ReleasingEntry({self.label!r}, {self.expected!r})"


def releasing_entry_points() -> tuple[ReleasingEntry, ...]:
    """Which chunk steps take over their carry: the counterpart of JAX's
    `donating_entry_points`. Each `released` entry carries the
    `utils/release.releases` mark; the race pass reads the paths and
    parameters for its dataflow lint and the sanitizer wraps the entries at
    run time. A marked function missing here, or an entry whose mark is
    gone, is a `race-unregistered-release` finding."""
    return (
        ReleasingEntry("sim.chunked._chunk", f"{PKG}/sim/chunked.py", "_chunk", "state",
                       "released", loops=("run_chunked",)),
        ReleasingEntry("sim.telemetry._chunk_t", f"{PKG}/sim/telemetry.py", "_chunk_t",
                       "state", "released", loops=("run_chunked_telemetry",)),
        ReleasingEntry("serve.loop._serve_chunk", f"{PKG}/serve/loop.py", "_serve_chunk",
                       "state", "released", loops=("_dispatch",)),
        ReleasingEntry("sim.scan.simulate", f"{PKG}/sim/scan.py", "simulate", None,
                       "not-released"),
        ReleasingEntry("sim.scan.simulate_scenario", f"{PKG}/sim/scan.py",
                       "simulate_scenario", None, "not-released"),
    )
