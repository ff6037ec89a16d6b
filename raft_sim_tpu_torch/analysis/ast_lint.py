"""Pass B: AST rules over the port's source, and the contract checks that
tie `types.py`'s comments and the checkpoint pin to the live structures (the
port of the JAX package's analysis/ast_lint.py).

Source rules (pure `ast`, nothing runs):

  host-sync        the counterpart of JAX's `traced-branch`: no Python
                   `if`/`while`/conditional expression on a tensor value, and
                   no `bool()`/`int()`/`float()`, `.item()`, `.tolist()`,
                   `.cpu()` or `.numpy()` of one, in `models/`, `sim/`, `ops/`
                   and `kernels/`. Under jit such a branch crashes; on the
                   card each one waits for the device, once a tick. Taint as
                   in JAX: parameters typed ClusterState, StepInputs,
                   Mailbox, StepInfo, RunMetrics or torch.Tensor are tensor
                   values, and so is whatever is computed from one or
                   returned by a `torch.` call. Metadata (`.shape`, `.dtype`,
                   `.device`, `len()`, `is None`) and config branches are not.
                   The port's deliberate syncs (the host's copy of `now`,
                   read once a run; the chunk loops' one sync a chunk) are
                   waived with their reasons in analysis/waivers.json.
  float-literal    no bare float literal as an argument of a `torch.` call in
                   `models/`, `sim/` and `ops/`: the protocol path is
                   integer-only.
  parse-error      a file that does not parse.

Contract rules (one tiny CPU tick, one tiny checkpoint round trip):

  dtype-comment            the `# [shape] dtype` comments of types.py parse
                           (policy.parse_types_comments) and match the dtypes
                           and ranks `init_rows` / `make_inputs` / `step_b`
                           produce at COMMENT_CHECK_CONFIGS (a uint32 leg at
                           its int32 carrier).
  checkpoint-version       the serialized field set hashes to the pin in
                           `utils/checkpoint._SCHEMA_FINGERPRINT`, and the pin
                           names `FORMAT_VERSION`.
  checkpoint-serialization a real save()'s npz key set equals the key set
                           derived from the NamedTuple fields, and load()
                           reads it back.
"""

from __future__ import annotations

import ast
import os
import tempfile

import numpy as np

from raft_sim_tpu_torch.analysis import policy
from raft_sim_tpu_torch.analysis.findings import Finding, dedupe
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

RULES = frozenset({
    "host-sync", "float-literal", "parse-error", "dtype-comment",
    "checkpoint-version", "checkpoint-serialization",
})

# Packages whose functions must not read a tensor value back to the host.
HOST_SYNC_DIRS = ("models", "sim", "ops", "kernels")
# Packages where float literals must not enter torch calls.
FLOAT_LITERAL_DIRS = ("models", "sim", "ops")

# Parameter annotations that mark a value as a tensor value.
TENSOR_ANNOTATIONS = {
    "ClusterState", "StepInputs", "Mailbox", "StepInfo", "RunMetrics", "Tensor",
    "torch.Tensor",
}

# Tensor attributes and methods that are host metadata, not device values.
META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda", "layout", "_fields"})
META_METHODS = frozenset({
    "dim", "numel", "size", "element_size", "data_ptr", "stride", "is_contiguous",
    "untyped_storage", "get_device", "_replace", "_asdict",
})
# Builtins whose result is host metadata whatever their argument.
HOST_FUNCS = frozenset({"len", "isinstance", "type", "hasattr", "callable", "id", "getattr"})
# `torch.<x>` calls that return no tensor.
TORCH_HOST = frozenset({
    "cuda", "backends", "device", "dtype", "iinfo", "finfo", "is_tensor", "Size",
    "get_default_dtype", "no_grad", "inference_mode", "utils", "distributed", "profiler",
    "autograd", "get_num_threads", "set_num_threads", "is_floating_point", "promote_types",
})
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
SYNC_BUILTINS = frozenset({"bool", "int", "float"})

# Config tiers the dtype-comment contract is checked against: the int8 index
# tier (config3), the int16 tier (config1), compaction's int32 and the
# redirect pipeline (config6r), and the wide cluster (config5).
COMMENT_CHECK_CONFIGS = ("config3", "config1", "config6r", "config5")


def _ann_name(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_ann_name(node.value)}.{node.attr}"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split("[")[0].split("|")[0].strip()
    if isinstance(node, ast.BinOp):  # `torch.Tensor | None`
        return _ann_name(node.left)
    return ""


def _root_name(node) -> str:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


def _torch_call(call: ast.Call) -> bool:
    """A call of `torch.<x>...` that returns a tensor."""
    parts = []
    f = call.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if not (isinstance(f, ast.Name) and f.id == "torch" and parts):
        return False
    return parts[-1] not in TORCH_HOST


def _targets(node):
    """Flat Name targets of an assignment target (tuple unpacking included)."""
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _targets(elt)
    elif isinstance(node, ast.Starred):
        yield from _targets(node.value)


class _FunctionLint:
    """Taint analysis and the host-sync checks for one function body."""

    def __init__(self, fn, path: str, findings: list[Finding]):
        self.fn = fn
        self.path = path
        self.findings = findings
        self.tainted: set[str] = set()
        args = fn.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            name = _ann_name(a.annotation) if a.annotation is not None else ""
            if name in TENSOR_ANNOTATIONS or name.split(".")[-1] in TENSOR_ANNOTATIONS:
                self.tainted.add(a.arg)

    def tainted_expr(self, node) -> bool:
        """Whether an expression's value is (or holds) a tensor value."""
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            return node.attr not in META_ATTRS and self.tainted_expr(node.value)
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            # The element decides: a comprehension over tensors of their
            # metadata (`x.element_size() for x in ...`) holds no tensor value.
            saved = set(self.tainted)
            for gen in node.generators:
                if self.tainted_expr(gen.iter):
                    self.tainted.update(_targets(gen.target))
            elts = (node.key, node.value) if isinstance(node, ast.DictComp) else (node.elt,)
            hit = any(self.tainted_expr(e) for e in elts)
            self.tainted = saved
            return hit
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return self.tainted_expr(node.left) or any(self.tainted_expr(c) for c in node.comparators)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in HOST_FUNCS | SYNC_BUILTINS:
                return False
            if isinstance(f, ast.Attribute) and f.attr in META_METHODS | SYNC_METHODS:
                return False
            if _torch_call(node):
                return True
            if isinstance(f, ast.Attribute) and self.tainted_expr(f.value):
                return True
            return any(self.tainted_expr(a) for a in node.args) or any(
                self.tainted_expr(k.value) for k in node.keywords)
        return any(self.tainted_expr(c) for c in ast.iter_child_nodes(node))

    def _flag(self, node, what: str) -> None:
        self.findings.append(Finding(
            rule="host-sync", path=self.path, line=node.lineno,
            message=(f"{what} in {self.fn.name}(): reading a tensor value on the host "
                     "waits for the device (a sync a tick on the card); keep tick code "
                     "in torch.where lattices and read back outside the tick"),
        ))

    def run(self):
        # Two propagation sweeps handle use-before-later-taint orderings.
        for _ in range(2):
            for node in ast.walk(self.fn):
                if isinstance(node, ast.Assign) and self.tainted_expr(node.value):
                    for tgt in node.targets:
                        self.tainted.update(_targets(tgt))
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None \
                        and self.tainted_expr(node.value):
                    self.tainted.update(_targets(node.target))
                elif isinstance(node, (ast.For, ast.comprehension)) and self.tainted_expr(node.iter):
                    self.tainted.update(_targets(node.target))
        for node in ast.walk(self.fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)) and self.tainted_expr(node.test):
                kind = {ast.If: "if", ast.While: "while", ast.IfExp: "conditional expression"}
                self._flag(node, f"Python `{kind[type(node)]}` on a tensor value")
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name) and f.id in SYNC_BUILTINS and node.args \
                        and self.tainted_expr(node.args[0]):
                    self._flag(node, f"`{f.id}()` of a tensor value")
                elif isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS \
                        and self.tainted_expr(f.value):
                    self._flag(node, f"`.{f.attr}()` of a tensor value")


def _lint_host_sync(tree: ast.AST, path: str, findings: list[Finding]):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _FunctionLint(node, path, findings).run()


def _lint_float_literals(tree: ast.AST, path: str, findings: list[Finding]):
    def scan_args(node, call_line):
        """Float constants in a call's argument subtree, not descending into
        nested calls other than torch's."""
        if isinstance(node, ast.Call) and _root_name(node.func) != "torch":
            return
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            findings.append(Finding(
                rule="float-literal", path=path, line=getattr(node, "lineno", call_line),
                message=(f"bare float literal {node.value!r} entering a torch call in a "
                         "hot-path module: the protocol path is integer-only (types.py); "
                         "name the constant and cast explicitly if a float is intended"),
            ))
            return
        for child in ast.iter_child_nodes(node):
            scan_args(child, call_line)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _root_name(node.func) == "torch":
            for arg in (*node.args, *(kw.value for kw in node.keywords)):
                scan_args(arg, node.lineno)


def lint_source(source: str, path: str) -> list[Finding]:
    """The source rules over one file's text; `path` (repo-relative) decides
    which rules apply and anchors the findings."""
    try:
        tree = ast.parse(source)
    except SyntaxError as ex:
        return [Finding(rule="parse-error", path=path, line=ex.lineno or 0,
                        message=f"does not parse: {ex.msg}")]
    parts = path.replace("\\", "/").split("/")
    findings: list[Finding] = []
    if any(d in parts for d in HOST_SYNC_DIRS):
        _lint_host_sync(tree, path, findings)
    if any(d in parts for d in FLOAT_LITERAL_DIRS):
        _lint_float_literals(tree, path, findings)
    return findings


def iter_package_files(root: str):
    """(absolute path, repo-relative path) of every .py file under `root`
    (the package directory), in sorted order."""
    repo = os.path.dirname(os.path.abspath(root.rstrip("/")))
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(("__pycache__", "build")))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                yield full, os.path.relpath(full, repo).replace(os.sep, "/")


def lint_tree(root: str) -> list[Finding]:
    """The source rules over every .py file under `root`."""
    findings: list[Finding] = []
    for full, rel in iter_package_files(root):
        with open(full) as f:
            findings.extend(lint_source(f.read(), rel))
    return findings


# ------------------------------------------------------------ contract rules

TYPES_PATH = f"{policy.PKG}/types.py"
CHECKPOINT_PATH = f"{policy.PKG}/utils/checkpoint.py"


def check_dtype_comments(configs=COMMENT_CHECK_CONFIGS, source: str | None = None) -> list[Finding]:
    """Rule dtype-comment: the parsed field contracts hold against the live
    structures at every tier of `configs` (`source`: a types.py text to
    parse instead of the module's, for tests)."""
    from raft_sim_tpu_torch.types import Mailbox

    specs, problems = policy.parse_types_comments(source)
    findings = [Finding(rule="dtype-comment", path=TYPES_PATH, line=ln, message=msg)
                for ln, msg in problems]
    for name in configs:
        cfg, _ = PRESETS[name]
        state, inputs, info = policy.state_shapes(cfg)
        actual = {
            "ClusterState": {f: getattr(state, f) for f in state._fields if f != "mailbox"},
            "Mailbox": {f: getattr(state.mailbox, f) for f in Mailbox._fields},
            "StepInputs": {f: getattr(inputs, f) for f in inputs._fields},
            "StepInfo": {f: getattr(info, f) for f in info._fields},
        }
        for cls, fields in actual.items():
            for fname, leaf in fields.items():
                spec = specs.get(cls, {}).get(fname)
                if spec is None:
                    findings.append(Finding(
                        rule="dtype-comment", path=TYPES_PATH,
                        message=(f"{cls}.{fname} has no parseable `# [shape] dtype` comment: "
                                 "the dtype contract must stay machine-readable"),
                    ))
                    continue
                allowed = policy.resolve_dtypes(spec, cfg)
                if leaf.dtype not in allowed:
                    findings.append(Finding(
                        rule="dtype-comment", path=TYPES_PATH, line=spec.line,
                        message=(f"{cls}.{fname} is {policy.dtype_name(leaf.dtype)} under "
                                 f"{name} but the comment declares {'/'.join(spec.dtypes)}"),
                    ))
                ndim = leaf.dim() - 1  # one cluster: the leading [1] is the batch
                if spec.ndim is not None and ndim != spec.ndim:
                    findings.append(Finding(
                        rule="dtype-comment", path=TYPES_PATH, line=spec.line,
                        message=(f"{cls}.{fname} has ndim {ndim} under {name} but the "
                                 f"comment declares ndim {spec.ndim}"),
                    ))
    return dedupe(findings)


def check_checkpoint_version(pin=None, version=None) -> list[Finding]:
    """Rule checkpoint-version: the field-set fingerprint matches the pin and
    the pin names the current format version (`pin`/`version` injectable
    for tests)."""
    from raft_sim_tpu_torch.utils import checkpoint

    pin_version, pin_hash = checkpoint._SCHEMA_FINGERPRINT if pin is None else pin
    version = checkpoint.FORMAT_VERSION if version is None else version
    out = []
    actual = policy.schema_fingerprint()
    if actual != pin_hash:
        out.append(Finding(
            rule="checkpoint-version", path=CHECKPOINT_PATH,
            message=(f"serialized field sets hash to {actual} but _SCHEMA_FINGERPRINT pins "
                     f"{pin_hash}: a ClusterState/Mailbox/RunMetrics field changed -- bump "
                     "FORMAT_VERSION and refresh the pin"),
        ))
    if pin_version != version:
        out.append(Finding(
            rule="checkpoint-version", path=CHECKPOINT_PATH,
            message=(f"_SCHEMA_FINGERPRINT pins version {pin_version} but FORMAT_VERSION is "
                     f"{version}: refresh the pin alongside the version bump"),
        ))
    return out


def check_checkpoint_serialization() -> list[Finding]:
    """Rule checkpoint-serialization: one tiny save()'s npz key set equals
    the derived key set, and load() reads it back."""
    import torch

    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.utils import checkpoint

    cfg = RaftConfig(n_nodes=2, log_capacity=4, max_entries_per_rpc=1)
    state, keys = scan.seed_fleet(cfg, 0, 1, torch.device("cpu"))
    metrics = scan.init_metrics_batch(1)
    out = []
    with tempfile.TemporaryDirectory() as td:
        fp = checkpoint.save(os.path.join(td, "ck"), cfg, state, keys, metrics)
        with np.load(fp) as z:
            actual = set(z.files)
        expected = policy.expected_checkpoint_keys()
        for missing in sorted(expected - actual):
            out.append(Finding(rule="checkpoint-serialization", path=CHECKPOINT_PATH,
                               message=f"save() omitted expected npz key {missing!r}"))
        for extra in sorted(actual - expected):
            out.append(Finding(rule="checkpoint-serialization", path=CHECKPOINT_PATH,
                               message=f"save() wrote unexpected npz key {extra!r}"))
        try:
            checkpoint.load(fp, device="cpu")
        except Exception as ex:  # any load failure is the finding itself
            out.append(Finding(rule="checkpoint-serialization", path=CHECKPOINT_PATH,
                               message=f"load() cannot read back save()'s output: {ex}"))
    return out


def run_pass(package_root: str) -> list[Finding]:
    """The full source and contract pass."""
    out = lint_tree(package_root)
    out.extend(check_dtype_comments())
    out.extend(check_checkpoint_version())
    out.extend(check_checkpoint_serialization())
    return out
