"""Pass E's interval interpreter: value ranges proven over a captured graph
of the port's tick (the counterpart of the JAX package's
analysis/range_audit.py `_Interp`, which interprets the lowered jaxprs).

torch has no jaxpr, so the graph is captured: `Recorder`, op_audit's
`OpRecorder` (whose records give the op hash, `op_audit.hash_op`), also
notes for every aten op which earlier op (or named input, or constant)
produced each of its tensor arguments, and its outputs' dtypes and shapes. An in-place op rebinds the tensor it
mutates to a new value, and every tensor that shares its storage (a view or
its base) to the join of what it held and that value. A tensor the function
reads that no op produced and no input names is a constant: its interval
is its concrete values (the genome's leaves, a cached table).

A program (`capture_program`) is two graphs: the prologue, which builds the
loop's initial carry (`types.init_rows` from a key, the zeroed metrics), and
the body, one tick: the draws on the genome path, `step_b`, the metric fold
and, for the served and traced programs, the window's first-violation fold
and the trace ring. The body's tick is the carry leg `now` itself (a [B]
int32 tensor), so nothing of the tick's value is baked into the graph; a
host branch on the tick would bake one arm, which the capture catches by
hashing the body again at a second tick (`probe_ticks`: residues that
differ for every cadence in force) -- range_audit.audit_program compares
the two hashes, and refuses a body that reads a device value on the host.
The log-matching cadence is such a host branch
(`raft_batched.log_matching_due`, JAX's `lax.cond`): the body runs `step_b`
under both arms and joins their outputs, as JAX's `_p_cond` does.

`Interp` carries an interval `(lo, hi, taint)` per tensor (None = unknown)
through the ops. An op with no handler gives unknown, and its name is kept
in `Interp.unknown`, which the derived document lists. `audit_loop` runs
JAX's widening fixed point over the body (`MAX_ITERS`, the rate from three
history points, `H_AUDIT`, the declared legs pinned at their declaration)
and JAX's target checks; the final pass reports index and dtype findings.
Where JAX classifies after one round, `audit_loop` repeats the rounds until
the image of the widened carry moves no leg it calls stable and leaves each
rate leg within its bound plus its rate (`MAX_ROUNDS`): a leg still in the
last pass, or a rate leg whose floor or offset the widened image moves, is
not proven by one round.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import math
import os
import sys
import weakref

import torch

from raft_sim_tpu_torch.analysis import op_audit, policy
from raft_sim_tpu_torch.analysis.findings import Finding
from raft_sim_tpu_torch.utils.config import RaftConfig

#: The soak budget a monotone protocol leg must survive.
SOAK_TICKS = 10_000_000
#: Audited horizon: widened monotone legs are valued at 2x the soak budget,
#: so arithmetic downstream of a widened leg is checked with soak headroom.
H_AUDIT = 2 * SOAK_TICKS
#: Horizons are capped here (a leg that wraps after 1e12 ticks is "never").
HORIZON_CAP = 10**12
#: Widening iterations of the audited tick loop (a rate needs >= 3 points).
MAX_ITERS = 4
#: Rounds of MAX_ITERS: a leg the widened carry still moves iterates again.
MAX_ROUNDS = 4
#: A declared range is "wildly looser" than the proven interval when its
#: width exceeds LOOSE_FACTOR x the proven width plus LOOSE_SLACK.
LOOSE_FACTOR = 4
LOOSE_SLACK = 8

TOP = (None, None, False)
_PKG_DIR = os.sep + policy.PKG + os.sep
_TORCH_DIR = os.path.dirname(torch.__file__)
_HERE = os.path.abspath(__file__)

_BOUNDS = {torch.bool: (0, 1), torch.uint8: (0, 255), torch.int8: (-128, 127),
           torch.int16: (-(2**15), 2**15 - 1), torch.int32: (-(2**31), 2**31 - 1),
           torch.int64: (-(2**63), 2**63 - 1), torch.uint32: (0, 2**32 - 1)}
U32_BOUNDS = (0, 2**32 - 1)
#: The package's uint32 word arithmetic, modular by design as JAX's unsigned
#: planes are: the log checksums' products of words carried in int64, and a
#: lane packed into a word's top bit. An op issued inside one of these
#: functions may leave its dtype as a uint32 pattern (its value is then
#: unknown); anywhere else such an escape fires range-dtype-overflow.
WORD_ARITHMETIC = frozenset({
    ("ops/log_ops.py", "chk_weights_at"), ("ops/log_ops.py", "prefix_chk2_b"),
    ("ops/log_ops.py", "ring_contrib"), ("ops/tile.py", "pack_words"),
})


def known(*vals) -> bool:
    return all(v[0] is not None and v[1] is not None for v in vals)


def join(a, b):
    lo = None if a[0] is None or b[0] is None else min(a[0], b[0])
    hi = None if a[1] is None or b[1] is None else max(a[1], b[1])
    return (lo, hi, a[2] or b[2])


def join_all(vals):
    return functools.reduce(join, vals) if vals else TOP


def fmt(v) -> str:
    return f"[{'?' if v[0] is None else v[0]}, {'?' if v[1] is None else v[1]}]"


def const_iv(t: torch.Tensor):
    """The interval of a concrete tensor's values."""
    if t.dtype.is_floating_point or t.dtype.is_complex:
        return TOP
    if t.numel() == 0:
        return (0, 0, False)
    x = t.to(torch.int64) if t.dtype in (torch.bool, torch.uint32) else t
    lo, hi = torch.aminmax(x.detach())
    return (int(lo), int(hi), False)


# ------------------------------------------------------------------ capture


class Ref:
    """A tensor argument of a captured op: the value slot that holds it, and
    its dtype and shape."""

    __slots__ = ("slot", "dtype", "shape")

    def __init__(self, slot: int, dtype, shape):
        self.slot, self.dtype, self.shape = slot, dtype, shape


class Node:
    """One captured op: its name (the aten packet, e.g. 'add'), arguments
    (tensors as `Ref`s), output slots and their (dtype, shape), and the
    package site that issued it (file, line, function)."""

    __slots__ = ("op", "args", "kwargs", "outs", "meta", "site")

    def __init__(self, op, args, kwargs, outs, meta, site):
        self.op, self.args, self.kwargs = op, args, kwargs
        self.outs, self.meta, self.site = outs, meta, site


class Graph:
    """A captured function: its ops in order, the slots of its named inputs
    and outputs, the constant slots with their intervals, the op hash
    (op_audit.op_hash of its op stream), the host reads it saw, and
    `marks` (the node span of a named call, e.g. the step)."""

    def __init__(self):
        self.nodes: list[Node] = []
        self.n_slots = 0
        self.consts: dict[int, tuple] = {}
        self.inputs: dict[str, int] = {}
        self.outputs: dict[str, int] = {}
        self.slot_meta: list = []
        self.hash = ""
        self.host_reads: list = []
        self.marks: dict = {}

    def in_meta(self, name: str):
        return self.slot_meta[self.inputs[name]]


_VIEWS = frozenset({
    "view", "_unsafe_view", "permute", "select", "slice", "squeeze", "unsqueeze",
    "transpose", "expand", "unbind", "as_strided", "alias", "t", "diagonal", "unfold",
    "split", "split_with_sizes", "chunk", "narrow", "movedim", "detach", "view_as",
    "_reshape_alias", "unflatten", "indices", "values",
})
_HOST_READS = frozenset({"_local_scalar_dense", "is_nonzero", "item", "equal"})
_NO_SITE = ("?", 0, "?")


def _site():
    """(file, line, function) of the innermost frame outside torch and this
    module."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_TORCH_DIR) and fn != _HERE:
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return _NO_SITE


def _rel(fn: str) -> str:
    return fn.split(_PKG_DIR, 1)[1] if _PKG_DIR in fn else fn


def site_str(site) -> str:
    return f"{_rel(site[0])}:{site[1]}"


def word_arithmetic(node) -> bool:
    """Whether `node` was issued inside the package's uint32 word
    arithmetic (WORD_ARITHMETIC)."""
    return (_rel(node.site[0]), node.site[2]) in WORD_ARITHMETIC


class Recorder(op_audit.OpRecorder):
    """Captures every aten op issued inside it into `graph` (see the module
    docstring); each OpRecorder record (names and signatures) is folded
    into the op hash (op_audit.op_hash's, kept running) and dropped.
    `bind(name, tensor)` names an input before the capture; `output(name,
    tensor)` names an output after it."""

    def __init__(self, hash_only: bool = False):
        super().__init__(0, light=True)
        self.hash_only = hash_only  # the records and host reads only (a second tick's capture)
        self.graph = Graph()
        self._slot: dict[int, tuple] = {}  # id(tensor) -> (weakref, slot)
        self._alias: dict[int, list] = {}  # storage pointer -> weakrefs of views and bases
        self._keep: list = []
        self._hash = hashlib.sha256()

    def _new_slot(self, t: torch.Tensor) -> int:
        g = self.graph
        s = g.n_slots
        g.n_slots += 1
        g.slot_meta.append((t.dtype, tuple(t.shape)))
        self._slot[id(t)] = (weakref.ref(t), s)
        return s

    def bind(self, name: str, t: torch.Tensor) -> None:
        self._keep.append(t)
        self.graph.inputs[name] = self._new_slot(t)

    def slot_of(self, t: torch.Tensor) -> int:
        hit = self._slot.get(id(t))
        if hit is not None and hit[0]() is t:
            return hit[1]
        s = self._new_slot(t)  # a constant: no op produced it, no input names it
        with torch.utils._python_dispatch._disable_current_modes():
            self.graph.consts[s] = const_iv(t)
        self._keep.append(t)
        return s

    def output(self, name: str, t: torch.Tensor) -> None:
        self.graph.outputs[name] = self.slot_of(t)

    def _ref(self, x):
        if isinstance(x, torch.Tensor):
            return Ref(self.slot_of(x), x.dtype, tuple(x.shape))
        if isinstance(x, (list, tuple)) and any(isinstance(e, torch.Tensor) for e in x):
            return [self._ref(e) for e in x]
        return x

    def _track_alias(self, *ts) -> None:
        for t in ts:
            try:
                ptr = t.untyped_storage().data_ptr()
            except (RuntimeError, NotImplementedError):
                continue
            group = self._alias.setdefault(ptr, [])
            if not any(r() is t for r in group):
                group.append(weakref.ref(t))

    def add_node(self, op: str, args, kwargs, outs, site=None) -> None:
        """Append a node whose outputs are the tensors `outs` (rebinding
        each to a new slot)."""
        meta = tuple((t.dtype, tuple(t.shape)) for t in outs)
        slots = tuple(self._new_slot(t) for t in outs)
        self.graph.nodes.append(Node(op, args, kwargs, slots, meta, site or _NO_SITE))

    def join_into(self, target: torch.Tensor, others: list[torch.Tensor]) -> None:
        """Rebind `target` to the join of its value and `others`' (the
        arms of a host branch)."""
        if self.hash_only:
            return
        args = (Ref(self.slot_of(target), target.dtype, tuple(target.shape)),
                *(Ref(self.slot_of(o), o.dtype, tuple(o.shape)) for o in others))
        self.add_node("__join__", args, {}, (target,))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.hash_only:  # before the op: an in-place op's constant is read as it was
            rargs = tuple(self._ref(a) for a in args)
            rkw = {k: self._ref(v) for k, v in kwargs.items()} if kwargs else kwargs
        out = super().__torch_dispatch__(func, types, args, kwargs)
        rec = self.records.pop()
        op_audit.hash_op(self._hash, rec)
        name = rec.name
        if name in _HOST_READS:
            self.graph.host_reads.append((name, _site()))
            return out
        if self.hash_only:
            return out
        site = _site()
        outs = [out] if isinstance(out, torch.Tensor) else [
            x for x in (out if isinstance(out, (tuple, list)) else ()) if isinstance(x, torch.Tensor)]
        tin = [a for a in args if isinstance(a, torch.Tensor)]
        mutated = func._schema.is_mutable and tin and outs and outs[0] is tin[0]
        if mutated:
            target = tin[0]
            self.add_node(name, rargs, rkw, (target,), site)
            try:
                group = self._alias.get(target.untyped_storage().data_ptr(), ())
            except (RuntimeError, NotImplementedError):
                group = ()
            for r in group:
                t = r()
                if t is not None and t is not target:
                    self.join_into(t, [target])
            return out
        self.add_node(name, rargs, rkw, outs, site)
        if name in _VIEWS and tin:
            self._track_alias(tin[0], *outs)
        return out

    def finish(self) -> Graph:
        self.graph.hash = self._hash.hexdigest()[:16]
        self._keep.clear()
        self._slot.clear()
        self._alias.clear()
        return self.graph


def capture(fn, inputs: dict, hash_only: bool = False) -> Graph:
    """The Graph of `fn()` with `inputs` ({name: tensor}) bound; `fn`
    returns {name: tensor}, the named outputs. `hash_only`: the op hash and
    host reads only."""
    rec = Recorder(hash_only)
    for name, t in inputs.items():
        rec.bind(name, t)
    with rec:
        out = fn()
    if not hash_only:
        for name, t in out.items():
            rec.output(name, t)
    return rec.finish()


def current_recorder() -> Recorder | None:
    """The innermost Recorder capturing now, if any."""
    stack = torch.utils._python_dispatch._get_current_dispatch_mode_stack()
    return next((m for m in reversed(stack) if isinstance(m, Recorder)), None)


@contextlib.contextmanager
def mark(name: str, tensors: dict):
    """Mark the node span of a call in the graph being captured, with the
    slots of `tensors` ({name: tensor}) at its start: the step program runs
    that span alone, from those slots."""
    rec = current_recorder()
    if rec is None or rec.hash_only:
        yield
        return
    start = len(rec.graph.nodes)
    slots = {k: rec.slot_of(t) for k, t in tensors.items()}
    yield
    rec.graph.marks[name] = {"start": start, "end": len(rec.graph.nodes), "slots": slots}


# -------------------------------------------------------------- interpreter


def _iv(env, x):
    t = type(x)
    if t is Ref:
        return env[x.slot]
    if t is bool:
        return (int(x), int(x), False)
    if t is int:
        return (x, x, False)
    return TOP


def _corners(a, b, op):
    t = a[2] or b[2]
    if not known(a, b):
        return (None, None, t)
    vals = [op(x, y) for x in (a[0], a[1]) for y in (b[0], b[1])]
    return (min(vals), max(vals), t)


def _dims(dim, ndim):
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return list(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return [d % ndim if ndim else 0 for d in dim]


class Interp:
    """One interpretation run: the findings sink (muted while `report` is
    False), the program's label, and the ops that had no handler."""

    def __init__(self, program: str, findings: list):
        self.program = program
        self.findings = findings
        self.report = True
        self.unknown: collections.Counter = collections.Counter()
        self._seen: set = set()

    def emit(self, rule: str, message: str) -> None:
        if not self.report or (rule, message) in self._seen:
            return
        self._seen.add((rule, message))
        self.findings.append(Finding(rule=rule, path=self.program, message=message))

    def env(self, g: Graph, values: dict | None = None) -> list:
        env = [TOP] * g.n_slots
        for s, v in g.consts.items():
            env[s] = v
        for name, v in (values or {}).items():
            env[g.inputs[name]] = v
        return env

    def run(self, g: Graph, env: list, start: int = 0, end: int | None = None) -> list:
        for node in g.nodes[start:end]:
            h = _HANDLERS.get(node.op)
            if h is None:
                self.unknown[node.op] += 1
                t = any(env[a.slot][2] for a in _refs(node))
                outs = [(None, None, t)] * len(node.outs)
            else:
                outs = h(self, node, env)
            for slot, val, meta in zip(node.outs, outs, node.meta):
                env[slot] = self.fit(val, meta[0], node)
        return env

    def fit(self, val, dtype, node):
        """Dtype admission (JAX `_fit`): a proven signed interval escaping
        the output dtype fires range-dtype-overflow and drops to unknown.
        Unsigned and bool outputs are modular; tainted int32+ values are the
        horizon rule's."""
        b = _BOUNDS.get(dtype)
        lo, hi, t = val
        if b is None:
            return TOP
        if not ((lo is not None and lo < b[0]) or (hi is not None and hi > b[1])):
            return val
        if b[0] < 0 and not (t and dtype.itemsize >= 4):
            self.emit("range-dtype-overflow",
                      f"{node.op}: proven interval {fmt(val)} exceeds {policy.dtype_name(dtype)} "
                      f"[{b[0]}, {b[1]}] at {site_str(node.site)}")
        return (lo, hi, t) if t else (None, None, t)

    def oob(self, what: str, node, idx, size: int, dim) -> None:
        """range-index-oob: the index interval must lie in [0, size - 1]; a
        negative index, which torch wraps silently, is a finding."""
        if not self.report:
            return
        if not known(idx):
            self.emit("range-index-oob",
                      f"{what} at {site_str(node.site)}: unproven index interval {fmt(idx)} "
                      f"over dim {dim} of extent {size}")
        elif idx[0] < 0 or idx[1] > size - 1:
            self.emit("range-index-oob",
                      f"{what} at {site_str(node.site)}: index interval {fmt(idx)} is not within "
                      f"[0, {size - 1}] (dim {dim} of extent {size})")


def _refs(node):
    for a in (*node.args, *node.kwargs.values()):
        if type(a) is Ref:
            yield a
        elif type(a) is list:
            yield from (e for e in a if type(e) is Ref)


# ---- handlers: h(interp, node, env) -> [interval per output]


def _arith(op):
    def h(it, node, env):
        a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
        alpha = node.kwargs.get("alpha", 1) if node.kwargs else 1
        if alpha != 1:
            b = _corners(b, (alpha, alpha, False), lambda x, y: x * y)
        t = a[2] or b[2]
        if op == "add":
            lo = None if a[0] is None or b[0] is None else a[0] + b[0]
            hi = None if a[1] is None or b[1] is None else a[1] + b[1]
            return [(lo, hi, t)]
        if op == "sub":
            lo = None if a[0] is None or b[1] is None else a[0] - b[1]
            hi = None if a[1] is None or b[0] is None else a[1] - b[0]
            return [(lo, hi, t)]
        v = _corners(a, b, lambda x, y: x * y)
        if (node.meta[0][0] == torch.int64 and known(v) and v[1] > _BOUNDS[torch.int64][1]
                and known(a, b) and min(a[0], b[0]) >= 0 and max(a[1], b[1]) <= U32_BOUNDS[1]
                and word_arithmetic(node)):
            # A product of uint32 words carried in int64: the wrap keeps the
            # low 32 bits, which is all the checksum's modular arithmetic reads.
            return [(None, None, t)]
        return [v]
    return h


def _rsub(it, node, env):
    a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
    lo = None if b[0] is None or a[1] is None else b[0] - a[1]
    hi = None if b[1] is None or a[0] is None else b[1] - a[0]
    return [(lo, hi, a[2] or b[2])]


def _neg(it, node, env):
    a = _iv(env, node.args[0])
    return [(None if a[1] is None else -a[1], None if a[0] is None else -a[0], a[2])]


def _abs(it, node, env):
    a = _iv(env, node.args[0])
    if not known(a):
        return [(0, None, a[2])]
    if a[0] >= 0:
        return [a]
    lo = 0 if a[0] <= 0 <= a[1] else min(abs(a[0]), abs(a[1]))
    return [(lo, max(abs(a[0]), abs(a[1])), a[2])]


def _maximum(a, b):
    los = [x for x in (a[0], b[0]) if x is not None]
    lo = max(los) if los else None
    hi = None if a[1] is None or b[1] is None else max(a[1], b[1])
    return (lo, hi, a[2] or b[2])


def _minimum(a, b):
    his = [x for x in (a[1], b[1]) if x is not None]
    hi = min(his) if his else None
    lo = None if a[0] is None or b[0] is None else min(a[0], b[0])
    return (lo, hi, a[2] or b[2])


def _h_maximum(it, node, env):
    return [_maximum(_iv(env, node.args[0]), _iv(env, node.args[1]))]


def _h_minimum(it, node, env):
    return [_minimum(_iv(env, node.args[0]), _iv(env, node.args[1]))]


def _h_clamp(it, node, env):
    args = list(node.args) + [None] * (3 - len(node.args))
    lo_b = node.kwargs.get("min", args[1]) if node.kwargs else args[1]
    hi_b = node.kwargs.get("max", args[2]) if node.kwargs else args[2]
    x = _iv(env, args[0])
    if hi_b is not None:
        x = _minimum(x, _iv(env, hi_b))
    if lo_b is not None:
        x = _maximum(_iv(env, lo_b), x)
    return [x]


def _floordiv(x, y):
    return x // y


def _truncdiv(x, y):
    q = abs(x) // abs(y)
    return q if (x >= 0) == (y >= 0) else -q


def _h_div(it, node, env):
    a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
    mode = node.kwargs.get("rounding_mode") if node.kwargs else None
    if mode is None and len(node.args) > 2:
        mode = node.args[2]
    t = a[2] or b[2]
    if node.op != "floor_divide" and mode is None:
        return [(None, None, t)]  # true division: a float
    if not known(a, b) or b[0] <= 0 <= b[1]:
        return [(None, None, t)]
    op = _truncdiv if mode == "trunc" else _floordiv
    vals = [op(x, y) for x in (a[0], a[1]) for y in (b[0], b[1])]
    return [(min(vals), max(vals), t)]


def _h_remainder(it, node, env):
    """aten.remainder is floor-mod: the result takes the divisor's sign, so
    a positive divisor d gives [0, d - 1] whatever the dividend."""
    a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
    t = a[2] or b[2]
    if not known(b) or b[0] <= 0 <= b[1]:
        return [(None, None, t)]
    if b[0] > 0:
        hi = b[1] - 1
        if known(a) and a[0] >= 0:
            if a[1] < b[0]:
                return [(a[0], a[1], t)]
            hi = min(hi, a[1])
        return [(0, hi, t)]
    lo = b[0] + 1
    if known(a) and a[1] <= 0:
        if a[0] > b[1]:
            return [(a[0], a[1], t)]
        lo = max(lo, a[0])
    return [(lo, 0, t)]


def _cmp(true_if, false_if):
    def h(it, node, env):
        a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
        t = a[2] or b[2]
        if known(a, b):
            if true_if(a, b):
                return [(1, 1, t)]
            if false_if(a, b):
                return [(0, 0, t)]
        return [(0, 1, t)]
    return h


def _bool_out(node):
    return node.meta[0][0] == torch.bool


def _h_and(it, node, env):
    a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
    t = a[2] or b[2]
    if _bool_out(node) and known(a, b):
        return [(a[0] & b[0], a[1] & b[1], t)]
    # x & c for a non-negative c lies in [0, c] whatever x is (two's complement).
    his = [v[1] for v in (a, b) if known(v) and v[0] >= 0]
    if his:
        return [(0, min(his), t)]
    return [(None, None, t)]


def _h_or(it, node, env):
    a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
    t = a[2] or b[2]
    if known(a, b) and a[0] >= 0 and b[0] >= 0:
        if _bool_out(node):
            return [(a[0] | b[0], a[1] | b[1], t)]
        return [(max(a[0], b[0]), (1 << max(a[1], b[1]).bit_length()) - 1, t)]
    return [(None, None, t)]


def _h_xor(it, node, env):
    a, b = _iv(env, node.args[0]), _iv(env, node.args[1])
    t = a[2] or b[2]
    if known(a, b) and a[0] >= 0 and b[0] >= 0:
        if a[0] == a[1] and b[0] == b[1]:
            v = a[0] ^ b[0]
            return [(v, v, t)]
        return [(0, (1 << max(a[1], b[1]).bit_length()) - 1, t)]
    return [(None, None, t)]


def _h_not(it, node, env):
    a = _iv(env, node.args[0])
    if not known(a):
        return [(None, None, a[2])]
    if _bool_out(node):
        return [(1 - a[1], 1 - a[0], a[2])]
    return [(-1 - a[1], -1 - a[0], a[2])]


def _h_lshift(it, node, env):
    a, s = _iv(env, node.args[0]), _iv(env, node.args[1])
    t = a[2] or s[2]
    if not known(a, s) or s[0] < 0 or s[1] > 63:
        return [(None, None, t)]
    vals = [x << y for x in (a[0], a[1]) for y in (s[0], s[1])]
    v = (min(vals), max(vals), t)
    if (node.meta[0][0] == torch.int32 and v[0] >= 0
            and _BOUNDS[torch.int32][1] < v[1] <= U32_BOUNDS[1] and word_arithmetic(node)):
        return [(None, None, t)]  # a lane shifted into a uint32 word's top bit
    return [v]


def _h_rshift(it, node, env):
    a, s = _iv(env, node.args[0]), _iv(env, node.args[1])
    t = a[2] or s[2]
    if known(a, s) and s[0] >= 0:
        vals = [x >> y for x in (a[0], a[1]) for y in (s[0], s[1])]
        return [(min(vals), max(vals), t)]
    return [(None, None, t)]


def _identity(it, node, env):
    v = _iv(env, node.args[0])
    return [v] * len(node.outs)


def _h_join(it, node, env):
    return [join_all([_iv(env, a) for a in node.args])]


def _h_cat(it, node, env):
    return [join_all([env[r.slot] for r in node.args[0]])]


def _h_pad(it, node, env):
    value = node.args[2] if len(node.args) > 2 else node.kwargs.get("value", 0)
    return [join(_iv(env, node.args[0]), _iv(env, value))]


def _h_where(it, node, env):
    p, x, y = (_iv(env, a) for a in node.args[:3])
    if p[0] is not None and p[0] == p[1]:
        case = x if p[0] else y
        return [(case[0], case[1], case[2] or p[2])]
    return [join(x, y)]


def _h_full(it, node, env):
    return [_iv(env, node.args[2] if node.op == "new_full" else node.args[1])]


def _h_const(value):
    def h(it, node, env):
        return [(value, value, False)] * len(node.outs)
    return h


def _h_scalar_tensor(it, node, env):
    return [_iv(env, node.args[0])]


def _h_arange(it, node, env):
    a = [x for x in node.args if not isinstance(x, Ref)]
    if len(a) == 1:
        start, end, step = 0, a[0], 1
    else:
        start, end, step = a[0], a[1], (a[2] if len(a) > 2 else 1)
    if not all(isinstance(v, int) for v in (start, end, step)):
        return [TOP]
    n = len(range(start, end, step))
    if n == 0:
        return [(0, 0, False)]
    last = start + (n - 1) * step
    return [(min(start, last), max(start, last), False)]


def _h_eye(it, node, env):
    n = node.args[0]
    return [(1, 1, False) if n == 1 and (len(node.args) < 2 or node.args[1] == 1) else (0, 1, False)]


def _h_to_copy(it, node, env):
    """A cast. To bool: nonzero. To an integer dtype: a fit keeps the
    interval; an escape fires range-dtype-overflow (JAX's narrowing
    `convert_element_type`)."""
    v = _iv(env, node.args[0])
    dst = node.meta[0][0]
    src = node.args[0].dtype if type(node.args[0]) is Ref else None
    if dst == torch.bool:
        if known(v) and v[0] == v[1] == 0:
            return [(0, 0, v[2])]
        if known(v) and (v[0] > 0 or v[1] < 0):
            return [(1, 1, v[2])]
        return [(0, 1, v[2])]
    b = _BOUNDS.get(dst)
    if b is None:
        return [TOP]
    if not known(v):
        return [(None, None, v[2])]
    if b[0] <= v[0] and v[1] <= b[1]:
        return [v]
    if b[0] < 0 and not (v[2] and dst.itemsize >= 4):
        it.emit("range-dtype-overflow",
                f"narrowing cast to {policy.dtype_name(dst)}: fit unproven for interval {fmt(v)} "
                f"(source {policy.dtype_name(src) if src is not None else '?'}) at "
                f"{site_str(node.site)}")
    return [v] if v[2] else [(None, None, v[2])]


def _reduced(node):
    ref = node.args[0]
    dim = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
    if dim is None or isinstance(dim, (list, tuple)) and not dim:
        return math.prod(ref.shape) if ref.shape else 1
    return math.prod(ref.shape[d] for d in _dims(dim, len(ref.shape))) if ref.shape else 1


def _h_sum(it, node, env):
    a = _iv(env, node.args[0])
    if not known(a):
        return [(None, None, a[2])]
    n = _reduced(node) if len(node.args) > 1 and not isinstance(node.args[1], torch.dtype) \
        else math.prod(node.args[0].shape or (1,))
    return [(min(0, a[0] * n), max(0, a[1] * n), a[2])]


def _h_any(it, node, env):
    a = _iv(env, node.args[0])
    if known(a):
        if a[0] == a[1] == 0:
            return [(0, 0, a[2])]
        if a[0] > 0 or a[1] < 0:
            return [(1, 1, a[2])]
    return [(0, 1, a[2])]


def _h_cumsum(it, node, env):
    a = _iv(env, node.args[0])
    ref = node.args[0]
    n = ref.shape[node.args[1] % len(ref.shape)] if ref.shape else 1
    if not known(a):
        return [(None, None, a[2])]
    return [(min(a[0], a[0] * n), max(a[1], a[1] * n), a[2])]


def _h_sort(it, node, env):
    a = _iv(env, node.args[0])
    ref = node.args[0]
    dim = node.args[1] if len(node.args) > 1 and isinstance(node.args[1], int) else \
        node.kwargs.get("dim", -1)
    n = ref.shape[dim % len(ref.shape)] if ref.shape else 1
    return [a, (0, max(n - 1, 0), False)][:len(node.outs)]


def _h_max_dim(it, node, env):
    a = _iv(env, node.args[0])
    if len(node.outs) == 1:
        return [a]
    ref = node.args[0]
    n = ref.shape[node.args[1] % len(ref.shape)] if ref.shape else 1
    return [a, (0, max(n - 1, 0), False)]


def _h_gather(it, node, env):
    x, dim, idx = node.args[0], node.args[1], node.args[2]
    iv = _iv(env, idx)
    d = dim % len(x.shape) if x.shape else 0
    it.oob("gather", node, iv, x.shape[d] if x.shape else 1, d)
    v = env[x.slot]
    return [(v[0], v[1], v[2] or iv[2])]


def _h_index_select(it, node, env):
    x, dim, idx = node.args[0], node.args[1], node.args[2]
    iv = _iv(env, idx)
    d = dim % len(x.shape)
    it.oob("index_select", node, iv, x.shape[d], d)
    v = env[x.slot]
    return [(v[0], v[1], v[2] or iv[2])]


def _index_checks(it, node, env, what):
    x, indices = node.args[0], node.args[1]
    t = False
    for d, idx in enumerate(indices):
        if idx is None or idx.dtype == torch.bool:
            continue
        iv = env[idx.slot]
        t = t or iv[2]
        it.oob(what, node, iv, x.shape[d], d)
    return t


def _h_index(it, node, env):
    t = _index_checks(it, node, env, "index")
    v = env[node.args[0].slot]
    return [(v[0], v[1], v[2] or t)]


def _h_index_put(it, node, env):
    t = _index_checks(it, node, env, "index_put")
    x, vals = env[node.args[0].slot], _iv(env, node.args[2])
    acc = node.args[3] if len(node.args) > 3 else node.kwargs.get("accumulate", False)
    if acc:
        return [(None, None, x[2] or vals[2] or t)]
    v = join(x, vals)
    return [(v[0], v[1], v[2] or t)]


def _h_scatter(it, node, env):
    x, dim, idx = node.args[0], node.args[1], node.args[2]
    src = node.args[3] if len(node.args) > 3 else node.kwargs.get("src", node.kwargs.get("value"))
    iv = _iv(env, idx)
    d = dim % len(x.shape)
    it.oob(node.op.rstrip("_"), node, iv, x.shape[d], d)
    base, upd = env[x.slot], _iv(env, src)
    if node.op.startswith("scatter_add"):
        n = idx.shape[d] if idx.shape else 1
        hi_u = _corners(upd, (0, n, False), lambda a, b: a * b)
        v = _corners(base, hi_u, lambda a, b: a + b)
        return [(v[0], v[1], v[2] or iv[2])]
    if len(node.args) > 4 or (node.kwargs and "reduce" in node.kwargs):
        return [(None, None, base[2] or upd[2] or iv[2])]
    v = join(base, upd)
    return [(v[0], v[1], v[2] or iv[2])]


def _h_cummax(it, node, env):
    a = _iv(env, node.args[0])
    ref = node.args[0]
    n = ref.shape[node.args[1] % len(ref.shape)] if ref.shape else 1
    return [a, (0, max(n - 1, 0), False)][:len(node.outs)]


def _h_copy_(it, node, env):
    return [_iv(env, node.args[1])]


_HANDLERS = {
    "add": _arith("add"), "sub": _arith("sub"), "mul": _arith("mul"), "rsub": _rsub,
    "neg": _neg, "abs": _abs,
    "maximum": _h_maximum, "minimum": _h_minimum, "clamp": _h_clamp,
    "div": _h_div, "floor_divide": _h_div, "remainder": _h_remainder,
    "eq": _cmp(lambda a, b: a[0] == a[1] == b[0] == b[1], lambda a, b: a[1] < b[0] or a[0] > b[1]),
    "ne": _cmp(lambda a, b: a[1] < b[0] or a[0] > b[1], lambda a, b: a[0] == a[1] == b[0] == b[1]),
    "lt": _cmp(lambda a, b: a[1] < b[0], lambda a, b: a[0] >= b[1]),
    "le": _cmp(lambda a, b: a[1] <= b[0], lambda a, b: a[0] > b[1]),
    "gt": _cmp(lambda a, b: a[0] > b[1], lambda a, b: a[1] <= b[0]),
    "ge": _cmp(lambda a, b: a[0] >= b[1], lambda a, b: a[1] < b[0]),
    "bitwise_and": _h_and, "__and__": _h_and, "logical_and": _h_and,
    "bitwise_or": _h_or, "__or__": _h_or, "logical_or": _h_or,
    "bitwise_xor": _h_xor, "__xor__": _h_xor,
    "bitwise_not": _h_not, "logical_not": _h_not,
    "__lshift__": _h_lshift, "bitwise_left_shift": _h_lshift,
    "__rshift__": _h_rshift, "bitwise_right_shift": _h_rshift,
    "where": _h_where, "cat": _h_cat, "stack": _h_cat, "constant_pad_nd": _h_pad,
    "__join__": _h_join,
    "full": _h_full, "full_like": _h_full, "new_full": _h_full,
    "zeros": _h_const(0), "zeros_like": _h_const(0), "new_zeros": _h_const(0),
    "ones": _h_const(1), "ones_like": _h_const(1), "new_ones": _h_const(1),
    "scalar_tensor": _h_scalar_tensor, "arange": _h_arange, "eye": _h_eye,
    "_to_copy": _h_to_copy,
    "sum": _h_sum, "any": _h_any, "all": _h_any, "amax": _identity, "amin": _identity,
    "max": _h_max_dim, "min": _h_max_dim, "cumsum": _h_cumsum, "sort": _h_sort,
    "cummax": _h_cummax, "cummin": _h_cummax,
    "gather": _h_gather, "index_select": _h_index_select, "index": _h_index,
    "index_put": _h_index_put, "_index_put_impl": _h_index_put,
    "scatter": _h_scatter, "scatter_add": _h_scatter, "copy": _h_copy_,
}
for _v in ("view", "_unsafe_view", "permute", "select", "slice", "squeeze", "unsqueeze",
           "transpose", "expand", "unbind", "alias", "t", "clone", "lift_fresh",
           "lift_fresh_copy", "detach", "contiguous", "reshape", "flatten", "expand_as",
           "as_strided", "movedim", "repeat", "flip", "roll", "diagonal", "narrow",
           "split", "split_with_sizes", "chunk", "unfold", "_reshape_alias",
           "repeat_interleave_self", "tile"):
    _HANDLERS[_v] = _identity
# In-place forms compute as their out-of-place op; the recorder rebinds.
for _k in list(_HANDLERS):
    if not _k.startswith("_"):
        _HANDLERS.setdefault(_k + "_", _HANDLERS[_k])
_HANDLERS["copy_"] = _h_copy_
_HANDLERS["fill_"] = _h_full


# ------------------------------------------------------- the loop fixed point


def protocol_leg(name: str) -> bool:
    """Horizon-gated legs: the protocol state and mailbox planes (metric
    and trace accumulators are pinned as diagnostics, not gated)."""
    return not name.startswith(("metric.", "trace.", "extra")) and name != "first_viol"


def public_iv(v, u32: bool):
    """A uint32 carrier's interval in the uint32 domain JAX reports: its
    non-negative patterns as they are, anything else unknown."""
    if not u32:
        return v
    if known(v) and v[0] >= 0:
        return v
    return (None, None, v[2])


def audit_loop(interp: Interp, body: Graph, entry0: dict, consts: dict, names: list, *,
               declared: dict, invariant: set, u32: frozenset = frozenset(),
               public_dtypes: dict | None = None):
    """JAX's `_scan` and `_target_checks` over one captured tick body:
    `entry0` {leg: interval} the initial carry, `consts` {input: interval}
    the loop's constants, `names` the carry legs (body inputs and outputs
    of the same names), `u32` the legs carrying uint32 bit patterns
    (recorded in the uint32 domain, as JAX's unsigned planes). Declared legs are pinned at their declaration;
    the rest iterate a widening fixed point of MAX_ITERS passes, then each
    is stable (proven invariant), monotone at a measured rate (a horizon),
    or widened. Returns the per-leg record, or None when the body does not
    carry exactly `names`."""
    if set(names) - set(body.inputs) or set(names) - set(body.outputs):
        return None
    nk = len(names)
    dtypes = [body.in_meta(n)[0] for n in names]
    dbounds = [U32_BOUNDS if n in u32 else _BOUNDS.get(d) for n, d in zip(names, dtypes)]
    carry_b = [_BOUNDS.get(d) for d in dtypes]
    entry = [entry0.get(n, TOP) for n in names]
    for i, nm in enumerate(names):
        d = declared.get(nm)
        if d is None:
            continue
        b = carry_b[i]
        if b is not None and (d[0] < b[0] or d[1] > b[1]):
            interp.emit("range-dtype-overflow",
                        f"carry leg `{nm}`: declared range [{d[0]}, {d[1]}] does not fit its "
                        f"{policy.dtype_name(dtypes[i])} plane [{b[0]}, {b[1]}]")
            entry[i] = (max(d[0], b[0]), min(d[1], b[1]), False)
            continue
        c0 = entry[i]
        if known(c0) and not (d[0] <= c0[0] and c0[1] <= d[1]):
            interp.emit("range-annotation-stale",
                        f"carry leg `{nm}`: initial-value interval {fmt(c0)} is not within the "
                        f"declared range [{d[0]}, {d[1]}]")
        entry[i] = (d[0], d[1], False)
    pinned = [declared.get(n) is not None for n in names]

    def body_pass(carry):
        env = interp.env(body, consts)
        for n, v in zip(names, carry):
            env[body.inputs[n]] = v
        interp.run(body, env)
        return [env[body.outputs[n]] for n in names]

    saved, interp.report = interp.report, False
    fixed = list(pinned)  # legs that no longer iterate: declared, or classified growing
    stable = [True] * nk
    rate: list = [None] * nk  # a growing leg's measured rate
    cur = list(entry)
    moved: list = []
    relaxed = [False] * nk  # moved under a widened carry after sitting still
    offset = [0] * nk  # a rate leg's bound at tick 0 raised past its entry by the widened image
    for _ in range(MAX_ROUNDS):
        hist = [[(v[0], v[1]) for v in cur]]
        for _ in range(MAX_ITERS):
            out = body_pass(cur)
            nxt = [c if fx else join(c, o) for fx, c, o in zip(fixed, cur, out)]
            hist.append([(v[0], v[1]) for v in nxt])
            stable_all = all(n[:2] == c[:2] for n, c in zip(nxt, cur))
            cur = nxt
            if stable_all:
                break
        for i in range(nk):
            if fixed[i] or hist[-1][i] == hist[-2][i]:
                continue
            fixed[i], stable[i] = True, False
            b = carry_b[i]
            los = [row[i][0] for row in hist]
            his = [row[i][1] for row in hist]
            lo_ok = los[-1] is not None and los[-1] == los[-2]
            d1 = None if his[-1] is None or his[-2] is None else his[-1] - his[-2]
            d2 = (None if len(his) < 3 or his[-2] is None or his[-3] is None
                  else his[-2] - his[-3])
            ent_hi = entry[i][1]
            if (lo_ok and d1 is not None and d1 > 0 and d2 == d1 and b is not None
                    and ent_hi is not None):
                rate[i] = d1
                cur[i] = (los[-1], ent_hi + d1 * H_AUDIT, True)
            else:
                cur[i] = (None, None, True)
        # A leg that sat still in the last pass is stable only if the image of
        # the widened carry stays inside it too; one that moves iterates again.
        # A rate leg's image may grow by its rate past the widened carry and no
        # more: a lower floor (a NOOP written into a value leg) is taken into
        # its bound, and a higher image (a leg that copies a leg that starts
        # higher or grows faster) into its offset and rate (`_regrow`).
        image = body_pass(cur)
        moved = [i for i in range(nk)
                 if not fixed[i] and join(cur[i], image[i])[:2] != cur[i][:2]]
        rebound = False
        for i in range(nk):
            r = rate[i]
            if pinned[i] or r is None:
                continue
            (lo, hi, _), (il, ih, _) = cur[i], image[i]
            if il is None or ih is None:
                rate[i] = None
                cur[i], rebound = (None, None, True), True
            elif il < lo or ih > hi + r:
                if ih > hi + r:
                    rate[i], offset[i] = _regrow(ih - entry[i][1])
                cur[i] = (min(lo, il), entry[i][1] + offset[i] + rate[i] * H_AUDIT, True)
                rebound = True
        if not moved and not rebound:
            break
        for i in moved:
            relaxed[i] = True
    for i in range(nk):
        # Still moving after MAX_ROUNDS, or settled at an unknown bound after
        # moving: widened, as JAX widens a leg its iterations cannot bound.
        if i in moved or (relaxed[i] and not known(cur[i])):
            stable[i], rate[i] = False, None
            cur[i] = (None, None, True)
    interp.report = saved
    image = body_pass(cur)

    record = {}
    public_dtypes = public_dtypes or {}
    for i, nm in enumerate(names):
        d = declared.get(nm)
        u = nm in u32
        ent = {"dtype": public_dtypes.get(nm, policy.dtype_name(dtypes[i]))}
        if d is not None:
            ent["lo"], ent["hi"] = d[0], d[1]
            iw = public_iv(image[i], u)
            if known(iw):
                esc = [min(0, iw[0] - d[0]), max(0, iw[1] - d[1])]
                if esc != [0, 0]:
                    ent["escape"] = esc
                elif nm not in invariant:
                    dw, cw = d[1] - d[0], iw[1] - iw[0]
                    if dw > LOOSE_FACTOR * cw + LOOSE_SLACK:
                        interp.emit("range-annotation-stale",
                                    f"carry leg `{nm}`: declared range [{d[0]}, {d[1]}] is wildly "
                                    f"looser than the proven interval {fmt(iw)}")
            else:
                ent["escape"] = None
        elif stable[i]:
            v = public_iv(cur[i], u)
            ent["lo"], ent["hi"] = v[0], v[1]
        elif rate[i] is not None:
            # [lo, hi] at entry (JAX's record), the floor and offset the
            # widened image forced taken in; the horizon, which the gate below
            # reads too, from that hi and the final rate.
            hi = entry[i][1] + offset[i]
            horizon = min((carry_b[i][1] - hi) // rate[i], HORIZON_CAP)
            ent["lo"], ent["hi"] = min(entry[i][0], cur[i][0]), hi
            ent["rate"], ent["horizon"] = rate[i], horizon
            if horizon < SOAK_TICKS and protocol_leg(nm):
                interp.emit("range-horizon",
                            f"carry leg `{nm}` ({policy.dtype_name(dtypes[i])}) grows by "
                            f"{rate[i]}/tick from {hi}: wraps after ~{horizon:,} ticks, below "
                            f"the {SOAK_TICKS:,}-tick soak budget")
        else:
            b = dbounds[i]
            ent["lo"], ent["hi"] = (b[0], b[1]) if b else (None, None)
            ent["widened"] = True
        record[nm] = ent
    return record


def _regrow(total: int) -> tuple[int, int]:
    """(rate, offset) of a rate leg whose image of the widened carry (valued
    at H_AUDIT ticks) is `total` above its entry, past entry + its rate x
    (H_AUDIT + 1): a leg that copies another. An excess under half the
    horizon is an offset (the copied leg starts higher); a larger one is
    growth, and the rate rises to cover the image with no offset."""
    r, off = divmod(total, H_AUDIT + 1)  # r >= rate: total > rate x (H_AUDIT + 1)
    if off > H_AUDIT // 2:
        return r + 1, 0
    return r, off


# ----------------------------------------------------------------- programs
#
# The audited programs of a tier (the JAX package's jaxpr_audit.programs):
# `simulate` (one capture serves `scenario_simulate` too: the homogeneous
# genome equals the scalar path), `serve_simulate` (offer planes, the
# window's first violation), `trace_simulate` (the event fold into the trace
# ring), and `step`, the step_b span of the simulate body run alone.

AUDIT_TRACE_DEPTH = 32
PROGRAMS = ("simulate", "serve_simulate", "trace_simulate")


@dataclasses.dataclass
class Program:
    """One captured loop: its prologue and body graphs, the carry's leg
    names, the body's loop constants, the config its rules run under, and
    the op hash of the body captured at a second tick."""

    label: str
    cfg: RaftConfig
    init: Graph
    body: Graph
    names: list
    consts: dict
    ticks: tuple
    hash_b: str
    seconds: float = 0.0


def carry_names(variant: str) -> list[str]:
    """The carry legs of a variant's loop (JAX `_leg_names`)."""
    if variant == "trace_simulate":
        return policy.trace_carry_leaf_names()
    names = policy.carry_leaf_names()
    return names + ["first_viol"] if variant == "serve_simulate" else names


def cadences(cfg: RaftConfig) -> list[int]:
    """The tick cadences in force under `cfg`."""
    c = [cfg.client_interval, cfg.partition_period, cfg.reconfig_interval,
         cfg.transfer_interval, cfg.read_interval, cfg.fsync_interval]
    if cfg.crash_prob > 0:
        c.append(cfg.crash_period)
    if cfg.check_log_matching:
        c.append(cfg.log_matching_interval)
    return [x for x in c if x > 1]


def probe_ticks(cfg: RaftConfig) -> tuple[int, int]:
    """Two ticks whose residues differ for every cadence in force: their
    least common multiple (residue 0 everywhere, past tick 0) and the next."""
    t = math.lcm(*cadences(cfg)) if cadences(cfg) else 1
    return t, t + 1


@contextlib.contextmanager
def _lm_arm(due: bool | None):
    from raft_sim_tpu_torch.models import raft_batched

    real = raft_batched.log_matching_due
    if due is not None:
        raft_batched.log_matching_due = lambda cfg, s, now: bool(cfg.check_log_matching) and due
    try:
        yield
    finally:
        raft_batched.log_matching_due = real


def lm_branch(cfg: RaftConfig) -> bool:
    """Whether `cfg`'s tick takes the log-matching cadence as a host branch."""
    return bool(cfg.check_log_matching) and cfg.log_matching_interval > 1


def step_arms(cfg, s, inp, now):
    """`step_b` in a capture: the span marked `step` from the state's slots;
    under a log-matching cadence, both arms of the host branch, joined."""
    from raft_sim_tpu_torch.models import raft_batched

    with mark("step", policy.state_leaves(s)):
        if not lm_branch(cfg):
            return raft_batched.step_b(cfg, s, inp, now)
        with _lm_arm(True):
            a = raft_batched.step_b(cfg, s, inp, now)
        with _lm_arm(False):
            b = raft_batched.step_b(cfg, s, inp, now)
        rec = current_recorder()
        for x, y in zip(_leaves(a), _leaves(b)):
            if x is not y:
                rec.join_into(x, [y])
        return a


def _leaves(tree):
    if isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, torch.Tensor):
        yield tree


def audit_genome(cfg: RaftConfig, keys: torch.Tensor):
    """The homogeneous genome of `cfg` (`genome.from_config`, [B, 1]
    leaves); under drop_prob_uniform, its drop leaf is the hidden
    per-cluster rate drawn from the keys (`faults.uniform_drop_rate`), so
    the genome path equals the scalar path there too."""
    from raft_sim_tpu_torch.scenario import genome as gmod
    from raft_sim_tpu_torch.sim import faults

    b = keys.shape[0]
    if not (cfg.drop_prob > 0 and cfg.drop_prob_uniform):
        return gmod.broadcast(gmod.from_config(cfg, keys.device), b)
    g = gmod.broadcast(gmod.from_config(dataclasses.replace(cfg, drop_prob_uniform=False),
                                        keys.device), b)
    return g._replace(drop=faults.uniform_drop_rate(cfg, keys)[:, None])


def _carry_of(variant, s, m, extra) -> dict:
    out = dict(policy.state_leaves(s))
    out.update({f"metric.{f}": getattr(m, f) for f in m._fields})
    if variant != "simulate":
        out["first_viol"] = extra["fv"]
    if variant == "trace_simulate":
        out.update({f"trace.{f}": getattr(extra["tw"], f) for f in extra["tw"]._fields})
        out.update({f"trace.{f}": getattr(extra["tp"], f) for f in extra["tp"]._fields})
    return out


def _fresh(tree):
    """Distinct tensors for every leaf: a capture names inputs by identity."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fresh(x) for x in tree))
    return tree.clone()


def capture_program(name: str, cfg: RaftConfig, variant: str, batch: int = 4,
                    device="cpu", tick_fn=None) -> Program:
    """Capture `variant` of tier `name` (PROGRAMS) at `cfg`: the prologue
    from a key input, the body at the first of `probe_ticks`, and the body's
    op hash at the second. `tick_fn` replaces `scan.tick_batch_minor` (the
    tests' seeded faults)."""
    import time

    from raft_sim_tpu_torch import types as port_types
    from raft_sim_tpu_torch.analysis import op_audit
    from raft_sim_tpu_torch.kernels import draw_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan, telemetry
    from raft_sim_tpu_torch.trace import ring as tring

    t0 = time.process_time()
    dev = torch.device(device)
    vcfg = op_audit.variant_config(cfg, variant)
    spec = tring.TraceSpec(depth=AUDIT_TRACE_DEPTH)
    k_init, keys = scan.fleet_keys(0, batch, dev)

    def init():
        s = raft_batched.to_batch_minor(port_types.init_rows(vcfg, k_init))
        m = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
        extra = {"fv": torch.full((batch,), telemetry.NEVER, dtype=torch.int32, device=dev),
                 "tw": tring.init_window(spec, batch, dev),
                 "tp": tring.init_persist(spec, batch, dev)}
        return _carry_of(variant, s, m, extra)

    g_init = capture(init, {"init_keys": k_init})
    state, _ = scan.seed_fleet(vcfg, 0, batch, dev)
    tick = scan.tick_batch_minor if tick_fn is None else tick_fn
    planes = {"client_cmd": torch.arange(1, batch + 1, dtype=torch.int32, device=dev)}
    if vcfg.read_index:
        planes["read_cmd"] = torch.ones(batch, dtype=torch.int32, device=dev)

    def body_at(t: int, hash_only: bool):
        s = _fresh(raft_batched.to_batch_minor(state))
        s = s._replace(now=torch.full_like(s.now, t))
        m = _fresh(raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev)))
        extra = {"fv": torch.full((batch,), telemetry.NEVER, dtype=torch.int32, device=dev),
                 "tw": _fresh(tring.init_window(spec, batch, dev)),
                 "tp": _fresh(tring.init_persist(spec, batch, dev))}
        carry = _carry_of(variant, s, m, extra)
        ks = keys.clone()
        pl = {k: v.clone() for k, v in planes.items()} if variant == "serve_simulate" else {}

        def body():
            kw = {"step_fn": step_arms,
                  "draw_fn": draw_engine.draw_plain, "genome": audit_genome(vcfg, ks),
                  "seg_len": 1}
            if variant == "serve_simulate":
                kw["client_cmd"] = pl["client_cmd"]
                if "read_cmd" in pl:
                    kw["read_cmd"] = pl["read_cmd"]
            if variant == "trace_simulate":
                kw["events"] = True
            out = tick(vcfg, s, ks, m, s.now, **kw)
            s2, m2, info = out[:3]
            ex2 = {}
            if variant != "simulate":
                bad = scan.step_bad(info)
                ex2["fv"] = torch.minimum(extra["fv"], torch.where(bad, s.now, telemetry.NEVER))
            if variant == "trace_simulate":
                ex2["tw"], ex2["tp"] = tring.record(vcfg, spec, extra["tw"], extra["tp"], out[3],
                                                    s.now)
            return _carry_of(variant, s2, m2, ex2)

        return capture(body, dict(carry, keys=ks, **pl), hash_only=hash_only)

    ta, tb = probe_ticks(vcfg)
    g_body = body_at(ta, False)
    hash_b = body_at(tb, True).hash
    consts = {"keys": TOP, **{k: TOP for k in planes if variant == "serve_simulate"}}
    return Program(f"range:{name}/{variant}", vcfg, g_init, g_body, carry_names(variant),
                   consts, (ta, tb), hash_b, time.process_time() - t0)


def audit_step(interp: Interp, body: Graph, declared: dict) -> bool:
    """The `step` program (JAX's step_b jaxpr): the body's `step` span run
    alone, the state legs seeded from their declared ranges and everything
    else unknown (the inputs, the undeclared legs). False when the body
    has no step span."""
    span = body.marks.get("step")
    if span is None:
        return False
    env = [TOP] * body.n_slots
    for s, v in body.consts.items():
        env[s] = v
    for leg, slot in span["slots"].items():
        d = declared.get(leg)
        b = _BOUNDS.get(body.slot_meta[slot][0])
        if d is not None and b is not None and b[0] <= d[0] and d[1] <= b[1]:
            env[slot] = (d[0], d[1], False)
    interp.run(body, env, span["start"], span["end"])
    return True
