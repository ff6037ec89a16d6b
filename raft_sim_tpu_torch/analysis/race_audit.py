"""Pass D: host/device concurrency audit, the static legs (the port of
the JAX package's analysis/race_audit.py).

Three standing loops hand their fleet carry to a chunk step between chunks
(`sim/chunked.run_chunked`, `sim/telemetry.run_chunked_telemetry`,
`serve/loop.ServeSession`), where JAX donates it, while host code works
inside the dispatch->sync window (the serve loop's overlapped export, pack
and extraction rounds, whose copies to pinned memory are in flight behind a
CUDA event). A reference to a released carry kept past its chunk pins
memory the loop means to free, and read late it sees a carry the loop has
moved past; a host write into a buffer whose `non_blocking` copy is still
in flight races the copy. The rules are host-side AST dataflow; nothing
runs.

  race-use-after-release      a reference aliasing a released argument (the
                              name, a view of it -- `from_batch_minor`,
                              `movedim`, subscripts -- or a closure that
                              captured it) is read or kept after the
                              releasing call without being rebound from the
                              call's outputs. The releasing steps are the
                              registry's (`policy.releasing_entry_points`).
  race-window-mutation        between a releasing dispatch and its sync, host
                              code rebinds, mutates or deletes the in-flight
                              carry root; or anywhere, it writes into a buffer
                              bound from `device.to_host_async` before
                              `host_numpy` has waited for its event
                              (serve/loop.py's overlap: chunk k's copies in
                              flight, host writes only to k+1's planes).
  race-key-reuse              a threefry key is consumed twice (double draw,
                              double split, same-salt fold_in, or a draw mixed
                              with another consumption) in `sim/faults.py`,
                              `scenario/` or `farm/` (utils/threefry.py's
                              `fold_in`, `split`, `bits`, `randint`).
  race-sink-writer            an append-mode `open()` of a stream outside the
                              single-writer registry (`APPEND_OWNERS`), or a
                              stale registry row.
  race-unregistered-release   a function marked `@releases(...)`
                              (utils/release.py) missing from the registry,
                              or a registered releasing step without the mark.
  race-donation-poison        the runtime leg's rule (analysis/sanitizer.py):
                              a sanitizer-armed loop raised or diverged from
                              the unarmed run. Emitted by `check --race
                              --dynamic` and `run/serve --sanitize`.
  race-parse-error            a file that does not parse.
"""

from __future__ import annotations

import ast
import functools
import os

from raft_sim_tpu_torch.analysis import policy
from raft_sim_tpu_torch.analysis.ast_lint import iter_package_files
from raft_sim_tpu_torch.analysis.findings import Finding, dedupe

PKG = policy.PKG

RULES = frozenset({
    "race-use-after-release", "race-window-mutation", "race-key-reuse",
    "race-sink-writer", "race-unregistered-release", "race-donation-poison",
    "race-parse-error",
})

# Calls whose result is a view of their tensor arguments: assigning through
# them aliases the argument (torch returns views where JAX returns values).
VIEW_CALLS = frozenset({
    "from_batch_minor", "to_batch_minor", "movedim", "view", "reshape", "permute",
    "transpose", "unsqueeze", "squeeze", "expand", "narrow", "select", "unbind", "_map",
})

# Calls that end the dispatch->sync window: the loop has waited on (a host
# copy of) the dispatched chunk's outputs. `end` counts only with `sync=`
# (obs/timer.py ChunkTimer).
SYNC_CALLS = frozenset({"synchronize", "host_numpy", "drain", "finish_rounds", "_collect"})

# Methods wrapping a releasing chunk step: calling one releases the named
# carry and rebinds it to the chunk's output before returning.
RELEASING_WRAPPERS: dict[str, dict[str, str]] = {
    f"{PKG}/serve/loop.py": {"_dispatch": "self._s"},
}

# In-place writes into a tensor or array.
INPLACE_CALLS = frozenset({"copy_", "fill_", "zero_", "copyto", "put_", "index_put_",
                           "scatter_", "add_", "sub_", "mul_", "masked_fill_"})

# threefry consumption classes for the key-stream rule (utils/threefry.py).
_RANDOM_DRAWS = frozenset({"bits", "randint"})
_RANDOM_CREATES = frozenset({"key"})

# The single-writer registry: every append-mode open() of a stream file in
# the package, keyed (repo-relative path, enclosing function).
APPEND_OWNERS: dict[tuple[str, str], str] = {
    (f"{PKG}/serve/deltas.py", "append_delta_rows"): "deltas.jsonl",
    (f"{PKG}/serve/tenancy.py", "credit_windows"): "tenants/<name>/windows.jsonl",
    (f"{PKG}/health/monitor.py", "append_health"): "health.jsonl",
    (f"{PKG}/health/monitor.py", "append_alert"): "alerts.jsonl",
    (f"{PKG}/farm/core.py", "append_hunt"): "members/<name>/hunt.jsonl",
    (f"{PKG}/farm/core.py", "append_perf"): "perf.jsonl (farm dir)",
    (f"{PKG}/utils/telemetry_sink.py", "append_windows"): "windows.jsonl",
    (f"{PKG}/utils/telemetry_sink.py", "append_perf"): "perf.jsonl",
    (f"{PKG}/utils/telemetry_sink.py", "append_trace"): "trace.jsonl + trace_windows.jsonl",
    (f"{PKG}/utils/apply_log.py", "update"): "node_<i>.jsonl",
}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dotted(node) -> str | None:
    """Full dotted name of a Name/Attribute chain ('self._s'); None when the
    base is not a plain name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _base_dotted(node) -> str | None:
    """The dotted name under a subscript chain ('pending' of pending[0][1])."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return _dotted(node)


def _collect_reads(node, out: list[str]) -> None:
    """Maximal dotted names read inside an expression subtree; lambda bodies
    included with the lambda's own parameters shadowed out."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        d = _dotted(node)
        if d is not None:
            out.append(d)
            return
    if isinstance(node, ast.Subscript):
        d = _dotted(node.value)
        if d is not None:
            out.append(d)
        else:
            _collect_reads(node.value, out)
        _collect_reads(node.slice, out)
        return
    if isinstance(node, ast.Lambda):
        inner: list[str] = []
        _collect_reads(node.body, inner)
        params = {a.arg for a in (*node.args.posonlyargs, *node.args.args,
                                  *node.args.kwonlyargs)}
        out.extend(d for d in inner if d.split(".")[0] not in params)
        return
    for child in ast.iter_child_nodes(node):
        _collect_reads(child, out)


def _flat_targets(node) -> list[str]:
    """Dotted names an assignment target binds (tuple unpacking included)."""
    if isinstance(node, (ast.Name, ast.Attribute, ast.Subscript)):
        base = node.value if isinstance(node, ast.Subscript) else node
        d = _dotted(base)
        return [d] if d is not None else []
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            out.extend(_flat_targets(elt))
        return out
    if isinstance(node, ast.Starred):
        return _flat_targets(node.value)
    return []


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_prefix(name: str, root: str) -> bool:
    return name == root or name.startswith(root + ".")


@functools.lru_cache(maxsize=None)
def releasing_signatures() -> dict:
    """{func name: (released arg index, released param name, registry label)}
    for every `released` registry entry, the index parsed from the entry's
    own source."""
    repo = _repo_root()
    sigs: dict[str, tuple[int, str, str]] = {}
    for e in policy.releasing_entry_points():
        if e.released_param is None:
            continue
        try:
            with open(os.path.join(repo, e.path)) as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == e.func:
                params = [a.arg for a in (*node.args.posonlyargs, *node.args.args)]
                if e.released_param in params:
                    sigs[e.func] = (params.index(e.released_param), e.released_param, e.label)
                break
    return sigs


def _released_arg_expr(call: ast.Call, idx: int, pname: str):
    if idx < len(call.args) and not any(isinstance(a, ast.Starred) for a in call.args[:idx + 1]):
        return call.args[idx]
    for kw in call.keywords:
        if kw.arg == pname:
            return kw.value
    return None


class _St:
    """Dataflow state at one program point of the release lint."""

    __slots__ = ("dead", "anc", "window", "outs", "inflight")

    def __init__(self):
        self.dead: dict[str, tuple[int, str]] = {}  # name -> (release line, label)
        self.anc: dict[str, set[str]] = {}  # name -> view ancestors
        self.window: str | None = None  # in-flight carry root
        self.outs: set[str] = set()  # a releasing call's raw outputs
        self.inflight: dict[str, int] = {}  # name -> line of its to_host_async

    def copy(self) -> "_St":
        st = _St()
        st.dead = dict(self.dead)
        st.anc = {k: set(v) for k, v in self.anc.items()}
        st.window = self.window
        st.outs = set(self.outs)
        st.inflight = dict(self.inflight)
        return st

    def merge(self, other: "_St") -> None:
        for k, v in other.dead.items():
            self.dead.setdefault(k, v)
        for k, v in other.anc.items():
            self.anc.setdefault(k, set()).update(v)
        self.window = self.window or other.window
        self.outs |= other.outs
        for k, v in other.inflight.items():
            self.inflight.setdefault(k, v)


def _aliases(value) -> bool:
    """Whether assigning `value` makes a view of the names it reads: no call
    in it, or only view-returning calls."""
    calls = [n for n in ast.walk(value) if isinstance(n, ast.Call)]
    return all(_call_name(c) in VIEW_CALLS for c in calls)


class _ReleaseLint:
    """Use-after-release, overlap-window and in-flight-copy dataflow over one
    function body. Statement-ordered walk: If branches forked and merged;
    loop bodies with a releasing call walked twice, so statements before the
    call are checked in their next-iteration role."""

    def __init__(self, fn, path: str, findings: list[Finding], write_sets: dict | None = None):
        self.fn = fn
        self.path = path
        self.findings = findings
        self.sigs = releasing_signatures()
        self.wrappers = RELEASING_WRAPPERS.get(path, {})
        self.closures: list[tuple[int, set[str]]] = []
        self.write_sets = write_sets

    def run(self) -> None:
        self._walk(self.fn.body, _St())

    def _walk(self, stmts, st: _St) -> None:
        for stmt in stmts:
            self._proc(stmt, st)

    def _walk_loop(self, body, st: _St) -> None:
        self._walk(body, st)
        if any(isinstance(n, ast.Call) and (_call_name(n) in self.sigs or _call_name(n) in self.wrappers)
               for s in body for n in ast.walk(s)):
            self._walk(body, st)

    def _proc(self, stmt, st: _St) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            free = {n.id for n in ast.walk(stmt) if isinstance(n, ast.Name)} - {
                a.arg for a in (*stmt.args.posonlyargs, *stmt.args.args, *stmt.args.kwonlyargs)}
            self.closures.append((stmt.lineno, free))
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, ast.If):
            self._check_reads(stmt.test, st, stmt.lineno)
            a, b = st.copy(), st.copy()
            self._walk(stmt.body, a)
            self._walk(stmt.orelse, b)
            a.merge(b)
            st.dead, st.anc, st.window, st.outs, st.inflight = (
                a.dead, a.anc, a.window, a.outs, a.inflight)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._check_reads(stmt.iter, st, stmt.lineno)
            self._walk_loop(stmt.body, st)
            self._walk(stmt.orelse, st)
            return
        if isinstance(stmt, ast.While):
            self._check_reads(stmt.test, st, stmt.lineno)
            self._walk_loop(stmt.body, st)
            self._walk(stmt.orelse, st)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._check_reads(item.context_expr, st, stmt.lineno)
            self._walk(stmt.body, st)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, st)
            for h in stmt.handlers:
                hv = st.copy()
                self._walk(h.body, hv)
                st.merge(hv)
            self._walk(stmt.orelse, st)
            self._walk(stmt.finalbody, st)
            return
        self._simple(stmt, st)

    def _flag_window(self, stmt, t: str, st: _St, what: str) -> None:
        self.findings.append(Finding(
            rule="race-window-mutation", path=self.path, line=stmt.lineno,
            message=(f"`{t}` is {what} inside the dispatch->sync window of the in-flight "
                     f"carry `{st.window}` in {self.fn.name}(): host code between a releasing "
                     "dispatch and its sync must never rebind or mutate the carry"),
        ))

    def _check_inflight_writes(self, stmt, targets, st: _St) -> None:
        """Writes into a buffer whose copy to the host is still in flight."""
        written = []
        if isinstance(stmt, (ast.Assign, ast.AugAssign)):
            tgts = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in tgts:
                if isinstance(t, ast.Subscript):
                    d = _base_dotted(t)
                    if d is not None:
                        written.append(d)
            if isinstance(stmt, ast.AugAssign):
                written.extend(targets)
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call) and _call_name(n) in INPLACE_CALLS:
                base = n.func.value if isinstance(n.func, ast.Attribute) else None
                d = _base_dotted(base) if base is not None else None
                if d is None and n.args:
                    d = _base_dotted(n.args[0])
                if d is not None:
                    written.append(d)
        for w in written:
            for name, line in st.inflight.items():
                if _is_prefix(w, name):
                    self.findings.append(Finding(
                        rule="race-window-mutation", path=self.path, line=stmt.lineno,
                        message=(f"`{w}` is written while its copy to the host (to_host_async at "
                                 f"line {line}) may still be in flight in {self.fn.name}(): wait "
                                 "for its event (host_numpy) first, or write the next chunk's "
                                 "buffer"),
                    ))

    def _simple(self, stmt, st: _St) -> None:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Lambda):
                params = {a.arg for a in (*n.args.posonlyargs, *n.args.args, *n.args.kwonlyargs)}
                free = {x.id for x in ast.walk(n.body) if isinstance(x, ast.Name)} - params
                self.closures.append((n.lineno, free))

        targets: list[str] = []
        if isinstance(stmt, ast.Assign):
            self._check_reads(stmt.value, st, stmt.lineno)
            for t in stmt.targets:
                targets.extend(_flat_targets(t))
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                self._check_reads(stmt.value, st, stmt.lineno)
            if isinstance(stmt, ast.AugAssign):
                self._check_reads(stmt.target, st, stmt.lineno)
            targets.extend(_flat_targets(stmt.target))
        else:
            self._check_reads(stmt, st, stmt.lineno)

        self._check_inflight_writes(stmt, targets, st)
        release = self._find_releasing_call(stmt)

        if st.window is not None and targets:
            if self.write_sets is not None:
                self.write_sets.setdefault(f"{self.path}::{self.fn.name}", set()).update(targets)
            allowed = release is not None or self._carry_unpack(stmt, st)
            if not allowed:
                for t in targets:
                    if _is_prefix(t, st.window) or _is_prefix(st.window, t):
                        self._flag_window(stmt, t, st, "written")
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                for d in _flat_targets(t):
                    if st.window is not None and _is_prefix(d, st.window):
                        self._flag_window(stmt, d, st, "deleted")

        if release is not None:
            call, dexpr, label, rebinds = release
            self._kill(stmt, dexpr, label, targets, st, rebinds=rebinds)
        for t in targets:
            for k in [k for k in st.dead if _is_prefix(k, t)]:
                del st.dead[k]
            st.anc.pop(t, None)
            st.inflight.pop(t, None)
        if isinstance(stmt, ast.Assign) and targets:
            value = stmt.value
            if any(isinstance(n, ast.Call) and _call_name(n) == "to_host_async" for n in ast.walk(value)):
                for t in targets:
                    st.inflight[t] = stmt.lineno
            elif _aliases(value):
                roots: list[str] = []
                _collect_reads(value, roots)
                anc = set()
                for r in roots:
                    anc.add(r)
                    anc |= st.anc.get(r, set())
                if anc:
                    for t in targets:
                        st.anc[t] = set(anc)

        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                name = _call_name(n)
                if name in SYNC_CALLS or (name == "end" and any(kw.arg == "sync" for kw in n.keywords)):
                    st.window = None
                if name == "host_numpy":
                    reads: list[str] = []
                    for a in n.args:
                        _collect_reads(a, reads)
                    for r in reads:
                        for k in [k for k in st.inflight if _is_prefix(r, k) or _is_prefix(k, r)]:
                            del st.inflight[k]

    def _carry_unpack(self, stmt, st: _St) -> bool:
        """`state, m, ... = out` (or a comprehension over it) where `out`
        holds a releasing call's raw outputs: the rebind of the new carry."""
        if not isinstance(stmt, ast.Assign) or not st.outs:
            return False
        reads: list[str] = []
        _collect_reads(stmt.value, reads)
        bound = {t for n in ast.walk(stmt.value) if isinstance(n, ast.comprehension)
                 for t in _flat_targets(n.target)}
        roots = {r.split(".")[0] for r in reads} - bound
        return bool(roots) and roots <= st.outs

    def _find_releasing_call(self, stmt):
        for n in ast.walk(stmt):
            if not isinstance(n, ast.Call):
                continue
            name = _call_name(n)
            if name in self.wrappers:
                return n, self.wrappers[name], f"{self.path}::{name}", True
            if name in self.sigs:
                idx, pname, label = self.sigs[name]
                expr = _released_arg_expr(n, idx, pname)
                if expr is not None:
                    if isinstance(expr, ast.Call) and not isinstance(expr.func, ast.Name) \
                            and _call_name(expr) == "_take":
                        continue  # handed over by value: nothing keeps it
                    d = _dotted(expr)
                    if d is not None:
                        return n, d, label, False
        return None

    def _kill(self, stmt, dexpr: str, label: str, targets, st: _St, rebinds: bool = False):
        newly = {dexpr}
        for n, ancs in st.anc.items():
            if any(_is_prefix(a, dexpr) or _is_prefix(dexpr, a) for a in ancs):
                newly.add(n)
        if rebinds:
            newly = {k for k in newly if not _is_prefix(k, dexpr)}
        for t in targets:
            newly = {k for k in newly if not _is_prefix(k, t)}
        for cl_line, free in self.closures:
            for k in sorted(newly):
                if "." not in k and k in free:
                    self.findings.append(Finding(
                        rule="race-use-after-release", path=self.path, line=cl_line,
                        message=(f"closure defined at line {cl_line} captures `{k}`, whose carry "
                                 f"is released to {label} at line {stmt.lineno} and never rebound "
                                 f"in {self.fn.name}(): copy what it needs before the dispatch"),
                    ))
        for k in newly:
            st.dead[k] = (stmt.lineno, label)
        if isinstance(stmt, ast.Assign):
            st.outs = {t for t in targets if "." not in t}
        st.window = dexpr

    def _check_reads(self, node, st: _St, lineno: int) -> None:
        if not st.dead:
            return
        reads: list[str] = []
        _collect_reads(node, reads)
        for d in reads:
            for dd, (kline, label) in st.dead.items():
                if _is_prefix(d, dd):
                    self.findings.append(Finding(
                        rule="race-use-after-release", path=self.path,
                        line=getattr(node, "lineno", lineno),
                        message=(f"`{d}` is read after its carry was released to {label} at line "
                                 f"{kline} in {self.fn.name}(): rebind it from the call's "
                                 "outputs, or copy what it needs before the dispatch"),
                    ))
                    break


# ------------------------------------------------------- key-stream discipline


class _KeyStreamLint:
    """Threefry key consumption over one function: every draw must come from
    a fresh split or fold_in. Illegal: a second identical consumption and a
    draw mixed with any other consumption of the same key. Legal: one split
    plus fold_ins with distinct salts. Rebinding a key name resets it."""

    def __init__(self, fn, path: str, findings: list[Finding]):
        self.fn = fn
        self.path = path
        self.findings = findings

    def run(self) -> None:
        self._walk(self.fn.body, {})

    def _walk(self, stmts, ledger: dict) -> None:
        for stmt in stmts:
            self._proc(stmt, ledger)

    def _proc(self, stmt, ledger: dict) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(stmt, ast.If):
            a = {k: dict(v) for k, v in ledger.items()}
            b = {k: dict(v) for k, v in ledger.items()}
            self._consume_in(stmt.test, a)
            self._consume_in(stmt.test, b)
            self._walk(stmt.body, a)
            self._walk(stmt.orelse, b)
            ledger.clear()
            for src in (a, b):
                for name, sigs in src.items():
                    dst = ledger.setdefault(name, {})
                    for sig, cnt in sigs.items():
                        dst[sig] = max(dst.get(sig, 0), cnt)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            head = stmt.iter if isinstance(stmt, (ast.For, ast.AsyncFor)) else stmt.test
            self._consume_in(head, ledger)
            self._walk(stmt.body, ledger)
            self._walk(stmt.orelse, ledger)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._walk(stmt.body, ledger)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, ledger)
            for h in stmt.handlers:
                self._walk(h.body, ledger)
            self._walk(stmt.orelse, ledger)
            self._walk(stmt.finalbody, ledger)
            return
        self._consume_in(stmt, ledger)
        targets: list[str] = []
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                targets.extend(_flat_targets(t))
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets.extend(_flat_targets(stmt.target))
        for t in targets:
            ledger.pop(t, None)

    def _consume_in(self, node, ledger: dict) -> None:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            fname = _call_name(n)
            parent = _dotted(n.func.value) if isinstance(n.func, ast.Attribute) else None
            # Only utils/threefry.py's consumption sites count.
            if parent is None or "threefry" not in parent.split("."):
                continue
            if fname in _RANDOM_CREATES:
                continue
            if fname in _RANDOM_DRAWS:
                sig = ("draw",)
            elif fname == "split":
                sig = ("split",)
            elif fname == "fold_in":
                salt = ast.unparse(n.args[1]) if len(n.args) > 1 else "?"
                sig = ("fold", salt)
            else:
                continue
            key = n.args[0] if n.args else None
            if key is None:
                for kw in n.keywords:
                    if kw.arg in ("k", "key"):
                        key = kw.value
            kname = _dotted(key) if key is not None else None
            if kname is None:
                continue
            sigs = ledger.setdefault(kname, {})
            prior_draw = sigs.get(("draw",), 0) > 0
            sigs[sig] = sigs.get(sig, 0) + 1
            reuse = sigs[sig] > 1 or (sig == ("draw",) and len(sigs) > 1) or (
                sig != ("draw",) and prior_draw)
            if reuse:
                self.findings.append(Finding(
                    rule="race-key-reuse", path=self.path, line=n.lineno,
                    message=(f"threefry key `{kname}` is consumed again ({fname}) in "
                             f"{self.fn.name}() after an earlier consumption: every draw needs a "
                             "fresh split/fold_in stream -- a reused key repeats the same "
                             "randomness (sim/faults.py key discipline)"),
                ))


# ------------------------------------------------------------ per-file lints


def _lint_release(tree, path: str, findings: list[Finding], write_sets: dict | None = None):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _ReleaseLint(node, path, findings, write_sets).run()


def _key_scope(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return path.endswith("sim/faults.py") or "scenario" in parts or "farm" in parts


def _lint_keys(tree, path: str, findings: list[Finding]) -> None:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _KeyStreamLint(node, path, findings).run()


def append_sites(tree):
    """(enclosing function, lineno, stream hint) of every append-mode open()
    in a file."""
    func_of: dict[int, str] = {}

    def mark(node, fname):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mark(child, child.name)
            else:
                mark(child, fname)
        func_of[id(node)] = fname

    mark(tree, "<module>")
    sites = []
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and _call_name(n) == "open"):
            continue
        mode = None
        if len(n.args) > 1 and isinstance(n.args[1], ast.Constant):
            mode = n.args[1].value
        for kw in n.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        if not (isinstance(mode, str) and "a" in mode):
            continue
        hint = next((c.value for c in ast.walk(n) if isinstance(c, ast.Constant)
                     and isinstance(c.value, str) and c.value.endswith(".jsonl")),
                    "<unresolved stream>")
        sites.append((func_of.get(id(n), "<module>"), n.lineno, hint))
    return sites


def _lint_sink_sites(tree, path: str, findings: list[Finding]):
    sites = append_sites(tree)
    for fname, lineno, hint in sites:
        if (path, fname) not in APPEND_OWNERS:
            findings.append(Finding(
                rule="race-sink-writer", path=path, line=lineno,
                message=(f"append-mode open() of {hint} in {fname}() is not in the single-writer "
                         "registry (race_audit.APPEND_OWNERS): each .jsonl stream has exactly one "
                         "writer per scope -- register the owner or route the rows through it"),
            ))
    return sites


def release_marked(tree) -> list[tuple[str, int]]:
    """(function, lineno) of every function marked `@releases(...)`."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and _call_name(dec) == "releases":
                    out.append((node.name, node.lineno))
    return out


def _lint_release_registry(tree, path: str, findings: list[Finding]):
    marked = release_marked(tree)
    registered = {e.func for e in policy.releasing_entry_points()
                  if e.path == path and e.expected == "released"}
    for fname, lineno in marked:
        if fname not in registered:
            findings.append(Finding(
                rule="race-unregistered-release", path=path, line=lineno,
                message=(f"{fname}() is marked @releases but is not in policy."
                         "releasing_entry_points: register it so the use-after-release lint and "
                         "the sanitizer cover it"),
            ))
    return marked


def lint_source(source: str, path: str, write_sets: dict | None = None) -> list[Finding]:
    """The per-file rules over one file's text (tree-level reverse checks --
    stale registry rows -- live in `lint_tree`)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as ex:
        return [Finding(rule="race-parse-error", path=path, line=ex.lineno or 0,
                        message=f"does not parse: {ex.msg}")]
    findings: list[Finding] = []
    _lint_release(tree, path, findings, write_sets)
    if _key_scope(path):
        _lint_keys(tree, path, findings)
    _lint_sink_sites(tree, path, findings)
    _lint_release_registry(tree, path, findings)
    return dedupe(findings)


def lint_tree(root: str, write_sets: dict | None = None) -> list[Finding]:
    """The per-file rules over every .py file under `root`, and the
    registries' reverse checks."""
    findings: list[Finding] = []
    seen_appends: set[tuple[str, str]] = set()
    seen_marked: set[tuple[str, str]] = set()
    for full, rel in iter_package_files(root):
        with open(full) as f:
            source = f.read()
        try:
            tree = ast.parse(source)
        except SyntaxError as ex:
            findings.append(Finding(rule="race-parse-error", path=rel, line=ex.lineno or 0,
                                    message=f"does not parse: {ex.msg}"))
            continue
        _lint_release(tree, rel, findings, write_sets)
        if _key_scope(rel):
            _lint_keys(tree, rel, findings)
        for fname, _, _ in _lint_sink_sites(tree, rel, findings):
            seen_appends.add((rel, fname))
        for fname, _ in _lint_release_registry(tree, rel, findings):
            seen_marked.add((rel, fname))
    for (path, fname), stream in sorted(APPEND_OWNERS.items()):
        if (path, fname) not in seen_appends:
            findings.append(Finding(
                rule="race-sink-writer", path=path,
                message=(f"APPEND_OWNERS registers {fname}() as the writer of {stream} but no "
                         "append-mode open() exists there: remove the stale registry row"),
            ))
    for e in policy.releasing_entry_points():
        if e.expected == "released" and (e.path, e.func) not in seen_marked:
            findings.append(Finding(
                rule="race-unregistered-release", path=e.path,
                message=(f"policy.releasing_entry_points registers {e.func}() as releasing but it "
                         f"carries no @releases mark in {e.path}: fix the registry or the step"),
            ))
    return dedupe(findings)


def overlap_write_sets(package_root: str | None = None) -> dict[str, list[str]]:
    """For every function that dispatches a releasing chunk, the host names
    written between dispatch and sync (the checked fact, printable)."""
    if package_root is None:
        package_root = os.path.join(_repo_root(), PKG)
    sets: dict[str, set] = {}
    lint_tree(package_root, write_sets=sets)
    return {k: sorted(v) for k, v in sorted(sets.items())}


def run_pass(package_root: str) -> list[Finding]:
    """The full static Pass D (the runtime leg is analysis/sanitizer.py)."""
    return lint_tree(package_root)
