"""Pass D, runtime leg: the release-poison sanitizer (the port of
the JAX package's analysis/sanitizer.py).

The static lint (analysis/race_audit.py) checks the source; this harness
checks the running loops. Arming it wraps each registered releasing chunk
step (`policy.releasing_entry_points`: `sim.chunked._chunk`,
`sim.telemetry._chunk_t`, `serve.loop._serve_chunk`) by module-global patch.
Once a chunk's outputs are synchronized (`torch.cuda.synchronize` on the
card), the wrapper poisons, in place, every leaf of the carry it handed to
the chunk -- the leaves JAX would have donated -- with a per-dtype
sentinel. Three kinds of leaf are not poisoned, and are counted apart:

  - a leaf the running carry still shares (a leg the tier's gates leave
    untouched comes back as the same tensor: `kept`);
  - a leaf of the caller's own input, which no wrapped chunk produced: the
    loops never write it (sim/chunked.py's promise), and the armed run
    checks it is bit-unchanged at the end (`caller`);
  - a leaf the loop had already let go of (nothing references it once the
    chunk returns: `released`, the counterpart of JAX's buffers "invalidated
    by donation").

Any later read of a poisoned leaf -- a callback that kept a state, a view
that outlived its chunk -- changes the run, so an armed run must equal the
unarmed run leaf for leaf; a divergence or an exception is a
`race-donation-poison` finding. Arming serializes the dispatch->sync
overlap (the serve loop's), changes no value, and keeps each chunk's input
carry alive through its chunk (the wrapper holds its arguments).

What it cannot see: K1's shared memory inside a launch (the race proxy
build, chip_smoke.py, stands in for racecheck), and buffers no registered
step hands over. torch's stream sanitizer (`torch.cuda._sanitizer`) is not
armed: it sees torch ops only, not K1's ctypes launch.

Entry points: `python -m raft_sim_tpu_torch check --race --dynamic` and
`run/serve --sanitize`.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import weakref

import numpy as np
import torch
from torch.utils import _pytree as pytree

from raft_sim_tpu_torch.analysis import policy
from raft_sim_tpu_torch.analysis.findings import Finding

# The poison, by dtype: values no leg holds at the sizes the loops run.
SENTINEL = {torch.bool: True, torch.int8: -77, torch.int16: -19_533, torch.int32: -1_515_870_811,
            torch.int64: -6_510_615_555_426_900_571}


def _leaves(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _poison_storage(t: torch.Tensor) -> None:
    """Fill the whole storage behind `t` with its dtype's sentinel."""
    st = t.untyped_storage()
    whole = torch.empty(0, dtype=t.dtype, device=t.device)
    whole.set_(st, 0, (st.nbytes() // t.element_size(),))
    whole.fill_(SENTINEL[t.dtype])


def new_stats() -> dict:
    return {"calls": {}, "poisoned": 0, "released": 0, "kept": 0, "caller": 0}


def _wrap(real, idx: int, pname: str, label: str, stats: dict, owned: dict):
    @functools.wraps(real)
    def wrapper(*args, **kwargs):
        carry = kwargs.get(pname, args[idx] if idx < len(args) else None)
        refs = [weakref.ref(x) for x in _leaves(carry)]
        del carry
        out = real(*args, **kwargs)
        del args, kwargs
        # The chunk's outputs first: poisoning emulates donation, never
        # corrupts the computation.
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stats["calls"][label] = stats["calls"].get(label, 0) + 1
        live = {_ptr(x) for x in _leaves(out)}
        done = set()
        for ref in refs:
            x = ref()
            if x is None:
                stats["released"] += 1
                continue
            p = _ptr(x)
            if p in done:
                continue
            done.add(p)
            if p in live:
                stats["kept"] += 1
            elif p not in owned.get(label, ()):
                stats["caller"] += 1
            else:
                _poison_storage(x)
                stats["poisoned"] += 1
        owned[label] = live
        return out

    wrapper._race_sanitizer_real = real
    return wrapper


@contextlib.contextmanager
def armed():
    """Patch every registered releasing chunk step with the poisoning wrapper
    for the block. Yields the stats ({'calls': {label: n}, 'poisoned',
    'released', 'kept', 'caller'}) so a caller can prove the harness
    covered its loop. Re-arming an armed step is a no-op."""
    from raft_sim_tpu_torch.analysis import race_audit

    stats = new_stats()
    owned: dict = {}
    sigs = race_audit.releasing_signatures()
    patched = []
    for e in policy.releasing_entry_points():
        if e.expected != "released" or e.func not in sigs:
            continue
        mod = importlib.import_module(e.path[:-3].replace("/", "."))
        real = getattr(mod, e.func)
        if hasattr(real, "_race_sanitizer_real"):
            continue
        idx, pname, _ = sigs[e.func]
        setattr(mod, e.func, _wrap(real, idx, pname, e.label, stats, owned))
        patched.append((mod, e.func, real))
    try:
        yield stats
    finally:
        for mod, name, real in patched:
            setattr(mod, name, real)


def report_line(stats: dict) -> str:
    """The one-line report `run/serve --sanitize` print to stderr (the JAX
    driver's format, in the port's counters)."""
    calls = ", ".join(f"{k}x{v}" for k, v in sorted(stats["calls"].items()))
    return (f"sanitizer: clean ({calls or 'no releasing dispatches'}; "
            f"{stats['released']} buffers invalidated by release, "
            f"{stats['poisoned']} poisoned as backstop, {stats['kept']} kept by the running "
            f"carry, {stats['caller']} the caller's)")


# --------------------------------------------------------- bit-exactness pin


def mismatched_leaves(a, b) -> list[str]:
    """Paths of the leaves where two trees (NamedTuples, dicts, lists,
    tensors, numpy arrays, scalars) differ. [] = bit-exact."""
    fa = pytree.tree_flatten_with_path(a)[0]
    fb = pytree.tree_flatten_with_path(b)[0]
    if len(fa) != len(fb):
        return ["<tree structure differs>"]
    bad = []
    for (pa, la), (_, lb) in zip(fa, fb):
        xa = la.detach().cpu().numpy() if isinstance(la, torch.Tensor) else np.asarray(la)
        xb = lb.detach().cpu().numpy() if isinstance(lb, torch.Tensor) else np.asarray(lb)
        if xa.dtype != xb.dtype or xa.shape != xb.shape or not np.array_equal(xa, xb):
            bad.append(pytree.keystr(pa))
    return bad


def snapshot(tree):
    """A host copy of a tree's tensors (to hold a caller's input against)."""
    return pytree.tree_map(lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x,
                           tree)


# ----------------------------------------------------------- the dynamic leg

TINY_TICKS = 8
TINY_CHUNK = 4
TINY_BATCH = 2


def _tiny_cfg():
    from raft_sim_tpu_torch.utils.config import RaftConfig

    return RaftConfig(n_nodes=3, log_capacity=4, max_entries_per_rpc=1)


def _fleet(cfg, device):
    from raft_sim_tpu_torch.sim import scan

    return scan.seed_fleet(cfg, 0, TINY_BATCH, torch.device(device))


def _leg_chunked(device):
    from raft_sim_tpu_torch.sim import chunked

    cfg = _tiny_cfg()
    state0, keys = _fleet(cfg, device)

    def once():
        return chunked.run_chunked(cfg, state0, keys, TINY_TICKS, chunk=TINY_CHUNK)

    return "sim.chunked.run_chunked", f"{policy.PKG}/sim/chunked.py", once, state0


def _leg_telemetry(device):
    from raft_sim_tpu_torch.sim import telemetry

    cfg = _tiny_cfg()
    state0, keys = _fleet(cfg, device)

    def once():
        return telemetry.run_chunked_telemetry(cfg, state0, keys, TINY_TICKS, TINY_CHUNK,
                                               chunk=TINY_CHUNK)

    return ("sim.telemetry.run_chunked_telemetry", f"{policy.PKG}/sim/telemetry.py", once,
            state0)


def _leg_serve(device):
    from raft_sim_tpu_torch.serve import loop
    from raft_sim_tpu_torch.serve.ingest import CommandSource

    cfg = _tiny_cfg()

    def once():
        sess = loop.ServeSession(cfg, batch=TINY_BATCH, seed=3, chunk=8, window=4,
                                 delta_depth=4, device=device)
        stats = sess.serve(CommandSource(iter([7, 1, 2, 9])), drain_chunks=2)
        # Wall-clock fields are what arming changes (the overlap is
        # serialized); every counter stays bit-exact.
        stats = {k: v for k, v in stats.items() if not k.endswith("_s")}
        return sess.state, sess.delta_rows, stats

    return "serve.loop.ServeSession.serve", f"{policy.PKG}/serve/loop.py", once, None


def run_dynamic(device: str = "cpu") -> tuple[list[Finding], dict]:
    """Run each releasing loop one short session unarmed, then the same
    session armed (JAX's tiny sizes: 8 ticks, chunks of 4, B = 2), on
    `device`, and hold (a) the armed run raised nothing and equals the
    unarmed one leaf for leaf, (b) the wrapper fired and poisoned, (c) the
    caller's input is bit-unchanged. A violation is a `race-donation-poison`
    finding naming the loop. Returns (findings, info): info has each loop's
    counters."""
    findings: list[Finding] = []
    info: dict = {"device": str(device), "loops": {}}
    for label, path, once, caller in (_leg_chunked(device), _leg_telemetry(device),
                                      _leg_serve(device)):
        before = snapshot(caller) if caller is not None else None
        plain = once()
        try:
            with armed() as stats:
                poisoned = once()
        except Exception as ex:  # the raise is the finding
            findings.append(Finding(
                rule="race-donation-poison", path=path,
                message=(f"{label}: sanitizer-armed session raised {type(ex).__name__}: {ex} -- "
                         "a host access touched a released carry")))
            continue
        info["loops"][label] = {k: (dict(v) if isinstance(v, dict) else v) for k, v in stats.items()}
        if not stats["calls"] or not stats["poisoned"] + stats["released"]:
            findings.append(Finding(
                rule="race-donation-poison", path=path,
                message=(f"{label}: the armed session released nothing through a wrapped step "
                         f"({stats}) -- the harness is not covering this loop")))
        bad = mismatched_leaves(plain, poisoned)
        if bad:
            findings.append(Finding(
                rule="race-donation-poison", path=path,
                message=(f"{label}: the armed run diverged from the unarmed run at {len(bad)} "
                         f"leaves (first: {bad[0]}) -- a released carry was read after its "
                         "chunk")))
        if before is not None and mismatched_leaves(before, snapshot(caller)):
            findings.append(Finding(
                rule="race-donation-poison", path=path,
                message=f"{label}: the caller's input state changed during the runs"))
    return findings, info
