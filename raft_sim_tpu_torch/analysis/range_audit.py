"""Pass E: value ranges (the counterpart of the JAX package's
analysis/range_audit.py), in two legs.

The proof (analysis/interval.py): an interval interpreter over a captured,
tick-generic graph of each audited program of a tier -- `step`, `simulate`
(whose capture `scenario_simulate` shares), `serve_simulate` and
`trace_simulate` -- seeded from the config and the types.py range clauses,
with JAX's widening fixed point over the tick loop. It proves each carry
leg stable, or measures its growth rate and wrap horizon, and proves every
gather, index, index_select, scatter and index_put index inside its
extent. Each tier's `simulate` record is pinned in JAX's shape
(tests/golden_torch_ranges.json `interval`), with `jax_differs` naming every
leg whose record is not tests/golden_ranges.json's, with its reason from the
hand-kept table analysis/jax_differs.json.

The witness (`run_tier`): each tier's real plain tick (B = AUDIT_BATCH,
AUDIT_TICKS ticks: enough to reach its crash, compaction and membership
states, which the audit checks it reached), its values watched. Every value
it sees must lie inside the proof's interval for its leg (`check_witness`);
and the config arithmetic carries over: the narrow-dtype ceilings,
`range-pack-width` and the observed horizons from the hand rates
(`monotone_rates`, `BOUNDED_BY`).

  range-dtype-overflow    a proven interval escapes its dtype, or a narrowing
                          cast whose fit is unproven (only the package's
                          uint32 word arithmetic, interval.WORD_ARITHMETIC,
                          may leave its dtype as a uint32 pattern); a
                          declared range that does not fit its
                          plane; and on the watched ticks (a `RangeChecker`
                          dispatch mode, every CHECK_EVERY-th and the first)
                          a narrowing `.to` whose input does not fit.
  range-index-oob         an index not proven inside its extent -- negative
                          ones included, which torch would wrap silently --
                          or, on the watched ticks, one seen outside it. A
                          clip (`clamp`) on the index discharges the proof.
  range-annotation-stale  a declared range the initial carry contradicts, or
                          wildly looser than the proven image; a carry leg
                          seen outside its declared range (the types.py
                          clause in force, policy.declared_ranges; the dense
                          view under compact_planes).
  range-horizon           a protocol leg whose measured horizon (its dtype's
                          headroom over its rate) is under SOAK_TICKS; on the
                          watched ticks, a monotone leg that grew faster than
                          its hand rate, or a BOUNDED_BY leg above its bound.
  range-pack-width        a compacted plane's range does not fit its packed
                          width, or disagrees with the declared range.
  range-golden            the pins drifted or are missing; a program whose
                          capture is not tick-generic, reads the device on
                          the host, or whose loop or derivation fails ("NOT
                          being checked"); a witness value outside its proven
                          interval; a leg that differs from JAX's record with
                          no reason in analysis/jax_differs.json, or a reason
                          there for a leg that no longer differs; or an
                          audit run that did not reach the states it must.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raft_sim_tpu_torch import types as port_types
from raft_sim_tpu_torch.analysis import interval, op_audit, policy
from raft_sim_tpu_torch.analysis.findings import Finding
from raft_sim_tpu_torch.utils.config import PRESETS, RaftConfig

RULES = frozenset({
    "range-dtype-overflow", "range-pack-width", "range-index-oob",
    "range-annotation-stale", "range-horizon", "range-golden",
})

SOAK_TICKS = interval.SOAK_TICKS

AUDIT_BATCH = 4
#: Ticks a tier runs: enough for its crash (crash_period 64), compaction
#: (the ring filling at a client every 4 ticks) and membership (a reconfig
#: every 97 ticks) states. Other tiers run a few election rounds.
AUDIT_TICKS = {
    "config1": 48, "config3": 32, "config4": 32, "config5": 16, "config5c": 16,
    "config6": 112, "config6r": 96, "config7": 16, "config7x": 8, "config8": 104,
    "config9": 240, "config10": 32,
}
DEFAULT_TICKS = 32
#: The RangeChecker watches tick 0 and every CHECK_EVERY-th tick after it.
CHECK_EVERY = 16


def monotone_rates(cfg: RaftConfig) -> dict[str, int]:
    """{protocol leg: the most its per-cluster maximum grows in one tick}:
    the legs that grow without bound over a soak. Clocks advance by the
    skew draw (at most 2); a term by one election at a time; under
    compaction the absolute log indices by one AppendEntries window (E) and
    a leader's entries (a client command and a no-op)."""
    rates = {"now": 1, "clock": 2, "term": 1}
    if cfg.compaction:
        idx = cfg.max_entries_per_rpc + 2
        rates.update({leg: idx for leg in ("log_base", "commit_index", "log_len", "dur_len")})
    if cfg.reconfig:
        rates["cfg_epoch"] = cfg.max_entries_per_rpc + 2
    return rates


#: Legs that grow without bound but jump (a heard clock, a wire copy of a
#: term, the latency frontier): each stays at or below the monotone leg it
#: copies, element by element, so it wraps no sooner than that leg.
BOUNDED_BY = {"heard_clock": "clock", "dur_term": "term", "mb.req_term": "term",
              "mb.resp_term": "term", "lat_frontier": "now"}


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_REGEN = "regenerate with `python -m raft_sim_tpu_torch check --update-goldens` if intended"


def golden_path() -> str:
    return os.path.join(_REPO_ROOT, "tests", "golden_torch_ranges.json")


def jax_golden_path() -> str:
    """The JAX package's range pins, read (never written) for `jax_differs`."""
    return os.path.join(_REPO_ROOT, "tests", "golden_ranges.json")


def jax_reasons_path() -> str:
    """The hand-kept table of why a leg's record differs from JAX's."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_differs.json")


_INT_BOUNDS = {torch.int8: (-128, 127), torch.int16: (-(2**15), 2**15 - 1),
               torch.int32: (-(2**31), 2**32 - 1)}  # int32: a uint32 carrier's pattern fits
_WIDTH = {torch.bool: 1, torch.uint8: 1, torch.int8: 1, torch.int16: 2, torch.int32: 4,
          torch.int64: 8}


def _site() -> str:
    """The innermost package frame outside the analysis (the offending line)."""
    for f in reversed(traceback.extract_stack()):
        if f"{policy.PKG}/" in f.filename and "/analysis/" not in f.filename:
            return f"{f.filename.split(policy.PKG + '/')[-1]}:{f.lineno}"
    return "?"


class RangeChecker(TorchDispatchMode):
    """Checks every narrowing integer cast and every index operand of the
    ops issued inside it; findings accumulate in `found` as (rule, message)."""

    def __init__(self):
        super().__init__()
        self.found: list[tuple[str, str]] = []

    def _bounds(self, idx: torch.Tensor, size: int, op: str, what: str) -> None:
        if idx.numel() == 0 or idx.dtype == torch.bool:
            return
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= size:
            self.found.append(("range-index-oob",
                               f"{op} at {_site()}: {what} index in [{lo}, {hi}] outside [0, "
                               f"{size - 1}]"))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if name == "_to_copy":
            x, dt = args[0], kwargs.get("dtype")
            if dt in _INT_BOUNDS and x.dtype in _WIDTH and _WIDTH[x.dtype] > _WIDTH[dt] \
                    and x.numel():
                lo, hi = int(x.min()), int(x.max())
                tlo, thi = _INT_BOUNDS[dt]
                if lo < tlo or hi > thi:
                    self.found.append(("range-dtype-overflow",
                                       f"cast {policy.dtype_name(x.dtype)} -> "
                                       f"{policy.dtype_name(dt)} at {_site()}: values in "
                                       f"[{lo}, {hi}] do not fit [{tlo}, {thi}]"))
        elif name in ("gather", "scatter", "scatter_add", "scatter_reduce", "index_select"):
            x, dim, idx = args[0], args[1], args[2]
            self._bounds(idx, x.shape[dim], name, f"dim {dim}")
        elif name in ("index", "index_put", "_index_put_impl"):
            x, indices = args[0], args[1]
            for d, idx in enumerate(indices):
                if idx is not None:
                    self._bounds(idx, x.shape[d], name, f"dim {d}")
        return func(*args, **kwargs)


@dataclasses.dataclass
class TierRun:
    """What one tier's audit run saw: each leg's observed [lo, hi], each
    monotone leg's largest one-tick growth, the states it reached, and the
    checker's findings."""

    legs: dict
    entry: dict  # each leg's [lo, hi] in the fleet the audit starts from
    growth: dict
    reached: dict
    found: list
    ticks: int
    escaped: list  # BOUNDED_BY legs seen above their bound


def _value_range(x: torch.Tensor, u32: bool) -> tuple[int, int]:
    if u32:
        x = x.to(torch.int64) & 0xFFFFFFFF
    if x.dtype == torch.bool:
        x = x.to(torch.int8)
    lo, hi = torch.aminmax(x)
    return int(lo), int(hi)


def _dense_leaves(cfg: RaftConfig, s) -> dict[str, torch.Tensor]:
    """The carry's legs (batch-minor), the dense view under compact_planes."""
    if cfg.compact_planes:
        from raft_sim_tpu_torch.ops import tile

        s = tile.unpack_state(cfg, s)
    return policy.state_leaves(s)


def run_tier(name: str, cfg: RaftConfig, ticks: int | None = None,
             batch: int = AUDIT_BATCH, check_every: int = CHECK_EVERY, tick_fn=None,
             device: str = "cpu") -> TierRun:
    """Run one tier's audit ticks (the plain tick) on `device`, watching
    the values. `tick_fn` replaces `scan.tick_batch_minor` (the tests'
    seeded faults)."""
    from raft_sim_tpu_torch.kernels import draw_engine
    from raft_sim_tpu_torch.models import raft_batched
    from raft_sim_tpu_torch.sim import scan

    ticks = AUDIT_TICKS.get(name, DEFAULT_TICKS) if ticks is None else ticks
    tick = scan.tick_batch_minor if tick_fn is None else tick_fn
    dev = torch.device(device)
    state, keys = scan.seed_fleet(cfg, 0, batch, dev)
    s = raft_batched.to_batch_minor(state)
    m = raft_batched.to_batch_minor(scan.init_metrics_batch(batch, dev))
    dense_cfg = port_types.compact_twin(cfg, False)
    u32 = port_types.u32_leaves(dense_cfg)
    rates = monotone_rates(cfg)
    legs: dict[str, list] = {}
    growth = {leg: 0 for leg in rates}
    reached = {"restart": False, "compaction": False, "membership": False}
    found: list = []
    escaped: set = set()

    def observe(s):
        leaves = _dense_leaves(cfg, s)
        for leg, x in leaves.items():
            lo, hi = _value_range(x, leg.removeprefix("mb.") in u32)
            r = legs.setdefault(leg, [lo, hi])
            r[0], r[1] = min(r[0], lo), max(r[1], hi)
        for leg, bound in BOUNDED_BY.items():
            over = leaves[leg] > leaves[bound]
            if leg == "heard_clock":  # boot value -election_min_ticks, before any heartbeat
                over &= leaves[leg] >= 0
            if bool(over.any()):
                escaped.add(leg)
        return {leg: leaves[leg].reshape(-1, batch).amax(0) for leg in rates}

    top = observe(s)
    entry = {k: tuple(v) for k, v in legs.items()}
    for t in range(ticks):
        checker = RangeChecker() if t % check_every == 0 else contextlib.nullcontext()
        with checker:
            inp = draw_engine.draw_plain(cfg, keys, t)
            s, m, _ = tick(cfg, s, keys, m, t, step_fn=raft_batched.step_b, inputs=inp)
        if isinstance(checker, RangeChecker):
            found.extend(checker.found)
        d = _dense_leaves(cfg, s)
        reached["restart"] |= bool(inp.restarted.any())
        reached["compaction"] |= bool((d["log_base"] > 0).any())
        reached["membership"] |= bool((d["cfg_epoch"] > 0).any())
        new_top = observe(s)
        for leg in rates:
            growth[leg] = max(growth[leg], int((new_top[leg] - top[leg]).max()))
        top = new_top
    return TierRun({k: tuple(v) for k, v in legs.items()}, entry, growth, reached, found, ticks,
                   sorted(escaped))


def expected_states(cfg: RaftConfig) -> list[str]:
    """The states a tier's audit must reach, by its gates."""
    out = []
    if cfg.crash_prob > 0:
        out.append("restart")
    if cfg.compaction:
        out.append("compaction")
    if cfg.reconfig:
        out.append("membership")
    return out


# ------------------------------------------------------- tier-level checks


def check_pack_widths(cfg: RaftConfig, name: str, *, widths=None, declared=None) -> list[Finding]:
    """range-pack-width: every compacted plane's range fits its packed bits
    after biasing, and agrees with a declared range on the same leg.
    `widths`/`declared` injectable for tests."""
    from raft_sim_tpu_torch.ops import tile

    widths = tile.pack_width_table(cfg) if widths is None else widths
    declared = policy.declared_ranges(cfg) if declared is None else declared
    out: list[Finding] = []
    path = f"range:{name}/pack"
    for leg, (bits, bias, lo, hi) in sorted(widths.items()):
        if lo + bias < 0 or hi + bias >= (1 << bits):
            out.append(Finding(
                rule="range-pack-width", path=path,
                message=(f"compact plane `{leg}`: value range [{lo}, {hi}] with bias {bias} does "
                         f"not fit {bits} bit(s) (biased range must sit in [0, {(1 << bits) - 1}])"),
            ))
        d = declared.get(leg)
        if d is not None and tuple(d) != (lo, hi):
            out.append(Finding(
                rule="range-pack-width", path=path,
                message=(f"compact plane `{leg}`: pack-width table range [{lo}, {hi}] disagrees "
                         f"with the types.py declared range [{d[0]}, {d[1]}]"),
            ))
    return out


def check_ceilings():
    """Re-derive the narrow-dtype ceilings from the config module's formulas
    and compare. Returns (findings, ceilings record)."""
    from raft_sim_tpu_torch.utils import config as cfg_mod

    out: list[Finding] = []
    path = f"{policy.PKG}/types.py"
    derived = {
        "MAX_INT8_LOG_CAPACITY": cfg_mod.max_log_capacity_for(127),
        "MAX_INT8_NODES": cfg_mod.max_nodes_for(127),
    }
    for nm, want in derived.items():
        have = getattr(port_types, nm)
        if have != want:
            out.append(Finding(rule="range-dtype-overflow", path=path,
                               message=(f"{nm} is {have} but the encoding-bound formula derives "
                                        f"{want}")))
    enc = cfg_mod.window_min_encoding_max(cfg_mod.MAX_LOG_CAPACITY)
    if enc > 32767:
        out.append(Finding(rule="range-dtype-overflow", path=f"{policy.PKG}/utils/config.py",
                           message=(f"MAX_LOG_CAPACITY={cfg_mod.MAX_LOG_CAPACITY} drives the "
                                    f"window-min encoding to {enc}, beyond int16")))
    ceilings = dict(derived, MAX_LOG_CAPACITY=cfg_mod.MAX_LOG_CAPACITY,
                    window_min_encoding_max=enc)
    return out, ceilings


def check_run(name: str, cfg: RaftConfig, run: TierRun) -> tuple[list[Finding], dict]:
    """The per-tier rules over one audit run. Returns (findings, the tier's
    record: legs, horizons, pack widths)."""
    from raft_sim_tpu_torch.ops import tile

    path = f"range:{name}"
    out = [Finding(rule=rule, path=f"{path}/tick", message=msg) for rule, msg in run.found]
    dense_cfg = port_types.compact_twin(cfg, False)
    for leg, (lo, hi) in sorted(policy.declared_ranges(dense_cfg).items()):
        got = run.legs.get(leg)
        if got is not None and (got[0] < lo or got[1] > hi):
            out.append(Finding(
                rule="range-annotation-stale", path=f"{path}/{leg}",
                message=(f"carry leg `{leg}` took values in [{got[0]}, {got[1]}] outside its "
                         f"declared range [{lo}, {hi}] (types.py)"),
            ))
    horizons = {}
    for leg, rate in sorted(monotone_rates(cfg).items()):
        if run.growth[leg] > rate:
            out.append(Finding(
                rule="range-horizon", path=f"{path}/{leg}",
                message=(f"monotone leg `{leg}` grew {run.growth[leg]} in one tick, over its "
                         f"declared rate {rate} (range_audit.monotone_rates)"),
            ))
        horizon = (2**31 - 1 - run.legs[leg][1]) // rate
        horizons[leg] = horizon
        if horizon < SOAK_TICKS:
            out.append(Finding(
                rule="range-horizon", path=f"{path}/{leg}",
                message=(f"monotone leg `{leg}` wraps int32 after {horizon:,} ticks at {rate} a "
                         f"tick, under the {SOAK_TICKS:,}-tick soak budget"),
            ))
    for leg in run.escaped:
        out.append(Finding(
            rule="range-horizon", path=f"{path}/{leg}",
            message=(f"`{leg}` rose above `{BOUNDED_BY[leg]}`, the monotone leg it must stay "
                     "under: its horizon is no longer that leg's"),
        ))
    for state in expected_states(cfg):
        if not run.reached[state]:
            out.append(Finding(
                rule="range-golden", path=path,
                message=(f"the audit's {run.ticks} ticks never reached the tier's {state} state: "
                         "its ranges are not being checked there -- run the tier longer "
                         "(range_audit.AUDIT_TICKS)"),
            ))
    out.extend(check_pack_widths(cfg, name))
    record = {
        "ticks": run.ticks,
        "legs": {leg: list(v) for leg, v in sorted(run.legs.items())},
        "entry": {leg: list(v) for leg, v in sorted(run.entry.items())},
        "horizons": horizons,
        "pack_widths": {leg: list(w) for leg, w in sorted(tile.pack_width_table(cfg).items())},
    }
    return out, record


@functools.lru_cache(maxsize=4)
def _derive_all(config_names: tuple, device: str) -> tuple[dict, list]:
    findings: list[Finding] = []
    tiers: dict[str, dict] = {}
    for name in config_names:
        cfg, _ = PRESETS[name]
        try:
            fs, record = check_run(name, cfg, run_tier(name, cfg, device=device))
        except Exception as ex:  # a derivation failure must be visible
            fs, record = [Finding(
                rule="range-golden", path=f"range:{name}",
                message=(f"range audit failed ({type(ex).__name__}: {ex}): the value-range gates "
                         "for this tier are NOT being checked"),
            )], None
        findings.extend(fs)
        if record is not None:
            tiers[name] = record
    ceil_finds, ceilings = check_ceilings()
    findings.extend(ceil_finds)
    return {"torch_version": torch.__version__, "soak_ticks": SOAK_TICKS,
            "audit_batch": AUDIT_BATCH, "ceilings": ceilings, "tiers": tiers}, findings


def derive_all(config_names=op_audit.AUDIT_CONFIGS, device: str = "cpu"):
    """(derived document, findings) for the audited tiers (cached). The
    document is the same on any device: the card's tick equals the CPU's."""
    derived, findings = _derive_all(tuple(config_names), str(device))
    return derived, list(findings)


def compare(derived: dict, golden: dict, *, full: bool = True) -> list[Finding]:
    """The pins' drift: each tier's legs, horizons and pack widths, and the
    ceilings."""
    out: list[Finding] = []
    g_tiers = golden.get("tiers") or {}
    for name, d in derived["tiers"].items():
        g = g_tiers.get(name)
        if g is None:
            out.append(Finding(rule="range-golden", path=f"range:{name}/golden",
                               message=f"tier has no golden range pin -- {_REGEN}"))
            continue
        diffs = []
        for key in ("ticks", "legs", "entry", "horizons", "pack_widths"):
            dv, gv = d[key], g.get(key)
            if isinstance(dv, dict):
                for leg in sorted(set(dv) | set(gv or {})):
                    if (gv or {}).get(leg) != dv.get(leg):
                        diffs.append(f"{key}/{leg}: {(gv or {}).get(leg)} -> {dv.get(leg)}")
            elif dv != gv:
                diffs.append(f"{key}: {gv} -> {dv}")
        if diffs:
            more = f" (+{len(diffs) - 4} more)" if len(diffs) > 4 else ""
            out.append(Finding(rule="range-golden", path=f"range:{name}/golden",
                               message=f"range pins drifted: {'; '.join(diffs[:4])}{more} -- {_REGEN}"))
    if full:
        for name in g_tiers:
            if name not in derived["tiers"]:
                out.append(Finding(rule="range-golden", path=f"range:{name}/golden",
                                   message=f"golden pins a tier the audit no longer derives -- {_REGEN}"))
    if derived.get("ceilings") != golden.get("ceilings"):
        out.append(Finding(rule="range-golden", path="range:ceilings/golden",
                           message=(f"pinned dtype ceilings {golden.get('ceilings')} differ from "
                                    f"derived {derived.get('ceilings')} -- {_REGEN}")))
    return out


def run_pass(config_names=op_audit.AUDIT_CONFIGS, golden_file: str | None = None,
             device: str = "cpu") -> list[Finding]:
    """The full value-range pass: both legs derived, the witness held to the
    proof, the pins loaded and compared. A missing golden file is itself a
    finding."""
    golden_file = golden_file or golden_path()
    rel = os.path.relpath(golden_file, _REPO_ROOT)
    derived, findings = derive_all(config_names, device)
    dint, _, ifinds = derive_intervals(config_names, device)
    findings = findings + ifinds
    for name, tier in derived["tiers"].items():
        legs = (dint["tiers"].get(name) or {}).get("legs")
        if legs is not None:
            findings += check_witness(name, PRESETS[name][0], tier, legs)
    try:
        with open(golden_file) as f:
            golden = json.load(f)
    except FileNotFoundError:
        return findings + [Finding(rule="range-golden", path=rel,
                                   message=f"no golden range pins -- {_REGEN}")]
    except (OSError, json.JSONDecodeError) as ex:
        return findings + [Finding(rule="range-golden", path=rel,
                                   message=f"golden range file unreadable: {ex}")]
    full = tuple(config_names) == tuple(op_audit.AUDIT_CONFIGS)
    return findings + compare(derived, golden, full=full) + compare_intervals(dint, golden,
                                                                              full=full)


class UnexplainedDivergence(Exception):
    """update_golden's refusal: a leg differs from JAX's record with no
    reason in analysis/jax_differs.json."""


def update_golden(path: str | None = None, config_names=op_audit.AUDIT_CONFIGS) -> str:
    """Regenerate tests/golden_torch_ranges.json from the tree: the observed
    pins and the proof's `interval` section. Refuses (UnexplainedDivergence,
    nothing written) while a leg differs from JAX's record with no reason."""
    path = path or golden_path()
    dint, _, _ = derive_intervals(config_names)
    missing = [f"{name}/{leg}" for name, tier in dint["tiers"].items()
               for leg, e in (tier.get("jax_differs") or {}).items() if e["reason"] is None]
    if missing:
        raise UnexplainedDivergence(
            f"{len(missing)} leg(s) differ from JAX's record with no reason in "
            f"analysis/jax_differs.json: {', '.join(missing)}")
    derived, _ = derive_all(config_names)
    with open(path, "w") as f:
        json.dump(dict(derived, interval=dint), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def diff_table(derived: dict, golden: dict, out=None) -> None:
    """Pinned against current: the legs that moved, per tier."""
    import sys

    out = out or sys.stdout
    g_tiers = golden.get("tiers") or {}
    print(f"{'tier/leg':44} {'pinned':>24} {'current':>24}", file=out)
    for name in sorted(set(derived.get("tiers") or {}) | set(g_tiers)):
        d = (derived.get("tiers") or {}).get(name) or {}
        g = g_tiers.get(name) or {}
        for key in ("legs", "horizons", "pack_widths"):
            dk, gk = d.get(key) or {}, g.get(key) or {}
            for leg in sorted(set(dk) | set(gk)):
                if dk.get(leg) != gk.get(leg):
                    print(f"{name + '/' + key + '/' + leg:44} {str(gk.get(leg)):>24} "
                          f"{str(dk.get(leg)):>24}", file=out)
    if derived.get("ceilings") != golden.get("ceilings"):
        print(f"{'ceilings':44} {str(golden.get('ceilings')):>24} "
              f"{str(derived.get('ceilings')):>24}", file=out)
    dint = derived.get("interval")
    if dint is None:
        return
    g_int = (golden.get("interval") or {}).get("tiers") or {}
    show = lambda rec: "-" if rec is None else _span(rec) + (  # noqa: E731
        f" +{rec['rate']}/t" if "rate" in rec else "")
    for name in sorted(dint["tiers"]):
        dl = dint["tiers"][name].get("legs") or {}
        gl = (g_int.get(name) or {}).get("legs") or {}
        for leg in sorted(set(dl) | set(gl)):
            if dl.get(leg) != gl.get(leg):
                print(f"{name + '/interval/' + leg:44} {show(gl.get(leg)):>24} "
                      f"{show(dl.get(leg)):>24}", file=out)


# ------------------------------------------------------------- the interval leg


def packed_legs(cfg: RaftConfig) -> set[str]:
    """The legs the compacted layout carries as packed words."""
    if not cfg.compact_planes:
        return set()
    from raft_sim_tpu_torch.ops import tile

    return ({f for f, mode, *_ in tile.state_plan(cfg) if mode == "pack"}
            | {f"mb.{f}" for f, mode, *_ in tile.mailbox_plan(cfg) if mode == "pack"})


def proof_declared(cfg: RaftConfig) -> dict:
    """The declared ranges the proof seeds and pins: under compact_planes the
    packed legs' value-domain declarations are dropped (their words live in
    another domain; check_pack_widths holds them to the tile table)."""
    packed = packed_legs(cfg)
    return {k: v for k, v in policy.declared_ranges(cfg).items() if k not in packed}


def _u32_legs(cfg: RaftConfig, names) -> set[str]:
    u32 = port_types.u32_leaves(cfg)
    return {n for n in names if not n.startswith(("metric.", "first_viol"))
            and n.removeprefix("mb.").removeprefix("trace.") in u32}


def _not_checked(label: str, why: str) -> Finding:
    return Finding(rule="range-golden", path=label,
                   message=f"{why}: the value-range gates for this program are NOT being checked")


def audit_program(prog: interval.Program, *, declared=None, leg_names=None):
    """Interpret one captured program. Returns (findings, record, unknown
    ops): the record is the tick loop's per-leg record, None when the
    program could not be checked (a finding says why). `declared` and
    `leg_names` are injectable for the seeded negatives."""
    findings: list[Finding] = []
    cfg, body = prog.cfg, prog.body
    if body.host_reads:
        op, site = body.host_reads[0]
        findings.append(_not_checked(
            prog.label, f"the tick reads a device value on the host ('{op}' at "
                        f"{interval.site_str(site)}): the capture bakes one arm of its branch"))
        return findings, None, {}
    if body.hash != prog.hash_b:
        findings.append(_not_checked(
            prog.label, f"the tick's op stream differs between ticks {prog.ticks[0]} and "
                        f"{prog.ticks[1]} ({body.hash} -> {prog.hash_b}): a host branch on the "
                        "tick bakes one arm into the capture"))
        return findings, None, {}
    declared = proof_declared(cfg) if declared is None else declared
    names = prog.names if leg_names is None else leg_names
    it = interval.Interp(prog.label, findings)
    env = it.run(prog.init, it.env(prog.init, dict.fromkeys(prog.init.inputs, interval.TOP)))
    entry = {n: env[s] for n, s in prog.init.outputs.items()}
    public = {n: policy.public_dtype(n, body.in_meta(n)[0], cfg) for n in names
              if n in body.inputs and not n.startswith(("metric.", "trace.", "first_viol"))}
    record = interval.audit_loop(
        it, body, entry, prog.consts, names, declared=declared,
        invariant=policy.invariant_leaves(cfg), u32=_u32_legs(cfg, names),
        public_dtypes=public)
    if record is None:
        findings.append(_not_checked(
            prog.label, f"no loop with the expected {len(names)}-leg carry found"))
    return findings, record, dict(it.unknown)


def audit_step_program(prog: interval.Program, label: str, declared=None) -> list[Finding]:
    """The `step` program: the simulate body's step_b span alone, state
    seeded from the declared ranges, inputs unknown (JAX `_step_seed`)."""
    findings: list[Finding] = []
    it = interval.Interp(label, findings)
    declared = proof_declared(prog.cfg) if declared is None else declared
    if not interval.audit_step(it, prog.body, declared):
        findings.append(_not_checked(label, "the capture marks no step span"))
    return findings


def _span(rec: dict) -> str:
    return f"[{rec.get('lo')}, {rec.get('hi')}]"


def load_jax_reasons(path: str | None = None) -> dict:
    """{(tier, leg): reason} from analysis/jax_differs.json: each entry names
    tiers, legs and one reason for all their pairs. A pair named twice is a
    ValueError."""
    with open(path or jax_reasons_path()) as f:
        doc = json.load(f)
    out: dict = {}
    for e in doc["reasons"]:
        for tier in e["tiers"]:
            for leg in e["legs"]:
                if (tier, leg) in out:
                    raise ValueError(f"jax_differs.json gives {tier}/{leg} two reasons")
                out[(tier, leg)] = e["reason"]
    return out


def jax_differs(name: str, legs: dict, jax_tiers: dict | None, reasons: dict) -> dict:
    """{leg: {port, jax, reason}} for every leg of `legs` whose record is not
    JAX's for tier `name` (empty without the JAX pins); `reason` is the
    table's (`reasons`, load_jax_reasons), None where it gives none."""
    if jax_tiers is None or name not in jax_tiers:
        return {}
    jlegs = jax_tiers[name].get("legs") or {}
    return {leg: {"port": rec, "jax": jlegs.get(leg), "reason": reasons.get((name, leg))}
            for leg, rec in sorted(legs.items()) if jlegs.get(leg) != rec}


def reason_findings(name: str, differs: dict, reasons: dict) -> list[Finding]:
    """range-golden for a leg that differs from JAX's record with no reason
    in the table, and for a reason the table gives a leg of tier `name`
    that no longer differs."""
    out = []
    for leg, e in differs.items():
        if e["reason"] is None:
            out.append(Finding(
                rule="range-golden", path=f"range:{name}/jax",
                message=(f"`{leg}`: the proof's record {e['port']} is not JAX's {e['jax']}, and "
                         f"analysis/jax_differs.json gives no reason -- trace the cause and add "
                         "one")))
    for tier, leg in sorted(reasons):
        if tier == name and leg not in differs:
            out.append(Finding(
                rule="range-golden", path=f"range:{name}/jax",
                message=(f"`{leg}`: analysis/jax_differs.json gives a reason, but the proof's "
                         "record now equals JAX's -- remove the entry")))
    return out


def _load_jax_tiers():
    try:
        with open(jax_golden_path()) as f:
            return json.load(f).get("tiers") or {}
    except (OSError, json.JSONDecodeError):
        return None


@functools.lru_cache(maxsize=4)
def _derive_intervals(config_names: tuple, device: str):
    import time

    findings: list[Finding] = []
    tiers: dict[str, dict] = {}
    captures: dict[str, dict] = {}
    jax_tiers = _load_jax_tiers()
    try:
        reasons = load_jax_reasons()
    except (OSError, ValueError, KeyError) as ex:
        reasons = {}
        findings.append(Finding(rule="range-golden", path="range:jax_differs",
                                message=f"analysis/jax_differs.json unreadable: {ex}"))
    for name in config_names:
        cfg, _ = PRESETS[name]
        tier: dict = {}
        unknown: dict = {}
        caps: dict = {}
        for variant in interval.PROGRAMS:
            label = f"range:{name}/{variant}"
            t0 = time.process_time()
            try:
                prog = interval.capture_program(name, cfg, variant, AUDIT_BATCH, device)
                fs, record, unk = audit_program(prog)
                if variant == "simulate":
                    fs += audit_step_program(prog, f"range:{name}/step")
                caps[variant] = {"hash": prog.body.hash, "hash_second_tick": prog.hash_b,
                                 "nodes": len(prog.body.nodes),
                                 "ticks": list(prog.ticks), "capture_cpu_s": round(prog.seconds, 3),
                                 "cpu_s": round(time.process_time() - t0, 3)}
            except Exception as ex:  # a derivation failure must be visible
                fs, record, unk = [_not_checked(
                    label, f"range derivation failed ({type(ex).__name__}: {ex})")], None, {}
            findings.extend(fs)
            for op, n in unk.items():
                unknown[op] = unknown.get(op, 0) + n
            if variant == "simulate" and record is not None:
                tier["legs"] = record
        caps["scenario_simulate"] = {"same_capture_as": "simulate"}
        tier["unknown_ops"] = sorted(unknown)
        if "legs" in tier:
            tier["jax_differs"] = jax_differs(name, tier["legs"], jax_tiers, reasons)
            findings.extend(reason_findings(name, tier["jax_differs"], reasons))
        tiers[name] = tier
        captures[name] = caps
    doc = {"audit_horizon": interval.H_AUDIT, "max_iters": interval.MAX_ITERS,
           "max_rounds": interval.MAX_ROUNDS, "audit_batch": AUDIT_BATCH,
           "programs": ["step", "simulate", "scenario_simulate", "serve_simulate",
                        "trace_simulate"],
           "shared_captures": {"scenario_simulate": "simulate"}, "tiers": tiers}
    return doc, captures, tuple(findings)


def derive_intervals(config_names=op_audit.AUDIT_CONFIGS, device: str = "cpu"):
    """(interval document, captures, findings) of the proof leg (cached):
    the document is what the golden pins; `captures` gives each program's
    op hash, node count, probe ticks and CPU seconds."""
    doc, captures, findings = _derive_intervals(tuple(config_names), str(device))
    return doc, captures, list(findings)


def check_witness(name: str, cfg: RaftConfig, observed: dict, legs: dict) -> list[Finding]:
    """The observing pass as the proof's witness: every value `run_tier`
    saw (`observed`: its `legs`, `entry` and `ticks`) lies inside the proven
    interval of its leg -- a rate leg's within entry + rate x tick. The
    packed legs of the compacted layout are watched in their dense view and
    proven as words: check_pack_widths holds them."""
    out = []
    packed = packed_legs(cfg)
    ticks = observed["ticks"]
    for leg, (lo, hi) in sorted(observed["legs"].items()):
        rec = legs.get(leg)
        if rec is None or leg in packed or rec.get("widened"):
            continue
        plo, phi = rec.get("lo"), rec.get("hi")
        if "rate" in rec and phi is not None:
            phi = phi + rec["rate"] * ticks
        if (plo is not None and lo < plo) or (phi is not None and hi > phi):
            out.append(Finding(
                rule="range-golden", path=f"range:{name}/witness",
                message=(f"the audit run saw `{leg}` in [{lo}, {hi}] over {ticks} ticks, outside "
                         f"its proven interval [{plo}, {phi}]: the proof is unsound there")))
    return out


def compare_intervals(dint: dict, golden: dict, *, full: bool = True) -> list[Finding]:
    """The interval pins' drift: each tier's leg records, jax_differs and
    unknown ops against the golden's `interval` section."""
    out: list[Finding] = []
    g_tiers = (golden.get("interval") or {}).get("tiers") or {}
    for name, d in dint["tiers"].items():
        g = g_tiers.get(name)
        if g is None:
            out.append(Finding(rule="range-golden", path=f"range:{name}/golden",
                               message=f"tier has no interval pin -- {_REGEN}"))
            continue
        diffs = []
        dl, gl = d.get("legs") or {}, g.get("legs") or {}
        for leg in sorted(set(dl) | set(gl)):
            if dl.get(leg) != gl.get(leg):
                diffs.append(f"interval/{leg}: {gl.get(leg)} -> {dl.get(leg)}")
        dj, gj = d.get("jax_differs") or {}, g.get("jax_differs") or {}
        for leg in sorted(set(dj) | set(gj)):
            if dj.get(leg) != gj.get(leg):
                diffs.append(f"jax_differs/{leg}: pinned {'yes' if leg in gj else 'no'}, "
                             f"now {'yes' if leg in dj else 'no'}")
        if d.get("unknown_ops") != g.get("unknown_ops"):
            diffs.append(f"unknown_ops: {g.get('unknown_ops')} -> {d.get('unknown_ops')}")
        if diffs:
            more = f" (+{len(diffs) - 4} more)" if len(diffs) > 4 else ""
            out.append(Finding(rule="range-golden", path=f"range:{name}/golden",
                               message=f"interval pins drifted: {'; '.join(diffs[:4])}{more} -- "
                                       f"{_REGEN}"))
    if full:
        for name in g_tiers:
            if name not in dint["tiers"]:
                out.append(Finding(rule="range-golden", path=f"range:{name}/golden",
                                   message=f"golden pins a tier the proof no longer derives -- "
                                           f"{_REGEN}"))
    return out


def report(config_names=op_audit.AUDIT_CONFIGS, device: str = "cpu") -> dict:
    """Both legs' derived documents and the captures (`check --range-report`)."""
    derived, _ = derive_all(config_names, device)
    dint, captures, _ = derive_intervals(config_names, device)
    return dict(derived, interval=dict(dint, captures=captures))
