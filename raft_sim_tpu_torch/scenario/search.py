"""Violation-hunting search: a cross-entropy loop where the fleet is the
population (the port of raft_sim_tpu/scenario/search.py).

One generation is one fleet run: the population of candidate fault genomes
becomes the `[B, 1]` genome of a heterogeneous fleet
(telemetry.simulate_windowed through the scenario input path), and each
cluster's fitness comes from its telemetry windows -- violations dominate,
and below them distress signals (concurrent leaders, leaderless windows,
commit stalls, term churn) pull the distribution toward trouble. A mutant
config (scenario/mutation.py) is the ground truth that this hunts: it must
fall within a bounded generation budget, while the real config survives.

Deterministic and replayable, with the JAX package's host arithmetic:
generation g runs under seed `spec.seed + SEED_STRIDE * g`, the population
comes from `np.random.default_rng(spec.seed)`, and a hit is described by
(genome row, seed, batch, cluster, horizon) -- what shrink.py minimizes.
The same spec gives the same generation log, hit and `genome_raw` as the
JAX `search`.

`fitness="coverage"` scores each cluster by the transition-coverage bits
(trace/ring.py) it sets that no earlier generation of the hunt set, with
violations still dominant; it runs the config's trace variant
(track_trace) through `telemetry.simulate_windowed(trace=...)`.
`proposal="coverage-guided"` (coverage fitness only) draws part of each
generation as small mutations of the previous generation's novelty-lit
genomes. `perf` (ROADMAP item 18) raises.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from raft_sim_tpu_torch.scenario import genome as genome_mod
from raft_sim_tpu_torch.sim import telemetry
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig

# Per-generation seed stride: disjoint generation seeds, int32-representable.
SEED_STRIDE = 100_003

# Fitness weights: any violation outranks any distress score; multi_leader
# (concurrent LEADER roles, one term collision from a violation) is the
# load-bearing precursor (the JAX module explains the landscape).
W_VIOLATION = 1.0e6
W_MULTI_LEADER = 20.0
W_LEADERLESS_WINDOW = 10.0
W_COMMIT_STALL = 5.0
W_TERM_CHURN = 1.0
W_LAT_EXCLUDED = 1.0


@dataclasses.dataclass(frozen=True)
class Knob:
    """One searched genome dimension, normalized to [0, 1] for the CE update:
    kind 'prob' decodes to a probability in [lo, hi], 'int' to a rounded
    integer in [lo, hi]."""

    name: str
    lo: float
    hi: float
    kind: str = "prob"


def default_knobs(cfg: RaftConfig) -> tuple[Knob, ...]:
    """The searched fault dimensions and their bounds; the disk-fault axes
    join only when the config runs the durable storage plane."""
    base = (
        Knob("drop_prob", 0.0, 0.6),
        Knob("partition_period", 0.0, 64.0, kind="int"),
        Knob("partition_prob", 0.0, 1.0),
        Knob("crash_prob", 0.0, 0.6),
        Knob("crash_down_ticks", 1.0, float(cfg.crash_period), kind="int"),
        Knob("clock_skew_prob", 0.0, 0.3),
    )
    if cfg.durable_storage:
        # fsync_interval stays >= 1: a zero cadence never flushes, and the
        # hunt would collapse into a commit stall that cannot violate.
        base += (
            Knob("fsync_interval", 1.0, 8.0, kind="int"),
            Knob("fsync_jitter_prob", 0.0, 0.6),
            Knob("torn_tail_prob", 0.0, 0.6),
            Knob("lost_suffix_span", 1.0, float(cfg.log_capacity // 2), kind="int"),
        )
    return base


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Search hyperparameters (the JAX SearchSpec's fields and defaults).
    `population` doubles as the fleet batch."""

    generations: int = 8
    population: int = 64
    ticks: int = 512
    window: int = 64
    elite_frac: float = 0.25
    seed: int = 0
    init_sigma: float = 0.35
    min_sigma: float = 0.05
    fitness: str = "scalar"  # or "coverage": transition-coverage novelty
    trace_depth: int = 32  # the coverage run's event-buffer depth
    proposal: str = "gaussian"  # or "coverage-guided" (needs fitness="coverage")
    guided_frac: float = 0.5  # share of a guided generation cloned from lit parents
    smoothing: float = 0.6  # CE smoothing toward the elite statistics
    carry_best: bool = True  # re-inject the best-so-far vector into slot 0
    stop_on_hit: bool = True
    knobs: tuple[Knob, ...] | None = None  # None -> default_knobs(cfg)


def _row_params(cfg: RaftConfig, knobs, x: np.ndarray) -> dict:
    """One normalized knob vector -> the `genome.segment` keywords of its
    one segment. Workload cadences stay pinned to cfg: the hunt searches
    the fault space around the workload."""
    params = {
        "client_interval": cfg.client_interval,
        "reconfig_interval": cfg.reconfig_interval,
        "transfer_interval": cfg.transfer_interval,
        "read_interval": cfg.read_interval,
        "fsync_interval": cfg.fsync_interval,
        "fsync_jitter_prob": cfg.fsync_jitter_prob,
        "torn_tail_prob": cfg.torn_tail_prob,
        "lost_suffix_span": cfg.lost_suffix_span,
    }
    for k, xi in zip(knobs, x):
        v = k.lo + float(xi) * (k.hi - k.lo)
        params[k.name] = int(round(v)) if k.kind == "int" else v
    params["crash_down_ticks"] = max(1, min(int(params.get("crash_down_ticks", 1)),
                                            cfg.crash_period))
    params["lost_suffix_span"] = max(1, min(int(params.get("lost_suffix_span", 1)),
                                            cfg.log_capacity))
    if cfg.durable_storage:
        params["fsync_interval"] = max(1, int(params.get("fsync_interval", cfg.fsync_interval)))
    return params


def _decode_row(cfg: RaftConfig, knobs, x: np.ndarray) -> genome_mod.ScenarioGenome:
    """One normalized knob vector -> an [S=1] genome."""
    return genome_mod.from_segments([genome_mod.segment(**_row_params(cfg, knobs, x))])


decode_row = _decode_row


def _population_genome(cfg: RaftConfig, knobs, xs: np.ndarray):
    """(the [B, 1] genome of a population, its rows' encoded segments): the
    same values as stacking `_decode_row` of each row, built as one tensor
    per field."""
    segs = [genome_mod.segment(**_row_params(cfg, knobs, x)) for x in xs]
    g = genome_mod.ScenarioGenome(**{
        f: torch.tensor([[s[f]] for s in segs], dtype=genome_mod.leaf_dtype(f))
        for f in genome_mod.ScenarioGenome._fields
    })
    return g, segs


def leaderless_windows(records) -> np.ndarray:
    """[B] windows whose fold saw any leaderless tick (last_leaderless_tick
    >= 0 in the window's metrics)."""
    return (np.asarray(records.metrics.last_leaderless_tick) >= 0).sum(axis=1)


def term_churn(metrics) -> np.ndarray:
    """[B] elections burned over the run (terms start at 1)."""
    return np.maximum(np.asarray(metrics.max_term) - 1, 0)


def commit_stalls(records, metrics) -> np.ndarray:
    """[B] windows where max_commit did not pass the previous window's
    high-water mark (zero without a client workload)."""
    mc = np.asarray(records.metrics.max_commit)  # [B, W]
    stalls = (np.diff(mc, axis=1) <= 0).sum(axis=1) if mc.shape[1] > 1 else 0
    return stalls * (np.asarray(metrics.total_cmds) > 0)


def fitness_from_records(records, metrics) -> np.ndarray:
    """[B] fitness from the telemetry window counters (higher = closer to
    breaking), host-side numpy over fetched records."""
    viol = np.asarray(metrics.violations, np.float64)
    lat_ex = np.asarray(metrics.lat_excluded, np.float64)
    multi = np.asarray(metrics.multi_leader, np.float64)
    return (
        W_VIOLATION * viol
        + W_MULTI_LEADER * multi
        + W_LEADERLESS_WINDOW * leaderless_windows(records)
        + W_COMMIT_STALL * commit_stalls(records, metrics)
        + W_TERM_CHURN * term_churn(metrics)
        + W_LAT_EXCLUDED * lat_ex
    )


def _popcount_words(words: np.ndarray) -> np.ndarray:
    """Set bits along the leading word axis ([C, B] -> [B])."""
    from raft_sim_tpu_torch.ops.bitplane import np_popcount_u32

    return np_popcount_u32(words).sum(axis=0)


def _u32(cov) -> np.ndarray:
    """Coverage words as uint32 (the port carries them as int32 patterns)."""
    a = np.asarray(cov)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def coverage_novelty(cov: np.ndarray, seen: np.ndarray) -> np.ndarray:
    """[B] bits each cluster's [C, B] coverage sets beyond the [C] seen-bit
    union as handed in (every cluster of a generation against the same
    baseline); the caller unions `cov` in afterwards (`seen_union`)."""
    return _popcount_words(_u32(cov) & ~seen[:, None])


def seen_union(cov: np.ndarray, seen: np.ndarray) -> np.ndarray:
    """The updated [C] seen-bit union after a [C, B] generation bitmap."""
    return seen | np.bitwise_or.reduce(_u32(cov), axis=1)


def coverage_fitness(cov: np.ndarray, seen: np.ndarray, violations):
    """([B] fitness, updated seen): novelty against the union seen before this
    generation, with violations lexicographically dominant."""
    fit = W_VIOLATION * np.asarray(violations, np.float64) + coverage_novelty(cov, seen)
    return fit, seen_union(cov, seen)


def propose_gaussian(rng, mu: np.ndarray, sigma: np.ndarray, n: int) -> np.ndarray:
    """The classic CE proposal: n knob vectors ~ N(mu, sigma), clipped to the
    normalized cube."""
    return np.clip(rng.normal(mu, sigma, size=(n, mu.shape[0])), 0.0, 1.0)


def _parent_entropy(seed: int, x: np.ndarray) -> list[int]:
    """rng entropy for one parent genome: the base seed plus its knob vector
    on the uint32 grid, so a mutation stream depends on (genome, seed) only."""
    return [int(seed) & 0xFFFFFFFF] + [
        int(v) for v in (np.clip(x, 0.0, 1.0) * 0xFFFFFFFF).astype(np.uint64)
    ]


def propose_coverage_guided(rng, mu: np.ndarray, sigma: np.ndarray, n: int,
                            parents: np.ndarray | None, parent_novelty: np.ndarray | None,
                            seed: int, frac: float = 0.5, mut_scale: float = 0.25) -> np.ndarray:
    """Coverage-guided mutation: up to `frac` of the n proposals (the last
    ones) are clones of the previous generation's novelty-lit parents,
    richest first, perturbed by `mut_scale` x sigma from each parent's own
    stream (`_parent_entropy`); the rest are gaussian draws. With no lit
    parent this is the gaussian proposal."""
    if parents is None or parent_novelty is None or not np.any(parent_novelty > 0):
        return propose_gaussian(rng, mu, sigma, n)
    lit = np.flatnonzero(parent_novelty > 0)
    lit = lit[np.argsort(-parent_novelty[lit], kind="stable")]
    n_guided = min(int(round(frac * n)), n)
    xs = propose_gaussian(rng, mu, sigma, n)
    for j in range(n_guided):
        p = parents[lit[j % lit.size]]
        crng = np.random.default_rng(_parent_entropy(seed, p) + [j])
        xs[n - 1 - j] = np.clip(p + crng.normal(0.0, sigma * mut_scale), 0.0, 1.0)
    return xs


@dataclasses.dataclass
class SearchResult:
    """One search: the per-generation log and the first violating hit (None
    if the config survived the budget)."""

    hit: dict | None
    generations: list[dict]
    spec: dict

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def search(cfg: RaftConfig, spec: SearchSpec | None = None, perf=None,
           device="cuda", on_generation=None) -> SearchResult:
    """Run the cross-entropy hunt against `cfg` (a mutation.py config to hunt
    a weakened tick) on `device`. Returns the generation log and, if a
    cluster tripped an invariant, the replayable hit. `on_generation(gen,
    genome, seed)`, if given, sees each generation's [B, 1] population
    genome and fleet seed after its run. In coverage mode each generation's
    row also carries `cov_new_bits` and `cov_total_bits`; a guided
    generation draws its clones when the generation before it lit a new
    bit (its `cov_new_bits` > 0)."""
    spec = spec or SearchSpec()
    knobs = spec.knobs or default_knobs(cfg)
    if spec.ticks % spec.window:
        raise ValueError(f"ticks {spec.ticks} must divide by window {spec.window}")
    if spec.fitness not in ("scalar", "coverage"):
        raise ValueError(f"unknown fitness mode {spec.fitness!r} (have: scalar, coverage)")
    if spec.proposal not in ("gaussian", "coverage-guided"):
        raise ValueError(f"unknown proposal mode {spec.proposal!r} "
                         "(have: gaussian, coverage-guided)")
    if spec.proposal == "coverage-guided" and spec.fitness != "coverage":
        raise ValueError("proposal='coverage-guided' needs fitness='coverage': guided mutation "
                         "selects parents by the novelty bits only the coverage bitmap provides")
    if perf is not None:
        raise NotImplementedError(
            "search: perf attribution is not ported yet (ROADMAP item 18)")
    dev = device_mod.resolve(device)
    trace_spec = seen = None
    if spec.fitness == "coverage":
        from raft_sim_tpu_torch.trace.ring import COV_WORDS, TraceSpec

        cfg = dataclasses.replace(cfg, track_trace=True)
        trace_spec = TraceSpec(depth=spec.trace_depth, coverage=True)
        seen = np.zeros(COV_WORDS, np.uint32)
    rng = np.random.default_rng(spec.seed)
    dim = len(knobs)
    mu = np.full(dim, 0.5)
    sigma = np.full(dim, spec.init_sigma)
    n_elite = max(2, int(round(spec.elite_frac * spec.population)))
    gens: list[dict] = []
    hit: dict | None = None
    best_x, best_fit = None, -np.inf
    prev_xs = prev_novelty = None  # the coverage-guided parent pool

    for gen in range(spec.generations):
        if spec.proposal == "coverage-guided":
            xs = propose_coverage_guided(rng, mu, sigma, spec.population, prev_xs, prev_novelty,
                                         spec.seed, frac=spec.guided_frac)
        else:
            xs = propose_gaussian(rng, mu, sigma, spec.population)
        if spec.carry_best and best_x is not None:
            xs[0] = best_x
        g, segs = _population_genome(cfg, knobs, xs)  # [B, 1] leaves
        genome_mod.validate(cfg, g)
        sim_seed = spec.seed + SEED_STRIDE * gen
        out = telemetry.simulate_windowed(
            cfg, sim_seed, spec.population, spec.ticks, spec.window, genome=g, device=dev,
            trace=trace_spec,
        )
        fetched = [out[1], out[2]] + ([out[5].cov] if trace_spec is not None else [])
        metrics, records, *tp_cov = device_mod.host_numpy(*device_mod.to_host_async(fetched))
        del out
        if on_generation is not None:
            on_generation(gen, g, sim_seed)
        if trace_spec is None:
            fit = fitness_from_records(records, metrics)
            cov_new = None
        else:
            before = int(_popcount_words(seen[:, None])[0])
            novelty = coverage_novelty(tp_cov[0], seen)
            fit = W_VIOLATION * np.asarray(metrics.violations, np.float64) + novelty
            seen = seen_union(tp_cov[0], seen)
            cov_new = int(_popcount_words(seen[:, None])[0]) - before
            prev_xs, prev_novelty = xs, novelty
        order = np.argsort(-fit)
        elites = xs[order[:n_elite]]
        a = spec.smoothing
        mu = a * elites.mean(axis=0) + (1 - a) * mu
        sigma = np.maximum(a * elites.std(axis=0) + (1 - a) * sigma, spec.min_sigma)
        if fit[order[0]] > best_fit:
            best_fit, best_x = float(fit[order[0]]), xs[order[0]].copy()
        violating = np.flatnonzero(np.asarray(metrics.violations) > 0)
        best = int(order[0])
        row = {
            "gen": gen,
            "seed": int(sim_seed),
            "best_fitness": float(fit[best]),
            "mean_fitness": float(fit.mean()),
            "violating_clusters": int(violating.size),
            "best_genome": genome_mod.decode(genome_mod.from_segments([segs[best]]))[0],
        }
        if cov_new is not None:
            row["cov_new_bits"] = cov_new
            row["cov_total_bits"] = int(_popcount_words(seen[:, None])[0])
        gens.append(row)
        if violating.size and hit is None:
            c = int(violating[0])
            fv = np.asarray(records.first_viol_tick)[c]
            row = genome_mod.from_segments([segs[c]])
            hit = {
                "seed": int(sim_seed),
                "batch": int(spec.population),
                "cluster": c,
                "ticks": int(spec.ticks),
                "seg_len": 1,
                "first_viol_tick": int(fv[fv < telemetry.NEVER].min()),
                "genome_raw": genome_mod.to_raw(row),
                "segments": genome_mod.decode(row),
            }
            if spec.stop_on_hit:
                break

    return SearchResult(
        hit=hit,
        generations=gens,
        spec={
            "generations": spec.generations,
            "population": spec.population,
            "ticks": spec.ticks,
            "window": spec.window,
            "elite_frac": spec.elite_frac,
            "seed": spec.seed,
            "fitness": spec.fitness,
            "proposal": spec.proposal,
            "knobs": [dataclasses.asdict(k) for k in knobs],
        },
    )
