"""The fuzzing farm: portfolio hunts over one fleet run a generation (the port
of raft_sim_tpu/farm/core.py; the same hunt rows, manifest, manifest hash,
negative result and frozen artifacts as the JAX farm on the same seed).

`scenario search` is one CE loop with one fitness function; the farm makes
the fleet's scale count:

  1. PORTFOLIO -- the batch axis is partitioned among fitness members
     (farm/portfolio.py) the way serve/tenancy.py partitions tenants: each
     member owns a contiguous cluster slice and its own CE distribution, and
     one generation = ONE `telemetry.simulate_windowed` call for the whole
     portfolio, every tick of it one launch of the tick kernel on the card.
  2. COVERAGE-GUIDED MUTATION -- members propose through
     `search.propose_coverage_guided` against a FARM-WIDE seen-bit union:
     genomes that lit unseen transition bits anywhere in the portfolio
     become mutation parents, deterministic per (genome, seed).
  3. AUTO-CORPUS -- hits are shrunk (scenario/shrink.py; bounded: the first
     violating cluster per member per generation, the rest counted in the
     hunt stream), deduped against the corpus by (kernel, violation kinds,
     mechanism set) signature, provenance-stamped, checker-gated and frozen
     (farm/corpus.py). A budget spent without a hit ends in a pinned
     negative result with coverage numbers (negative.json).

Each generation's records, metrics and coverage words come to the host in
one copy; the members score numpy slices of it. Out-dir streams:
farm_manifest.json, members/<name>/hunt.jsonl (one row per generation per
member), negative.json (hitless budgets) and perf.jsonl (one chunk-timer row
a generation), with health.jsonl/alerts.jsonl beside them under `health`.
The mesh-sharded farm is not ported (ROADMAP item 19).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from raft_sim_tpu_torch.farm import corpus as corpus_mod
from raft_sim_tpu_torch.farm import portfolio as portfolio_mod
from raft_sim_tpu_torch.scenario import genome as genome_mod
from raft_sim_tpu_torch.scenario import search as search_mod
from raft_sim_tpu_torch.scenario import shrink as shrink_mod
from raft_sim_tpu_torch.serve.tenancy import split_even
from raft_sim_tpu_torch.sim import telemetry
from raft_sim_tpu_torch.utils import device as device_mod
from raft_sim_tpu_torch.utils.config import RaftConfig, nondefault_fields

FARM_MANIFEST_SCHEMA = "farm-manifest-v1"
FARM_NEGATIVE_SCHEMA = "farm-negative-v1"

# Required fields of a members/<name>/hunt.jsonl row (validate_farm_dir).
HUNT_INT_FIELDS = ("gen", "seed", "violating_clusters")
HUNT_FLOAT_FIELDS = ("best_fitness", "mean_fitness")


@dataclasses.dataclass(frozen=True)
class FarmSpec:
    """Farm hyperparameters (the JAX FarmSpec's fields and defaults).
    `population` is the TOTAL fleet batch, split contiguously among the
    portfolio members (tenancy's split_even)."""

    portfolio: tuple[str, ...] = ("scalar", "coverage")
    budget_gens: int = 8
    population: int = 64
    ticks: int = 512
    window: int = 64
    elite_frac: float = 0.25
    seed: int = 0
    init_sigma: float = 0.35
    min_sigma: float = 0.05
    smoothing: float = 0.6
    carry_best: bool = True
    trace_depth: int = 32
    # Coverage-guided proposals for every member against the farm-wide seen
    # set; they need the coverage bitmap, so they run the traced variant.
    guided: bool = True
    guided_frac: float = 0.5
    # When to stop early: "hit" = the first processed hit, "frozen" = only a
    # newly frozen artifact, "budget" = never.
    stop_on: str = "hit"
    knobs: tuple = None  # None -> search.default_knobs(cfg)

    def __post_init__(self):
        if self.stop_on not in ("hit", "frozen", "budget"):
            raise ValueError(f"stop_on {self.stop_on!r} (have: hit, frozen, budget)")
        if self.ticks % self.window:
            raise ValueError(f"ticks {self.ticks} must divide by window {self.window}")


@dataclasses.dataclass
class FarmResult:
    """One farm run: the manifest (what farm_manifest.json holds), the
    per-generation member rows, processed hits, frozen artifact paths and
    the dedup ledger."""

    manifest: dict
    generations: list[dict]
    hits: list[dict]
    frozen: list[str]
    dedup_rejected: list[dict]

    @property
    def negative(self) -> bool:
        return not self.hits


def manifest_hash(identity: dict) -> str:
    """Stable short hash of the farm's identity (config, mutant, portfolio,
    budget, seed, CE knobs): the provenance key tying a frozen artifact to
    the hunt that produced it, equal to the JAX farm's for the same
    identity."""
    blob = json.dumps(identity, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class FarmSink:
    """Writer half of the farm's out-dir schema. Creating one truncates the
    streams and drops another run's member streams; it speaks the chunk
    timer's sink protocol (append_perf), so perf.jsonl rows stream here."""

    def __init__(self, directory: str, members: list[dict]):
        import shutil

        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        for stale in ("farm_manifest.json", "negative.json", "perf.jsonl"):
            p = os.path.join(directory, stale)
            if os.path.exists(p):
                os.remove(p)
        keep = {m["name"] for m in members}
        mdir = os.path.join(directory, "members")
        if os.path.isdir(mdir):
            for name in os.listdir(mdir):
                if name not in keep:
                    shutil.rmtree(os.path.join(mdir, name))
        self._hunt_paths = {}
        for m in members:
            d = os.path.join(mdir, m["name"])
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, "hunt.jsonl")
            open(path, "w").close()
            self._hunt_paths[m["name"]] = path

    def append_hunt(self, member: str, row: dict) -> None:
        with open(self._hunt_paths[member], "a") as f:
            f.write(json.dumps(row) + "\n")

    def append_perf(self, rows: list[dict]) -> int:
        with open(os.path.join(self.directory, "perf.jsonl"), "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        return len(rows)

    def _write(self, name: str, doc: dict) -> str:
        path = os.path.join(self.directory, name)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def write_manifest(self, manifest: dict) -> str:
        return self._write("farm_manifest.json", manifest)

    def write_negative(self, doc: dict) -> str:
        return self._write("negative.json", doc)


@dataclasses.dataclass
class _Member:
    """One portfolio member's host-side hunt state."""

    name: str
    fitness: str
    lo: int
    hi: int
    mu: np.ndarray
    sigma: np.ndarray
    rng: np.random.Generator
    best_x: np.ndarray | None = None
    best_fit: float = -np.inf
    prev_xs: np.ndarray | None = None
    prev_novelty: np.ndarray | None = None

    @property
    def b(self) -> int:
        return self.hi - self.lo


def _member_names(portfolio: tuple[str, ...]) -> list[str]:
    """Unique stream names for possibly duplicated members (scalar, scalar2)."""
    seen: dict[str, int] = {}
    names = []
    for f in portfolio:
        seen[f] = seen.get(f, 0) + 1
        names.append(f if seen[f] == 1 else f"{f}{seen[f]}")
    return names


def _rows(tree, lo: int, hi: int):
    """A NamedTuple tree of numpy leaves, each cut to clusters [lo, hi) of its
    leading axis."""
    return type(tree)(*(_rows(x, lo, hi) if hasattr(x, "_fields") else x[lo:hi] for x in tree))


def run_farm(cfg: RaftConfig, spec: FarmSpec | None = None, mutant: str | None = None,
             out_dir: str | None = None, corpus_dir: str | None = None, freeze: bool = False,
             perf=None, mesh=None, health=None, device="cuda") -> FarmResult:
    """Run the portfolio hunt on `device`. `cfg` must already be the tick
    under test (mutant_config-applied for mutant hunts; `mutant` labels
    artifacts and provenance, as in shrink). `corpus_dir` arms the
    auto-corpus policy: hits are shrunk and dedup'd against it, and
    `freeze=True` lets the farm write new artifacts into it (checker-gated).
    `perf` is an obs.ChunkTimer (one row a generation); with an `out_dir`
    and no timer the farm makes its own, streaming perf.jsonl there.
    `health` (an SLO spec: "default", a path or a dict; needs `out_dir`)
    folds the streaming evaluator into the per-generation record copy, one
    scope ("farm") over the whole population; hunts are the same with it.

    Hit processing is bounded: each generation, each member's first
    violating cluster is shrunk; the other violating clusters are counted in
    the hunt rows and the manifest's violating_clusters_total. `mesh` (the
    JAX farm's sharded evaluation) is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError("run_farm: the mesh-sharded farm is not ported yet "
                                  "(ROADMAP item 19)")
    spec = spec or FarmSpec()
    dev = device_mod.resolve(device)
    portfolio = portfolio_mod.parse_portfolio(spec.portfolio)
    knobs = spec.knobs or search_mod.default_knobs(cfg)
    dim = len(knobs)
    needs_trace = spec.guided or any(portfolio_mod.FITNESS[f][1] for f in portfolio)
    run_cfg = cfg
    trace_spec = seen = None
    if needs_trace:
        from raft_sim_tpu_torch.trace.ring import COV_WORDS, TraceSpec

        run_cfg = dataclasses.replace(cfg, track_trace=True)
        trace_spec = TraceSpec(depth=spec.trace_depth, coverage=True)
        seen = np.zeros(COV_WORDS, np.uint32)

    sizes = split_even(spec.population, len(portfolio))
    names = _member_names(portfolio)
    members: list[_Member] = []
    lo = 0
    for i, (fname, b) in enumerate(zip(portfolio, sizes)):
        members.append(_Member(
            name=names[i], fitness=fname, lo=lo, hi=lo + b,
            mu=np.full(dim, 0.5), sigma=np.full(dim, spec.init_sigma),
            rng=np.random.default_rng([spec.seed, i]),
        ))
        lo += b

    identity = {
        "config": nondefault_fields(cfg),
        "mutant": mutant,
        "portfolio": list(portfolio),
        "population": spec.population,
        "ticks": spec.ticks,
        "window": spec.window,
        "budget_gens": spec.budget_gens,
        "seed": spec.seed,
        "guided": spec.guided,
        # The CE knobs change the hunt's trajectory, so they are part of the
        # hashed identity.
        "spec": {
            "elite_frac": spec.elite_frac,
            "smoothing": spec.smoothing,
            "init_sigma": spec.init_sigma,
            "min_sigma": spec.min_sigma,
            "guided_frac": spec.guided_frac,
            "trace_depth": spec.trace_depth,
            "stop_on": spec.stop_on,
        },
    }
    mhash = manifest_hash(identity)
    member_docs = [{"name": m.name, "fitness": m.fitness, "lo": m.lo, "hi": m.hi}
                   for m in members]
    sink = FarmSink(out_dir, member_docs) if out_dir else None
    if sink is not None and perf is None:
        from raft_sim_tpu_torch.obs import ChunkTimer

        perf = ChunkTimer(label="farm", batch=spec.population, sink=sink)
    if perf is not None:
        perf.watch(dev)
    monitor = None
    if health is not None:
        if out_dir is None:
            raise ValueError("health monitoring needs an out_dir: the health/alert streams "
                             "and evidence bundles live there")
        from raft_sim_tpu_torch.health import HealthMonitor, HealthWriter, load_spec

        refs = {"farm": mhash, "mutant": mutant, "seed": spec.seed}
        monitor = HealthMonitor(load_spec(health), batch=spec.population,
                                writer=HealthWriter(out_dir), scope="farm", perf=perf,
                                capture=lambda alert, clusters: {"refs": refs})

    gens: list[dict] = []
    hits: list[dict] = []
    frozen: list[str] = []
    dedup_rejected: list[dict] = []
    cov_by_gen: list[int] = []
    n_elite_of = lambda b: max(2, int(round(spec.elite_frac * b)))  # noqa: E731
    stop = False

    for gen in range(spec.budget_gens):
        # --- propose: per-member CE draws, coverage-guided when armed.
        xs = np.zeros((spec.population, dim))
        for m in members:
            if spec.guided:
                mx = search_mod.propose_coverage_guided(
                    m.rng, m.mu, m.sigma, m.b, m.prev_xs, m.prev_novelty, spec.seed,
                    frac=spec.guided_frac)
            else:
                mx = search_mod.propose_gaussian(m.rng, m.mu, m.sigma, m.b)
            if spec.carry_best and m.best_x is not None:
                mx[0] = m.best_x
            xs[m.lo:m.hi] = mx
        g, segs = search_mod._population_genome(cfg, knobs, xs)  # [B, 1] leaves
        genome_mod.validate(cfg, g)
        sim_seed = spec.seed + search_mod.SEED_STRIDE * gen

        # --- evaluate: the whole portfolio in one fleet run.
        if perf is not None:
            perf.begin(spec.ticks)
        out = telemetry.simulate_windowed(run_cfg, sim_seed, spec.population, spec.ticks,
                                          spec.window, genome=g, trace=trace_spec, device=dev)
        if perf is not None:
            perf.dispatched()
            perf.annotate(n_devices=1, backend=dev.type)
            perf.end(sync=lambda: out[1].ticks.cpu())
        # One host copy of the generation: records, metrics, coverage words.
        fetched = [out[1], out[2]] + ([out[5].cov] if trace_spec is not None else [])
        metrics, records, *cov = device_mod.host_numpy(*device_mod.to_host_async(fetched))
        del out
        cov = cov[0] if cov else None
        if monitor is not None:
            monitor.observe_records(records)

        # --- score and CE-update each member against the shared baseline.
        viol_all = np.asarray(metrics.violations)
        gen_rows = []
        for m in members:
            m_rec, m_met = _rows(records, m.lo, m.hi), _rows(metrics, m.lo, m.hi)
            novelty = None
            if cov is not None:
                novelty = search_mod.coverage_novelty(cov[:, m.lo:m.hi], seen)
            fit = portfolio_mod.FITNESS[m.fitness][0](m_rec, m_met, novelty)
            order = np.argsort(-fit)
            elites = xs[m.lo:m.hi][order[:n_elite_of(m.b)]]
            a = spec.smoothing
            m.mu = a * elites.mean(axis=0) + (1 - a) * m.mu
            m.sigma = np.maximum(a * elites.std(axis=0) + (1 - a) * m.sigma, spec.min_sigma)
            if fit[order[0]] > m.best_fit:
                m.best_fit = float(fit[order[0]])
                m.best_x = xs[m.lo + order[0]].copy()
            m.prev_xs, m.prev_novelty = xs[m.lo:m.hi], novelty
            best = genome_mod.from_segments([segs[m.lo + int(order[0])]])
            gen_rows.append({
                "gen": gen,
                "seed": int(sim_seed),
                "member": m.name,
                "fitness": m.fitness,
                "best_fitness": float(fit[order[0]]),
                "mean_fitness": float(fit.mean()),
                "violating_clusters": int((viol_all[m.lo:m.hi] > 0).sum()),
                "novelty_bits": int(novelty.sum()) if novelty is not None else None,
                "best_genome": genome_mod.decode(best)[0],
            })
        # Union after every member scored: scoring is member-order-free and
        # the seen set grows monotonically.
        if cov is not None:
            seen = search_mod.seen_union(cov, seen)
            total_bits = int(search_mod._popcount_words(seen[:, None])[0])
            for row in gen_rows:
                row["cov_total_bits"] = total_bits
            cov_by_gen.append(total_bits)
        if sink is not None:
            for row in gen_rows:
                sink.append_hunt(row["member"], row)
        gens.extend(gen_rows)

        # --- bank hits: the first violating cluster per member this generation.
        for m in members:
            violating = np.flatnonzero(viol_all[m.lo:m.hi] > 0)
            if not violating.size:
                continue
            c = m.lo + int(violating[0])
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
                "member": m.name,
                "fitness": m.fitness,
                "gen": gen,
            }
            hits.append(hit)
            if corpus_dir is not None:
                art = shrink_mod.shrink(cfg, hit, mutant=mutant, device=dev)
                dup = corpus_mod.find_duplicate(art, corpus_dir)
                if dup is not None:
                    dedup_rejected.append(dict(dup, member=m.name, gen=gen))
                elif freeze:
                    path, _ = corpus_mod.freeze(
                        art, corpus_dir,
                        provenance={
                            "mutant": mutant,
                            "fitness": m.fitness,
                            "member": m.name,
                            "generation": gen,
                            "seed": int(sim_seed),
                            "farm": mhash,
                        },
                        device=dev,
                    )
                    frozen.append(path)
                    if spec.stop_on == "frozen":
                        stop = True
                else:
                    hit["unfrozen"] = True  # a new signature, freezing off
            if spec.stop_on == "hit":
                stop = True
        if stop:
            break

    n_gens = (gens[-1]["gen"] + 1) if gens else 0
    manifest = {
        "schema": FARM_MANIFEST_SCHEMA,
        **identity,
        "manifest_hash": mhash,
        "members": member_docs,
        "generations_run": n_gens,
        "evaluations": n_gens * spec.population,
        # Hit processing is bounded; the full violating-cluster count is a
        # number here, never a silence.
        "violating_clusters_total": sum(g["violating_clusters"] for g in gens),
        "cov_bits_total": cov_by_gen[-1] if cov_by_gen else None,
        "hits": [{k: h[k] for k in ("member", "fitness", "gen", "seed", "cluster",
                                    "first_viol_tick")}
                 for h in hits],
        "frozen": [os.path.basename(p) for p in frozen],
        "dedup_rejected": dedup_rejected,
        "negative": not hits,
    }
    if monitor is not None:
        manifest["health"] = monitor.finalize()
    if sink is not None:
        sink.write_manifest(manifest)
        if not hits:
            sink.write_negative({
                "schema": FARM_NEGATIVE_SCHEMA,
                "manifest_hash": mhash,
                **identity,
                "generations": manifest["generations_run"],
                "evaluations": manifest["evaluations"],
                "cov_bits_total": manifest["cov_bits_total"],
                "cov_bits_by_gen": cov_by_gen,
                "knobs": [dataclasses.asdict(k) for k in knobs],
            })
    return FarmResult(manifest=manifest, generations=gens, hits=hits, frozen=frozen,
                      dedup_rejected=dedup_rejected)


def _hunt_errors(directory: str, man: dict, m: dict) -> list[str]:
    """The problems of one member's hunt.jsonl: field types, contiguous
    generations, and as many rows as the manifest's generations_run."""
    path = os.path.join(directory, "members", m.get("name", "?"), "hunt.jsonl")
    if not os.path.isfile(path):
        return [f"missing members/{m.get('name')}/hunt.jsonl"]
    errors = []
    prev_gen = -1
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            try:
                row = json.loads(raw)
            except json.JSONDecodeError as ex:
                errors.append(f"{m['name']}/hunt.jsonl:{ln}: not JSON: {ex}")
                continue
            for k in HUNT_INT_FIELDS:
                if not isinstance(row.get(k), int) or row.get(k) is True:
                    errors.append(f"{m['name']}/hunt.jsonl:{ln}: field {k!r} missing or non-int")
            for k in HUNT_FLOAT_FIELDS:
                if not isinstance(row.get(k), (int, float)):
                    errors.append(
                        f"{m['name']}/hunt.jsonl:{ln}: field {k!r} missing or non-numeric")
            if isinstance(row.get("gen"), int):
                if row["gen"] != prev_gen + 1:
                    errors.append(f"{m['name']}/hunt.jsonl:{ln}: gen {row['gen']} "
                                  f"(expected {prev_gen + 1})")
                prev_gen = row["gen"]
    # Contiguity alone passes a tail-truncated stream.
    if isinstance(man.get("generations_run"), int) and prev_gen + 1 != man["generations_run"]:
        errors.append(f"{m['name']}/hunt.jsonl: {prev_gen + 1} generation rows, manifest "
                      f"claims {man['generations_run']} -- stream truncated")
    return errors


def validate_farm_dir(directory: str) -> list[str]:
    """Check a farm out-dir ([] = valid): manifest fields, each member's
    hunt.jsonl, the negative document when the manifest claims one,
    perf.jsonl rows against the telemetry sink's perf fields, and the
    health streams (telemetry_sink.validate_health_files)."""
    from raft_sim_tpu_torch.utils.telemetry_sink import perf_row_errors, validate_health_files

    man_path = os.path.join(directory, "farm_manifest.json")
    if not os.path.isfile(man_path):
        return [f"missing farm_manifest.json in {directory}"]
    try:
        with open(man_path) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        return [f"farm_manifest.json unreadable: {ex}"]
    errors = [f"farm_manifest.json: missing field {k!r}"
              for k in ("schema", "config", "portfolio", "members", "manifest_hash",
                        "population", "budget_gens", "seed", "generations_run", "hits", "frozen",
                        "dedup_rejected", "negative")
              if k not in man]
    if man.get("schema") != FARM_MANIFEST_SCHEMA:
        errors.append(f"farm_manifest.json: schema {man.get('schema')!r}, expected "
                      f"{FARM_MANIFEST_SCHEMA}")
    for m in man.get("members", []):
        errors += _hunt_errors(directory, man, m)
    if man.get("negative") and not os.path.isfile(os.path.join(directory, "negative.json")):
        errors.append("manifest claims a negative result but negative.json missing")
    perf_path = os.path.join(directory, "perf.jsonl")
    if os.path.isfile(perf_path):
        with open(perf_path) as f:
            for ln, raw in enumerate(f, 1):
                try:
                    row = json.loads(raw)
                except json.JSONDecodeError as ex:
                    errors.append(f"perf.jsonl:{ln}: not JSON: {ex}")
                    continue
                errors += perf_row_errors(row, f"perf.jsonl:{ln}")
    return errors + validate_health_files(directory)
