"""The port's fuzzing farm (raft_sim_tpu_torch/farm/core.py and portfolio.py)
against the JAX package's, on the CPU at the JAX farm tests' sizes.

The fresh-freeze hunt (blind-transfer on a config without it in the corpus,
portfolio scalar,coverage, 16 x 192, 4 generations, freezing into an empty
corpus) runs once in each package -- the port's through `scenario farm` on
the command line -- and is shared by the module; so is the negative hunt
(the real kitchen-sink config, 2 generations of 16 x 128). Host-side parts
(portfolio parsing, spec checks, the manifest hash, the six fitness
functions, the seen set) are held to the JAX functions on the same inputs.

Tolerance: exact equality. Hunt rows, manifests, negative documents and
frozen artifacts compare byte for byte or value for value; fitness floats
too (both packages run the same numpy over equal integer counters). Left
out: the manifests' `dedup_rejected[].path` (a path into each run's own
corpus directory) and perf.jsonl's clock readings.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu import farm as jfarm
from raft_sim_tpu.farm import core as jcore
from raft_sim_tpu.farm import portfolio as jport
from raft_sim_tpu.scenario import mutation as jmut
from raft_sim_tpu.scenario import search as jsearch
from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch import farm as tfarm
from raft_sim_tpu_torch.farm import core as tcore
from raft_sim_tpu_torch.farm import portfolio as tport
from raft_sim_tpu_torch.scenario import search as tsearch
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

BLIND_KW = dict(n_nodes=5, log_capacity=16, client_interval=2, transfer_interval=9)
SINK_KW = dict(n_nodes=5, log_capacity=8, client_interval=4, drop_prob=0.2,
               partition_period=16, partition_prob=0.3, crash_prob=0.3, crash_period=32,
               crash_down_ticks=8, clock_skew_prob=0.1)
POP, WINDOW, DEPTH = 16, 32, 16
FRESH = dict(portfolio=("scalar", "coverage"), budget_gens=4, population=POP, ticks=192,
             window=WINDOW, trace_depth=DEPTH, seed=0)
NEGATIVE = dict(FRESH, budget_gens=2, ticks=128, stop_on="budget")


def _files(directory: str) -> dict:
    """{relative path: bytes} of every file under `directory`."""
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, directory)] = f.read()
    return out


def _manifest(directory: str) -> dict:
    with open(os.path.join(directory, "farm_manifest.json")) as f:
        man = json.load(f)
    for d in man["dedup_rejected"]:
        d.pop("path")
    return man


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """The fresh-freeze hunt in both packages: JAX's run_farm, the port's
    `scenario farm` command line (its printed summary line kept)."""
    base = tmp_path_factory.mktemp("fresh")
    jout, tout = str(base / "jax"), str(base / "port")
    jcorpus, tcorpus = str(base / "jax_corpus"), str(base / "port_corpus")
    os.makedirs(jcorpus)
    os.makedirs(tcorpus)
    jres = jfarm.run_farm(jmut.mutant_config("blind-transfer", rst.RaftConfig(**BLIND_KW)),
                          jfarm.FarmSpec(**FRESH), mutant="blind-transfer", out_dir=jout,
                          corpus_dir=jcorpus, freeze=True)
    flags = ["--n-nodes", "5", "--log-capacity", "16", "--client-interval", "2",
             "--transfer-interval", "9", "--mutant", "blind-transfer",
             "--portfolio", "scalar,coverage", "--budget-gens", "4", "--population", str(POP),
             "--ticks", "192", "--window", str(WINDOW), "--trace-depth", str(DEPTH),
             "--seed", "0"]
    return jres, jout, tout, jcorpus, tcorpus, flags


@pytest.fixture(scope="module")
def fresh_cli(fresh):
    import contextlib
    import io

    _, _, tout, _, tcorpus, flags = fresh
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["scenario", "farm", "--device", "cpu", *flags, "--out-dir", tout,
                       "--corpus-dir", tcorpus, "--freeze"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def negative(tmp_path_factory):
    base = tmp_path_factory.mktemp("negative")
    jout, tout = str(base / "jax"), str(base / "port")
    jres = jfarm.run_farm(rst.RaftConfig(**SINK_KW), jfarm.FarmSpec(**NEGATIVE), out_dir=jout)
    tres = tfarm.run_farm(tconfig.RaftConfig(**SINK_KW), tfarm.FarmSpec(**NEGATIVE),
                          out_dir=tout, device="cpu")
    return jres, tres, jout, tout


# ------------------------------------------------------------ host-side parts


@pytest.mark.parametrize("names", ["scalar,nonsense", "", "scalar, coverage", "durability",
                                   ("scalar", "scalar", "coverage")])
def test_parse_portfolio_matches_jax(names):
    def outcome(parse):
        try:
            return ("ok", parse(names))
        except ValueError as ex:
            return ("error", str(ex))

    assert outcome(tport.parse_portfolio) == outcome(jport.parse_portfolio)
    assert sorted(tport.FITNESS) == sorted(jport.FITNESS)
    assert ({k: v[1] for k, v in tport.FITNESS.items()}
            == {k: v[1] for k, v in jport.FITNESS.items()})


@pytest.mark.parametrize("kw", [dict(stop_on="whenever"), dict(ticks=100, window=64),
                                dict(stop_on="frozen")])
def test_farm_spec_validation_matches_jax(kw):
    def outcome(cls):
        try:
            return ("ok", str(cls(**kw)))
        except ValueError as ex:
            return ("error", str(ex))

    assert outcome(tfarm.FarmSpec) == outcome(jfarm.FarmSpec)
    assert tcore._member_names(("scalar", "scalar", "coverage")) == jcore._member_names(
        ("scalar", "scalar", "coverage"))
    with pytest.raises(ValueError, match="novelty"):
        tport.fit_coverage(None, None, None)


@pytest.mark.parametrize("kw,mutant", [
    (BLIND_KW, "blind-transfer"), (SINK_KW, None),
    (dict(n_nodes=7, fsync_interval=4, torn_tail_prob=0.1), "weak-quorum"),
])
def test_manifest_hash_matches_jax(kw, mutant):
    """The farm identity's config encoding and hash equal the JAX farm's, so
    provenance keys agree across the two packages."""
    jcfg, tcfg = rst.RaftConfig(**kw), tconfig.RaftConfig(**kw)
    if mutant:
        jcfg = jmut.mutant_config(mutant, jcfg)
        from raft_sim_tpu_torch.scenario import mutation as tmut

        tcfg = tmut.mutant_config(mutant, tcfg)
    assert tconfig.nondefault_fields(tcfg) == jcore._nondefault_config(jcfg)
    identity = {"config": tconfig.nondefault_fields(tcfg), "mutant": mutant, "seed": 3,
                "portfolio": ["scalar", "coverage"], "spec": {"elite_frac": 0.25}}
    assert tfarm.manifest_hash(identity) == jfarm.manifest_hash(identity)


def _fitness_inputs(seed: int, b: int = 12, w: int = 5):
    rng = np.random.default_rng(seed)
    rec_m = SimpleNamespace(
        max_commit=np.cumsum(rng.integers(0, 3, (b, w)), axis=1).astype(np.int32),
        fsync_lag_max=rng.integers(0, 12, (b, w)).astype(np.int32),
        last_leaderless_tick=rng.integers(-1, 40, (b, w)).astype(np.int32))
    records = SimpleNamespace(metrics=rec_m)
    metrics = SimpleNamespace(
        violations=rng.integers(0, 2, b).astype(np.int32),
        multi_leader=rng.integers(0, 6, b).astype(np.int32),
        max_term=rng.integers(1, 9, b).astype(np.int32),
        total_cmds=rng.integers(0, 3, b).astype(np.int32),
        reads_served=rng.integers(0, 50, b).astype(np.int32),
        lat_excluded=rng.integers(0, 4, b).astype(np.int32))
    return records, metrics, rng.integers(0, 30, b).astype(np.int64)


@pytest.mark.parametrize("name", sorted(jport.FITNESS))
def test_fitness_matches_jax(name):
    """Each portfolio member on fixed records, metrics and novelty equals the
    JAX member, float for float."""
    for seed in range(3):
        records, metrics, novelty = _fitness_inputs(seed)
        got = tport.FITNESS[name][0](records, metrics, novelty)
        want = jport.FITNESS[name][0](records, metrics, novelty)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def test_seen_set_monotone_and_member_order_free():
    """The farm-wide seen set only grows, member scoring against the
    pre-generation baseline does not depend on member order, and each step
    equals the JAX search's (the port reads int32 coverage patterns)."""
    from raft_sim_tpu_torch.trace.ring import COV_WORDS

    rng = np.random.default_rng(0)
    seen = jseen = np.zeros(COV_WORDS, np.uint32)
    history = []
    for _ in range(4):
        cov = rng.integers(0, 2**32, size=(COV_WORDS, 8), dtype=np.uint32)
        n_a = tsearch.coverage_novelty(cov[:, :4].view(np.int32), seen)
        n_b = tsearch.coverage_novelty(cov[:, 4:], seen)
        assert np.array_equal(n_b, tsearch.coverage_novelty(cov[:, 4:], seen))
        assert np.array_equal(n_a, tsearch.coverage_novelty(cov[:, :4], seen))
        assert np.array_equal(n_a, jsearch.coverage_novelty(cov[:, :4], jseen))
        seen, jseen = tsearch.seen_union(cov.view(np.int32), seen), jsearch.seen_union(cov, jseen)
        assert np.array_equal(seen, jseen)
        history.append(int(tsearch._popcount_words(seen[:, None])[0]))
    assert history == sorted(history)
    assert int(tsearch.coverage_novelty(cov, seen).sum()) == 0


# ------------------------------------------------------------ the hunts


def test_fresh_freeze_hunt_matches_jax(fresh, fresh_cli):
    """Hunt rows per member, the manifest (hits, frozen, dedup ledger,
    manifest hash), and the frozen artifact's bytes equal the JAX farm's;
    both packages' validate_farm_dir pass the port's directory."""
    jres, jout, tout, jcorpus, tcorpus, _ = fresh
    rc, _ = fresh_cli
    assert rc == 0
    for m in ("scalar", "coverage"):
        rel = os.path.join("members", m, "hunt.jsonl")
        assert _files(tout)[rel] == _files(jout)[rel], m
    assert _manifest(tout) == _manifest(jout)
    assert len(jres.frozen) == 1 and _files(tcorpus) == _files(jcorpus)
    art = json.loads(next(iter(_files(tcorpus).values())))
    assert art["provenance"]["farm"] == jres.manifest["manifest_hash"]
    assert tfarm.validate_farm_dir(tout) == [] and jfarm.validate_farm_dir(tout) == []
    perf = [json.loads(line) for line in open(os.path.join(tout, "perf.jsonl"))]
    want = [json.loads(line) for line in open(os.path.join(jout, "perf.jsonl"))]
    keep = ("chunk", "ticks", "warmup", "recompiled", "n_devices")
    assert [{k: r[k] for k in keep} for r in perf] == [{k: r[k] for k in keep} for r in want]
    assert all(r["backend"] == "cpu" and r["live_bytes"] is None for r in perf)


def test_farm_cli_summary_matches_jax(fresh, fresh_cli):
    """`scenario farm` exits 0 and prints the JAX driver's summary fields for
    the same hunt; a bad --mesh is a usage error, and a population the mesh
    does not divide is refused (the mesh farm itself:
    tests/test_torch_farm_mesh.py)."""
    jres, _, tout, _, _, flags = fresh
    rc, doc = fresh_cli
    want = {
        "found": bool(jres.hits), "hits": jres.manifest["hits"],
        "frozen": jres.manifest["frozen"], "negative": jres.negative,
        "generations_run": jres.manifest["generations_run"],
        "evaluations": jres.manifest["evaluations"],
        "cov_bits_total": jres.manifest["cov_bits_total"],
        "manifest_hash": jres.manifest["manifest_hash"],
    }
    assert rc == 0 and {k: doc[k] for k in want} == json.loads(json.dumps(want))
    assert doc["out_dir"] == tout and doc["found"] and len(doc["dedup_rejected"]) == 1
    with pytest.raises(SystemExit) as ex:
        cli.main(["scenario", "farm", "--device", "cpu", *flags, "--out-dir", tout,
                  "--mesh", "-1"])
    assert ex.value.code == 2
    from raft_sim_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="population 64 must divide over the mesh's 3"):
        tfarm.run_farm(tconfig.RaftConfig(), tfarm.FarmSpec(),
                       mesh=make_mesh(devices=["cpu"] * 3), device="cpu")


def test_negative_hunt_matches_jax(negative):
    """The real config survives the budget in both packages: the negative
    document, the manifest and the hunt rows are equal."""
    jres, tres, jout, tout = negative
    assert tres.negative and jres.negative
    for rel in ("negative.json", "farm_manifest.json", "members/scalar/hunt.jsonl",
                "members/coverage/hunt.jsonl"):
        assert _files(tout)[rel] == _files(jout)[rel], rel
    assert tres.manifest["cov_bits_total"] > 0 and tres.manifest["generations_run"] == 2
    assert tfarm.validate_farm_dir(tout) == []


@pytest.mark.parametrize("defect", ["tail-truncated", "head-truncated", "no-manifest",
                                    "bad-perf-row"])
def test_validate_farm_dir_catches_defects(negative, tmp_path, defect):
    """Each defect the JAX validate_farm_dir catches, the port's catches with
    the same message."""
    _, _, _, tout = negative
    d = str(tmp_path / "farm")
    shutil.copytree(tout, d)
    hunt = os.path.join(d, "members", "coverage", "hunt.jsonl")
    rows = open(hunt).read().splitlines()
    if defect == "tail-truncated":
        open(hunt, "w").write(rows[0] + "\n")
    elif defect == "head-truncated":
        open(hunt, "w").write(rows[-1] + "\n")
    elif defect == "no-manifest":
        os.remove(os.path.join(d, "farm_manifest.json"))
    else:
        with open(os.path.join(d, "perf.jsonl"), "a") as f:
            f.write(json.dumps({"chunk": 2, "ticks": -1, "warmup": 1}) + "\n")
    got = tfarm.validate_farm_dir(d)
    assert got and got == jfarm.validate_farm_dir(d)
