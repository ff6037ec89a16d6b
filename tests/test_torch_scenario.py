"""The port's scenario engine (raft_sim_tpu_torch/scenario/: genomes, phased
programs, the scenario input path of the scan, chunk and telemetry loops,
the single-cluster replay, scenario checkpoints and the `scenario` CLI)
against the JAX package's, on the CPU at small sizes.

The load-bearing contract is JAX's: the scenario path re-parameterizes the
simulator and draws every mechanism from the same key streams as the scalar
path, so a homogeneous genome built from a config reproduces the scalar path
bit for bit (port genome path == port scalar path == JAX genome path), and a
heterogeneous fleet of phased genomes equals the JAX fleet leaf for leaf.
Inputs are made from numpy seeds.

Tolerance: exact equality of every leaf (value, dtype, shape), of every
JSON field and of every printed summary field but the wall time.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.scenario import genome as jgenome
from raft_sim_tpu.scenario import program as jprogram
from raft_sim_tpu.sim import chunked as jchunked
from raft_sim_tpu.sim import faults as jfaults
from raft_sim_tpu.sim import scan as jscan
from raft_sim_tpu.sim import telemetry as jtel
from raft_sim_tpu.utils import checkpoint as jcheckpoint
from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch import bridge
from raft_sim_tpu_torch import driver
from raft_sim_tpu_torch.scenario import genome as tgenome
from raft_sim_tpu_torch.scenario import program as tprogram
from raft_sim_tpu_torch.sim import chunked as tchunked
from raft_sim_tpu_torch.sim import faults as tfaults
from raft_sim_tpu_torch.sim import scan as tscan
from raft_sim_tpu_torch.sim import telemetry as ttel
from raft_sim_tpu_torch.utils import checkpoint as tcheckpoint
from raft_sim_tpu_torch.utils import config as tconfig
from raft_sim_tpu_torch.utils import threefry

torch.set_num_threads(1)

# The JAX scenario tests' kitchen-sink config (tests/test_scenario.py): every
# fault mechanism on, with a client.
KW = dict(n_nodes=5, log_capacity=8, client_interval=4, drop_prob=0.2, partition_period=16,
          partition_prob=0.3, crash_prob=0.3, crash_period=32, crash_down_ticks=8,
          clock_skew_prob=0.1)
JCFG, TCFG = rst.RaftConfig(**KW), tconfig.RaftConfig(**KW)
B, T, W = 16, 128, 32


def segments(rng, cfg, n_seg: int) -> list[dict]:
    """`n_seg` random encoded segments for `cfg` from numpy's `rng`."""
    out = []
    for _ in range(n_seg):
        kw = dict(drop_prob=rng.uniform(0, 0.5), partition_period=int(rng.integers(0, 40)),
                  partition_prob=rng.uniform(0, 1), crash_prob=rng.uniform(0, 0.6),
                  crash_down_ticks=int(rng.integers(1, cfg.crash_period + 1)),
                  clock_skew_prob=rng.uniform(0, 0.3),
                  client_interval=int(rng.integers(0, 2 * cfg.client_interval + 1)))
        for f, on in (("reconfig_interval", cfg.reconfig), ("transfer_interval", cfg.leader_transfer),
                      ("read_interval", cfg.read_index)):
            if on:
                kw[f] = int(rng.integers(0, 2 * getattr(cfg, f) + 1))
        if cfg.durable_storage:
            kw.update(fsync_interval=int(rng.integers(0, 6)), fsync_jitter_prob=rng.uniform(0, 0.5),
                      torn_tail_prob=rng.uniform(0, 0.5),
                      lost_suffix_span=int(rng.integers(1, cfg.log_capacity + 1)))
        out.append(jgenome.segment(**kw))
    return out


def fleets(seed: int, batch: int, n_seg: int, cfg=JCFG):
    """(JAX genome, port genome) of a heterogeneous [batch, n_seg] fleet."""
    rng = np.random.default_rng(seed)
    rows = [segments(rng, cfg, n_seg) for _ in range(batch)]
    jg = jgenome.stack_rows([jgenome.from_segments(r) for r in rows])
    tg = tgenome.stack_rows([tgenome.from_segments(r) for r in rows])
    return jg, tg


def same(want, got, what=""):
    diff = bridge.first_difference(jax.device_get(want), got)
    assert diff is None, f"{what}: {diff}"


# ------------------------------------------------------------ genome parity


@pytest.fixture(scope="module")
def homogeneous():
    jg = jgenome.broadcast(jgenome.from_config(JCFG), B)
    want = jax.device_get(jtel.simulate_windowed(JCFG, 0, B, T, W, genome=jg))
    tg = tgenome.broadcast(tgenome.from_config(TCFG), B)
    got = ttel.simulate_windowed(TCFG, 0, B, T, W, genome=tg, device="cpu")
    return want, got


def test_homogeneous_genome_is_the_scalar_path_and_jaxs(homogeneous):
    """A genome replicating the config's scalars: the port's genome path ==
    the port's scalar path == the JAX genome path (state, metrics, windows)."""
    want, got = homogeneous
    scalar = ttel.simulate_windowed(TCFG, 0, B, T, W, device="cpu")
    for part, w, g, sc in zip(("state", "metrics", "records"), want, got, scalar):
        same(w, g, part)
        assert bridge.first_difference(sc, g) is None, part
    assert int(got[1].total_msgs.sum()) > 0 and int(got[1].total_cmds.sum()) > 0


@pytest.fixture(scope="module")
def phased_fleet():
    """A heterogeneous fleet of three-segment genomes (seg_len 40: the run
    crosses both boundaries and holds the last segment)."""
    jg, tg = fleets(11, B, 3)
    want = jax.device_get(jtel.simulate_windowed(JCFG, 5, B, T, W, genome=jg, seg_len=40))
    got = ttel.simulate_windowed(TCFG, 5, B, T, W, genome=tg, seg_len=40, device="cpu")
    return tg, want, got


def test_heterogeneous_phased_fleet_matches_jax(phased_fleet):
    tg, want, got = phased_fleet
    for part, w, g in zip(("state", "metrics", "records"), want, got):
        same(w, g, part)
    assert int(got[1].total_msgs.min()) >= 0 and len(set(got[1].total_msgs.tolist())) > 1


def test_scenario_loops_agree(phased_fleet):
    """simulate_scenario, run_chunked (chunks across segment boundaries) and
    run_chunked_telemetry give the windowed run's state and metrics."""
    tg, _, (state, metrics, records, _) = phased_fleet
    s1, m1 = tscan.simulate_scenario(TCFG, 5, B, T, tg, seg_len=40, device="cpu")
    assert bridge.first_difference(state, s1) is None
    assert bridge.first_difference(metrics, m1) is None
    st0, keys = tscan.seed_fleet(TCFG, 5, B, "cpu")
    s2, m2 = tchunked.run_chunked(TCFG, st0, keys, T, chunk=48, genome=tg, seg_len=40)
    assert bridge.first_difference(state, s2) is None
    assert bridge.first_difference(metrics, m2) is None
    s3, m3, _ = ttel.run_chunked_telemetry(TCFG, st0, keys, T, W, chunk=64, genome=tg, seg_len=40)
    assert bridge.first_difference(state, s3) is None
    assert bridge.first_difference(metrics, m3) is None
    assert bridge.first_difference(metrics, ttel.reduce_records(records)) is None


def test_one_clusters_genome_is_its_own(homogeneous):
    """A drop-always row delivers nothing while its neighbours run on,
    bit-identical to the homogeneous fleet (the JAX test's contract)."""
    tg = tgenome.broadcast(tgenome.from_config(TCFG), B)
    drop = tg.drop.clone()
    drop[0] = (1 << 32) - 1
    _, m, _, _ = ttel.simulate_windowed(TCFG, 0, B, T, W, genome=tg._replace(drop=drop),
                                        device="cpu")
    msgs = m.total_msgs
    assert int(msgs[0]) == 0 and bool((msgs[1:] > 0).all())
    assert torch.equal(msgs[1:], homogeneous[1][1].total_msgs[1:])


@pytest.mark.parametrize("kw", [KW, dict(n_nodes=5, log_capacity=8, client_interval=2,
                                         reconfig_interval=5, transfer_interval=7, read_interval=3,
                                         fsync_interval=3, fsync_jitter_prob=0.2,
                                         torn_tail_prob=0.3, lost_suffix_span=3, crash_prob=0.3,
                                         crash_period=16, crash_down_ticks=5,
                                         client_redirect=True)],
                         ids=["kitchen-sink", "admin-and-disk-planes"])
def test_genome_inputs_across_segment_boundaries(kw):
    """make_inputs on the scenario path, at ticks on both sides of each
    segment boundary and past the program's end, equals the JAX inputs
    (genome_at's clip, per-cluster partition windows, crash spans, the admin
    cadences and the disk draws)."""
    jcfg, tcfg = rst.RaftConfig(**kw), tconfig.RaftConfig(**kw)
    jg, tg = fleets(3, B, 3, jcfg)
    keys_j = jax.random.split(jax.random.key(9), B)
    keys_t = threefry.split(threefry.key(9), B)
    draw = jax.jit(lambda now: jax.vmap(
        lambda k, g: jfaults.make_inputs(jcfg, k, now, genome=g, seg_len=8))(keys_j, jg))
    for now in (0, 1, 7, 8, 9, 15, 16, 17, 23, 64, 999):
        same(draw(jnp.int32(now)), tfaults.make_inputs(tcfg, keys_t, now, genome=tg, seg_len=8),
             f"tick {now}")
    g0 = tfaults.genome_at(tg, 999, 8)
    assert torch.equal(g0.drop, tg.drop[:, 2]) and tfaults.genome_at(tg, 0, 8).crash.shape == (B,)


def test_single_cluster_replay_matches_jax_run():
    """scan.run_traced (a B=1 view of the batch-minor path) equals the JAX
    single-cluster `scan.run(..., trace_states=True, genome=...)`: final
    state, metrics, and every tick's StepInfo and state."""
    jg, tg = fleets(4, 1, 2)
    jg1 = jax.tree.map(lambda x: x[0], jg)
    root = jax.random.key(2)
    k_init, k_run = jax.random.split(root)
    st = jax.tree.map(lambda v: v[3], rst.init_batch(JCFG, k_init, 6))
    key = jax.random.split(k_run, 6)[3]
    want = jax.device_get(jax.jit(lambda s, k, g: jscan.run(
        JCFG, s, k, 96, trace_states=True, genome=g, seg_len=48))(st, key, jg1))
    state, keys = tscan.seed_fleet(TCFG, 2, 6, "cpu")
    one = tscan.raft_batched._map(lambda x: x[3:4], state)
    s, m, (infos, states) = tscan.run_traced(TCFG, one, keys[3:4], 96, genome=tg, seg_len=48)
    first = lambda tree: tscan.raft_batched._map(lambda x: x[0], tree)  # noqa: E731
    same(want[0], first(s), "final state")
    same(want[1], first(m), "metrics")
    same(want[2][0], first(infos), "infos")
    same(want[2][1], first(states), "states")


# ------------------------------------------------------- genomes and programs


def test_genome_host_forms_match_jax():
    """segment / from_config / decode / to_raw / from_raw agree with the JAX
    module's, and every corpus artifact's genome_raw round-trips exactly."""
    import glob
    import os

    rng = np.random.default_rng(1)
    segs = segments(rng, JCFG, 3)
    jg, tg = jgenome.from_segments(segs), tgenome.from_segments(segs)
    assert tgenome.to_raw(tg) == jgenome.to_raw(jg)
    assert tgenome.decode(tg) == jgenome.decode(jg)
    assert tgenome.to_raw(tgenome.from_config(TCFG)) == jgenome.to_raw(jgenome.from_config(JCFG))
    assert list(tgenome.ScenarioGenome._fields) == list(jgenome.ScenarioGenome._fields)
    assert tgenome.U32_FIELDS == jgenome.U32_FIELDS
    corpus = os.path.join(os.path.dirname(__file__), "corpus", "*.json")
    for path in sorted(glob.glob(corpus)):
        raw = json.load(open(path))["genome_raw"]
        assert tgenome.to_raw(tgenome.from_raw(raw)) == jgenome.to_raw(jgenome.from_raw(raw)), path


def test_validate_rejects_what_jax_rejects():
    g = tgenome.from_config(TCFG)
    bad = [
        (g._replace(crash_down=g.crash_down * 0), TCFG, "crash_down"),
        (g._replace(crash_down=g.crash_down * 0 + TCFG.crash_period + 1), TCFG, "crash_down"),
        (g, tconfig.RaftConfig(n_nodes=5), "client_interval"),
        (g._replace(read_interval=g.read_interval + 2), TCFG, "read_interval"),
        (g._replace(fsync_interval=g.fsync_interval + 2), TCFG, "fsync_interval"),
        (g._replace(torn_span=g.torn_span * 0), TCFG, "torn_span"),
    ]
    for genome, cfg, match in bad:
        jgen = jgenome.from_raw(tgenome.to_raw(genome))
        jcfg = rst.RaftConfig(**dataclasses.asdict(cfg))
        with pytest.raises(ValueError, match=match):
            tgenome.validate(cfg, genome)
        with pytest.raises(ValueError, match=match):
            jgenome.validate(jcfg, jgen)
    with pytest.raises(ValueError, match="drop_prob_uniform"):
        tgenome.from_config(tconfig.RaftConfig(drop_prob=0.3, drop_prob_uniform=True))


def test_program_json_forms_match_jax(tmp_path):
    doc = {"name": "partition-heal-crash", "seg_len": 64,
           "segments": [{"partition_period": 16, "partition_prob": 1.0}, {},
                        {"crash_prob": 0.4, "crash_down_ticks": 8, "drop_prob": 7e-10}]}
    tp, jp = tprogram.from_dict(doc, TCFG), jprogram.from_dict(doc, JCFG)
    assert tp.n_segments == 3 and tp.span == jp.span == 128
    assert tprogram.to_dict(tp) == jprogram.to_dict(jp)
    assert tprogram.to_dict(tp, exact=True) == jprogram.to_dict(jp, exact=True)
    path = tprogram.save(str(tmp_path / "p.json"), tp)
    # The file holds human units (9 decimals): both packages read it back alike.
    loaded = tprogram.load(path, TCFG)
    assert tgenome.to_raw(loaded.genome) == jgenome.to_raw(jprogram.load(path, JCFG).genome)
    assert loaded.name == tp.name and loaded.seg_len == tp.seg_len
    exact = tprogram.from_dict(json.loads(json.dumps(tprogram.to_dict(tp, exact=True))), TCFG)
    assert tgenome.to_raw(exact.genome) == tgenome.to_raw(tp.genome)
    assert int(exact.genome.drop[2]) == 3  # the 9-decimal form would lose this threshold
    assert int(tprogram.from_dict(tprogram.to_dict(tp), TCFG).genome.drop[2]) != 3
    for bad, match in (({"segments": [{"drop": 0.1}]}, "unknown keys"),
                       ({"segments": []}, "non-empty"),
                       ({"seg_len": 0, "segments": [{}]}, "seg_len"),
                       ({"segments": [{}], "extra": 1}, "unknown scenario keys")):
        with pytest.raises(ValueError, match=match):
            tprogram.from_dict(bad, TCFG)


# ------------------------------------------------------------- checkpoints


SCEN = {"name": "drop-heal", "seg_len": 16,
        "segments": [{"drop_prob": 0.5, "client_interval": 4}, {"client_interval": 4},
                     {"crash_prob": 0.3, "crash_down_ticks": 5, "client_interval": 4}]}
CK_B, CK_T = 4, 24


@pytest.fixture(scope="module")
def scenario_checkpoint_runs():
    """The JAX package: a scenario run of CK_T ticks, saved with its program;
    and the port's uninterrupted 2 x CK_T run of the same fleet."""
    prog_j = jprogram.from_dict(SCEN, JCFG)
    k_init, k_run = jax.random.split(jax.random.key(7))
    state = rst.init_batch(JCFG, k_init, CK_B)
    keys = jax.random.split(k_run, CK_B)
    g = jgenome.broadcast(prog_j.genome, CK_B)
    half = jax.device_get(jchunked.run_chunked(JCFG, state, keys, CK_T, chunk=CK_T, genome=g,
                                               seg_len=prog_j.seg_len))
    prog_t = tprogram.from_dict(SCEN, TCFG)
    st0, tkeys = tscan.seed_fleet(TCFG, 7, CK_B, "cpu")
    whole = driver.run_scenario(TCFG, prog_t, 2 * CK_T, st0, tkeys, chunk=CK_T)
    return prog_j, keys, half, prog_t, whole


def test_scenario_checkpoint_both_ways(tmp_path, scenario_checkpoint_runs):
    """A scenario checkpoint written by either package loads in the other,
    with its program; resumed through the scenario path it reaches the
    uninterrupted run's state; a plain Session.restore refuses it."""
    prog_j, keys, (state, metrics), prog_t, (whole_s, whole_m) = scenario_checkpoint_runs
    scen = jprogram.to_dict(prog_j, exact=True)
    jpath = jcheckpoint.save(str(tmp_path / "jax"), JCFG, state, keys, metrics, seed=7,
                             scenario=scen)
    cfg, s, k, m, seed, got_scen = tcheckpoint.load(jpath, "cpu")
    assert got_scen == scen and seed == 7
    prog = tprogram.from_dict(got_scen, cfg)
    s2, m2 = driver.run_scenario(cfg, prog, CK_T, s, k, chunk=CK_T)
    assert bridge.first_difference(whole_s, s2) is None
    assert bridge.first_difference(whole_m, tchunked.merge_metrics(m, m2)) is None
    with pytest.raises(ValueError, match="scenario"):
        driver.Session.restore(jpath, device="cpu")
    # The port writes the file back; the JAX package loads it.
    tpath = tcheckpoint.save(str(tmp_path / "port"), cfg, s, k, m, seed=7,
                             scenario=tprogram.to_dict(prog, exact=True))
    jcfg, js, jk, jm, jseed, jscen = jcheckpoint.load(tpath)
    assert jscen == scen and jseed == 7 and jcfg == JCFG
    same(js, s, "state")
    same(jm, m, "metrics")
    assert np.array_equal(np.asarray(jax.random.key_data(jk)), k.numpy().astype(np.uint32))
    assert jprogram.from_dict(jscen, jcfg).genome.drop.tolist() == prog.genome.drop.tolist()
    # ... and resumes it through its own scenario path to the same state.
    jprog = jprogram.from_dict(jscen, jcfg)
    js2, jm2 = jchunked.run_chunked(jcfg, js, jk, CK_T, chunk=CK_T, seg_len=jprog.seg_len,
                                    genome=jgenome.broadcast(jprog.genome, CK_B))
    same(js2, whole_s, "JAX resumed state")
    same(jchunked.merge_metrics(jm, jm2), whole_m, "JAX resumed metrics")
    # A plain checkpoint carries no scenario.
    plain = tcheckpoint.save(str(tmp_path / "plain"), cfg, s, k, m)
    assert tcheckpoint.load(plain, "cpu")[-1] is None


# ---------------------------------------------------------------------- CLI


def test_scenario_run_cli_saves_and_resumes(tmp_path, capsys):
    """`scenario run` prints the fleet summary with the program's shape;
    --save then --resume continues the same experiment (== one run of both
    halves); `run --resume` refuses the scenario checkpoint."""
    path = tmp_path / "prog.json"
    path.write_text(json.dumps(SCEN))
    ck = str(tmp_path / "ck.npz")
    base = ["scenario", "run", "--device", "cpu", "--batch", str(CK_B), "--seed", "7"]
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in KW.items()]
    assert cli.main([*base, "--scenario", str(path), "--ticks", str(CK_T), "--save", ck,
                     *flags]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["scenario"] == "drop-heal" and first["segments"] == 3 and first["seg_len"] == 16
    assert first["device"] == "cpu" and first["n_clusters"] == CK_B
    assert cli.main(["scenario", "run", "--device", "cpu", "--resume", ck,
                     "--ticks", str(CK_T)]) == 0
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main([*base, "--scenario", str(path), "--ticks", str(2 * CK_T), *flags]) == 0
    whole = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in whole:
        if k not in ("wall_s", "cluster_ticks_per_s"):
            assert resumed[k] == whole[k], k
    with pytest.raises(SystemExit):
        cli.main(["scenario", "run", "--device", "cpu", "--resume", ck, "--seed", "1"])
    with pytest.raises(ValueError, match="scenario"):
        cli.main(["run", "--device", "cpu", "--resume", ck, "--ticks", "4"])


_HUNT = ["--preset", "config2", "--generations", "1", "--population", "4", "--ticks", "32",
         "--window", "32"]


@pytest.mark.parametrize("argv", [
    ["scenario", "farm", "--device", "cpu"],
    ["scenario", "search", "--device", "cpu", *_HUNT, "--fitness", "coverage"],
    ["scenario", "search", "--device", "cpu", *_HUNT, "--fitness", "coverage", "--proposal",
     "coverage-guided"],
    ["scenario", "search", "--device", "cpu", "--profile", "x"],
    ["scenario", "run", "--device", "cpu", "--backend", "x"],
    ["scenario", "search", "--device", "cpu", *_HUNT, "--fitness", "coverage", "--trace-depth",
     "8"],
], ids=["farm", "coverage-fitness", "guided-proposal", "profile", "backend", "trace-depth"])
def test_scenario_unported_options_are_refused(capsys, argv, tmp_path):
    """The JAX-only flags are refused as usage errors, never accepted and
    ignored. Coverage fitness, guided proposals and the trace depth, refused
    until the trace plane was ported, are taken: the hunt runs and prints
    its generation log with the coverage counts. `scenario farm` and
    `search --profile`, refused until the observability slice, are taken:
    the farm refuses a run without --out-dir as JAX's parser does, and a
    profiled hunt writes its trace."""
    if argv[1] == "farm":
        with pytest.raises(SystemExit) as ex:
            cli.main(argv)
        assert ex.value.code == 2 and "--out-dir" in capsys.readouterr().err
        return
    if "--profile" in argv:
        d = tmp_path / "prof"
        assert cli.main([*argv[:-2], *_HUNT, "--profile", str(d)]) == 0
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert len(doc["generations"]) == 1 and (d / "torch_trace.json").exists()
        return
    if "--fitness" in argv:
        assert cli.main(argv) == 0
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert doc["spec"]["fitness"] == "coverage"
        assert doc["generations"][0]["cov_new_bits"] > 0
        return
    with pytest.raises(SystemExit) as ex:
        cli.main(argv)
    assert ex.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice" in err or "unrecognized arguments" in err, err
