"""The port's `run` subcommand and Session (raft_sim_tpu_torch/driver.py) on
the CPU: a run saved and resumed equals one uninterrupted run, leaf for leaf
in the checkpoint and field for field in the printed summary; --resume is
exclusive with every flag that sets the experiment; each RaftConfig field
has a flag that reaches the config; `--telemetry-dir` writes the JAX CLI's
files; flags the port has not taken are unknown to the parser. The default device (the card) is tested in
tests/test_torch_simulate.py.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch import driver
from raft_sim_tpu_torch.utils import config as tconfig

REPO = Path(__file__).resolve().parent.parent
RUN = ("run", "--device", "cpu", "--chunk", "16")
LM6 = ("--preset", "config6", "--check-log-matching", "true", "--batch", "3")


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "raft_sim_tpu_torch", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for k in ("wall_s", "cluster_ticks_per_s"):
        out.pop(k)
    return out


def test_save_then_resume_equals_one_run(tmp_path):
    """`run ... --chunk 16 --save X` for 48 ticks, then `run --resume X` for
    48 more, equals one run of 96 ticks: every array of the two checkpoints
    and every field of the final summary."""
    x, y, z = (str(tmp_path / n) for n in ("x.npz", "y.npz", "z.npz"))
    _run_cli(*RUN, *LM6, "--ticks", "48", "--save", x)
    resumed = _run_cli(*RUN, "--resume", x, "--ticks", "48", "--save", y)
    whole = _run_cli(*RUN, *LM6, "--ticks", "96", "--save", z)
    assert resumed == whole
    assert whole["total_violations"] == 0 and whole["device"] == "cpu"
    with np.load(y) as zy, np.load(z) as zz:
        assert sorted(zy.files) == sorted(zz.files)
        for f in zz.files:
            assert zy[f].dtype == zz[f].dtype and np.array_equal(zy[f], zz[f]), f
        assert json.loads(bytes(zz["config_json"]).decode())["check_log_matching"] is True
        assert int(zz["metrics_ticks"].min()) == 96


def _parse(*args):
    ap = argparse.ArgumentParser()
    driver.add_run_arguments(ap)
    return ap, ap.parse_args(list(args))


def test_config_flags_reach_the_config():
    """Every RaftConfig field has a flag; --check-log-matching true turns the
    ring form on over config6, and the preset's batch is kept."""
    ap, args = _parse("--preset", "config6", "--check-log-matching", "true",
                      "--log-matching-interval", "4", "--drop-prob", "0.2")
    cfg, batch = driver.build_config(args)
    assert cfg == dataclasses.replace(tconfig.PRESETS["config6"][0], check_log_matching=True,
                                      log_matching_interval=4, drop_prob=0.2)
    assert batch == tconfig.PRESETS["config6"][1]
    _, args = _parse("--check-log-matching", "no", "--batch", "7")
    cfg, batch = driver.build_config(args)
    assert cfg == tconfig.RaftConfig() and batch == 7


@pytest.mark.parametrize(
    "flags,named",
    [
        (("--check-log-matching", "true"), "check_log_matching"),
        (("--preset", "config6"), "preset"),
        (("--batch", "4"), "batch"),
        (("--seed", "3"), "seed"),
        (("--mutant", "weak-quorum"), "mutant"),
    ],
    ids=["config-field", "preset", "batch", "seed", "mutant"],
)
def test_resume_is_exclusive_with_config_flags(capsys, flags, named):
    with pytest.raises(SystemExit) as ex:
        cli.main(["run", "--device", "cpu", "--resume", "ck.npz", *flags])
    assert ex.value.code == 2
    err = capsys.readouterr().err
    assert "--resume is exclusive with config flags" in err and named in err


TAKEN_RUN_FLAGS = {
    # --perf/--health/--profile, taken since the observability slice, follow
    # the JAX driver's usage rules: no effect (so refused) under --trace-ticks,
    # and --health needs a telemetry directory.
    "--perf": (["--perf", "--trace-ticks", "4"], "have no effect"),
    "--health": (["--health", "x"], "--health needs --telemetry-dir"),
    "--profile": (["--profile", "x", "--trace-events"], "have no effect"),
    # --devices, taken since the sharding slice: a batch the shards do not
    # divide is the JAX driver's usage error.
    "--devices": (["--devices", "3", "--batch", "4"], "batch 4 must divide over 3 devices"),
}


@pytest.mark.parametrize("flag", ["--trace", "--perf", "--health",
                                  "--devices", "--sanitize", "--profile", "--backend"])
def test_unported_flags_are_unknown(capsys, flag):
    """A flag of the JAX `run` the port has not taken is refused, never
    accepted and ignored; --backend, now taken, refuses a name it does not
    know; --perf, --health, --profile and --devices, now taken, are refused
    where the JAX driver refuses them."""
    argv, named = TAKEN_RUN_FLAGS.get(flag, ([flag, "x"], None))
    with pytest.raises(SystemExit) as ex:
        cli.main(["run", "--device", "cpu", *argv])
    assert ex.value.code == 2
    err = capsys.readouterr().err
    if named is None:
        named = "invalid choice" if flag == "--backend" else "unrecognized arguments"
    assert named in err


@pytest.mark.parametrize("flag", ["--perf", "--health", "--profile", "--sanitize", "--backend"])
def test_serve_unported_flags_are_unknown(capsys, flag):
    """The JAX `serve` flag the port has not taken (the donation sanitizer)
    is refused by the port's `serve`; --backend refuses a name it does not
    know. --perf, --health and --profile are taken since the observability
    slice: the parser keeps their values, and --health without --sink is
    the JAX driver's usage error."""
    if flag in ("--perf", "--profile"):
        import argparse

        from raft_sim_tpu_torch import driver

        p = argparse.ArgumentParser()
        driver.add_serve_arguments(p)
        args = p.parse_args([flag] + (["x"] if flag == "--profile" else []))
        assert args.perf is True if flag == "--perf" else args.profile == "x"
        return
    argv = ["--health", "--source", __file__] if flag == "--health" else [flag, "x"]
    with pytest.raises(SystemExit) as ex:
        cli.main(["serve", "--device", "cpu", *argv])
    assert ex.value.code == 2
    err = capsys.readouterr().err
    named = {"--backend": "invalid choice", "--health": "--health needs --sink"}
    assert named.get(flag, "unrecognized arguments") in err


def test_telemetry_dir_matches_jax(tmp_path):
    """`run --telemetry-dir` (with --telemetry-window and --telemetry-ring)
    writes the JAX CLI's windows.jsonl byte for byte and its summary.json
    value for value, and the JAX package's validate() accepts the port's
    directory."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    flags = ("--preset", "config9", "--batch", "4", "--ticks", "100", "--chunk", "32",
             "--telemetry-window", "16", "--telemetry-ring", "8")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "raft_sim_tpu", "run", *flags, "--backend", "cpu",
                           "--telemetry-dir", str(jdir)],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    _run_cli("run", "--device", "cpu", *flags, "--telemetry-dir", str(tdir))
    assert (jdir / "windows.jsonl").read_bytes() == (tdir / "windows.jsonl").read_bytes()
    assert len((tdir / "windows.jsonl").read_text().splitlines()) == 7  # 6 x 16 + 4
    want, got = (json.loads((d / "summary.json").read_text()) for d in (jdir, tdir))
    assert got == want and got["flights_frozen"] == 0
    from raft_sim_tpu.utils import telemetry_sink as jsink

    assert jsink.validate(str(tdir)) == []


def test_apply_cluster_out_of_range_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as ex:
        cli.main(["run", "--device", "cpu", "--batch", "2", "--ticks", "1",
                  "--apply-log", "unused", "--apply-cluster", "2"])
    assert ex.value.code == 2
    assert "out of range" in capsys.readouterr().err


def test_session_run_equals_simulate():
    """A Session's chunked run equals `simulate` from the same seed."""
    from raft_sim_tpu_torch import bridge
    from raft_sim_tpu_torch.sim import scan

    cfg = tconfig.PRESETS["config2"][0]
    sess = driver.Session(cfg, batch=3, seed=4, device="cpu")
    sess.run(30, chunk=7)
    sess.run(20, chunk=50)
    want_s, want_m = scan.simulate(cfg, 4, 3, 50, device="cpu")
    assert bridge.first_difference(want_s, sess.state) is None
    assert bridge.first_difference(want_m, sess.metrics) is None
    assert sess.now == 50


def test_run_takes_a_mutant(capsys):
    """`run --mutant NAME` (once refused as an unported flag) runs the
    TEST-ONLY weakened tick: its summary is `simulate` under the mutant
    config's, which differs from the real config's; an unknown name is a
    usage error."""
    from raft_sim_tpu_torch.scenario.mutation import mutant_config
    from raft_sim_tpu_torch.sim import scan
    from raft_sim_tpu_torch.summary import summarize

    flags = ["--preset", "config2", "--batch", "6", "--ticks", "80", "--drop-prob", "0.3",
             "--partition-period", "16", "--partition-prob", "0.5"]
    assert cli.main(["run", "--device", "cpu", "--mutant", "weak-quorum", *flags]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    base = dataclasses.replace(tconfig.PRESETS["config2"][0], drop_prob=0.3, partition_period=16,
                               partition_prob=0.5)
    want = summarize(scan.simulate(mutant_config("weak-quorum", base), 0, 6, 80, device="cpu")[1])
    real = summarize(scan.simulate(base, 0, 6, 80, device="cpu")[1])
    assert {k: out[k] for k in want._asdict()} == want._asdict() != real._asdict()
    with pytest.raises(SystemExit) as ex:
        cli.main(["run", "--device", "cpu", "--mutant", "no-such", *flags])
    assert ex.value.code == 2 and "unknown mutant" in capsys.readouterr().err


def test_scenario_search_then_shrink(tmp_path, capsys):
    """`scenario search --mutant ... --out HIT` writes the hit the library's
    search finds; `scenario shrink --hit HIT --out ART` writes the
    library's shrink of it, and the artifact replays to its tick."""
    from raft_sim_tpu_torch.scenario import search as search_mod
    from raft_sim_tpu_torch.scenario import shrink as shrink_mod
    from raft_sim_tpu_torch.scenario.mutation import mutant_config

    hit_path, art_path = str(tmp_path / "hit.json"), str(tmp_path / "art.json")
    assert cli.main(["scenario", "search", "--device", "cpu", "--preset", "config2",
                     "--mutant", "weak-quorum", "--client-interval", "4", "--generations", "2",
                     "--population", "8", "--ticks", "64", "--window", "32",
                     "--out", hit_path]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = mutant_config("weak-quorum", dataclasses.replace(tconfig.PRESETS["config2"][0],
                                                           client_interval=4))
    res = search_mod.search(cfg, search_mod.SearchSpec(generations=2, population=8, ticks=64,
                                                       window=32), device="cpu")
    assert doc["found"] and doc["hit"] == json.loads(json.dumps(res.hit))
    hit = json.load(open(hit_path))
    assert hit["mutant"] == "weak-quorum" and hit["config"]["client_interval"] == 4
    assert cli.main(["scenario", "shrink", "--device", "cpu", "--hit", hit_path,
                     "--out", art_path]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    art = shrink_mod.load_artifact(art_path)
    assert art == json.loads(json.dumps(shrink_mod.shrink(cfg, res.hit, mutant="weak-quorum",
                                                          device="cpu")))
    assert printed["tick"] == art["tick"] and printed["kinds"] == art["kinds"]
    assert shrink_mod.replay_artifact(art, device="cpu")["reproduced"]


@pytest.mark.parametrize("backend,device", [("cpu", "cpu"), ("cpu", None), ("auto", "cuda"),
                                            ("tpu", None), ("gpu", None), ("cuda", "cuda"),
                                            (None, None), (None, "cpu")])
def test_backend_maps_to_a_device(backend, device):
    """The JAX driver's --backend names map to the port's device: cpu to the
    CPU, auto/tpu/gpu/cuda to the card; with neither flag, the card."""
    ap = argparse.ArgumentParser()
    args = argparse.Namespace(backend=backend, device=device)
    driver.select_device(ap, args)
    want = device or (driver.BACKENDS[backend] if backend else "cuda")
    assert args.device == want
    assert args.device == ("cpu" if "cpu" in (backend, device) else "cuda")


@pytest.mark.parametrize("argv", [
    ["run", "--backend", "cuda", "--device", "cpu"],
    ["run", "--backend", "cpu", "--device", "cuda"],
    ["serve", "--backend", "tpu", "--device", "cpu"],
    ["scenario", "run", "--backend", "auto", "--device", "cpu"],
    ["scenario", "search", "--backend", "gpu", "--device", "cpu"],
    ["scenario", "shrink", "--hit", "h.json", "--out", "a.json", "--backend", "cpu",
     "--device", "cuda"],
], ids=["run-cuda", "run-cpu", "serve", "scenario-run", "scenario-search", "scenario-shrink"])
def test_backend_conflicting_with_device_is_refused(capsys, argv):
    with pytest.raises(SystemExit) as ex:
        cli.main(argv)
    assert ex.value.code == 2
    assert "--backend" in capsys.readouterr().err


def test_backend_without_a_card_raises_and_cpu_runs(capsys):
    """--backend cuda (and tpu, which means the accelerator) fails without a
    card, naming the missing device; --backend cpu runs there, as --device
    cpu does, with the same summary."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show")
    for name in ("cuda", "tpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["run", "--preset", "config2", "--batch", "2", "--ticks", "5",
                      "--backend", name])
    out = []
    for flag in (("--backend", "cpu"), ("--device", "cpu")):
        assert cli.main(["run", "--preset", "config7x", "--batch", "2", "--ticks", "8", *flag]) == 0
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        doc.pop("wall_s"), doc.pop("cluster_ticks_per_s")
        out.append(doc)
    assert out[0] == out[1] and out[0]["device"] == "cpu" and out[0]["total_violations"] == 0
