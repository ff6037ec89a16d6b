"""The port's farm over the cluster mesh (farm/core.py `mesh`, through
parallel/mesh.simulate_windowed_sharded) on the CPU, against the port's
unsharded farm and the JAX package's mesh farm (8 virtual devices,
tests/conftest.py). The CPU shards share the one `cpu` device.

A hunt must not depend on the mesh it ran on: the same generation rows,
hits, coverage and manifest hash at every shard count, and the mesh stays
out of the hashed identity.

Tolerance: exact equality of every hunt row (floats included: both
packages run the same numpy over equal integer counters) and of the
manifest hash.
"""

import json

import pytest
import torch

import raft_sim_tpu as rst
from raft_sim_tpu.farm import FarmSpec as JFarmSpec
from raft_sim_tpu.farm import run_farm as jrun_farm
from raft_sim_tpu.parallel import make_mesh as jmake_mesh
from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch.farm import FarmSpec, run_farm
from raft_sim_tpu_torch.parallel import make_mesh
from raft_sim_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

CFG_KW = dict(n_nodes=5, client_interval=6, drop_prob=0.15, crash_prob=0.05, crash_period=32,
              crash_down_ticks=8)
SCALAR = dict(portfolio=("scalar",), budget_gens=2, population=8, ticks=64, window=32, seed=11,
              guided=False, stop_on="budget")
GUIDED = dict(portfolio=("scalar", "coverage"), budget_gens=2, population=8, ticks=64, window=32,
              seed=11, trace_depth=8, stop_on="budget")


def _rows(res) -> str:
    return json.dumps(res.generations, sort_keys=True)


@pytest.mark.parametrize("spec_kw,shards", [pytest.param(SCALAR, 8, id="scalar-8"),
                                            pytest.param(GUIDED, 4, id="guided-4")])
def test_farm_mesh_parity(spec_kw, shards):
    """The unguided scalar hunt over 8 CPU shards and the guided hunt (trace
    plane and genome path live) over 4: the same generation rows, hits,
    coverage and manifest hash as the port's unsharded farm and as the JAX
    package's farm on its 8-device mesh."""
    cfg = tconfig.RaftConfig(**CFG_KW)
    r_d = run_farm(cfg, FarmSpec(**spec_kw), device="cpu")
    r_s = run_farm(cfg, FarmSpec(**spec_kw), mesh=make_mesh(devices=["cpu"] * shards),
                   device="cpu")
    j_s = jrun_farm(rst.RaftConfig(**CFG_KW), JFarmSpec(**spec_kw), mesh=jmake_mesh(8))
    assert _rows(r_s) == _rows(r_d) == _rows(j_s)
    assert r_s.hits == r_d.hits == j_s.hits
    for k in ("manifest_hash", "cov_bits_total", "evaluations", "generations_run"):
        assert r_s.manifest[k] == r_d.manifest[k] == j_s.manifest[k], k


def test_farm_rejects_indivisible_population():
    with pytest.raises(ValueError, match="divide over"):
        run_farm(tconfig.RaftConfig(**CFG_KW), FarmSpec(population=10, budget_gens=1),
                 mesh=make_mesh(devices=["cpu"] * 8), device="cpu")


def test_farm_cli_mesh(tmp_path, capsys):
    """`scenario farm --mesh 2 --population 4` runs 8 clusters over 2 CPU
    shards: the summary line of `--population 8` unsharded."""
    flags = ["scenario", "farm", "--device", "cpu", "--n-nodes", "5", "--client-interval", "6",
             "--drop-prob", "0.15", "--portfolio", "scalar", "--budget-gens", "1", "--ticks",
             "64", "--window", "32", "--no-guided", "--stop-on", "budget", "--seed", "11"]
    docs = []
    for extra, name in ((["--population", "8"], "one"),
                        (["--population", "4", "--mesh", "2"], "two")):
        assert cli.main([*flags, *extra, "--out-dir", str(tmp_path / name)]) == 0
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        doc.pop("out_dir")
        docs.append(doc)
    assert docs[0] == docs[1]
    with pytest.raises(SystemExit) as ex:
        cli.main([*flags, "--population", "4", "--mesh", "-1", "--out-dir", str(tmp_path / "x")])
    assert ex.value.code == 2
