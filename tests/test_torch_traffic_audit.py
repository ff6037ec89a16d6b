"""The port's traffic audit (raft_sim_tpu_torch/traffic_audit.py) against
the JAX tool (tools/traffic_audit.py): the per-cluster leaf rows (group,
name, shape, itemsize; the loop-invariant legs left out), the dense
layout before packing (`_densify`) and the telemetry carry rows are equal
on config3, config5, config5c and config7x, and under serve mode
(`--serve`: each preset's serve-mode config). K1's columns: every leg the
kernel passes through is one the config's gates leave untouched, and the
totals K1 moves are tick_engine.traffic_bytes. The CLI prints one JSON
line with --json and no projection without a measurement document.

Tolerance: exact equality of every row.
"""

import importlib.util
import json
from pathlib import Path

import pytest

from raft_sim_tpu.analysis.jaxpr_audit import serve_variant
from raft_sim_tpu.utils.config import PRESETS as JPRESETS
from raft_sim_tpu_torch import traffic_audit as tta
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.serve.loop import serve_config
from raft_sim_tpu_torch.utils.config import PRESETS

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_traffic_audit",
                                               REPO / "tools" / "traffic_audit.py")
jta = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jta)
NAMES = ("config3", "config5", "config5c", "config7x")


@pytest.mark.parametrize("serve", [False, True], ids=["plain", "serve"])
@pytest.mark.parametrize("name", NAMES)
def test_leaf_rows_and_densify_equal_jax(name, serve):
    cfg, jcfg = PRESETS[name][0], JPRESETS[name][0]
    if serve:
        cfg, jcfg = serve_config(cfg), serve_variant(jcfg)
    rows, jrows = tta._leaf_rows(cfg), jta._leaf_rows(jcfg)
    assert [tuple(r) for r in rows] == [tuple(r) for r in jrows]
    assert tta._densify(rows, cfg) == jta._densify(jrows, jcfg)
    assert tta.invariant_leaves(cfg) == jta._invariant_leaves(jcfg)


@pytest.mark.parametrize("ring", [0, 4])
def test_telemetry_and_scenario_rows_equal_jax(ring):
    cfg, jcfg = PRESETS["config3"][0], JPRESETS["config3"][0]
    assert tta._telemetry_rows(cfg, ring) == jta._telemetry_rows(jcfg, ring)
    assert tta._scenario_rows(3) == jta._scenario_rows(3)


@pytest.mark.parametrize("name", NAMES)
def test_k1_columns(name):
    cfg = PRESETS[name][0]
    a = tta.audit(cfg)
    assert (a["k1_read"], a["k1_written"]) == tick_engine.traffic_bytes(cfg, 1)
    assert a["k1_live_logical"] + a["k1_passthrough_logical"] == a["packed_logical"]
    assert a["dense_logical"] >= a["packed_logical"] > a["boolfree_logical"]


def test_cli_json_without_projection(capsys):
    assert tta.main(["--configs", "config3,config7x", "--json", "--serve"]) == 0
    cap = capsys.readouterr()
    res = json.loads(cap.out)
    assert [r["config"] for r in res] == ["config3", "config7x"]
    assert all("recorded_ticks_per_s" not in r and "serve_k1_bytes" in r for r in res)
    assert "padded" not in cap.err and "== config3" in cap.err
    assert tta.main(["--configs", "nope"]) == 2


def test_projection_anchors_on_a_card_measurement(tmp_path, capsys):
    doc = tmp_path / "pass.json"
    doc.write_text(json.dumps({"matrix": {
        "config3": {"steady_ticks_per_s": 2.0e6, "backend": "cuda"},
        "config4": {"steady_ticks_per_s": 9.0e5, "backend": "cpu"}}}))
    assert tta.main(["--configs", "config3,config4", "--json", "--measurement",
                     str(doc)]) == 0
    res = {r["config"]: r for r in json.loads(capsys.readouterr().out)}
    k1 = sum(tick_engine.traffic_bytes(PRESETS["config3"][0], 1))
    assert res["config3"]["implied_bytes_per_s"] == 2.0e6 * k1
    assert "recorded_ticks_per_s" not in res["config4"]  # a CPU row anchors nothing
