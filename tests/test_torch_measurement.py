"""The port's measurement pass (raft_sim_tpu_torch/bench.py `measurement_pass`,
`bench --measurement-pass --out P`) on the CPU at smoke sizing with
`--configs config2`: the A/B arms on config2 (`--ab-preset config2`), the
mesh-scaling leg on config2 (`--mesh-preset config2`), ticks cut to 16 and
2 repeats a row (the JAX pass runs each row's preset ticks; the CPU's plain
tick would take minutes).

Checked: the document's keys; each A/B pair whose arms are bit-exact
(fault lattice, serve offer plane) has equal quality fields; every arm's
quality fields equal JAX bench.py `bench()` on the same config, genome and
sizes (the arms JAX `measurement_pass` builds, at the port pass's cut
ticks, one timed repeat: quality runs do not depend on repeats); the mesh
rows' quality fields are equal at every shard count and to the JAX
`simulate_windowed_sharded` run at 2 devices; every row is non-anchor;
the legs that compare with TPU records are null with their note; the CLI
needs --out; `metrics_report --perf` renders the document.

Tolerance: exact equality of every quality field and verdict.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

from raft_sim_tpu_torch import __main__ as cli
from raft_sim_tpu_torch import bench as tbench
from raft_sim_tpu_torch import metrics_report as tmr

torch.set_num_threads(1)

TICKS = 16
QUALITY = ("p50_stable_tick", "pct_stable", "p50_commit_latency", "lat_p50", "lat_p95",
           "lat_p99", "lat_excluded", "total_cmds", "violations", "noop_blocked",
           "lm_skipped_pairs", "multi_leader", "batch", "ticks")
ARGS = ["bench", "--measurement-pass", "--configs", "config2", "--ab-preset", "config2",
        "--mesh-preset", "config2", "--ticks", str(TICKS), "--repeats", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def doc(tmp_path_factory):
    path = tmp_path_factory.mktemp("measure") / "pass.json"
    assert cli.main([*ARGS, "--out", str(path)]) == 0
    return path, json.loads(path.read_text())


@pytest.fixture(scope="module")
def jax_arms():
    """{pair: (off, on)}: JAX bench.py's rows for each A/B arm of the pass,
    built as JAX `measurement_pass` builds them, and the JAX mesh leg's
    fleet summary of config2 at 2 devices."""
    import bench as jbench
    from raft_sim_tpu import PRESETS as JPRESETS
    from raft_sim_tpu.parallel import make_mesh, summarize
    from raft_sim_tpu.parallel import mesh as jmesh
    from raft_sim_tpu.scenario import genome as jgenome

    def row(name, cfg=None, scenario=None):
        batch, _ = jbench._matrix_sizing(name, True)
        return jbench.bench(cfg or JPRESETS[name][0], batch, TICKS, repeats=1,
                            config_name=name, smoke=True, scenario=scenario)

    def genome(g, name):
        return SimpleNamespace(genome=g, seg_len=1, name=name)

    c2, c8, c10 = (JPRESETS[n][0] for n in ("config2", "config8", "config10"))
    plain = row("config2")
    xj_on = jgenome.from_segments([jgenome.segment(
        drop_prob=c8.drop_prob, crash_prob=c8.crash_prob, crash_down_ticks=c8.crash_down_ticks,
        client_interval=c8.client_interval, reconfig_interval=24, transfer_interval=5,
        read_interval=c8.read_interval)])
    arms = {
        "fault_lattice": (plain, row("config2", scenario=genome(
            jgenome.from_config(c2), "homogeneous-from-config"))),
        "serve_offer_plane": (plain, row("config2", dataclasses.replace(c2, serve_ingest=True))),
        "durability": (row("config10", dataclasses.replace(
            c10, fsync_interval=0, fsync_jitter_prob=0.0, torn_tail_prob=0.0,
            lost_suffix_span=1)), row("config10")),
        "transfer_during_joint": (
            row("config8", scenario=genome(jgenome.from_config(c8), "homogeneous-from-config")),
            row("config8", scenario=genome(xj_on, "xfer-joint"))),
    }
    batch, _ = jbench._matrix_sizing("config2", True)
    out = jmesh.simulate_windowed_sharded(c2, 0, batch, TICKS, TICKS // 4, make_mesh(2))
    return arms, summarize(out[1])


def test_schema_keys(doc):
    _, d = doc
    assert d["schema"] == tbench.MEASUREMENT_SCHEMA
    assert {"schema", "created_unix", "backend", "torch_version", "smoke", "repeats",
            "ticks_cut", "matrix", "ab", "mesh_scaling", "reconciliation", "trajectory",
            "left_out", "notes"} <= set(d)
    assert d["backend"] == "cpu" and d["smoke"] is True and d["ticks_cut"] == 16
    assert list(d["matrix"]) == ["config2"]
    assert set(d["ab"]) == {"bitpack_vs_r05", "fault_lattice", "serve_offer_plane",
                            "layout_dense_vs_compact", "durability", "transfer_during_joint"}
    assert "skipped" in d["ab"]["layout_dense_vs_compact"]["notes"][0]
    for key in ("fault_lattice", "serve_offer_plane", "durability", "transfer_during_joint"):
        arm = d["ab"][key]
        assert arm["on_over_off_ticks_per_s"] > 0 and arm["off"]["ticks"] == 16
    names = [r["config"] for r in d["reconciliation"]["rows"]]
    assert names == sorted(["config2", "config8", "config8/xfer-joint", "config10",
                            "config10/durability-off"])


@pytest.mark.parametrize("pair", ["fault_lattice", "serve_offer_plane"])
def test_bit_exact_ab_arms_have_equal_quality(doc, pair):
    arm = doc[1]["ab"][pair]
    assert {k: arm["off"][k] for k in QUALITY} == {k: arm["on"][k] for k in QUALITY}
    assert arm["off"]["total_cmds"] > 0


@pytest.mark.parametrize("pair", ["fault_lattice", "serve_offer_plane", "durability",
                                  "transfer_during_joint"])
def test_ab_arms_equal_jax(doc, jax_arms, pair):
    """Both arms of each A/B pair, variant configs and genomes included,
    give JAX bench.py's quality fields."""
    arm = doc[1]["ab"][pair]
    for side, want in zip(("off", "on"), jax_arms[0][pair]):
        assert {k: arm[side].get(k) for k in QUALITY} == {k: want.get(k) for k in QUALITY}
    if pair == "durability":
        assert arm["off"]["config_variant"] == "fsync_interval=0 (storage plane off)"


def test_mesh_rows_equal_jax(doc, jax_arms):
    """Every mesh row's quality fields equal the JAX mesh leg's run."""
    want = jax_arms[1]
    for row in doc[1]["mesh_scaling"]["rows"].values():
        assert (row["violations"], row["total_cmds"], row["p50_stable_tick"], row["lat_p50"],
                row["multi_leader"]) == (want.total_violations, want.total_cmds,
                                         want.p50_stable_tick, want.lat_p50, want.multi_leader)
        assert (row["batch"], row["ticks"], row["window"]) == (64, TICKS, TICKS // 4)


def test_mesh_rows_equal_quality_at_every_width(doc):
    mesh = doc[1]["mesh_scaling"]
    rows = mesh["rows"]
    assert list(rows) == ["1dev", "2dev", "4dev", "8dev"]
    keep = ("violations", "total_cmds", "p50_stable_tick", "lat_p50", "multi_leader", "batch",
            "ticks")
    assert len({json.dumps({k: r[k] for k in keep}) for r in rows.values()}) == 1
    assert [r["n_devices"] for r in rows.values()] == [1, 2, 4, 8]
    assert all(r["devices_used"] == 1 for r in rows.values())
    assert any("share a device" in n for n in mesh["notes"])


def test_every_row_is_non_anchor(doc):
    d = doc[1]
    rec = d["reconciliation"]
    assert rec["anchor_eligible"] == [] and all(not r["anchor"] for r in rec["rows"])
    assert all("cpu backend: a CPU run can never rebase the roofline" in r["non_anchor_reasons"]
               for r in rec["rows"])
    # The preset rows are priced; the variant rows are not presets (JAX's rule).
    priced = {r["config"]: r["bytes_per_tick_padded"] for r in rec["rows"]}
    assert rec["pins_source"] and priced["config2"] and priced["config10"]
    assert priced["config8/xfer-joint"] is None
    assert all(not r["anchor"] for r in d["mesh_scaling"]["rows"].values())


def test_tpu_legs_are_null_with_their_note(doc):
    d = doc[1]
    assert d["ab"]["bitpack_vs_r05"] is None and d["trajectory"] is None
    assert set(d["left_out"]) == {"bitpack_vs_r05", "trajectory"}
    assert all("TPU" in note for note in d["left_out"].values())


def test_out_is_required(capsys):
    with pytest.raises(SystemExit) as ex:
        cli.main(ARGS)
    assert ex.value.code == 2 and "needs --out" in capsys.readouterr().err
    with pytest.raises(SystemExit) as ex:
        cli.main([*ARGS, "--out", "MEASUREMENT_r07.json"])
    assert ex.value.code == 2


def test_metrics_report_renders_the_document(doc, capsys):
    path, d = doc
    capsys.readouterr()
    assert tmr.main(["--perf", str(path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"measurement pass: {path}")
    for text in ("config8/xfer-joint", "fault_lattice", "mesh scaling", "8dev"[:1],
                 "bitpack_vs_r05: left out", "trajectory: left out", "non-anchor"):
        assert text in out
