"""The port's reconciliation (raft_sim_tpu_torch/obs/reconcile.py): measured
throughput joined to the card's roofline for K1's own traffic
(`tick_engine.traffic_bytes`), with the JAX package's anchor rules.

The join's arithmetic is checked against the prices it is built from; the
anchor verdicts against the JAX `non_anchor_reasons` on a table of rows;
the perf-directory join on a port telemetry directory against the JAX
`reconcile_perf_dir` reading the same directory (the summary and the
verdict; the JAX prices are TPU pins, so its numbers are not compared);
and the serve row's reconciliation is filled.

Tolerance: exact equality of every count, verdict and reason; the
arithmetic to float rounding of the stated digits.
"""

import math

import pytest
import torch

from raft_sim_tpu.obs import reconcile as jrec
from raft_sim_tpu_torch import bench as tbench
from raft_sim_tpu_torch.driver import Session
from raft_sim_tpu_torch.kernels import tick_engine
from raft_sim_tpu_torch.obs import reconcile as trec
from raft_sim_tpu_torch.serve.loop import serve_config
from raft_sim_tpu_torch.utils.config import PRESETS

torch.set_num_threads(1)


def test_prices_are_k1_traffic_over_the_card_peak():
    """Every preset's simulate price is K1's bytes a cluster-tick and the
    card's peak over them; serve_simulate prices the serve-mode config."""
    pins = trec.load_pins()
    assert pins["source"] == trec.PINS_SOURCE and "traffic_bytes" in pins["source"]
    assert "H100" in pins["source"] and pins["hbm_bytes_per_s"] == 3.35e12
    assert len(pins["programs"]) == 2 * len(PRESETS)
    for name, (cfg, _) in PRESETS.items():
        for prog, c in (("simulate", cfg), ("serve_simulate", serve_config(cfg))):
            pin = pins["programs"][f"{name}/{prog}"]
            b = sum(tick_engine.traffic_bytes(c, 1))
            assert pin["bytes_per_tick_padded"] == b
            assert pin["roofline_ticks_per_s"] == round(3.35e12 / b, 1)
    assert (pins["programs"]["config3/serve_simulate"]["bytes_per_tick_padded"]
            != pins["programs"]["config3/simulate"]["bytes_per_tick_padded"])


def test_join_arithmetic():
    """achieved = measured x bytes; fraction = measured / roofline; the live
    set is the carry's bytes at the row's batch; occupancy = observed /
    live set; a production card row anchors."""
    pins = trec.load_pins(configs=["config3"])
    pin = pins["programs"]["config3/simulate"]
    row = {"steady_ticks_per_s": 2.5e6, "batch": 100_000, "backend": "cuda", "repeat_cv": 0.01}
    out = trec.reconcile_row("config3", row, pins, observed_live_bytes=10**9)
    assert out["measured_ticks_per_s"] == 2.5e6 and out["measured_source"] == "steady"
    assert out["achieved_bytes_per_s"] == round(2.5e6 * pin["bytes_per_tick_padded"], 1)
    assert out["roofline_fraction"] == float(f"{2.5e6 / pin['roofline_ticks_per_s']:.4g}")
    live = sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for (g, _), (shape, dt) in tick_engine.leaf_specs(PRESETS["config3"][0],
                                                                 100_000).items()
               if g in ("state", "mailbox"))
    assert out["live_peak_pin"] == live
    assert out["live_occupancy_vs_pin"] == round(10**9 / live, 3)
    assert out["anchor"] is True and out["non_anchor_reasons"] == []
    legacy = trec.reconcile_row("config3", {"cluster_ticks_per_s": 5.0, "batch": 100_000,
                                            "backend": "cuda"}, pins)
    assert legacy["measured_source"] == "legacy-best" and legacy["notes"]
    unpriced = trec.reconcile_row("config4", row, pins)
    assert unpriced["roofline_fraction"] is None and "no price" in unpriced["notes"][0]
    doc = trec.reconcile_matrix({"matrix": {"config3": row, "config2": {**row, "batch": 8}}})
    assert doc["anchor_eligible"] == ["config3"] and doc["pins_source"] == trec.PINS_SOURCE
    assert set(doc) == {"pins_source", "anchor_eligible", "rows", "notes"}


ROWS = {
    "cpu": ("config3", {"batch": 100_000, "backend": "cpu"}, None),
    "card": ("config3", {"batch": 100_000}, "cuda"),
    "unrecorded": ("config3", {"batch": 100_000}, None),
    "smoke": ("config3", {"batch": 512, "smoke": True}, "cuda"),
    "scenario": ("config8", {"batch": 1000, "scenario": "xfer-joint"}, "cuda"),
    "non-production batch": ("config5", {"batch": 16}, "cuda"),
    "compact vs dense": ("config5", {"batch": 10_000, "layout": "compact"}, "cuda"),
    "dense vs compact": ("config5c", {"batch": 10_000, "layout": "dense"}, "cuda"),
    "compact on its preset": ("config5c", {"batch": 10_000, "layout": "compact"}, "cuda"),
    "four devices": ("config3", {"batch": 100_000, "n_devices": 4}, "cuda"),
    "not a preset": ("config8/xfer-joint", {"batch": 1000}, "cuda"),
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_non_anchor_reasons_equal_jax(case):
    name, row, backend = ROWS[case]
    got = trec.non_anchor_reasons(name, row, backend)
    assert got == jrec.non_anchor_reasons(name, row, backend)
    assert (got == []) == (case in ("card", "compact on its preset"))


def test_perf_dir_join(tmp_path):
    """A port run with the chunk timer and a sink: the directory joins to
    config2's prices, the steady summary recomputed from the rows equals
    the JAX function's reading of the same directory, and so does the
    verdict; a directory with no perf rows is refused."""
    cfg, _ = PRESETS["config2"]
    s = Session(cfg, batch=8, seed=0, device="cpu")
    s.attach_telemetry(str(tmp_path), window=16, ring=0)
    s.attach_perf(warmup_chunks=1)
    s.run(64, chunk=16)
    got = trec.reconcile_perf_dir(str(tmp_path))
    want = jrec.reconcile_perf_dir(str(tmp_path))
    assert got["summary"] == want["summary"] and got["summary"]["steady_chunks"] == 3
    rec = got["reconciliation"]
    assert rec["config"] == want["reconciliation"]["config"] == "config2"
    assert rec["non_anchor_reasons"] == want["reconciliation"]["non_anchor_reasons"]
    assert rec["bytes_per_tick_padded"] == sum(tick_engine.traffic_bytes(cfg, 1))
    assert rec["live_peak_pin"] == trec.live_bytes(cfg, 8) and rec["anchor"] is False
    with pytest.raises(ValueError, match="no perf.jsonl"):
        trec.reconcile_perf_dir(str(tmp_path / "nowhere"))


def test_serve_row_reconciliation_is_filled():
    """The bench's serve row carries its reconciliation, priced on the
    serve_simulate program (config9 under serve_config)."""
    row = tbench.serve_bench("config9", batch=8, chunks=1, chunk=16, window=8, tenants_n=2,
                             smoke=True, device="cpu")
    rec = row["reconciliation"]
    assert rec is not None and rec["config"] == "config9"
    assert rec["bytes_per_tick_padded"] == sum(tick_engine.traffic_bytes(
        serve_config(PRESETS["config9"][0]), 1))
    assert rec["measured_ticks_per_s"] == row["steady_ticks_per_s"]
    assert rec["anchor"] is False and "--smoke row" in rec["non_anchor_reasons"]
