"""The port's telemetry report (raft_sim_tpu_torch/metrics_report.py) against
the JAX tool (tools/metrics_report.py) on a telemetry directory the JAX
driver wrote (`run --telemetry-dir --trace --trace-trigger leader --health`,
a second run for `--diff`): the summary table, `--validate`, `--flight`,
`--trace`, `--health` and `--diff` print the same text. `--diff` against a
bench document of another backend refuses the throughput deltas.

Tolerance: exact equality of the printed text.
"""

import importlib.util
import json
from pathlib import Path

import pytest

from raft_sim_tpu import driver as jdriver
from raft_sim_tpu_torch import metrics_report as tmr

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_metrics_report",
                                               REPO / "tools" / "metrics_report.py")
jmr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jmr)

FLAGS = ["--n-nodes", "5", "--client-interval", "4", "--drop-prob", "0.2", "--crash-prob",
         "0.2", "--crash-period", "32", "--crash-down-ticks", "8", "--batch", "6", "--ticks",
         "96", "--chunk", "32", "--telemetry-window", "16", "--telemetry-ring", "4",
         "--trace", "--trace-trigger", "leader", "--health", "--backend", "cpu"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Two JAX-written telemetry directories (seeds 0 and 1)."""
    root = tmp_path_factory.mktemp("jaxtel")
    out = []
    for seed in (0, 1):
        d = root / f"s{seed}"
        assert jdriver.main(["run", *FLAGS, "--seed", str(seed), "--telemetry-dir", str(d)]) == 0
        out.append(d)
    return out


def _text(capsys, main, argv):
    capsys.readouterr()
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _cases(dirs):
    a, b = (str(d) for d in dirs)
    flight = sorted(p.name for p in dirs[0].glob("flight_*.jsonl"))[0]
    cluster = flight[len("flight_"):-len(".jsonl")]
    return {
        "summary": [a],
        "windows": [a, "--windows", "3"],
        "validate": [a, "--validate"],
        "flight": [a, "--flight", cluster],
        "trace": [a, "--trace", "--trace-cluster", "1", "--trace-limit", "12"],
        "health": [a, "--health"],
        "diff": ["--diff", a, b],
    }


@pytest.mark.parametrize("case", ["summary", "windows", "validate", "flight", "trace", "health",
                                  "diff"])
def test_text_equals_jax_tool(dirs, capsys, case):
    argv = _cases(dirs)[case]
    want = _text(capsys, jmr.main, argv)
    got = _text(capsys, tmr.main, argv)
    assert want[0] == 0 and got == want
    assert got[1].strip()


def test_diff_refuses_throughput_across_backends(dirs, tmp_path, capsys):
    """Against a bench document whose rows ran on another backend, the
    quality fields are compared and the throughput fields refused."""
    row = {"cluster_ticks_per_s": 1e6, "steady_ticks_per_s": 9e5, "violations": 0,
           "total_cmds": 10, "p50_stable_tick": 7.0, "backend": "cuda"}
    doc = tmp_path / "bench.json"
    doc.write_text(json.dumps({"matrix": {"config2": row}, "workload": "config2"}))
    rc, out, _ = _text(capsys, tmr.main, ["--diff", str(dirs[0]), str(doc)])
    assert rc == 0
    lines = {ln.split()[0]: ln.split() for ln in out.splitlines() if ln.strip()}
    assert lines["cluster_ticks_per_s"][-1] == "refused"
    assert lines["violations"][-1] != "refused"
    assert "throughput not compared across backends (A: cpu, B: cuda)" in out


def test_invalid_directory_is_refused(tmp_path, capsys):
    (tmp_path / "manifest.json").write_text("{}")
    rc, _, err = _text(capsys, tmr.main, [str(tmp_path)])
    assert rc == 1 and "INVALID" in err
