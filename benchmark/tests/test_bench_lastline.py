"""The last line's keys, and a run that finds no card prints no result."""

import json
import shutil
import subprocess
import sys

import torch

from harness import spec
from harness.main import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(result):
    result = dict(result)
    result.pop("_numbers")
    result.pop("_timing")
    return json.loads(json.dumps(result))


def test_end_to_end_line(tiny):
    line = _line(run_cell("holstein_64.hmc", 2 ** 40 + 3, 0.0, False, "cpu",
                          overrides=tiny["holstein"]))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"sweeps_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["attempted"] == 4 * 1 and line["failed"] == 0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name


def test_trace_line_reports_per_layer_metrics(tiny):
    line = _line(run_cell("holstein_64.hmc", 17, 0.0, True, "cpu", overrides=tiny["holstein"]))
    # off a card the device readers find nothing and are left out
    assert set(line["metrics"]) == {"acceptance.hmc", "cg_iters_per_solve.hmc",
                                    "host_reads_per_update.hmc"}
    assert line["metrics"]["host_reads_per_update.hmc"]["value"] > 0
    assert list(line)[-1] == "checks"


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "holstein_64.hmc",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        return
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_fails_without_the_port(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
