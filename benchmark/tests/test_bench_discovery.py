"""A cell finds its configuration, mix, entry, parts, limits and metric
readers by name, and a mix, a part and a metric added as new files, with no
file edited, run."""

import json
import shutil

import pytest

from harness import spec
from harness.main import run_cell


def test_cell_files_found_by_name():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(bench, w["name"])
        assert f"{cell.config}.{cell.traffic}" == cell.name
        cfg = spec.load_config(cell.config)
        assert cfg.chains > 0 and cfg.run["lattice"]["L"] == 64
        mix = spec.load_json("mixes", cell.traffic)
        assert callable(spec.load_module("entries", mix["entry"]).build)
        for part in mix["parts"]:
            mod = spec.load_module("parts", part)
            assert all(callable(getattr(mod, f)) for f in
                       ("draws", "port", "control", "before", "snapshot", "compare"))
        assert (spec.HERE / "limits" / f"{cell.name}.json").is_file()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_reader(m["name"]).read)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "sweeps_per_s"}


def test_config_edits_are_data():
    cfg = spec.load_config("holstein_64")
    assert cfg.run["holstein"]["beta"] == 4.0 and cfg.run["lattice"]["L"] == 64
    # the integrator is the source's: dt 0.01, 10 bosonic sub-steps
    assert cfg.run["hmc"]["dt"] == 0.01 and cfg.run["hmc"]["num_multitimesteps"] == 10
    # the couplings are the stock file's
    assert cfg.run["holstein"]["lambda"][0]["val"] == 1.0
    with pytest.raises(KeyError):
        spec._set({"a": {}}, "a.b", 1)


# a part whose step the hmc mix does not have: the field negated, checked
# exactly
FLIP = """
from types import SimpleNamespace

import torch

NUMBERS = ("flip_gap",)
STATS = ("moved",)


def draws(traffic, stream, step):
    return None


def port(program, state, d):
    new = type(state)(**dict(vars(state), x=-state.x))
    return new, SimpleNamespace(moved=torch.ones(state.x.shape[0]))


control = port


def before(state):
    return {"x": state.x.clone()}


def snapshot(step, kept, state, stats):
    return dict(kept, step=step, after=state.x.clone())


def compare(run_cfg, snap, d, device):
    return {"flip_gap": float((snap["after"] + snap["x"]).abs().max()), "n": 1}
"""


def test_added_mix_part_and_metric_run_without_edits(tmp_path, tiny):
    root = tmp_path / "repo"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = spec.load_benchmark()
    here = root / "benchmark"
    (here / "parts" / "flip.py").write_text(FLIP)
    mix = {"why": "an update, then the field negated", "entry": "hmc",
           "parts": ["update", "flip"], "initial_field_seed": 0, "warmup_steps": 1,
           "trace_steps": 1}
    (here / "mixes" / "hmc_flip.json").write_text(json.dumps(mix))
    (here / "metrics" / "flips.hmc_flip.py").write_text(
        "def read(record):\n"
        "    return float(sum(s['flip']['moved'].sum() for s in record.steps))\n")
    limits = json.loads((here / "limits" / "holstein_64.hmc.json").read_text())
    (here / "limits" / "holstein_64.hmc_flip.json").write_text(
        json.dumps(dict(limits, flip_gap=0.0)))
    bench["workloads"].append({"name": "holstein_64.hmc_flip", "config": "holstein_64",
                               "traffic": "hmc_flip", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("sweeps_per_s", "acceptance.hmc"):
            m["workloads"].append("holstein_64.hmc_flip")
    bench["per_layer"].append({"name": "flips.hmc_flip", "unit": "chains",
                               "better": "higher", "source": "host_clock", "layer": "Update",
                               "moves": "sweeps_per_s", "workloads": ["holstein_64.hmc_flip"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell(bench, "holstein_64.hmc_flip")
    assert [m["name"] for m in cell.end_to_end] == ["sweeps_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["acceptance.hmc", "flips.hmc_flip"]
    r = run_cell("holstein_64.hmc_flip", 5, 0.0, True, "cpu", overrides=tiny["holstein"],
                 here=here)
    assert r["metrics"]["flips.hmc_flip"] == {"value": 4.0, "unit": "chains"}
    assert list(r["checks"]) == ["dH_gap", "state_gap", "accept_flips", "flip_gap"]
    assert r["checks"]["flip_gap"]["value"] == 0.0
    assert r["_numbers"]["update"]["step"] == 0 and r["_numbers"]["flip"]["n"] == 1
    assert r["correct"], r["checks"]
    # the new part's check catches a fault planted in its step
    from harness.control import faulty

    r = run_cell("holstein_64.hmc_flip", 5, 0.0, False, "cpu", overrides=tiny["holstein"],
                 here=here, make_program=faulty("altered"))
    assert r["checks"]["flip_gap"]["value"] > 0 and not r["correct"]


def test_checked_update_is_drawn_over_the_whole_window():
    """The one-slot reservoir keeps each of a window's n updates with
    probability 1/n, and the same seed keeps the same one."""
    from collections import Counter

    from harness.traffic import Traffic

    def kept(seed, n=6):
        t = Traffic(seed, None, 1, "cpu", None)
        return [k for k in range(n) if t.keeps(0, k)][-1]

    counts = Counter(kept(2 ** 40 + s) for s in range(3000))
    assert set(counts) == set(range(6)) and min(counts.values()) > 400
    assert kept(2 ** 35 + 11) == kept(2 ** 35 + 11)
