"""Finding a cell's files by name.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` reads
``benchmark/configs/<config>/config.json`` (with the input file it names
beside it), ``benchmark/mixes/<mix>.json``, the port's entry and the parts
the mix names (``benchmark/entries/<entry>.py``,
``benchmark/parts/<part>.py``), its comparison limits
``benchmark/limits/<cell>.json``, and one reader
``benchmark/metrics/<metric>.py`` per metric it reports. Nothing here lists
configurations, mixes, parts or metrics: adding one is adding its files and
its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import tomllib
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # benchmark/
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    end_to_end: tuple      # metric entries of BENCHMARK.json this cell reports
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(bench: dict, name: str) -> Cell:
    """The workload ``name`` with the metrics it reports."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = tuple(m for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"])
    names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if _reports(m, name, names))
    return Cell(name=name, config=w["config"], traffic=w["traffic"], chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def _set(cfg: dict, dotted: str, value, add: bool = False) -> None:
    *path, key = dotted.split(".")
    node = cfg
    for p in path:
        node = node[p]
    if key not in node and not add:
        raise KeyError(f"edit {dotted!r}: no such key in the input file")
    node[key] = value


@dataclass(frozen=True)
class Config:
    name: str
    run: dict          # the parsed input file with the edits applied
    chains: int
    dtype: str
    meta: dict


def load_config(name: str, here: Path = HERE, overrides: dict | None = None) -> Config:
    """The configuration ``name``: its input file parsed, its edits applied
    (``overrides``, dotted keys as the edits, apply on top: the tests'
    small sizes)."""
    folder = here / "configs" / name
    with open(folder / "config.json") as f:
        meta = json.load(f)
    with open(folder / meta["input"], "rb") as f:
        run = tomllib.load(f)
    for k, v in meta.get("edits", {}).items():
        _set(run, k, v)
    chains = int(meta["chains"])
    for k, v in (overrides or {}).items():
        if k == "chains":
            chains = int(v)
        else:
            _set(run, k, v, add=True)
    return Config(name=name, run=run, chains=chains, dtype=meta.get("dtype", "float32"),
                  meta=meta)


def load_json(kind: str, name: str, here: Path = HERE) -> dict:
    with open(here / kind / f"{name}.json") as f:
        return json.load(f)


_MODULES: dict = {}


def load_module(kind: str, name: str, here: Path = HERE):
    """The module ``<kind>/<name>.py`` (``metrics``, ``parts``, ``entries``;
    its name may hold dots), loaded once per path."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {kind}/{name}.py")
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_')}_{len(_MODULES)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def load_reader(metric: str, here: Path = HERE):
    """The reader module of ``metric`` (``metrics/<metric>.py``)."""
    return load_module("metrics", metric, here)
