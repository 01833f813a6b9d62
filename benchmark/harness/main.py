"""One run of one cell: set-up, the measured window, the trace, the check,
the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's mix (``mixes/<mix>.json``) names the port's entry
(``entries/<entry>.py``) and the parts each step runs, in order
(``parts/<part>.py``). Set-up builds the cell's configuration through the
entry, makes the initial field and runs the mix's ``warmup_steps`` steps on
it (kernel builds, the kernels' geometry tuning, the graph captures), with
draws of the mix's ``initial_field_seed``, so that every run's window
starts from the same field. The window then runs the steps back to back
from there, each with draws of the run's seed, and ends at the first whole
step that finishes after ``--seconds``. With ``--trace 1`` the port's
counters are read over the window and the profiler traces the mix's
``trace_steps`` further steps. Then the port's objects are freed and each
part's check follows one step of the window, drawn from the seed
(:mod:`.check`). The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared with
its limit (also the last lines of standard error).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from harness import check, device as dev, kernels, nojax, spec, trace as tr
from harness.program import Program, counters, host_reads, reset_counts
from harness.traffic import WARMUP, WINDOW, Traffic
from reference.models import Model


@dataclass
class RunRecord:
    """What a metric's reader reads."""

    cell: spec.Cell
    config: spec.Config
    mix: dict
    model: Model                     # the configuration's shapes and couplings
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: list = field(default_factory=list)   # per step: {part: {stat: [C] tensor}}
    counters: dict | None = None     # the port's counters over the window
    trace: tr.Trace | None = None
    trace_counts: dict | None = None  # the port's launch counts over the traced steps


def _args(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on one card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _step(program, parts: dict, traffic, state, stream: int, k: int, keep=None):
    """Step ``k``: each part in order; returns the state, {part: stats} and
    the snapshots of the parts whose step ``keep(i, k)`` keeps."""
    stats_of, snaps = {}, {}
    for i, (name, part) in enumerate(parts.items()):
        d = part.draws(traffic, stream, k)
        kept = part.before(state) if keep is not None and keep(i, k) else None
        state, stats = program.step(part, state, d)
        stats_of[name] = {n: getattr(stats, n).clone() for n in part.STATS}
        if kept is not None:
            snaps[name] = part.snapshot(k, kept, state, stats)
    return state, stats_of, snaps


def _window(program, parts, traffic, state, seconds: float, device):
    """The window's steps back to back; returns the state, each step's
    stats, the checked steps' snapshots and each step's log (its end in s,
    the port's host reads and eager retries in it)."""
    steps, log, snaps = [], [], {}
    t0 = time.perf_counter()
    t = t0
    while t - t0 < seconds or not steps:
        reads, retries = host_reads(), program.retries()
        state, stats, kept = _step(program, parts, traffic, state, WINDOW, len(steps),
                                   traffic.keeps)
        snaps.update(kept)
        steps.append(stats)
        dev.sync(device)
        t = time.perf_counter()
        log.append({"end_s": t - t0, "host_reads": host_reads() - reads,
                    "retries": program.retries() - retries})
    return state, steps, snaps, log


def _summary(steps: list, log: list) -> list:
    """Per step: its log and the chains' mean of each stat (the run's
    standard error, where a slow or odd step shows)."""
    out = []
    for stats, entry in zip(steps, log):
        row = dict(entry)
        for part, st in stats.items():
            for n, v in st.items():
                row[f"{part}.{n}"] = float(v.double().mean())
        out.append(row)
    return out


def _read(metrics, record: RunRecord, here: Path) -> dict:
    out = {}
    for m in metrics:
        value = spec.load_reader(m["name"], here).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, make_program=None, here: Path = spec.HERE,
             t0: float | None = None, warmup_steps: int | None = None) -> dict:
    """The result of one run (the dict of the last line). ``overrides``,
    ``make_program`` and ``warmup_steps`` serve the tests and the readings:
    smaller sizes, a broken program or the control in the port's place,
    fewer set-up steps."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    bench = spec.load_benchmark(here.parent)
    cell = spec.find_cell(bench, name)
    cfg = spec.load_config(cell.config, here, overrides)
    mix = spec.load_json("mixes", cell.traffic, here)
    parts = {p: spec.load_module("parts", p, here) for p in mix["parts"]}
    limits_path = here / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    model = Model(cfg.run, device, torch.float64)
    program = (make_program or Program)(mix["entry"], copy.deepcopy(cfg.run), cfg.chains,
                                        cfg.dtype, device, seed, here=here)
    traffic = Traffic(seed, model, cfg.chains, device, program.dtype)
    start = Traffic(mix.get("initial_field_seed", seed), model, cfg.chains, device,
                    program.dtype)
    state = program.state(start.initial_field())
    n_warm = int(mix.get("warmup_steps", 1)) if warmup_steps is None else warmup_steps
    for i in range(n_warm):
        state, _, _ = _step(program, parts, start, state, WARMUP, i)
    dev.sync(device)
    record = RunRecord(cell=cell, config=cfg, mix=mix, model=model, device=device,
                       setup_s=time.perf_counter() - t0)

    c0 = counters() if trace else None
    state, record.steps, snaps, log = _window(program, parts, traffic, state, seconds, device)
    record.window_s = log[-1]["end_s"]
    t_after = time.perf_counter()
    record.steps = [{p: {k: t.cpu() for k, t in st.items()} for p, st in s.items()}
                    for s in record.steps]
    device_info = dev.describe(device, cell.chips)
    if trace:
        record.counters = {"host_reads": counters()["host_reads"] - c0["host_reads"]}
        n0 = len(record.steps)

        def more():
            s = state
            for i in range(int(mix.get("trace_steps", 1))):
                s, _, _ = _step(program, parts, traffic, s, WINDOW, n0 + i)

        reset_counts()
        record.trace = tr.traced(more, device)
        record.trace_counts = counters()
        metrics = _read(cell.per_layer, record, here)
        if record.trace is not None:
            device_info.update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
    else:
        metrics = _read(cell.end_to_end, record, here)

    program.close()
    del program, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers, notes = check.compare(parts, snaps, traffic, cfg.run, device)
    names = [n for p in parts.values() for n in p.NUMBERS]
    correct, checks = check.judge(numbers, names, limits)
    failed = sum(int((st["flag"] != 0).sum()) for s in record.steps for st in s.values()
                 if "flag" in st)
    result = {"correct": correct, "attempted": cfg.chains * len(record.steps),
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace and record.trace is not None:
        result["breakdown"] = {"device_ops": record.trace.device_ops,
                               "idle_gaps": record.trace.idle_gaps}
    result["checks"] = checks
    result["_numbers"] = dict(numbers, **notes)
    result["_timing"] = {"setup_s": record.setup_s, "steps": _summary(record.steps, log),
                         "trace_and_readers_s": t_check - t_after,
                         "check_s": time.perf_counter() - t_check}
    if record.trace is not None and record.trace_counts is not None:
        tc = record.trace_counts
        result["_timing"]["traced_launches"] = {
            "counted": {f: n for f, n in tc["table_launches"].items() if n},
            "shapes": sorted([f, list(sh), str(d)] for f, sh, d in tc["launch_shapes"]),
            "traced": {k: kernels.traced_launches(record, k) for k in kernels.TRACE_NAMES}}
    return result


def main(argv, t0: float) -> int:
    args = _args(argv)
    try:
        bench = spec.load_benchmark()
        chips = spec.find_cell(bench, args.workload).chips
        dev.require_cards(chips)
    except (dev.NoDevice, KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0=t0)
    numbers = result.pop("_numbers")
    print("timing: " + json.dumps(result.pop("_timing")), file=sys.stderr)
    found = nojax.loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    limit = dev.power_limit()
    print(f"card: {limit}", file=sys.stderr)
    print("counts: " + json.dumps({k: v for k, v in numbers.items() if k not in result["checks"]}),
          file=sys.stderr)
    for name, c in result["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])      # JSON has no inf or nan
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
