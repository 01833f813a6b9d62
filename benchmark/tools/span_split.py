"""The port's spans over a cell, on the card: the split of a traced update,
and the cell's rate with the spans recording or off.

    python3 benchmark/tools/span_split.py --workload <cell> --modes trace,on,off \\
        [--first-seed N] [--seconds 51]

Each mode is one run of the cell (set-up, window, check) in this process,
on its own seed:

* ``trace``: a run with ``--trace 1``; besides its metrics it prints the
  port's record of the traced update (``utils/spans.py``): per span name
  its count, host and device seconds and self parts, per graph its
  replays, device seconds, last replay and marks, and K2's traced seconds;
* ``on``: a run with ``--trace 0`` whose set-up and window run inside
  ``spans.recording()`` (the spans record with no profiler): against
  ``off``, what the spans cost while they record;
* ``off``: a run with ``--trace 0``, as ``benchmark/run.py`` makes it.

One JSON line per run.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.main import run_cell  # noqa: E402


def split(rec) -> dict:
    """The record of one update as plain numbers."""
    spans = {n: {"count": s.count, "host_s": s.host_s, "self_host_s": s.self_host_s,
                 "device_s": s.device_s, "self_device_s": s.self_device_s}
             for n, s in rec.spans.items()}
    graphs = {}
    for (name, key), s in rec.keys.items():
        if name == "graph.replay":
            graphs[key] = {"replays": s.count, "host_s": s.host_s, "device_s": s.device_s,
                           "last_replay_s": rec.replay_s.get(key),
                           "marks_s": rec.marks.get(key, {})}
    return {"index": rec.index, "device": rec.device, "spans": spans, "graphs": graphs}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--modes", default="trace", help="comma-separated: trace, on, off")
    p.add_argument("--first-seed", type=int, default=2_300_000_001)
    p.add_argument("--seconds", type=float, default=51.0)
    a = p.parse_args()
    from elphdynamics_tpu_torch.utils import spans

    for i, mode in enumerate(a.modes.split(",")):
        seed = a.first_seed + i
        t = time.perf_counter()
        on = spans.recording() if mode == "on" else contextlib.nullcontext()
        with on:
            r = run_cell(a.workload, seed, a.seconds, mode == "trace", "cuda")
        out = {"mode": mode, "seed": seed, "correct": r["correct"], "steps": r["attempted"],
               "metrics": r["metrics"], "device": r["device"],
               "step_end_s": [s["end_s"] for s in r["_timing"]["steps"]],
               "setup_s": r["_timing"]["setup_s"], "s": time.perf_counter() - t}
        if mode == "trace":
            out["traced_launches"] = r["_timing"].get("traced_launches")
            rec = spans.last("hmc.update")
            out["split"] = None if rec is None else split(rec)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
