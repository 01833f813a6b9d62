"""The readings a cell's limits are set from, and a chain's course, on the card.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 12 --seconds 5 \\
        [--control 3] [--faults half,altered] [--first-seed N] [--chains C]

Runs the cell's program on each seed (a window of ``--seconds``, the check
as a run makes it) and, with ``--control k``, the bfloat16 control in the
port's place on k seeds (one step each, no warm-up), and with ``--faults``
the port with each fault planted on one seed, all in one process. It prints
one JSON line per run: the numbers compared, the metrics, and per step its
end, host reads, retries and the chains' mean of each stat. The lower
reading of a number is the largest over the program's runs, the upper the
smallest over the control's. ``--chains`` runs the cell at another chain
count (a chain's course over a long window at a low cost).
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.control import Control, faulty  # noqa: E402
from harness.main import run_cell  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", default="", help="comma-separated faults to plant, one seed each")
    p.add_argument("--chains", type=int, default=0, help="another chain count (0: the cell's)")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    overrides = {"chains": a.chains} if a.chains else None
    runs = [("program", None, a.first_seed + i, a.seconds, None) for i in range(a.seeds)]
    runs += [("control", Control, a.first_seed + 1000 + i, 0.0, 0) for i in range(a.control)]
    runs += [(f"fault:{k}", faulty(k), a.first_seed + 2000 + i, 0.0, None)
             for i, k in enumerate(filter(None, a.faults.split(",")))]
    for kind, make, seed, seconds, warmup in runs:
        t = time.perf_counter()
        r = run_cell(a.workload, seed, seconds, bool(a.trace), a.device, overrides=overrides,
                     make_program=make, warmup_steps=warmup)
        print(json.dumps({"kind": kind, "seed": seed, "correct": r["correct"],
                          "steps": r["attempted"], "numbers": r["_numbers"],
                          "metrics": r["metrics"], "timing": r["_timing"],
                          "s": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
