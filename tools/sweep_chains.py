"""Sweep the chains per card of one HMC update on a CUDA card: the table of
``--chains 0`` (``simulation.CHAINS_PER_CARD``).

    python tools/sweep_chains.py [--models holstein,ssh] [--sizes 8,32,64]
                                 [--out FILE]

For each model (the bench models of ``elphdynamics_tpu_torch/bench.py``:
Holstein with KPM max_order 4, SSH with 8; β = 4, Δτ = 0.1, Lτ = 40; dt
0.05 up to 32×32, 0.025 at 64×64) and lattice size it builds the update at
a ladder of chain counts and runs 1 warm-up and 2 timed updates each,
float32: chain sweeps per second (chains × updates / seconds, after a
synchronisation), acceptance and CG iterations per solve. A count that
runs out of device memory ends its ladder. Every line names the card and
its power limit (``nvidia-smi``); ``--out`` writes every point to a JSON
file.

The table printed last (:func:`knee`) is, per (model, size), the fewest
chains whose sweeps/s reach 90% of the best on the ladder: throughput
grows with the batch while the host's launches are amortised and then
flattens, and chains past the knee buy little more throughput for their
memory and their burn-in.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from elphdynamics_tpu_torch import bench  # noqa: E402

LADDERS = {8: (32, 64, 128, 256, 512, 1024, 2048), 32: (8, 16, 32, 64, 128, 256),
           64: (4, 8, 16, 32, 64, 128)}
WARMUP, TIMED = 1, 2
KNEE = 0.9   # share of the best sweeps/s that the chosen count reaches


def knee(points: list[dict]) -> dict:
    """``{model: {N: chains}}``: per (model, N) the fewest chains whose
    sweeps/s reach ``KNEE`` of the best point of the ladder."""
    table: dict = {}
    for p in points:
        table.setdefault(p["model"], {}).setdefault(p["N"], []).append(p)
    return {m: {n: min(q["chains"] for q in ps
                       if q["sweeps_per_s"] >= KNEE * max(r["sweeps_per_s"] for r in ps))
                for n, ps in by_n.items()}
            for m, by_n in table.items()}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def point(model: str, L: int, chains: int) -> dict:
    """One (model, size, chain count): sweeps per second of the update."""
    make = bench.build_ssh_step if model == "ssh" else bench.build_bench_step
    dt = 0.025 if L >= 64 else 0.05
    b = make(L, 4.0, 0.1, dt, chains, "cuda", torch.float32)
    state = b.state
    for _ in range(WARMUP):
        state, stats = b.step(b.params, state, b.generator)
    torch.cuda.synchronize()
    acc, iters = [], []
    t0 = time.perf_counter()
    for _ in range(TIMED):
        state, stats = b.step(b.params, state, b.generator)
        acc.append(stats.accepted)
        iters.append(stats.iters)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(model=model, L=L, N=L * L, chains=chains, seconds=seconds,
                sweeps_per_s=chains * TIMED / seconds,
                acceptance=torch.stack(acc).double().mean().item(),
                cg_iters_per_solve=torch.stack(iters).double().mean().item(),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="holstein,ssh")
    ap.add_argument("--sizes", default="8,32,64")
    ap.add_argument("--out", default=None, help="JSON file for every point")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_chains: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    points = []
    for model in args.models.split(","):
        for L in map(int, args.sizes.split(",")):
            for chains in LADDERS[L]:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                try:
                    p = point(model, L, chains)
                except torch.cuda.OutOfMemoryError:
                    print(json.dumps(dict(model=model, L=L, chains=chains, oom=True, card=card)),
                          flush=True)
                    break
                p["card"] = card
                points.append(p)
                print(json.dumps(p), flush=True)
    table = knee(points)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, points=points, chains_per_card=table), f, indent=1)
    print(json.dumps(dict(card=card, chains_per_card=table)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
