"""HMC acceptance of the first updates of ``chip_smoke.py``'s 64×64 driver
runs, chain by chain.

``chip_smoke.py`` drives ``examples/holstein_hmc_square.toml`` and
``examples/ssh_hmc_square.toml`` at 64×64 (β = 4, dt = 0.025, 4 bosonic
substeps, nᵥ = 10, float32) from a fresh start and requires an acceptance
rate above 0. This script runs the same files with the same settings, no
burn-in and a few sampling updates, with the verbose HMC log on, and prints
per update and chain the decision and the change of H from the first to the
last leapfrog step (the start's H is not logged). Holstein runs 16 chains
with seed 1 and 4 chains with seeds 2, 3, 4 (the smoke's width); SSH 8
chains with seed 1. One JSON line per run, also written under
``chiprun_out/accept_probe/``.

Needs a CUDA card: ``python scripts/driver_acceptance_probe.py`` (~3.5 min
on an H100, the kernels' build included).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import tomllib

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from elphdynamics_tpu_torch.io.output import dump_toml  # noqa: E402
from elphdynamics_tpu_torch.ops import ckb_cuda  # noqa: E402
from elphdynamics_tpu_torch.simulation import simulate  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "accept_probe")


def run(example: str, model: str, chains: int, updates: int, seed: int) -> dict:
    with open(os.path.join(ROOT, "examples", f"{example}.toml"), "rb") as f:
        cfg = tomllib.load(f)
    cfg["lattice"]["L"] = 64
    cfg[model]["beta"] = 4.0
    cfg["hmc"].update(dt=0.025, num_multitimesteps=4, burnin_updates=0,
                      simulation_updates=updates, meas_freq=updates, verbose=True, log=True)
    cfg["simulation"].update(num_bins=1, random_seed=seed)
    cfg["measurements"]["num_random_vectors"] = 10
    with tempfile.TemporaryDirectory() as work:
        cfg["simulation"]["filepath"] = work
        path = os.path.join(work, "cfg.toml")
        with open(path, "w") as f:
            f.write(dump_toml(cfg))
        t0 = time.perf_counter()
        stats = simulate(path, n_chains=chains, device="cuda", dtype=torch.float32)
        wall = time.perf_counter() - t0
        log = os.path.join(work, f"{cfg['simulation']['foldername']}-1", "hmc_sim_log.out")
        with open(log) as f:
            rows = [r.split() for r in f.read().splitlines()[1:]]
    accepted: dict[int, list[int]] = {}
    steps: dict[int, list[list[float]]] = {}
    for r in rows:
        n, a, t, H = int(r[0]), int(r[1]), int(r[2]), float(r[3])
        if t == -1:
            accepted.setdefault(n, []).append(a)
        elif t == 1:
            # verbose rows run chain by chain, t = 1 .. Nt
            steps.setdefault(n, []).append([H])
        else:
            steps[n][-1].append(H)
    drift = {n: [round(h[-1] - h[0], 4) for h in per_chain] for n, per_chain in steps.items()}
    return dict(example=example, chains=chains, seed=seed, wall_s=wall,
                acceptance=stats["acceptance_rate"], accepted=accepted,
                H_drift_first_to_last_step=drift)


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    ckb_cuda.build()
    os.makedirs(OUT, exist_ok=True)
    runs = [("holstein_hmc_square", "holstein", 16, 3, 1)]
    runs += [("holstein_hmc_square", "holstein", 4, 1, seed) for seed in (2, 3, 4)]
    runs += [("ssh_hmc_square", "ssh", 8, 2, 1)]
    for example, model, chains, updates, seed in runs:
        out = run(example, model, chains, updates, seed)
        out["card"] = card.strip()
        print(json.dumps(out), flush=True)
        with open(os.path.join(OUT, f"{example}_{chains}_{seed}.json"), "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
