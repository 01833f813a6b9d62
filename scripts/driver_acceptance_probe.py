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

``--dtype float64`` runs the same in float64. ``--dtype both`` instead
compares the precisions on the Holstein case (16 chains, seed 1, one
update): float64 and float32 on the same draws (start fields, momenta,
pseudofermions and uniforms drawn in float64 from the seeded generator and
cast, since torch draws other numbers in float32), and float64 at solver
tolerances 0.8e-5, 1.25e-5 and 1e-7 as controls of how far ΔH moves with
where the trajectory's tol-1e-5 solves stop. Per chain it prints H at the
start, ΔH, the decisions and the float32-against-float64 differences
beside the float32 rounding of H, u·(|S| + K) per evaluation (u = 2⁻²⁴,
every term of H rounded once, the sums in float64). H at the start holds
the same state in both runs, so it must agree within that bound; ΔH holds
two evaluations and the trajectory, so it must agree within twice the
bound plus the solve-path band: the largest change of float64's ΔH when
the tolerance moves to 0.8e-5 or 1.25e-5.

Needs a CUDA card: ``python scripts/driver_acceptance_probe.py
[--dtype float32|float64|both]`` (~3.5 min on an H100 for float32, the
kernels' build included; ~3 min for ``both``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import tomllib
from dataclasses import replace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from elphdynamics_tpu_torch import simulation  # noqa: E402
from elphdynamics_tpu_torch.dynamics import hmc  # noqa: E402
from elphdynamics_tpu_torch.io.output import dump_toml  # noqa: E402
from elphdynamics_tpu_torch.ops import ckb_cuda  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "accept_probe")
U32 = 2.0 ** -24


@contextlib.contextmanager
def float64_draws(seen: list):
    """The driver's start fields and update draws made in float64 from its
    generator and cast to the run's dtype; every update's statistics
    appended to ``seen``."""
    init, draw, make = simulation.init_phonons_half_filled, hmc.draw, simulation.make_hmc_step

    def init64(ops, params, n_chains, generator=None, draws=None):
        p64 = replace(params, omega=params.omega.double(), lam=params.lam.double())
        return init(ops, p64, n_chains, generator, draws).to(params.omega.dtype)

    def draw64(ops, n_chains, dtype, device, generator=None, fdtype=None):
        fdtype = fdtype or dtype
        d = draw(ops, n_chains, torch.float64, device, generator,
                 torch.complex128 if fdtype.is_complex else torch.float64)
        return replace(d, momentum=d.momentum.to(dtype), pseudofermion=d.pseudofermion.to(fdtype))

    def make_recording(*a, **k):
        step = make(*a, **k)

        def rec(*sa, **sk):
            state, stats = step(*sa, **sk)
            seen.append(stats)
            return state, stats

        rec.draw = step.draw
        return rec

    simulation.init_phonons_half_filled, hmc.draw = init64, draw64
    simulation.make_hmc_step = make_recording
    try:
        yield
    finally:
        simulation.init_phonons_half_filled, hmc.draw = init, draw
        simulation.make_hmc_step = make


def run(example: str, model: str, chains: int, updates: int, seed: int,
        dtype=torch.float32, tol: float | None = None) -> dict:
    with open(os.path.join(ROOT, "examples", f"{example}.toml"), "rb") as f:
        cfg = tomllib.load(f)
    cfg["lattice"]["L"] = 64
    cfg[model]["beta"] = 4.0
    cfg["hmc"].update(dt=0.025, num_multitimesteps=4, burnin_updates=0,
                      simulation_updates=updates, meas_freq=updates, verbose=True, log=True)
    cfg["simulation"].update(num_bins=1, random_seed=seed)
    cfg["measurements"]["num_random_vectors"] = 10
    if tol is not None:
        cfg["solver"]["tol"] = tol
    with tempfile.TemporaryDirectory() as work:
        cfg["simulation"]["filepath"] = work
        path = os.path.join(work, "cfg.toml")
        with open(path, "w") as f:
            f.write(dump_toml(cfg))
        t0 = time.perf_counter()
        stats = simulation.simulate(path, n_chains=chains, device="cuda", dtype=dtype)
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
    return dict(example=example, chains=chains, seed=seed, dtype=str(dtype), wall_s=wall,
                acceptance=stats["acceptance_rate"], accepted=accepted,
                H_drift_first_to_last_step=drift)


CONTROLS = (("float64_tol0.8e-5", 0.8e-5), ("float64_tol1.25e-5", 1.25e-5),
            ("float64_tol1e-7", 1e-7))


def compare_dtypes(card: str) -> dict:
    """The first 64×64 Holstein trajectory in float64, in float32 and in
    float64 at the control tolerances, on the same float64 draws; per
    chain."""
    res = {}
    for name, dtype, tol in (("float64", torch.float64, None), ("float32", torch.float32, None),
                             *((n, torch.float64, t) for n, t in CONTROLS)):
        seen: list = []
        with float64_draws(seen):
            out = run("holstein_hmc_square", "holstein", 16, 1, 1, dtype, tol)
        st = seen[0]
        dH, H1 = st.delta_H.double().cpu(), st.H.double().cpu()
        res[name] = dict(wall_s=out["wall_s"], accepted=st.accepted.int().cpu().tolist(),
                         delta_H=dH.tolist(), H_start=(H1 - dH).tolist(),
                         S=st.S.double().cpu().tolist(), K=st.K.double().cpu().tolist(),
                         iters=st.iters.cpu().tolist(), flag=st.flag.cpu().tolist())
    f64, f32 = res["float64"], res["float32"]

    def minus(a, b):
        return [x - y for x, y in zip(a, b)]

    d32 = minus(f32["delta_H"], f64["delta_H"])
    dH0 = minus(f32["H_start"], f64["H_start"])
    dctl = {n: minus(res[n]["delta_H"], f64["delta_H"]) for n, _ in CONTROLS}
    band = max(abs(d) for n in CONTROLS[:2] for d in dctl[n[0]])
    rounding = [U32 * (abs(s) + k) for s, k in zip(f64["S"], f64["K"])]
    return dict(card=card, runs=res, H_start_f32_minus_f64=dH0, dH_f32_minus_f64=d32,
                dH_controls_minus_f64=dctl, rounding_per_evaluation=rounding,
                solve_path_band=band,
                start_within_rounding=all(abs(d) <= r for d, r in zip(dH0, rounding)),
                dH_within_rounding_and_band=all(abs(d) <= 2 * r + band
                                                for d, r in zip(d32, rounding)),
                decisions_equal=f32["accepted"] == f64["accepted"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("float32", "float64", "both"), default="float32")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    ckb_cuda.build()
    os.makedirs(OUT, exist_ok=True)
    if args.dtype == "both":
        out = compare_dtypes(card.strip())
        print(json.dumps(out), flush=True)
        with open(os.path.join(OUT, "holstein_dtypes_16_1.json"), "w") as f:
            json.dump(out, f)
        return 0
    dtype = getattr(torch, args.dtype)
    suffix = "" if dtype == torch.float32 else "_float64"
    runs = [("holstein_hmc_square", "holstein", 16, 3, 1)]
    runs += [("holstein_hmc_square", "holstein", 4, 1, seed) for seed in (2, 3, 4)]
    runs += [("ssh_hmc_square", "ssh", 8, 2, 1)]
    for example, model, chains, updates, seed in runs:
        out = run(example, model, chains, updates, seed, dtype)
        out["card"] = card.strip()
        print(json.dumps(out), flush=True)
        with open(os.path.join(OUT, f"{example}_{chains}_{seed}{suffix}.json"), "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
