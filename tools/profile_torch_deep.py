"""Measure the PyTorch port's deep-β samplers and solver aids on a CUDA card.

    python tools/profile_torch_deep.py [NAME ...] [--trace DIR]

NAME is one or more of (default: all, in this order):

* ``integrators``: ``bench.KERNEL_64X64`` (leapfrog, dt 0.025) against
  ``bench.KERNEL_2MN_64X64`` (2MN, dt 0.05; both 42 solves per update), one
  warm-up and 6 timed updates of 16 chains each, in turns (leapfrog, 2MN,
  2MN, leapfrog): sweeps/s, acceptance, acceptance per solve, CG iterations
  per solve, |ΔH|.
* ``timer_sync``: the 64×64 Holstein driver run of ``chip_smoke.py``
  (``examples/holstein_hmc_square.toml`` at L = 64, β = 4, dt 0.025, 4
  bosonic substeps, 4 chains, 1 burn-in and 2 sampling updates with a
  measurement each, nᵥ = 10) with the driver's timer (``simulation._clock``)
  reading the clock after a ``torch.cuda.synchronize`` and without one, in
  turns (with, without, without, with): the driver's ``simulation_time``
  and ``measurement_time`` and their split.
* ``tempering_64x64``: one ``bench.TEMPERING_64X64`` update and one
  exchange attempt under ``torch.profiler``.
* ``deep_beta``: the three solve kinds of ``bench.DEEP_BETA_64X64`` (plain
  KPM-CG, deflation, near-null), each set up and solved once to tune the
  launch geometries, then set up and solved under ``torch.profiler``.

A profiled run prints its wall time, the summed device-kernel time and the
device's busy share, both kernels' launches (by coefficient form) and device
time, the share of torch's elementwise kernels, and the heaviest kernels;
``--trace DIR`` writes its Chrome trace to ``DIR/<name>_trace.json``. Every
line names the card and its power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import tomllib
from dataclasses import replace
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from elphdynamics_tpu_torch import bench  # noqa: E402
from elphdynamics_tpu_torch.ops import ckb_cuda  # noqa: E402

NAMES = ("integrators", "timer_sync", "tempering_64x64", "deep_beta")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def say(name: str, **kv) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def profiled(name: str, run, trace: str | None) -> None:
    """``run()`` once under ``torch.profiler`` (CPU and CUDA activity), with
    the kernels' counts set to 0 before; the caller has warmed it up."""
    torch.cuda.synchronize()
    ckb_cuda.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in cuda)

    def kernel_s(name: str) -> float:
        return sum(e.self_device_time_total for e in cuda if f"{name}<" in e.key) / 1e6

    elementwise = sum(e.self_device_time_total for e in cuda if "elementwise" in e.key)

    say(name, wall_s=f"{wall:.4f}", device_kernel_s=f"{dev_us / 1e6:.4f}",
        device_busy_share=f"{dev_us / 1e6 / wall:.4f}", fold_launches=ckb_cuda.launches,
        fold_s=f"{kernel_s('ckb_fold_kernel'):.4f}", fused_launches=ckb_cuda.fused_launches,
        fused_s=f"{kernel_s('ckb_fold_fused_kernel'):.4f}",
        elementwise_share=f"{elementwise / max(dev_us, 1e-9):.4f}",
        table_launches=json.dumps({k: v for k, v in ckb_cuda.table_launches.items() if v}),
        **(extra or {}))
    print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    if trace:
        os.makedirs(trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace, f"{name}_trace.json"))


def integrators() -> None:
    """Leapfrog at dt 0.025 against 2MN at dt 0.05 on the kernel 64×64
    model, in turns."""
    built = {cfg.name: bench.build(cfg, "cuda", torch.float32)
             for cfg in (bench.KERNEL_64X64, bench.KERNEL_2MN_64X64)}
    nsolves = {bench.KERNEL_64X64.name: 42, bench.KERNEL_2MN_64X64.name: 42}
    states = {k: b.state for k, b in built.items()}
    for b_name, b in built.items():         # warm-up (tunes the launch geometries)
        states[b_name], _ = b.step(b.params, states[b_name], b.generator)
    rows = {k: [] for k in built}
    lf, mn = bench.KERNEL_64X64.name, bench.KERNEL_2MN_64X64.name
    for name in (lf, mn, mn, lf):
        b = built[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats_all = []
        for _ in range(3):
            states[name], stats = b.step(b.params, states[name], b.generator)
            stats_all.append(stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc = torch.stack([s.accepted for s in stats_all]).double()
        it = torch.stack([s.iters for s in stats_all]).double()
        dh = torch.stack([s.delta_H for s in stats_all]).abs()
        flag = int(torch.stack([s.flag for s in stats_all]).max())
        rows[name].append((wall, acc.mean().item(), it.mean().item(), dh.mean().item(), flag))
    for name, rs in rows.items():
        wall = sum(r[0] for r in rs)
        acc = statistics.mean(r[1] for r in rs)
        say("integrators", config=name, timed_updates=3 * len(rs), chains=16,
            sweeps_per_s=f"{16 * 3 * len(rs) / wall:.4f}", acceptance=f"{acc:.4f}",
            solves_per_update=nsolves[name],
            acceptance_per_solve=f"{acc / nsolves[name]:.5f}",
            cg_iters_per_solve=f"{statistics.mean(r[2] for r in rs):.3f}",
            mean_abs_dH=f"{statistics.mean(r[3] for r in rs):.4f}",
            max_flag=max(r[4] for r in rs),
            turns=",".join(f"{16 * 3 / r[0]:.3f}" for r in rs))


def timer_sync() -> None:
    """The 64×64 Holstein driver run with and without the synchronisation
    before each timer read, in turns."""
    from elphdynamics_tpu_torch import simulation
    from elphdynamics_tpu_torch.io.output import dump_toml

    with open(ROOT / "examples" / "holstein_hmc_square.toml", "rb") as f:
        cfg = tomllib.load(f)
    cfg["lattice"]["L"] = 64
    cfg["holstein"]["beta"] = 4.0
    cfg["hmc"].update(dt=0.025, num_multitimesteps=4, burnin_updates=1, simulation_updates=2,
                      meas_freq=1)
    cfg["simulation"]["num_bins"] = 2
    cfg["measurements"]["num_random_vectors"] = 10

    def synced(device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.time()

    def unsynced(device):
        return time.time()

    clock = simulation._clock
    try:
        with tempfile.TemporaryDirectory() as work:
            for i, sync in enumerate((True, False, False, True)):
                cfg["simulation"]["filepath"] = os.path.join(work, str(i))
                os.makedirs(cfg["simulation"]["filepath"])
                path = os.path.join(cfg["simulation"]["filepath"], "run.toml")
                with open(path, "w") as f:
                    f.write(dump_toml(cfg))
                simulation._clock = synced if sync else unsynced
                t0 = time.perf_counter()
                stats = simulation.simulate(path, n_chains=4, device="cuda", dtype=torch.float32)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                sim_t, meas_t = stats["simulation_time"], stats["measurement_time"]
                say("timer_sync", turn=i, sync=sync, wall_s=f"{wall:.3f}",
                    simulation_time_s=f"{sim_t:.4f}", measurement_time_s=f"{meas_t:.4f}",
                    s_per_update=f"{sim_t / 3:.4f}", s_per_measurement=f"{meas_t / 2:.4f}",
                    measurement_share=f"{meas_t / (sim_t + meas_t):.4f}",
                    write_s=f"{stats['write_time']:.3f}")
    finally:
        simulation._clock = clock


def tempering(trace) -> None:
    b = bench.build(bench.TEMPERING_64X64, "cuda", torch.float32)
    box = {"state": b.state, "parity": 0}

    def run():
        st, stats = b.step(b.params, box["state"], b.generator)
        x, v, rate, iters, flag = b.exchange(b.params, st.x, st.v, box["parity"], b.generator)
        box["state"], box["parity"] = replace(st, x=x, v=v), 1 - box["parity"]
        return dict(acceptance=f"{stats.accepted.double().mean().item():.4f}",
                    cg_iters_per_solve=f"{stats.iters.double().mean().item():.3f}",
                    exchange_acceptance=f"{float(rate):.4f}",
                    exchange_iters=f"{float(iters):.2f}", exchange_flag=int(flag))

    run()
    profiled("tempering_64x64", run, trace)


def deep_beta(trace) -> None:
    d = bench.build_deep_beta_solves(bench.DEEP_BETA_64X64, "cuda", torch.float32)
    for kind in bench.SOLVE_KINDS:
        d.prepare(kind)()          # tunes the launch geometries at these shapes
        box = {}

        def setup():
            box["run"] = d.prepare(kind)

        def solve():
            res = box["run"]()
            return dict(iters=f"{res.iters.double().mean().item():.2f}",
                        max_flag=int(res.flag.max()))

        torch.cuda.reset_peak_memory_stats()
        profiled(f"deep_beta_{kind}_setup", setup, trace)
        profiled(f"deep_beta_{kind}_solve", solve, trace)
        say(f"deep_beta_{kind}", peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help=f"any of {', '.join(NAMES)} (default: all)")
    ap.add_argument("--trace", default=None, help="directory for the Chrome traces")
    args = ap.parse_args()
    unknown = set(args.names) - set(NAMES)
    if unknown:
        ap.error(f"unknown names {sorted(unknown)}; expected any of {NAMES}")
    if not torch.cuda.is_available():
        print("profile_torch_deep: no CUDA device", file=sys.stderr)
        return 1
    print(_card(), flush=True)
    say("card", device=repr(torch.cuda.get_device_name(0)), torch=torch.__version__)
    for name in args.names or NAMES:
        if name == "integrators":
            integrators()
        elif name == "timer_sync":
            timer_sync()
        elif name == "tempering_64x64":
            tempering(args.trace)
        else:
            deep_beta(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
