"""Profile one update, or one measurement, of the PyTorch port on a CUDA
card.

    python scripts/profile_torch_hmc.py CONFIG [--eager] [--timed N] [--no-profile]
                                               [--trace DIR]

with CONFIG one of bench_8x8, bench_32x32, kernel_64x64, ssh_8x8,
ssh_64x64, twisted_64x64, ssh_twisted_64x64, langevin_64x64,
ssh_langevin_64x64, gmres_64x64, measure_64x64, measure_ssh_64x64,
measure_bond_64x64, driver_4x4, driver_ssh_4x4, driver_64x64,
driver_ssh_64x64, driver_langevin_4x4;
``--eager`` runs the eager update of an HMC configuration, the eager
Langevin step or a driver step with every part eager (update, reflection,
swap, measurement) in place of its CUDA graphs (``dynamics/graphs.py``;
the twisted ones are eager either way).
``--timed N`` times N more runs after the warm-up, without the profiler
(host clock, each run ended by a synchronisation), and for an HMC driver
step each part apart (``parts``: the update, the reflection and swap
calls, the measurement with its chain mean and container add, each ended
by a synchronisation), then one bin's post-processing and text files
(``bin_s``, written to a temporary folder, with the file's updates per
bin); ``--no-profile`` stops there (the profiler's cost per recorded event
makes an eager stock SSH step take many minutes).

``bench_8x8``, ``bench_32x32``, ``kernel_64x64``, ``ssh_8x8`` (the optical
SSH model, 64 chains, dense Ā) and ``ssh_64x64`` (8 chains) are the HMC
updates of ``bench.py``,
``twisted_64x64`` and
``ssh_twisted_64x64`` its twisted-boundary (complex hopping) updates; ``langevin_64x64`` and
``ssh_langevin_64x64`` one Runge-Kutta Langevin step of its Langevin
configurations; ``gmres_64x64`` one GMRES solve of M·z = r for nᵥ = 10
probes per chain on the ``langevin_64x64`` model (the left KPM apply);
``measure_64x64`` is one measurement of the driver at 64×64, β = 4 (4
chains, nᵥ = 10, the five time-dependent on-site correlations, KPM
max_order 8), as the 64×64 run of ``chip_smoke.py`` makes it;
``measure_ssh_64x64`` the same for the SSH example (its four on-site
correlations and the inter-site bond PhononGreens, KPM max_order 64);
``measure_bond_64x64`` the Holstein measurement with Greens and the three
time-dependent bond-pair correlations (BondBond, CurrentCurrent,
BondPairGreens);
``driver_4x4`` is one sampling step of the driver on
``examples/holstein_hmc_square.toml`` (1 chain): the HMC update, the
reflection and swap moves and the measurement (``bench.build_hmc_example``);
``driver_ssh_4x4`` the same on ``examples/ssh_hmc_square.toml`` (100
leapfrog steps of 10 bosonic substeps, KPM ``max_order`` 64);
``driver_64x64`` and ``driver_ssh_64x64`` the same two files widened as
``chip_smoke.py``'s 64×64 driver runs are (``bench.wide_hmc_config``: L =
64, β = 4, 4 chains, nᵥ = 10); ``driver_langevin_4x4`` one
step of the driver on ``examples/holstein_langevin_square.toml`` (1 chain,
RK, KPM ``max_order`` 64; the file measures once per 1000 steps, so a step
is the Langevin step alone). Builds the
configuration in float32, runs it once to warm up, then once under
``torch.profiler`` and prints: wall time, summed device-kernel time and
the device's busy share, both kernels' launches and summed device time
(K1's per-(chain, bond, τ) coefficient mode and its complex mode also
apart), the share of device time in torch's elementwise kernels,
the heaviest kernels by device time, and the heaviest host-side
operators. With ``--trace DIR`` the Chrome trace goes to
``DIR/<config>_trace.json`` (about 200 MB for one update).
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from elphdynamics_tpu_torch import bench  # noqa: E402
from elphdynamics_tpu_torch.dynamics.hmc import make_hmc_step  # noqa: E402
from elphdynamics_tpu_torch.ops import ckb_cuda, kpm  # noqa: E402


HMC_CONFIGS = {"bench_8x8": bench.BENCH_8X8, "bench_32x32": bench.BENCH_32X32,
               "kernel_64x64": bench.KERNEL_64X64, "ssh_8x8": bench.SSH_8X8,
               "ssh_64x64": bench.SSH_64X64,
               "twisted_64x64": bench.TWISTED_64X64,
               "ssh_twisted_64x64": bench.SSH_TWISTED_64X64}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config",
                    choices=[*HMC_CONFIGS, "langevin_64x64", "ssh_langevin_64x64",
                             "gmres_64x64", "measure_64x64", "measure_ssh_64x64",
                             "measure_bond_64x64", "driver_4x4", "driver_ssh_4x4",
                             "driver_64x64", "driver_ssh_64x64", "driver_langevin_4x4"])
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    ap.add_argument("--eager", action="store_true",
                    help="the eager update in place of the CUDA graphs")
    ap.add_argument("--timed", type=int, default=0,
                    help="runs timed without the profiler after the warm-up")
    ap.add_argument("--no-profile", action="store_true",
                    help="no profiled run after the timed ones")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_hmc: no CUDA device", file=sys.stderr)
        return 1
    graphable = None    # the step that may replay CUDA graphs
    if args.eager and args.config.startswith(("measure", "gmres")):
        ap.error("--eager takes an HMC configuration, a Langevin step or a driver step")
    box = {}
    if args.config.startswith("measure"):
        run = _measurement(ssh="ssh" in args.config, bond="bond" in args.config)
    elif args.config == "driver_langevin_4x4":
        run, box = _langevin_step(bench.build_langevin_example(
            str(Path(__file__).resolve().parent.parent / "examples"
                / "holstein_langevin_square.toml"), 1, "cuda", torch.float32), args.eager)
        graphable = box["step"]
    elif args.config.startswith("driver"):
        example = "ssh_hmc_square" if "ssh" in args.config else "holstein_hmc_square"
        run, box = _driver_step(example, args.eager, wide="64x64" in args.config)
        graphable = box["step"]
    elif args.config == "gmres_64x64":
        run = _gmres_solve()
    elif "langevin" in args.config:
        run, box = _langevin_step(bench.build(bench.SSH_LANGEVIN_64X64 if "ssh" in args.config
                                              else bench.LANGEVIN_64X64, "cuda", torch.float32),
                                  args.eager)
        graphable = box["step"]
    else:
        cfg = HMC_CONFIGS[args.config]
        b = bench.build(cfg, "cuda", torch.float32)
        if args.eager:
            b = replace(b, step=make_hmc_step(b.ops, b.mass, b.hmc_cfg,
                                              kpm.make_precond(b.ops, b.kpm_cfg), eager=True))
        box = {"state": b.state}
        graphable = b.step

        def run():
            box["state"], stats = b.step(b.params, box["state"], b.generator)
            return stats.iters
    run()
    torch.cuda.synchronize()
    first_update_s = box.get("update_s")
    first_parts = box.get("parts")
    timed, update_s, parts = [], [], []
    for _ in range(args.timed):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        if "update_s" in box:
            update_s.append(box["update_s"])
        if "parts" in box:
            parts.append(box["parts"])
    if timed:
        print(f"[{args.config}] device={torch.cuda.get_device_name(0)!r} eager={args.eager} "
              f"unprofiled_s={[round(t, 4) for t in timed]}"
              + (f" first_update_s={first_update_s:.4f} update_s={[round(t, 4) for t in update_s]}"
                 if update_s else ""))
    if parts:
        print(f"[{args.config}] eager={args.eager} first_parts_s={_rounded(first_parts)} "
              f"parts_s={[_rounded(p) for p in parts]} bin_s={box['bin']()[0]:.4f} "
              f"updates_per_bin={box['bin']()[1]} replays={box['replays']()}", flush=True)
    if args.no_profile:
        return 0
    ckb_cuda.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iters = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in cuda)

    elementwise_us = sum(e.self_device_time_total for e in cuda if "elementwise" in e.key)

    def kernel_s(name, mode=""):
        return sum(e.self_device_time_total for e in cuda
                   if f"{name}<" in e.key and mode in e.key) / 1e6

    graphed = graphable is not None and graphable.workspace() is not None
    print(f"[{args.config}] device={torch.cuda.get_device_name(0)!r} graphed={graphed} "
          f"wall_s={wall:.4f} "
          f"device_kernel_s={dev_us / 1e6:.4f} device_busy_share={dev_us / 1e6 / wall:.4f} "
          f"fold_launches={ckb_cuda.launches} fold_s={kernel_s('ckb_fold_kernel'):.4f} "
          f"fold_per_column_s={kernel_s('ckb_fold_kernel', ', true>'):.4f} "
          f"fold_complex_s={kernel_s('ckb_fold_kernel', 'cplx'):.4f} "
          f"elementwise_share={elementwise_us / max(dev_us, 1e-9):.4f} "
          f"table_launches={ckb_cuda.table_launches} "
          f"fused_launches={ckb_cuda.fused_launches} "
          f"fused_s={kernel_s('ckb_fold_fused_kernel'):.4f} "
          f"mean_cg_iters={iters.double().mean().item():.3f}")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    if args.trace:
        out = Path(args.trace)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{args.config}_trace.json"))
    return 0


def _langevin_step(b, eager: bool):
    """One step of the Langevin bench ``b`` (its eager twin with
    ``eager``), and a box that keeps the step's seconds (host clock, ended
    by a synchronisation)."""
    step = b.eager() if eager else b.step
    box = {"x": b.x, "step": step}

    def run():
        t0 = time.perf_counter()
        box["x"], stats = step(b.params, box["x"], b.generator)
        torch.cuda.synchronize()
        box["update_s"] = time.perf_counter() - t0
        return stats.iters

    return run, box


def _gmres_solve():
    """One GMRES solve (restart 20, tol 1e-5) of nᵥ = 10 probes per chain on
    the Langevin 64×64 model, preconditioned by the left KPM apply."""
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_minv

    b = bench.build(bench.LANGEVIN_64X64, "cuda", torch.float32)
    R = torch.randn((b.x.shape[0], 10, b.ops.Nsites, b.ops.Ltau), device="cuda",
                    generator=b.generator)
    ds = b.ops.stack(b.ops.derived(b.params, b.x))
    pa = resolve_precond(b.precond, b.params, b.x)
    scfg = SolverConfig(tol=1e-5, maxiter=500, kind="gmres", restart=20)
    return lambda: solve_minv(b.ops, b.params, ds, R, scfg, pa).iters


def _measurement(ssh: bool = False, bond: bool = False):
    """One driver measurement at 64×64, β = 4, 4 chains (Holstein, or SSH;
    ``bond``: Holstein with the bond-pair correlations)."""
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.measure import measurements as M
    from elphdynamics_tpu_torch.ops import kpm

    make = bench.build_ssh_step if ssh else bench.build_bench_step
    b = make(64, 4.0, 0.1, 0.025, 4, "cuda", torch.float32)
    kinds = M.ONSITE_CORR_KINDS[:4] if ssh else M.ONSITE_CORR_KINDS
    inter = (("PhononGreens", True),) if ssh else ()
    if bond:
        kinds = ("Greens",)
        inter = tuple((k, True) for k in M.INTERSITE_CORR_KINDS[:3])
    mspec = M.MeasurementSpec(nv=10, onsite_corr=tuple((k, True) for k in kinds),
                              intersite_corr=inter)
    cfg = kpm.KPMConfig(max_order=64 if ssh else 8)
    step = M.make_measurement_step(b.ops, mspec, SolverConfig(tol=1e-5, maxiter=10000),
                                   kpm.make_precond(b.ops, cfg))

    def run():
        inc, stats, snaps = step(b.params, b.state.x, b.generator)
        M.mean_over_chains(inc, snaps, stats["flag"])
        return stats["iters"]

    return run


def _rounded(parts: dict) -> dict:
    return {k: round(v, 4) for k, v in parts.items()}


def _driver_step(example: str, eager: bool, wide: bool = False):
    """One sampling step of the driver on a stock example (``wide``: at
    64×64, 4 chains) with every part eager with ``eager``, and a box that
    keeps the step's parts' seconds (host clock, each ended by a
    synchronisation), the graph replays of each part so far and a timer of
    one bin's post-processing and text files."""
    import tempfile

    from elphdynamics_tpu_torch.dynamics.hmc import HMCState
    from elphdynamics_tpu_torch.io import output as out_io
    from elphdynamics_tpu_torch.io.config import load_toml
    from elphdynamics_tpu_torch.measure import measurements as M
    from elphdynamics_tpu_torch.simulation import _host_tree

    root = Path(__file__).resolve().parent.parent
    cfg = load_toml(str(root / "examples" / f"{example}.toml"))
    if wide:
        cfg = bench.wide_hmc_config(cfg)
    ex = bench.build_hmc_example(cfg, 4 if wide else 1, "cuda", torch.float32, eager=eager)
    params, gen, mspec = ex.params, ex.generator, ex.setup.mspec
    container = M.zero_container(ex.ops, mspec, torch.float32, "cuda")
    box = {"state": ex.state, "step": ex.step}

    def run():
        parts, t0 = {}, time.perf_counter()

        def lap(name):
            nonlocal t0
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t0
            t0 = time.perf_counter()

        state, stats = ex.step(params, box["state"], gen)
        lap("update")
        x, _ = ex.reflect(params, state.x, gen)
        lap("reflect")
        x, _ = ex.swap(params, x, gen)
        lap("swap")
        inc, mstats, snaps = ex.measure(params, x, gen)
        inc, _ = M.mean_over_chains(inc, snaps, mstats["flag"])
        for group, vals in container.items():
            for k, a in vals.items():
                a.add_(inc[group][k])
        lap("measurement")
        box["state"] = HMCState(x=x, v=state.v)
        box["update_s"], box["parts"] = parts["update"], parts
        return stats.iters

    def replays():
        out = {}
        for name in ("step", "reflect", "swap", "measure"):
            fn = getattr(getattr(ex, name), "workspace", None)
            ws = fn() if fn is not None else None
            out[name] = ws.graphs.replays if ws is not None and ws.graphs is not None else 0
        return out

    def bin_once():
        """One bin of the file's size: post-processing and the text files."""
        if "bin_s" not in box:
            sp = ex.setup.sim_params
            with tempfile.TemporaryDirectory() as folder:
                out_io.init_measurement_folders(folder, container, mspec.snapshots)
                out_io.write_key_files(folder, ex.ops, mspec, container)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                processed = _host_tree(M.process_bin(ex.ops, mspec, container, sp.bin_size))
                out_io.write_bin(folder, processed, 1, ex.ops)
                box["bin_s"] = (time.perf_counter() - t0, sp.bin_size)
        return box["bin_s"]

    box["replays"], box["bin"] = replays, bin_once
    return run, box


if __name__ == "__main__":
    sys.exit(main())
