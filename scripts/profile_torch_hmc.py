"""Profile one update, or one measurement, of the PyTorch port on a CUDA
card.

    python scripts/profile_torch_hmc.py CONFIG [--eager] [--timed N] [--no-profile]
                                               [--trace DIR] [--chains N]
                                               [--blocks K,K,...]

with CONFIG one of bench_8x8, bench_32x32, kernel_64x64, ssh_8x8,
ssh_64x64, twisted_64x64, ssh_twisted_64x64, kernel_2mn_64x64,
tempering_64x64, gmres_update_64x64, bicgstab_64x64, langevin_64x64,
ssh_langevin_64x64, twisted_langevin_64x64, gmres_langevin_64x64, gmres_64x64,
measure_64x64, measure_ssh_64x64,
measure_bond_64x64, driver_4x4, driver_ssh_4x4, driver_64x64,
driver_ssh_64x64, driver_twisted_4x4, driver_ssh_twisted_4x4,
driver_twisted_64x64, driver_ssh_twisted_64x64, driver_deep_beta_8x8,
driver_langevin_4x4;
``--eager`` runs the eager update of an HMC configuration, the eager
Langevin step, the eager GMRES solve or a driver step with every part eager
(update, reflection, swap, measurement) in place of its CUDA graphs
(``dynamics/graphs.py``; real and complex hopping alike).
``--timed N`` times N more runs after the warm-up, without the profiler
(host clock, each run ended by a synchronisation), and for an HMC driver
step each part apart (``parts``: the update, the reflection and swap
calls, the measurement, and its chain mean and container add as the
driver makes them (``accumulate``), each ended by a synchronisation),
then one bin's post-processing and text files (``bin_s``, written to a
temporary folder, with the file's updates per bin); ``--no-profile``
stops there (the profiler's cost per recorded event makes an eager stock
SSH step take many minutes). A driver step's
timed line also gives the peak allocated and reserved device memory of
the process and each graphed part's pool; a step that runs out of device
memory prints the error on a ``[CONFIG] out_of_memory`` line and exits 1.

``--chains N`` sets a driver step's chains (default 1, and 4 at 64×64;
0: the driver's ``--chains 0`` count, ``simulation.auto_chains``).
``--blocks K,K,...`` times a driver step's measurement alone instead, its
estimators in blocks of K chains (0: as the driver sizes them,
``measurements.analyze_chains``; ``all``: one block of every chain): one
step per K built side by side in one process from the same seed, a
warm-up call of each, then ``--timed`` interleaved rounds (each round
calls every K once, the order reversed every other round, each call ended
by a synchronisation). Prints, per K, the seconds per call (median and
quartiles), the graph pool, how far its results are from the first K's
(the largest difference, each result's over its largest magnitude; 0: bit
for bit), and the process's peak allocated memory; a K that runs out of
memory is reported and dropped.

``bench_8x8``, ``bench_32x32``, ``kernel_64x64``, ``ssh_8x8`` (the optical
SSH model, 64 chains, dense Ā) and ``ssh_64x64`` (8 chains) are the HMC
updates of ``bench.py``, ``twisted_64x64`` and ``ssh_twisted_64x64`` its
twisted-boundary (complex hopping) updates, ``kernel_2mn_64x64`` its 2MN
update and ``tempering_64x64`` its laddered update (per-chain couplings;
the exchange: ``tools/profile_torch_deep.py tempering_64x64``); ``langevin_64x64``,
``ssh_langevin_64x64`` and ``twisted_langevin_64x64`` one Runge-Kutta
Langevin step of its Langevin configurations; ``gmres_update_64x64`` and
``bicgstab_64x64`` the updates of ``bench.GMRES_64X64`` and
``BICGSTAB_64X64`` (each (MᵀM)⁻¹ by Mᵀ then M), ``gmres_langevin_64x64`` the
RK step of ``GMRES_LANGEVIN_64X64``; ``gmres_64x64`` one GMRES solve of
M·z = r for nᵥ = 10 probes per chain on the ``langevin_64x64`` model (the
left KPM apply), graphed (``--eager``: the eager solve);
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
64, β = 4, 4 chains, nᵥ = 10); ``driver_twisted_4x4``,
``driver_ssh_twisted_4x4``, ``driver_twisted_64x64`` and
``driver_ssh_twisted_64x64`` the same for ``examples/holstein_hmc_twisted.toml``
and ``ssh_hmc_twisted.toml`` (complex hopping; the files configure no
moves, so a step is the update and the measurement);
``driver_deep_beta_8x8`` the same for ``examples/holstein_hmc_deep_beta.toml``
(8×8, β = 16, Lτ = 160, nᵥ = 20); ``driver_langevin_4x4`` one
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
from elphdynamics_tpu_torch.ops import ckb_cuda  # noqa: E402


HMC_CONFIGS = {"bench_8x8": bench.BENCH_8X8, "bench_32x32": bench.BENCH_32X32,
               "kernel_64x64": bench.KERNEL_64X64, "ssh_8x8": bench.SSH_8X8,
               "ssh_64x64": bench.SSH_64X64,
               "twisted_64x64": bench.TWISTED_64X64,
               "ssh_twisted_64x64": bench.SSH_TWISTED_64X64,
               "kernel_2mn_64x64": bench.KERNEL_2MN_64X64,
               "tempering_64x64": bench.TEMPERING_64X64,
               # bench.GMRES_64X64's update (the case gmres_64x64 is a probe solve)
               "gmres_update_64x64": bench.GMRES_64X64,
               "bicgstab_64x64": bench.BICGSTAB_64X64}
LANGEVIN_CONFIGS = {"langevin_64x64": bench.LANGEVIN_64X64,
                    "ssh_langevin_64x64": bench.SSH_LANGEVIN_64X64,
                    "twisted_langevin_64x64": bench.TWISTED_LANGEVIN_64X64,
                    "gmres_langevin_64x64": bench.GMRES_LANGEVIN_64X64}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config",
                    choices=[*HMC_CONFIGS, *LANGEVIN_CONFIGS, "gmres_64x64",
                             "measure_64x64", "measure_ssh_64x64", "measure_bond_64x64",
                             "driver_4x4", "driver_ssh_4x4", "driver_64x64",
                             "driver_ssh_64x64", "driver_twisted_4x4",
                             "driver_ssh_twisted_4x4", "driver_twisted_64x64",
                             "driver_ssh_twisted_64x64", "driver_deep_beta_8x8",
                             "driver_langevin_4x4"])
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    ap.add_argument("--eager", action="store_true",
                    help="the eager update in place of the CUDA graphs")
    ap.add_argument("--timed", type=int, default=0,
                    help="runs timed without the profiler after the warm-up")
    ap.add_argument("--no-profile", action="store_true",
                    help="no profiled run after the timed ones")
    ap.add_argument("--chains", type=int, default=None,
                    help="a driver step's chains (0: the driver's --chains 0 count)")
    ap.add_argument("--blocks", default=None,
                    help="time a driver step's measurement with its estimators in blocks "
                         "of K chains, K,K,... (0: as the driver sizes them; all: one block)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_hmc: no CUDA device", file=sys.stderr)
        return 1
    if args.eager and args.config.startswith("measure"):
        ap.error("--eager takes an HMC configuration, a Langevin step, the GMRES solve or a "
                 "driver step")
    hmc_driver = args.config.startswith("driver") and args.config != "driver_langevin_4x4"
    if (args.chains is not None or args.blocks) and not hmc_driver:
        ap.error("--chains and --blocks take an HMC driver step")
    if args.blocks and args.timed < 2:
        ap.error("--blocks needs --timed 2 or more rounds")
    example = (("holstein_hmc_deep_beta" if "deep_beta" in args.config else
                f"{'ssh' if 'ssh' in args.config else 'holstein'}_hmc_"
                f"{'twisted' if 'twisted' in args.config else 'square'}") if hmc_driver else None)
    wide = "64x64" in args.config
    chains = args.chains if args.chains is not None else (4 if wide else 1)
    if args.blocks:
        return _measure_blocks(args.config, example, wide, chains, args.blocks, args.timed)
    try:
        return _profile(args, example, wide, chains)
    except torch.OutOfMemoryError as e:
        print(f"[{args.config}] out_of_memory chains={chains} "
              f"peak_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"error={str(e).splitlines()[0]!r}", flush=True)
        return 1


def _profile(args, example, wide: bool, chains: int) -> int:
    """Build ``args.config``, warm it up, time it and profile it (module
    docstring)."""
    graphable = None    # the step that may replay CUDA graphs
    box = {}
    if args.config.startswith("measure"):
        run = _measurement(ssh="ssh" in args.config, bond="bond" in args.config)
    elif args.config == "driver_langevin_4x4":
        run, box = _langevin_step(bench.build_langevin_example(
            str(Path(__file__).resolve().parent.parent / "examples"
                / "holstein_langevin_square.toml"), 1, "cuda", torch.float32), args.eager)
        graphable = box["step"]
    elif example is not None:
        run, box = _driver_step(example, args.eager, wide, chains)
        graphable = box["step"]
    elif args.config == "gmres_64x64":
        run, graphable = _gmres_solve(args.eager)
    elif args.config in LANGEVIN_CONFIGS:
        run, box = _langevin_step(bench.build(LANGEVIN_CONFIGS[args.config], "cuda",
                                              torch.float32), args.eager)
        graphable = box["step"]
    else:
        cfg = HMC_CONFIGS[args.config]
        b = bench.build(cfg, "cuda", torch.float32)
        if args.eager:
            b = replace(b, step=b.eager())
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
        print(f"[{args.config}] eager={args.eager} chains={box['chains']} "
              f"first_parts_s={_rounded(first_parts)} "
              f"parts_s={[_rounded(p) for p in parts]} bin_s={box['bin']()[0]:.4f} "
              f"updates_per_bin={box['bin']()[1]} replays={box['replays']()} "
              f"peak_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"peak_reserved_gb={torch.cuda.max_memory_reserved() / 1e9:.3f} "
              f"pool_gb={box['pools']()}", flush=True)
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


def _gmres_solve(eager: bool):
    """One GMRES solve (restart 20, tol 1e-5) of nᵥ = 10 probes per chain on
    the Langevin 64×64 model, preconditioned by the left KPM apply: its
    graphs (``dynamics/graphs.NonsymSolve``: a start, each cycle's start,
    blocks of Arnoldi steps and close, the verification; the first call
    captures them) or with ``eager`` the eager solve; and an object whose
    ``workspace()`` is the graphed solve's workspace (None eager)."""
    from types import SimpleNamespace

    from elphdynamics_tpu_torch.dynamics import graphs
    from elphdynamics_tpu_torch.dynamics.solve import (
        SolverConfig, precond_applies, precond_state, solve_minv)

    b = bench.build(bench.LANGEVIN_64X64, "cuda", torch.float32)
    R = torch.randn((b.x.shape[0], 10, b.ops.Nsites, b.ops.Ltau), device="cuda",
                    generator=b.generator)
    derived = b.ops.derived(b.params, b.x)
    pstate = precond_state(b.precond, b.params, b.x)
    scfg = SolverConfig(tol=1e-5, maxiter=500, kind="gmres", restart=20)
    if eager:
        ds, pa = b.ops.stack(derived), precond_applies(b.precond, pstate)
        return (lambda: solve_minv(b.ops, b.params, ds, R, scfg, pa).iters,
                SimpleNamespace(workspace=lambda: None))
    solve = graphs.make_solve(b.ops, b.precond, scfg, rhs="R", stacked=True)
    ws = graphs.step_workspace({}, b.params, b.x)
    ws.put("env", derived)
    ws.put("R", R)
    ws.load("kpm", pstate)

    def run():
        ws.capture_once(lambda: [("probe_start", lambda: solve.start(ws, scfg.tol)),
                                 *solve.segments(ws, scfg.tol)])
        ws.run("probe_start", lambda: solve.start(ws, scfg.tol))
        solve.solve(ws, scfg.tol)
        return solve.result(ws)[1]

    return run, SimpleNamespace(workspace=lambda: ws)


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


def _driver_example(example: str, wide: bool, chains: int, **kw):
    """The stock ``[hmc]`` example's driver step (``wide``: at 64×64) on
    ``chains`` chains (0: the driver's ``--chains 0`` count) in float32."""
    from elphdynamics_tpu_torch.io.config import load_toml

    cfg = load_toml(str(Path(__file__).resolve().parent.parent / "examples"
                        / f"{example}.toml"))
    if wide:
        cfg = bench.wide_hmc_config(cfg)
    return bench.build_hmc_example(cfg, chains, "cuda", torch.float32, **kw)


def _driver_step(example: str, eager: bool, wide: bool, chains: int):
    """One sampling step of the driver on a stock example (``wide``: at
    64×64) on ``chains`` chains with every part eager with ``eager``, and a
    box that keeps the step's parts' seconds (host clock, each ended by a
    synchronisation), the graph replays and pools of each part so far and a
    timer of one bin's post-processing and text files."""
    import tempfile

    from elphdynamics_tpu_torch.dynamics.hmc import HMCState
    from elphdynamics_tpu_torch.io import output as out_io
    from elphdynamics_tpu_torch.measure import measurements as M
    from elphdynamics_tpu_torch.simulation import _host_tree

    ex = _driver_example(example, wide, chains, eager=eager)
    params, gen, mspec = ex.params, ex.generator, ex.setup.mspec
    container = M.zero_container(ex.ops, mspec, torch.float32, "cuda")
    box = {"state": ex.state, "step": ex.step, "chains": ex.state.x.shape[0]}

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
        lap("measurement")
        # the driver's chain mean and bin accumulation (simulation._run)
        inc, _ = M.mean_over_chains(inc, snaps, mstats["flag"])
        for group, vals in container.items():
            for k, a in vals.items():
                a.add_(inc[group][k])
        lap("accumulate")
        box["state"] = HMCState(x=x, v=state.v)
        box["update_s"], box["parts"] = parts["update"], parts
        return stats.iters

    def graph_sets():
        for name in ("step", "reflect", "swap", "measure"):
            fn = getattr(getattr(ex, name), "workspace", None)
            ws = fn() if fn is not None else None
            yield name, ws.graphs if ws is not None else None

    def replays():
        return {name: g.replays if g is not None else 0 for name, g in graph_sets()}

    def pools():
        return {name: round(g.pool_bytes / 1e9, 3) for name, g in graph_sets() if g is not None}

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

    box["replays"], box["pools"], box["bin"] = replays, pools, bin_once
    return run, box


def _measure_blocks(config: str, example: str, wide: bool, chains: int, blocks: str,
                    rounds: int) -> int:
    """Seconds per graphed measurement of a driver step with its estimators
    in blocks of each K of ``blocks`` (module docstring)."""
    import statistics

    from elphdynamics_tpu_torch.measure import measurements as M

    ex = _driver_example(example, wide, chains)
    n, shape = ex.state.x.shape[0], (ex.setup.mspec.nv, ex.ops.Nsites, ex.ops.Ltau)
    del ex
    steps, secs, results = {}, {}, {}
    for k in blocks.split(","):
        block = n if k == "all" else int(k) or M.analyze_chains(n, *shape, torch.float32)
        try:
            ex = _driver_example(example, wide, n, chain_block=block)
            results[k] = ex.measure(ex.params, ex.state.x, ex.generator)   # warm-up, capture
            torch.cuda.synchronize()
        except torch.OutOfMemoryError as e:
            print(f"[{config}] blocks={k} chains={n} chains_per_block={block} out_of_memory "
                  f"error={str(e).splitlines()[0]!r}", flush=True)
            ex = None
            torch.cuda.empty_cache()
            continue
        steps[k], secs[k] = (ex, block), []
    first = next(iter(results), None)
    for r in range(rounds):
        for k in (list(steps) if r % 2 == 0 else list(steps)[::-1]):
            ex = steps[k][0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.measure(ex.params, ex.state.x, ex.generator)
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)

    def leaves(a):
        if isinstance(a, dict):
            for k in sorted(a):
                yield from leaves(a[k])
        elif isinstance(a, (tuple, list)):
            for v in a:
                yield from leaves(v)
        else:
            yield a.double()

    def rel_diff(a, b) -> float:
        """The largest difference, each result's over its largest magnitude."""
        return max(((u - v).abs().max() / max(float(v.abs().max()), 1e-300)).item()
                   for u, v in zip(leaves(a), leaves(b)))

    for k, (ex, block) in steps.items():
        q1, med, q3 = statistics.quantiles(secs[k], n=4, method="inclusive")
        ws = ex.measure.workspace()
        graphs = ws.graphs if ws is not None else None
        print(f"[{config}] device={torch.cuda.get_device_name(0)!r} chains={n} "
              f"blocks={k} chains_per_block={block} median_s={med:.4f} q1_s={q1:.4f} "
              f"q3_s={q3:.4f} calls_s={[round(t, 4) for t in secs[k]]} "
              f"pool_gb={graphs.pool_bytes / 1e9 if graphs is not None else 0.0:.3f} "
              f"rel_diff_vs_{first}={rel_diff(results[k], results[first]):.3e}", flush=True)
    print(f"[{config}] peak_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.3f}",
          flush=True)
    return 0 if steps else 1


if __name__ == "__main__":
    sys.exit(main())
