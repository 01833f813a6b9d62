"""Command-line entry point, the counterpart of ``python -m elphdynamics_tpu``:

    python -m elphdynamics_tpu_torch input.toml [run_id] [--chains N] [--x64]
                                     [--device {cuda,cpu}] [--profile DIR]
                                     [--devices N] [--site-devices N] [--multihost]

The run uses a CUDA card by default (the command fails when none is
available), or the CPU with ``--device cpu``. Fields are float32 unless
``--x64``. The input file chooses the sampler (``[hmc]`` or
``[langevin]``) and the solver (``[solver] type`` CG, BiCGStab or GMRES;
``block = true`` for block CG over systems that share an operator).
``--chains 0`` takes the measured per-card chain count
(``simulation.auto_chains``). ``--profile DIR`` runs the simulation under
``torch.profiler`` (CPU and, on the card, CUDA activity) and writes its
Chrome trace to ``DIR/trace.json``.

Several ranks, one process each: ``--devices N`` shards the chains over N
ranks, ``--site-devices N`` the lattice (Holstein or SSH), and both
together make the 2-D layout of N₁ × N₂ ranks. The command spawns the
ranks itself, joined by NCCL with one card each (it fails when
the host has fewer cards than ranks) or, with ``--device cpu``, by gloo on
the CPU. With ``--multihost`` it spawns nothing: every process is one rank,
started by ``torchrun`` (or a launcher that sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``), and the ranks meet
through ``env://``. Under ``--site-devices`` the near-null preconditioner,
the 2MN integrator and BiCGStab / GMRES raise ``NotImplementedError`` before
any rank starts (the JAX package does not run them sharded).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="elphdynamics_tpu_torch")
    ap.add_argument("input", help="TOML input file (the JAX package's schema; [hmc] or [langevin])")
    ap.add_argument("run_id", nargs="?", type=int, default=None,
                    help="datafolder suffix id (auto-incremented if omitted)")
    ap.add_argument("--chains", type=int, default=1,
                    help="independent Markov chains (0: the measured per-card count)")
    ap.add_argument("--x64", action="store_true", help="float64 fields (default float32)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run executes (default: the CUDA card)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to shard the chains over (one card each on CUDA)")
    ap.add_argument("--site-devices", type=int, default=1,
                    help="ranks to shard one chain's lattice over (with --devices: "
                         "the 2-D chain x site layout)")
    ap.add_argument("--multihost", action="store_true",
                    help="this process is one rank of a launcher-started run (env://)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the whole run to DIR/trace.json")
    args = ap.parse_args(argv)

    import torch

    from elphdynamics_tpu_torch.io.config import load_toml
    from elphdynamics_tpu_torch.parallel import multihost
    from elphdynamics_tpu_torch.simulation import check_parallel, run_rank

    check_parallel(load_toml(args.input), args.devices, args.site_devices)
    world = args.devices * args.site_devices
    if args.device == "cuda" and not torch.cuda.is_available():
        print("elphdynamics_tpu_torch: no CUDA device is available; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    backend = multihost.backend_for(args.device)
    kw = dict(config=args.input, run_id=args.run_id, n_chains=args.chains,
              dtype=torch.float64 if args.x64 else torch.float32, n_devices=args.devices,
              site_devices=args.site_devices)
    if args.multihost:
        multihost.init_from_env(backend)
        if multihost.world() != world:
            print(f"elphdynamics_tpu_torch: the launcher started {multihost.world()} ranks, "
                  f"--devices x --site-devices asks for {world}", file=sys.stderr)
            return 2
        stats = run_rank(multihost.rank_device(args.device), kw, args.profile)
        if multihost.is_primary():
            print(stats)
        return 0
    if world == 1:
        print(run_rank(torch.device(args.device), kw, args.profile))
        return 0
    if args.device == "cuda" and torch.cuda.device_count() < world:
        print(f"elphdynamics_tpu_torch: {world} ranks need {world} CUDA devices (one per "
              f"rank), this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # CPU ranks share the host's cores instead of each taking all of them
    threads = max(1, (os.cpu_count() or 1) // world) if args.device == "cpu" else None
    stats = multihost.launch(run_rank, world, backend, args.device, (kw, args.profile),
                             threads=threads)
    print(stats[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
