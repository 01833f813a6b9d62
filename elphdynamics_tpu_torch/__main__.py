"""Command-line entry point, the counterpart of ``python -m elphdynamics_tpu``:

    python -m elphdynamics_tpu_torch input.toml [run_id] [--chains N] [--x64]
                                     [--device {cuda,cpu}] [--profile DIR]

The run uses one device: a CUDA card by default (the command fails when
none is available), or the CPU with ``--device cpu``. Fields are float32
unless ``--x64``. The input file chooses the sampler (``[hmc]`` or
``[langevin]``) and the solver (``[solver] type`` CG, BiCGStab or GMRES;
``block = true`` for block CG over systems that share an operator).
``--profile DIR`` runs the simulation under ``torch.profiler`` (CPU and, on
the card, CUDA activity) and writes its Chrome trace to
``DIR/trace.json``.
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
                    help="independent Markov chains batched on the device")
    ap.add_argument("--x64", action="store_true", help="float64 fields (default float32)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run executes (default: the CUDA card)")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices to shard the chains over (only 1 is ported)")
    ap.add_argument("--site-devices", type=int, default=1,
                    help="devices to shard one chain's lattice over (only 1 is ported)")
    ap.add_argument("--multihost", action="store_true",
                    help="a run over several hosts (not ported)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the whole run to DIR/trace.json")
    args = ap.parse_args(argv)

    if args.devices != 1 or args.site_devices != 1 or args.multihost:
        raise NotImplementedError("--devices / --site-devices / --multihost "
                                  "(multi-GPU runs): ROADMAP slice H")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("elphdynamics_tpu_torch: no CUDA device is available; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    from elphdynamics_tpu_torch.simulation import simulate

    def run():
        return simulate(args.input, run_id=args.run_id, n_chains=args.chains,
                        device=args.device, dtype=torch.float64 if args.x64 else torch.float32)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=acts) as prof:
            stats = run()
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        stats = run()
    print(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
