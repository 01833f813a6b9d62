"""Time SSH's fermionic-force walk (``muldMdx``) and one HMC update at the
64×64 configurations' shapes on the card, for one checkout of the port.

    python scripts/ssh_force_ab.py [--root DIR] [--reps 50]

``--root DIR`` imports ``elphdynamics_tpu_torch`` from DIR (another
checkout, e.g. a parent commit unpacked with ``git archive``) instead of
this one; run the two checkouts in one call, in turns (A, B, B, A), to
compare them on one card. Prints one JSON line per configuration
(``SSH_64X64``, ``SSH_TWISTED_64X64``; float32, 8 chains): device ms per
``muldMdx`` call (CUDA events around ``--reps`` calls after 3 warm-up
calls) on x ``[8, Nph, 40]`` and u, v ``[8, N, 40]`` as the force passes
them, a checksum of its output, and seconds per update (1 warm-up and 2
timed updates at trajectory 0.1), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from elphdynamics_tpu_torch import bench

    if not torch.cuda.is_available():
        print("ssh_force_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    for cfg in (bench.SSH_64X64, bench.SSH_TWISTED_64X64):
        b = bench.build(cfg, "cuda", torch.float32, trajectory_time=0.1)
        ops, params, x = b.ops, b.params, b.state.x
        g = torch.Generator(device="cuda").manual_seed(3)
        shape = (x.shape[0], ops.Nsites, ops.Ltau)
        u = torch.randn(shape, generator=g, device="cuda")
        v = torch.randn(shape, generator=g, device="cuda")
        derived = ops.derived(params, x)
        for _ in range(3):
            out = ops.muldMdx(params, derived, x, u, v)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            out = ops.muldMdx(params, derived, x, u, v)
        t1.record()
        torch.cuda.synchronize()
        force_ms = t0.elapsed_time(t1) / args.reps
        state, _ = b.step(b.params, b.state, b.generator)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(2):
            state, stats = b.step(b.params, state, b.generator)
        torch.cuda.synchronize()
        print(json.dumps({
            "config": cfg.name, "root": os.path.abspath(args.root), "card": card.strip(),
            "muldMdx_ms": force_ms, "checksum": float(out.double().abs().sum()),
            "update_s": (time.perf_counter() - start) / 2,
            "finite": bool(torch.isfinite(state.x).all()),
            "max_flag": int(stats.flag.max())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
