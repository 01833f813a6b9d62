"""The HMC mass operator in float64 against the field dtype, on the card.

This tree applies the Fourier-acceleration mass operator of HMC
(``dynamics/hmc.py`` ``make_hmc_step``: the kinetic energy, the momentum
refresh and the accelerations) in float64 for every field; a checkout
that applies it in the field dtype (the commit before that change) is
given as ``--parent``. The parent's ``[solver] loop_precision`` is
accepted and runs full precision; this tree's default "high" runs the
dense in-loop MᵀM as bf16×3, so the change runs twice: at "highest"
(the mass operator alone against the parent) and at "high" (the tree as
shipped). Bench 8×8 (128 chains, dense branch) and ``KERNEL_64X64`` (16
chains, fold branch, where the knob changes nothing) run in float32, each
block in a fresh process, in the order parent, highest, high, high,
highest, parent (``--rounds`` times). Per block and configuration: one
warm-up update, then ``--updates`` timed updates from the configuration's
seed: sweeps/s, acceptance, mean |ΔH|, CG iterations per solve and the
largest flag. Each block also counts the mass-operator applies of its
warm-up update and times one apply on the configuration's field both
ways (float32; float64 with its two casts), ``--reps`` times after a
warm-up, so that the float64 form's cost per update stands beside the
update's own time.

    mkdir -p _archive/parent && git archive <parent> | tar -x -C _archive/parent
    python scripts/mass_precision_ab.py --parent _archive/parent [--rounds 2]

Needs a CUDA card (~5 min on an H100 at 2 rounds). Writes
``chiprun_out/mass_precision_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("BENCH_8X8", "KERNEL_64X64")


def worker(root: str, updates: int, precision: str | None, reps: int) -> dict:
    """Time every configuration with the package of checkout ``root``,
    with ``precision`` as ``loop_precision`` when given."""
    sys.path.insert(0, root)
    from dataclasses import replace

    import torch

    import elphdynamics_tpu_torch
    from elphdynamics_tpu_torch import bench
    from elphdynamics_tpu_torch.dynamics.hmc import make_hmc_step
    from elphdynamics_tpu_torch.ops import fourier_accel, kpm

    here = os.path.dirname(os.path.abspath(elphdynamics_tpu_torch.__file__))
    assert here.startswith(os.path.abspath(root)), here
    Mop = fourier_accel.MassOperator
    plain_apply, applies = Mop.apply, [0]

    def counting_apply(self, v, power):
        applies[0] += 1
        return plain_apply(self, v, power)

    out = {}
    for name in CONFIGS:
        cfg = getattr(bench, name)
        b = bench.build(cfg, "cuda", torch.float32)
        if precision is not None:
            b = replace(b, step=make_hmc_step(
                b.ops, b.mass, replace(b.hmc_cfg, loop_precision=precision),
                kpm.make_precond(b.ops, b.kpm_cfg)))
        Mop.apply = counting_apply
        state, _ = b.step(b.params, b.state, b.generator)   # warm-up
        Mop.apply, n_applies, applies[0] = plain_apply, applies[0], 0
        torch.cuda.synchronize()
        rows = []
        t0 = time.perf_counter()
        for _ in range(updates):
            state, stats = b.step(b.params, state, b.generator)
            rows.append(stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        acc = torch.stack([s.accepted for s in rows]).double()
        dH = torch.stack([s.delta_H for s in rows]).double()
        it = torch.stack([s.iters for s in rows]).double()
        fl = torch.stack([s.flag for s in rows])
        out[name] = dict(seconds=dt, sweeps_per_s=cfg.n_chains * updates / dt,
                         acceptance=float(acc.mean()), mean_abs_dH=float(dH.abs().mean()),
                         cg_iters_per_solve=float(it.mean()), max_flag=int(fl.max()),
                         mass_applies_per_update=n_applies,
                         **apply_seconds(Mop, b.mass, state.x, reps))
        o = out[name]
        # the float64 form's added seconds per update over an update's seconds
        o["float64_mass_share"] = (n_applies * (o["apply_s_float64"] - o["apply_s_float32"])
                                   / (dt / updates))
    return out


def apply_seconds(Mop, table, x, reps: int) -> dict:
    """Seconds of one M⁻¹ apply on ``x``: in float32, and in float64 with
    the casts to and from it (wall time over ``reps`` applies after ten,
    launch overhead included)."""
    import torch

    out = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        op = Mop(table, (-1.0,), x.device, dtype)
        for n in range(10 + reps):
            if n == 10:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            op.apply(x.to(dtype), -1.0).to(x.dtype)
        torch.cuda.synchronize()
        out[f"apply_s_{name}"] = (time.perf_counter() - t0) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout whose mass operator runs in the field dtype")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--updates", type=int, default=3)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--loop-precision", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        out = worker(args.worker, args.updates, args.loop_precision, args.reps)
        print("RESULT " + json.dumps(out), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = {"parent": (os.path.abspath(args.parent), []),
            "change_highest": (ROOT, ["--loop-precision", "highest"]),
            "change_high": (ROOT, [])}
    blocks = []
    for _ in range(args.rounds):
        for label in ("parent", "change_highest", "change_high", "change_high",
                      "change_highest", "parent"):
            root, extra = runs[label]
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                                   "--updates", str(args.updates), *extra],
                                  capture_output=True, text=True, cwd=root)
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode or not line:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"{label} block failed (exit {proc.returncode})")
            blocks.append(dict(label=label, **json.loads(line[0][len("RESULT "):])))
            print(label, json.dumps(blocks[-1]), flush=True)
    summary = {}
    for name in CONFIGS:
        for label in runs:
            mine = [b[name] for b in blocks if b["label"] == label]
            rates = [r["sweeps_per_s"] for r in mine]
            summary[f"{name}/{label}"] = dict(
                sweeps_per_s_median=statistics.median(rates), sweeps_per_s_min=min(rates),
                sweeps_per_s_max=max(rates),
                **{k: statistics.mean(r[k] for r in mine)
                   for k in ("acceptance", "mean_abs_dH", "cg_iters_per_solve",
                             "mass_applies_per_update", "apply_s_float32",
                             "apply_s_float64", "float64_mass_share")},
                max_flag=max(r["max_flag"] for r in mine))
        for label in ("change_highest", "change_high"):
            summary[f"{name}/{label}_over_parent"] = (
                summary[f"{name}/{label}"]["sweeps_per_s_median"]
                / summary[f"{name}/parent"]["sweeps_per_s_median"])
        print(name, json.dumps({k: v for k, v in summary.items() if k.startswith(name)}),
              flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mass_precision_ab.json"), "w") as f:
        json.dump(dict(card=card, blocks=blocks, summary=summary), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
