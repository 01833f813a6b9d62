"""``[solver] loop_precision`` on the card: "high" against "highest".

The bench's Holstein update (β = 4, Δτ = 0.1, dt = 0.05, Nb = 4, tol
1e-5, cubic warm starts, KPM max_order 4, float32) at 8×8 (128 chains,
N = 64) and 32×32 (32 chains, N = 1024), both on the dense branch, where
"high" runs the in-loop MᵀM as three bf16 products accumulated in float32
(``models/holstein.bf16_matmul``) and "highest" in float32. Per
configuration: one warm-up update of each, then timed blocks of
``--updates`` updates in the order high, highest, highest, high (repeated
``--rounds`` times), every block from the same state and seed, so the two
precisions see the same draws. For each block: sweeps/s, acceptance,
mean |ΔH|, CG iterations per solve, the largest flag and the systems
retried by the unpreconditioned ladder; and the relative error of one
in-loop exp(−Δτ·K) apply and one MᵀM apply against float64, for both
precisions.

    python scripts/loop_precision_ab.py [--updates 3] [--rounds 2]

Needs a CUDA card (~1 min on an H100). Writes
``chiprun_out/loop_precision_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from elphdynamics_tpu_torch import solvers  # noqa: E402
from elphdynamics_tpu_torch.bench import build_bench_step  # noqa: E402
from elphdynamics_tpu_torch.dynamics.hmc import make_hmc_step  # noqa: E402
from elphdynamics_tpu_torch.models import holstein as Hm  # noqa: E402
from elphdynamics_tpu_torch.ops import kpm  # noqa: E402

CONFIGS = (("bench_8x8", 8, 128), ("dense_32x32", 32, 32))
PRECISIONS = ("high", "highest")


def apply_errors(b) -> dict:
    """Relative error (max |·−exact| over max |exact|) of one exp(−Δτ·K)
    apply and one MᵀM apply at each precision, against float64."""
    spec, p, ops = b.ops.spec, b.params, b.ops
    g = torch.Generator(device="cuda").manual_seed(9)
    C, N, L = b.state.x.shape
    y = torch.randn((C, 2, N, L), generator=g, device="cuda")
    env = ops.stack(ops.derived(p, b.state.x))
    exact_k = torch.matmul(p.expK.double(), y.double())
    exact_m = Hm.mulMTM(spec, replace(p, expK=p.expK.double()), env.double(), y.double())
    out = {}
    for prec in PRECISIONS:
        k = Hm.apply_expK(spec, p, y, prec)
        m = ops.mulMTM(p, env, y, precision=prec)
        out[prec] = dict(
            expK=float((k.double() - exact_k).abs().max() / exact_k.abs().max()),
            MTM=float((m.double() - exact_m).abs().max() / exact_m.abs().max()),
            dtype=str(k.dtype))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    retried = [0]
    cg = solvers.cg

    def counting_cg(*a, **k):
        if k.get("active0") is not None:
            retried[0] += int(k["active0"].sum())
        return cg(*a, **k)

    solvers.cg = counting_cg
    result = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, configs={})
    for name, L, chains in CONFIGS:
        b = build_bench_step(L, 4.0, 0.1, 0.05, chains, "cuda", torch.float32)
        assert b.ops.spec.dense_ckb
        pre = kpm.make_precond(b.ops, b.kpm_cfg)
        steps = {prec: make_hmc_step(b.ops, b.mass, replace(b.hmc_cfg, loop_precision=prec),
                                     pre) for prec in PRECISIONS}
        start, _ = steps["highest"](b.params, b.state, torch.Generator("cuda").manual_seed(1))
        for prec in PRECISIONS:   # warm-up
            steps[prec](b.params, start, torch.Generator("cuda").manual_seed(2))
        blocks = []
        for _ in range(args.rounds):
            for prec in ("high", "highest", "highest", "high"):
                g = torch.Generator("cuda").manual_seed(3)
                state, rows = start, []
                retried[0] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.updates):
                    state, stats = steps[prec](b.params, state, g)
                    rows.append(stats)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                acc = torch.stack([s.accepted for s in rows]).double()
                dH = torch.stack([s.delta_H for s in rows]).double()
                it = torch.stack([s.iters for s in rows]).double()
                fl = torch.stack([s.flag for s in rows])
                blocks.append(dict(precision=prec, seconds=dt,
                                   sweeps_per_s=chains * args.updates / dt,
                                   acceptance=float(acc.mean()),
                                   mean_abs_dH=float(dH.abs().mean()),
                                   cg_iters_per_solve=float(it.mean()), max_flag=int(fl.max()),
                                   retried_systems=retried[0]))
                print(name, json.dumps(blocks[-1]), flush=True)
        summary = {}
        for prec in PRECISIONS:
            mine = [r for r in blocks if r["precision"] == prec]
            summary[prec] = {k: sum(r[k] for r in mine) / len(mine)
                             for k in ("sweeps_per_s", "acceptance", "mean_abs_dH",
                                       "cg_iters_per_solve")}
            summary[prec]["max_flag"] = max(r["max_flag"] for r in mine)
            summary[prec]["retried_systems"] = sum(r["retried_systems"] for r in mine)
        result["configs"][name] = dict(L=L, chains=chains, N=b.ops.Nsites, blocks=blocks,
                                       mean=summary, apply_error=apply_errors(b))
        print(name, json.dumps(result["configs"][name]["mean"]),
              json.dumps(result["configs"][name]["apply_error"]), flush=True)
    solvers.cg = cg
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "loop_precision_ab.json"), "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
