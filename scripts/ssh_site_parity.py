"""Where a site-sharded SSH driver run parts from the one-rank run.

Runs ``examples/ssh_hmc_square.toml`` with the settings of
``chip_smoke.py`` phase (f) (seed 17, trajectory 0.05, nᵥ 4, KPM
``max_order`` 8, 2 bins, float64; ``--burnin`` and ``--updates`` set the
depth, 0 + 2 by default) on one rank in this process and on 2 gloo site
ranks, with every solve recorded in order: each CG call (its iterations
per system, whether it converged, its true residual ‖b − A·x‖/‖b‖ with
the loop's operator, whether it is a retry) and each checked solve (the
verified residual, flag, ‖x‖²). The two records are compared entry by
entry; the first entry whose iterations differ, or whose ‖x‖² differs by
more than 1e-12 relative, names the solve where the runs part. Then every
bin array's largest difference.

    python scripts/ssh_site_parity.py [--device cpu] [--burnin 0] [--updates 2]
        [--seed 17] [--perturb]

Writes ``chiprun_out/ssh_site_parity/<device>_<burnin>_<updates>_<seed>[_perturb].json``.
On the card (~1 min, the kernels' build included) the one-rank run folds
with the CUDA kernel K1 and the site ranks with the plain halo fold; on the
CPU both fold in plain torch. ``--perturb`` (CPU) compares the one-rank
run with a second one-rank run whose every plain fold output is moved by
a random −1, 0 or +1 half-ulp: another rounding of the same folds, as K1's
against the plain fold's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import tomllib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from elphdynamics_tpu_torch.io.output import dump_toml  # noqa: E402
from elphdynamics_tpu_torch.parallel.multihost import launch  # noqa: E402
from elphdynamics_tpu_torch.utils.device import require_device  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "ssh_site_parity")


def _vals(t) -> list:
    return t.detach().flatten().double().cpu().tolist()


def trace_worker(device, path: str, run_id: int, site_devices: int,
                 perturb: bool = False) -> dict:
    """One rank of the driver run with every CG call and checked solve
    recorded; rank 0 also returns the processed bins. ``perturb``: every
    plain fold output moved by a random −1, 0 or +1 half-ulp."""
    from elphdynamics_tpu_torch import simulation, solvers
    from elphdynamics_tpu_torch.ops import checkerboard
    from elphdynamics_tpu_torch.utils.dtypes import fdot

    log, bins = [], []
    cg, checked, block = solvers.cg, solvers.solve_checked, solvers.block_solve_checked

    def norms(reduce, *pairs):
        d = torch.stack([fdot(a, b, dim=(-2, -1)) for a, b in pairs])
        return (reduce(d) if reduce is not None else d).unbind(0)

    def traced_cg(apply_A, b, *a, **k):
        res = cg(apply_A, b, *a, **k)
        r = b - apply_A(res.x)
        rr, bb = norms(k.get("reduce"), (r, r), (b, b))
        log.append(dict(kind="cg", retry=k.get("active0") is not None, tol=k.get("tol"),
                        shape=list(b.shape), iters=_vals(res.iters),
                        converged=_vals(res.converged),
                        residual=_vals(torch.sqrt(rr / torch.clamp(bb, min=1e-300)))))
        return res

    def traced(kind, fn):
        def solve(apply_A, b, *a, **k):
            res = fn(apply_A, b, *a, **k)
            xx, = norms(k.get("reduce"), (res.x, res.x))
            log.append(dict(kind=kind, tol=k.get("tol"), shape=list(b.shape),
                            iters=_vals(res.iters), residual=_vals(res.residual),
                            flag=_vals(res.flag), xx=_vals(xx)))
            return res
        return solve

    write_bin = simulation.out_io.write_bin

    def recording_write_bin(datafolder, processed, bin_index, ops):
        bins.append(processed)
        return write_bin(datafolder, processed, bin_index, ops)

    fold, ulps = checkerboard.fold, torch.Generator().manual_seed(0)

    def perturbed_fold(*a, **k):
        out = fold(*a, **k)
        e = torch.randint(-1, 2, out.shape, generator=ulps).to(out)
        return out + e * (torch.finfo(out.dtype).eps / 2) * out

    solvers.cg = traced_cg
    solvers.solve_checked = traced("checked", checked)
    solvers.block_solve_checked = traced("block_checked", block)
    simulation.out_io.write_bin = recording_write_bin
    if perturb:
        checkerboard.fold = perturbed_fold
    try:
        stats = simulation.simulate(path, run_id=run_id, n_chains=1, device=device,
                                    dtype=torch.float64, site_devices=site_devices)
    finally:
        solvers.cg, solvers.solve_checked, solvers.block_solve_checked = cg, checked, block
        simulation.out_io.write_bin = write_bin
        checkerboard.fold = fold
    return dict(stats=stats, log=log,
                bins=[{p: np.asarray(a) for p, a in _leaves(b)} for b in bins])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree.cpu() if torch.is_tensor(tree) else tree)


def compare(one: list, two: list) -> dict:
    """The first entry of the two solve records that parts, and the
    largest relative ‖x‖² difference before it."""
    if len(one) != len(two):
        return dict(parted_at=None, note=f"{len(one)} against {len(two)} entries")
    worst_before = 0.0
    for i, (a, b) in enumerate(zip(one, two)):
        same_iters = a["iters"] == b["iters"]
        rel = 0.0
        if "xx" in a:
            xa, xb = np.array(a["xx"]), np.array(b["xx"])
            rel = float(np.max(np.abs(xa - xb) / np.maximum(np.abs(xa), 1e-300)))
        if not same_iters or rel > 1e-12:
            return dict(parted_at=i, entry_one=a, entry_two=b, xx_rel_diff=rel,
                        previous_one=one[max(0, i - 2):i], previous_two=two[max(0, i - 2):i],
                        worst_xx_rel_before=worst_before)
        worst_before = max(worst_before, rel)
    return dict(parted_at=None, worst_xx_rel=worst_before)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--burnin", type=int, default=0)
    ap.add_argument("--updates", type=int, default=2)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--perturb", action="store_true")
    args = ap.parse_args()
    device = require_device(args.device)
    if args.perturb and device.type != "cpu":
        raise SystemExit("--perturb moves the plain fold's outputs: run it with --device cpu")
    card = ""
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        from elphdynamics_tpu_torch.ops import ckb_cuda
        ckb_cuda.build()
    else:
        torch.set_num_threads(1)
    print(card or "cpu", flush=True)
    with open(os.path.join(ROOT, "examples", "ssh_hmc_square.toml"), "rb") as f:
        cfg = tomllib.load(f)
    cfg["hmc"].update(burnin_updates=args.burnin, simulation_updates=args.updates,
                      trajectory_time=0.05)
    cfg["simulation"].update(num_bins=2, random_seed=args.seed)
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"].setdefault("preconditioner", {})["max_order"] = 8
    with tempfile.TemporaryDirectory() as work:
        cfg["simulation"]["filepath"] = work
        path = os.path.join(work, "ssh_square.toml")
        with open(path, "w") as f:
            f.write(dump_toml(cfg))
        one = trace_worker(device, path, 1, 1)
        if args.perturb:
            two = [trace_worker(device, path, 2, 1, perturb=True)] * 2
        else:
            two = launch(trace_worker, 2, "gloo", str(device), (path, 2, 2), timeout_s=900,
                         threads=1 if device.type == "cpu" else None, store_dir=work)
    r0 = two[0]
    bins = []
    for b1, b2 in zip(one["bins"], r0["bins"]):
        for p, a in b1.items():
            if a.size:
                bins.append((float(np.abs(b2[p] - a).max()), p, float(np.abs(a).max())))
    bins.sort(reverse=True)
    out = dict(card=card, device=str(device), burnin=args.burnin, updates=args.updates,
               seed=args.seed, against="one rank, folds perturbed" if args.perturb else
               "2 gloo site ranks",
               solves=len(one["log"]), first_parting=compare(one["log"], r0["log"]),
               ranks_agree=r0["log"] == two[1]["log"],
               bins_worst=bins[:8], max_abs_dbin=bins[0][0] if bins else None,
               acceptance=[one["stats"]["acceptance_rate"], r0["stats"]["acceptance_rate"]],
               log_one=one["log"], log_two=r0["log"])
    os.makedirs(OUT, exist_ok=True)
    name = (f"{device.type}_{args.burnin}_{args.updates}_{args.seed}"
            f"{'_perturb' if args.perturb else ''}.json")
    with open(os.path.join(OUT, name), "w") as f:
        json.dump(out, f)
    brief = {k: v for k, v in out.items() if not k.startswith("log_")}
    print(json.dumps(brief, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
