"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each, and the process exits non-zero if any fails):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions and
   the TF32 switches;
2. build the CUDA checkerboard-fold kernel from ``elphdynamics_tpu_torch/
   csrc/ckb_fold.cu`` with nvcc;
3. the kernel against its plain torch twin in all four directions at the
   main path's shapes, float32 and float64, with median times;
4. a small update (4×4, float64) on the card with the kernel forced on,
   against the same update on the CPU through the plain twin;
5. the bench 8×8 configuration (128 chains, dense branch): 1 warm-up and 3
   timed updates;
6. the kernel 64×64 configuration (16 chains, fold branch, N = 4096): 1
   warm-up and 2 timed updates, with the kernel's launch count.

The line before the last is a JSON object with the kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

F32_TOL = 1e-5
F64_TOL = 1e-12
DIRECTIONS = (("forward", False, 1.0), ("transpose", True, 1.0),
              ("inverse", True, -1.0), ("inverse_transpose", False, -1.0))


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("card", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def phase_build():
    from elphdynamics_tpu_torch.ops import ckb_cuda

    t0 = time.perf_counter()
    so = ckb_cuda.build(verbose=True)
    say("build", library=so.name, seconds=f"{time.perf_counter() - t0:.2f}")


def _spec_64():
    from elphdynamics_tpu_torch.bench import KERNEL_64X64
    from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
    from elphdynamics_tpu_torch.models.holstein import build_holstein

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = Lattice.create(uc, KERNEL_64X64.L)
    spec, params = build_holstein(
        lat, beta=KERNEL_64X64.beta, dtau=KERNEL_64X64.dtau,
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
        rng=np.random.default_rng(0), device="cuda")
    return spec, params


def phase_kernel_vs_twin() -> dict:
    """The kernel and the plain twin on the same inputs: the fermion operator
    shape [2·16 chains, 4096, Lτ=40] (the KPM's [32, 4096, 2Lω=40] too), the
    power-iteration shapes [16, 4096, 1] and [1, 4096, 1]."""
    from elphdynamics_tpu_torch.ops import checkerboard as ckb
    from elphdynamics_tpu_torch.ops import ckb_cuda

    spec, params = _spec_64()
    g = torch.Generator(device="cuda").manual_seed(0)
    worst_abs = 0.0
    main = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        c, s = params.cosht.to(dtype), params.sinht.to(dtype)
        for shape in ((32, spec.Nsites, 40), (16, spec.Nsites, 1), (1, spec.Nsites, 1)):
            v = torch.randn(shape, generator=g, dtype=dtype, device="cuda")
            for name, rev, sign in DIRECTIONS:
                got = ckb_cuda.fold(spec.ckb, c, s, v, reverse=rev, sign=sign)
                want = ckb.fold(spec.ckb, c, s, v, reverse=rev, sign=sign)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                worst_abs = max(worst_abs, err)
                ms = median_ms(lambda: ckb_cuda.fold(spec.ckb, c, s, v, reverse=rev, sign=sign))
                plain = median_ms(lambda: ckb.fold(spec.ckb, c, s, v, reverse=rev, sign=sign))
                say("kernel", dtype=str(dtype).split(".")[1], shape="x".join(map(str, shape)),
                    direction=name, max_rel_err=f"{rel:.3e}", tol=tol, max_abs_err=f"{err:.3e}",
                    kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}")
                if not rel <= tol:
                    raise RuntimeError(f"kernel disagrees with the plain twin: {rel} > {tol}")
                if dtype == torch.float32 and shape[0] == 32 and name == "forward":
                    main = dict(ms=ms, plain_ms=plain)
    return dict(max_abs_err=worst_abs, **main)


def phase_small_reference() -> None:
    """One 4×4 update in float64 on the card with the kernel forced on
    (pallas_threshold=0), against the same update on the CPU (plain twin)."""
    from elphdynamics_tpu_torch.bench import build_bench_step
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState, draw
    from elphdynamics_tpu_torch.ops import ckb_cuda

    runs = {}
    for dev in ("cpu", "cuda"):
        b = build_bench_step(4, 1.0, 0.1, 0.05, 4, dev, torch.float64, trajectory_time=0.2,
                             dense_threshold=0, pallas_threshold=0)
        if dev == "cpu":
            draws = draw(b.ops, 4, torch.float64, "cpu", torch.Generator().manual_seed(1))
            x0 = b.state.x
        moved = replace(draws, momentum=draws.momentum.to(dev),
                        pseudofermion=draws.pseudofermion.to(dev),
                        uniform=draws.uniform.to(dev))
        before = ckb_cuda.launches
        st, stats = b.step(b.params, HMCState(x=x0.to(dev), v=torch.zeros_like(x0, device=dev)),
                           draws=moved)
        runs[dev] = (st.x.cpu(), stats.delta_H.cpu(), stats.accepted.cpu(),
                     ckb_cuda.launches - before)
    dx = (runs["cuda"][0] - runs["cpu"][0]).abs().max().item()
    ddh = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
    say("small_reference", max_abs_dx=f"{dx:.3e}", max_abs_ddH=f"{ddh:.3e}",
        accept_equal=bool(torch.equal(runs["cuda"][2], runs["cpu"][2])),
        cuda_kernel_launches=runs["cuda"][3], cpu_kernel_launches=runs["cpu"][3])
    if not (dx <= 1e-10 and ddh <= 1e-9 and torch.equal(runs["cuda"][2], runs["cpu"][2])
            and runs["cuda"][3] > 0 and runs["cpu"][3] == 0):
        raise RuntimeError("the card's update disagrees with the CPU reference")


def run_config(cfg, warmup: int, timed: int) -> dict:
    """Build ``cfg`` on the card in float32 and run warm-up + timed updates."""
    from elphdynamics_tpu_torch.bench import build
    from elphdynamics_tpu_torch.ops import ckb_cuda

    t0 = time.perf_counter()
    b = build(cfg, "cuda", torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ckb_cuda.launches = 0
    state = b.state
    for _ in range(warmup):
        state, stats = b.step(b.params, state, b.generator)
    torch.cuda.synchronize()
    acc, iters, flags, dHs = [], [], [], []
    t0 = time.perf_counter()
    for _ in range(timed):
        state, stats = b.step(b.params, state, b.generator)
        acc.append(stats.accepted)
        iters.append(stats.iters)
        flags.append(stats.flag)
        dHs.append(stats.delta_H)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ckb_cuda.launches
    acc, iters, flags, dHs = (torch.stack(a).cpu() for a in (acc, iters, flags, dHs))
    out = dict(sweeps_per_s=cfg.n_chains * timed / elapsed,
               acceptance=acc.double().mean().item(),
               cg_iters_per_solve=iters.double().mean().item(),
               max_flag=int(flags.max()), dH_finite=bool(torch.isfinite(dHs).all()),
               max_abs_dH=dHs.abs().max().item(), kernel_launches=launches,
               build_s=build_s, seconds=elapsed,
               x_shape=tuple(state.x.shape), x_finite=bool(torch.isfinite(state.x).all()))
    say(cfg.name, chains=cfg.n_chains, L=cfg.L, timed_updates=timed,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in out.items()})
    shape = (cfg.n_chains, cfg.L * cfg.L, round(cfg.beta / cfg.dtau))
    if not (out["x_finite"] and out["dH_finite"] and out["x_shape"] == shape):
        raise RuntimeError(f"{cfg.name}: non-finite or misshapen output")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import elphdynamics_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_card()
    phase_build()
    kern = phase_kernel_vs_twin()
    phase_small_reference()

    from elphdynamics_tpu_torch.bench import BENCH_8X8, KERNEL_64X64

    run_config(BENCH_8X8, warmup=1, timed=3)
    big = run_config(KERNEL_64X64, warmup=1, timed=2)
    if big["kernel_launches"] <= 0:
        raise RuntimeError("the 64x64 main path launched the fold kernel no time")
    if big["max_flag"] != 0 or big["acceptance"] <= 0:
        raise RuntimeError(f"64x64: flag {big['max_flag']}, acceptance {big['acceptance']}")
    if not math.isfinite(kern["ms"]):
        raise RuntimeError("kernel timing missing")

    print(json.dumps({"kernels": [{
        "name": "ckb_fold", "route": "cuda",
        "source": "elphdynamics_tpu_torch/csrc/ckb_fold.cu",
        "replaces": "elphdynamics_tpu/ops/ckb_pallas.py:75",
        "launches": big["kernel_launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
