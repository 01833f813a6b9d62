"""Profile one update of the PyTorch port's main path on a CUDA card.

    python scripts/profile_torch_hmc.py [bench_8x8|kernel_64x64] [--trace DIR]

Builds the configuration in float32, runs one warm-up update, then one
update under ``torch.profiler`` and prints: wall time, summed device-kernel
time and the device's busy share, the fold kernel's launches, the heaviest
kernels by device time, and the heaviest host-side operators. With
``--trace DIR`` the Chrome trace goes to ``DIR/<config>_trace.json`` (about
200 MB for one update).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from elphdynamics_tpu_torch import bench  # noqa: E402
from elphdynamics_tpu_torch.ops import ckb_cuda  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", choices=["bench_8x8", "kernel_64x64"])
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_hmc: no CUDA device", file=sys.stderr)
        return 1
    cfg = {"bench_8x8": bench.BENCH_8X8, "kernel_64x64": bench.KERNEL_64X64}[args.config]
    b = bench.build(cfg, "cuda", torch.float32)
    state, _ = b.step(b.params, b.state, b.generator)
    torch.cuda.synchronize()
    ckb_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, stats = b.step(b.params, state, b.generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[{cfg.name}] device={torch.cuda.get_device_name(0)!r} wall_s={wall:.4f} "
          f"device_kernel_s={dev_us / 1e6:.4f} device_busy_share={dev_us / 1e6 / wall:.4f} "
          f"fold_launches={ckb_cuda.launches} mean_cg_iters={stats.iters.double().mean().item():.3f}")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    if args.trace:
        out = Path(args.trace)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{cfg.name}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
