"""What holds device memory after the graphed SSH updates of `chip_smoke.py`
phase 37, for this checkout or another.

    python scripts/graph_memory_probe.py [--root DIR]

Builds the kernels, runs phase 37 (the graphed SSH update against the eager
one at ``SSH_8X8`` and ``SSH_64X64``: two graph sets, each warmed up and
captured on its capture stream) with the CUDA caching allocator's history
on, and prints, once every step and graph of the phase is garbage: the
allocated bytes against the CUDA tensors Python still reaches, and the
allocations still live grouped by the Python frames that made them, the
largest first. ``--root DIR`` runs the checkout in DIR (such as a parent
unpacked with ``git archive``): run both in one call, each in its own
process. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
from collections import Counter


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout to run (default: this one)")
    ap.add_argument("--top", type=int, default=6, help="allocation sites to print")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("graph_memory_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    chip_smoke.phase_build()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    chip_smoke.phase_graphed_update_ssh()
    gc.collect()
    torch.cuda.synchronize()
    reached = {}
    for o in gc.get_objects():
        if torch.is_tensor(o) and o.is_cuda:
            reached[o.untyped_storage().data_ptr()] = o.untyped_storage().nbytes()
    sites: Counter = Counter()
    blocks: Counter = Counter()
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = tuple(f"{os.path.relpath(f['filename'], root)}:{f['line']} {f['name']}"
                           for f in blk.get("frames", [])
                           if f["filename"].startswith(root) and f["filename"].endswith(".py"))
            sites[frames[:4]] += blk["size"]
            blocks[frames[:4]] += 1
    print(f"[graph_memory_probe] root={root} device={torch.cuda.get_device_name(0)!r} "
          f"allocated_mb={torch.cuda.memory_allocated() / 2**20:.1f} "
          f"python_tensors_mb={sum(reached.values()) / 2**20:.1f}", flush=True)
    for frames, size in sites.most_common(args.top):
        print(f"  {size / 2**20:.2f} MB in {blocks[frames]} block(s), made at:")
        for f in frames:
            print(f"      {f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
