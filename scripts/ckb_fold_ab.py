"""Time the checkerboard-fold kernels, K1 (``csrc/ckb_fold.cu``) and K2
(``csrc/ckb_fold_fused.cu``), at the main path's shapes on one CUDA card,
in one process, each comparison in turns (A, B, B, A).

    python scripts/ckb_fold_ab.py [--old DIR] [--variants] [--copies] [--reps 30]

The shapes are those of a 64×64 lattice (N = 4096, K = 2Lω = 40): K1 at
[32, 4096, 40], [16, 4096, 40] and [16, 4096, 1]; K2 with per-chain
diagonals and prev, adding into a Chebyshev sum, at [16, 2, 4096, 40] and
[16, 10, 4096, 40]; float32 and float64. Every time is device time per
launch: the summed durations of the card's kernels under ``torch.profiler``
over ``reps`` launches back to back, over ``reps``, so the host's pace does
not enter. The bound is the bytes (each input read once, each output
written once) over 3.35 TB/s.

Without options: the shipped kernels with the wrapper's geometry (the
fastest of its candidates, timed on the shape's first launch), beside
the same launch on a checkerboard with no bonds (copies and barriers, no
sweep), a PyTorch pass over about the same bytes (``clone`` for K1, one
``addcmul`` of v, prev and the sum for K2: four of its five field moves),
and the clusters of the grid against those the card holds at once.

``--old DIR``: also the kernels of the port's second slice (one ``[N, kt]``
slab per block of 1024 threads), built from their sources in ``DIR``
(``ckb_fold.cu``, ``ckb_fold_fused.cu``, ``ckb_fold_groups.cuh``, e.g. from
``git archive <commit> elphdynamics_tpu_torch/csrc``) and called through
THEIR C interface, written out below (``_OLD_ARGTYPES``): that of the
second slice only, not of the sources it was replaced by.

``--variants``: the shipped kernels at other (cs, threads) geometries, and
the persistent two-slab variant (``scripts/ckb_fold_persistent.cu``) with
as many clusters as the card holds, against the wrapper's geometry.

The second slice's K2 takes no sum: ``--old`` holds it against the
shipped step's result only, and its time against a step that also adds
into the sum.

``--copies``: K1 and K2 on a field whose chunks are 16-byte aligned (bulk
copy engine) against a view one element into its storage (the threaded
16-byte copy route).

One JSON object per line; the last line is the card's ``nvidia-smi`` name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from elphdynamics_tpu_torch.ops import checkerboard as ckb  # noqa: E402
from elphdynamics_tpu_torch.ops import ckb_cuda  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# The second slice's C interface: (in, out, bi, bj, c, s, goff, ngroups,
# reverse, sign, B, N, K, kt, threads, stream) for the fold, (in, out, prev,
# bi, bj, c, s, goff, ngroups, reverse, sign, pre, post, a, b, cprev, B, N,
# K, kt, inner, threads, stream) for the fused step.
_OLD_ARGTYPES = {
    "ckb_fold": [_PTR] * 7 + [_I32, _I32, _F64] + [_I32] * 5 + [_PTR],
    "ckb_fold_fused": [_PTR] * 8 + [_I32, _I32, _F64] + [_PTR] * 4 + [_F64] + [_I32] * 6 + [_PTR],
}
_OLD_THREADS = 1024
PERSIST_SRC = ROOT / "scripts" / "ckb_fold_persistent.cu"
_PERSIST_ARGTYPES = [_PTR] * 7 + [_I32, _F64] + [_PTR] * 4 + [_F64] + [_I32] * 10 + [_PTR]


def device_ms(fn, reps: int) -> float:
    """Device time per call: the card's kernel durations under the profiler
    over ``reps`` calls back to back, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def _compile(src: Path, so: Path):
    """Start ``nvcc`` on ``src`` (its own directory first on the include
    path, then the shipped ``csrc/``) into ``so``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([ckb_cuda._nvcc(), *ckb_cuda.NVCC_FLAGS, "-I", str(src.parent),
                             "-I", str(ckb_cuda.CSRC), "-o", str(so), str(src)],
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, what: str) -> None:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what}:\n{err}")


def _old_tile(B: int, N: int, K: int, itemsize: int, smem_bytes: int, n_sms: int) -> int:
    """The second slice's columns per block (its ``choose_tile``)."""
    kt_max = smem_bytes // (N * itemsize)
    n_tiles = max(math.ceil(K / kt_max), min(K, max(1, n_sms // B)))
    return math.ceil(K / n_tiles)


class OldKernels:
    """The second slice's kernels, built from ``src`` and bound to its C
    interface."""

    def __init__(self, src: Path):
        procs = {}
        for name in _OLD_ARGTYPES:
            so = src / "build" / f"lib{name}_old.so"
            procs[name] = (so, _compile(src / f"{name}.cu", so))
        self.libs = {}
        for name, (so, proc) in procs.items():
            _finish(proc, f"the earlier {name}.cu")
            lib = ctypes.CDLL(str(so))
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = _OLD_ARGTYPES[name]
                fn.restype = _I32
            lib.ckb_smem_optin.argtypes = [_I32]
            lib.ckb_smem_optin.restype = _I32
            self.libs[name] = lib
        self.smem = self.libs["ckb_fold"].ckb_smem_optin(torch.cuda.current_device())
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.tables = {}

    def _setup(self, spec, v):
        if id(spec) not in self.tables:
            nt = spec.neighbor_table
            self.tables[id(spec)] = tuple(torch.as_tensor(a, dtype=torch.int32, device=v.device)
                                          for a in (nt[0], nt[1], spec.group_offsets))
        N, K = v.shape[-2:]
        B = math.prod(v.shape[:-2])
        return self.tables[id(spec)], B, N, K, _old_tile(B, N, K, v.element_size(), self.smem,
                                                         self.sms)

    def _fn(self, name, dtype):
        return getattr(self.libs[name], f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")

    def run(self, case):
        spec, v = case["spec"], case["v"]
        (bi, bj, goff), B, N, K, kt = self._setup(spec, v)
        out = torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        if case["fused"]:
            err = self._fn("ckb_fold_fused", v.dtype)(
                v.data_ptr(), out.data_ptr(), case["prev"].data_ptr(), bi.data_ptr(),
                bj.data_ptr(), case["c"].data_ptr(), case["s"].data_ptr(), goff.data_ptr(),
                spec.ngroups, 0, 1.0, case["pre"].data_ptr(), None, case["a"].data_ptr(),
                case["b"].data_ptr(), -1.0, B, N, K, kt, B // v.shape[0], _OLD_THREADS, stream)
        else:
            err = self._fn("ckb_fold", v.dtype)(
                v.data_ptr(), out.data_ptr(), bi.data_ptr(), bj.data_ptr(), case["c"].data_ptr(),
                case["s"].data_ptr(), goff.data_ptr(), spec.ngroups, 0, 1.0, B, N, K, kt,
                _OLD_THREADS, stream)
        if err:
            raise RuntimeError(f"earlier kernel failed: CUDA error {err}")
        return out


def run_shipped(case, g=None, v=None):
    """The shipped kernel on ``case`` (or on the field ``v``), with the
    wrapper's geometry or, with ``g``, that geometry."""
    spec, v = case["spec"], case["v"] if v is None else v
    if case["fused"]:
        return ckb_cuda.fold_fused(spec, case["c"], case["s"], v, pre=case["pre"], a=case["a"],
                                   b=case["b"], c=-1.0, prev=case["prev"], acc=case["acc"],
                                   coeff=case["coeff"], init=False, geometry=g)
    return ckb_cuda.fold(spec, case["c"], case["s"], v, geometry=g)


class Persistent:
    """The persistent two-slab variant (``scripts/ckb_fold_persistent.cu``)."""

    def __init__(self, proc, so: Path):
        _finish(proc, PERSIST_SRC.name)
        self.lib = ctypes.CDLL(str(so))
        for suffix in ("f32", "f64"):
            fn = getattr(self.lib, f"ckb_persist_{suffix}")
            fn.argtypes = _PERSIST_ARGTYPES
            fn.restype = _I32
        self.lib.ckb_persist_clusters.argtypes = [_I32] * 8
        self.lib.ckb_persist_clusters.restype = _I32

    def clusters(self, case, cs: int, threads: int) -> int:
        v = case["v"]
        N, K = v.shape[-2:]
        vec = ckb_cuda.vector_width(K, K, v.element_size())
        return self.lib.ckb_persist_clusters(int(v.dtype == torch.float64), int(case["fused"]),
                                             vec, N, K, cs, ckb_cuda.owned_max(case["spec"], cs),
                                             threads)

    @staticmethod
    def takes(case, cs: int) -> bool:
        """Every rank's chunk of every row 16-byte aligned and sized."""
        v = case["v"]
        N, K = v.shape[-2:]
        site0 = np.arange(cs + 1) * N // cs
        return v.data_ptr() % 16 == 0 and bool(np.all(site0 * K * v.element_size() % 16 == 0))

    def run(self, case, cs: int, threads: int, nclusters: int):
        spec, v = case["spec"], case["v"]
        N, K = v.shape[-2:]
        B = math.prod(v.shape[:-2])
        vec = ckb_cuda.vector_width(K, K, v.element_size())
        bonds, poff = ckb_cuda._device_plan(spec, cs, False, v.device)
        out = torch.empty_like(v)
        fused = case["fused"]

        def ptr(t):
            return None if t is None or not fused else t.data_ptr()

        fn = getattr(self.lib, f"ckb_persist_{'f32' if v.dtype == torch.float32 else 'f64'}")
        err = fn(v.data_ptr(), out.data_ptr(), ptr(case["prev"]), bonds.data_ptr(),
                 poff.data_ptr(), case["c"].data_ptr(), case["s"].data_ptr(), spec.ngroups, 1.0,
                 ptr(case["pre"]), None, ptr(case["a"]), ptr(case["b"]), -1.0, int(fused), B, N,
                 K, cs, vec, B // v.shape[0] if fused else 1, ckb_cuda.owned_max(spec, cs),
                 threads, nclusters, ckb_cuda._stream(v.device.index))
        if err:
            raise RuntimeError(f"persistent variant cs={cs} threads={threads} failed: {err}")
        return out


def spec_64x64():
    """The kernel-64×64 model's checkerboard spec and coefficients (CPU)."""
    from elphdynamics_tpu_torch.bench import KERNEL_64X64
    from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
    from elphdynamics_tpu_torch.models.holstein import build_holstein

    uc = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    spec, params = build_holstein(
        Lattice.create(uc, KERNEL_64X64.L), KERNEL_64X64.beta, KERNEL_64X64.dtau,
        t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
        rng=np.random.default_rng(0), device="cpu", dense_threshold=0)
    return spec.ckb, params


def make_cases(spec, params, g):
    cases = []
    for dtype in (torch.float32, torch.float64):
        c = params.cosht.to("cuda", dtype)
        s = params.sinht.to("cuda", dtype)
        for shape in ((32, 4096, 40), (16, 4096, 40), (16, 4096, 1)):
            v = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            cases.append(dict(kernel="ckb_fold", fused=False, spec=spec, c=c, s=s, v=v,
                              prev=None, pre=None, a=None, b=None,
                              nbytes=2 * v.numel() * v.element_size(), ref=lambda v=v: v.clone()))
        for inner in (2, 10):
            shape = (16, inner, 4096, 40)
            v, prev, acc = (torch.randn(shape, generator=g, device="cuda", dtype=dtype)
                            for _ in range(3))
            cases.append(dict(
                kernel="ckb_fold_fused", fused=True, spec=spec, c=c, s=s, v=v, prev=prev,
                pre=0.5 + torch.rand((16, 4096), generator=g, device="cuda", dtype=dtype),
                a=0.5 + torch.rand(16, generator=g, device="cuda", dtype=dtype),
                b=torch.rand(16, generator=g, device="cuda", dtype=dtype) - 0.5, acc=acc,
                coeff=torch.randn((16, 40), generator=g, device="cuda", dtype=dtype),
                nbytes=5 * v.numel() * v.element_size(),
                ref=lambda v=v, p=prev, a=acc: torch.addcmul(a, v, p)))
    return cases


def label(case) -> dict:
    return {"kernel": case["kernel"], "dtype": str(case["v"].dtype).split(".")[1],
            "shape": list(case["v"].shape),
            "bound_ms": case["nbytes"] / HBM_BYTES_PER_S * 1e3}


def rel_diff(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def in_turns(runs: dict, reps: int) -> dict:
    """Each of ``runs`` timed twice, in the order given and then reversed;
    returns {name: [first, second]}."""
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(device_ms(runs[k], reps))
    return times


def tuned_geometry(case):
    """The geometry the wrapper picked for ``case`` (timed on its first
    launch)."""
    run_shipped(case)
    v = case["v"]
    N, K = v.shape[-2:]
    return case["spec"]._cache[("cluster_geometry", v.device.index, math.prod(v.shape[:-2]), N,
                                K, v.dtype, case["kernel"], False)]


def section_shipped(cases, bare, old, reps):
    none = {dt: torch.zeros(0, device="cuda", dtype=dt) for dt in (torch.float32, torch.float64)}
    for case in cases:
        v = case["v"]
        geo = tuned_geometry(case)
        bare_case = dict(case, spec=bare, c=none[v.dtype], s=none[v.dtype])
        out = dict(label(case), cs=geo.cs, kt=geo.kt, threads=geo.threads,
                   clusters=geo.B * math.ceil(geo.K / geo.kt),
                   resident_clusters=ckb_cuda._resident_clusters(case["kernel"], v.dtype, geo),
                   no_bonds_ms=device_ms(lambda: run_shipped(bare_case), reps),
                   same_bytes_torch_ms=device_ms(case["ref"], reps))
        runs = {"new": lambda: run_shipped(case)}
        if old is not None:
            runs = {"old": lambda: old.run(case), **runs}
            out["max_rel_diff_old_new"] = rel_diff(run_shipped(case), old.run(case))
        for k, ts in in_turns(runs, reps).items():
            out[f"{k}_ms"] = sum(ts) / len(ts)
            out[f"{k}_runs"] = ts
            out[f"{k}_bound_share"] = out["bound_ms"] / out[f"{k}_ms"]
        print(json.dumps(out), flush=True)


def section_variants(cases, persist, reps):
    smem = ckb_cuda._load("ckb_fold").ckb_smem_optin(0)
    for case in cases:
        v, spec = case["v"], case["spec"]
        N, K = v.shape[-2:]
        B = math.prod(v.shape[:-2])
        item = v.element_size()
        vec = ckb_cuda.vector_width(K, K, item)
        nvec = K // vec
        want = run_shipped(case)
        geo = tuned_geometry(case)
        runs = {"shipped": lambda: run_shipped(case)}
        meta = {"shipped": dict(cs=geo.cs, threads=geo.threads)}
        for cs in (1, 2, 4, 8, 16):
            owned = ckb_cuda.owned_max(spec, cs)
            if ckb_cuda._cta_bytes(N, cs, K, item, owned) > smem:
                continue
            for threads in sorted({(t // nvec) * nvec for t in (128, 256, 384, 512)} - {0}):
                g = ckb_cuda.Geometry(B=B, N=N, K=K, cs=cs, kt=K, vec=vec, threads=threads,
                                      owned=owned)
                key = f"cs{cs}_t{threads}"
                meta[key] = dict(resident=ckb_cuda._resident_clusters(case["kernel"], v.dtype, g),
                                 diff=rel_diff(run_shipped(case, g), want))
                runs[key] = lambda g=g: run_shipped(case, g)
            if not persist.takes(case, cs):
                continue
            if 2 * ckb_cuda._cta_bytes(N, cs, K, item, owned) > smem:
                continue
            for threads in sorted({(t // nvec) * nvec for t in (512, 1024)} - {0}):
                cap = persist.clusters(case, cs, threads)
                if cap <= 0:
                    continue
                key = f"persist_cs{cs}_t{threads}_R{min(cap, B)}"
                meta[key] = dict(resident=cap, diff=rel_diff(
                    persist.run(case, cs, threads, min(cap, B)), want))
                runs[key] = lambda cs=cs, t=threads, r=min(cap, B): persist.run(case, cs, t, r)
        times = in_turns(runs, reps)
        best = min(times, key=lambda k: sum(times[k]))
        out = dict(label(case), best=best, runs={
            k: dict(ms=sum(ts) / len(ts), runs=ts, **meta.get(k, {})) for k, ts in times.items()})
        print(json.dumps(out), flush=True)


def section_copies(cases, reps):
    """The shipped kernels on an aligned field and on a view one element
    into its storage (float32 and float64, the 64×64 K1 and K2 main shapes)."""
    for case in cases:
        if list(case["v"].shape) not in ([32, 4096, 40], [16, 10, 4096, 40]):
            continue
        v = case["v"]
        flat = torch.empty(v.numel() + 1, device="cuda", dtype=v.dtype)
        shifted = flat[1:].view(v.shape)
        shifted.copy_(v)
        sc = dict(case, v=shifted)
        if case["fused"]:
            pflat = torch.empty_like(flat)
            sc["prev"] = pflat[1:].view(v.shape)
            sc["prev"].copy_(case["prev"])
        diff = rel_diff(run_shipped(sc), run_shipped(case))
        times = in_turns({"aligned_bulk": lambda: run_shipped(case),
                          "misaligned_threads": lambda: run_shipped(sc)}, reps)
        print(json.dumps(dict(label(case), max_rel_diff=diff,
                              **{f"{k}_ms": sum(t) / len(t) for k, t in times.items()},
                              **{f"{k}_runs": t for k, t in times.items()})), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="directory of the second slice's sources")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--copies", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ckb_fold_ab: no CUDA device", file=sys.stderr)
        return 1
    so = ckb_cuda.BUILD_DIR / "libckb_persist.so"
    proc = _compile(PERSIST_SRC, so) if args.variants else None
    ckb_cuda.build()
    old = OldKernels(args.old) if args.old else None
    persist = Persistent(proc, so) if proc else None
    spec, params = spec_64x64()
    bare = ckb.build_checkerboard_spec(spec.nsites, np.zeros((2, 0), dtype=np.int64))
    cases = make_cases(spec, params, torch.Generator(device="cuda").manual_seed(7))
    section_shipped(cases, bare, old, args.reps)
    if args.copies:
        section_copies(cases, args.reps)
    if args.variants:
        section_variants(cases, persist, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
