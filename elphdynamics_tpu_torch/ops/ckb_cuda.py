"""The checkerboard fold and the fused Chebyshev step as hand-written CUDA
kernels (``csrc/ckb_fold.cu``, ``csrc/ckb_fold_fused.cu``, sharing
``csrc/ckb_fold_groups.cuh``).

* :func:`fold` replaces the Pallas TPU kernel ``elphdynamics_tpu/ops/
  ckb_pallas.py:_fold_kernel`` (driven by ``fold_2d``; wrappers ``ckb_mul``,
  ``ckb_transpose_mul``, ``ckb_inverse_mul``, ``ckb_inverse_transpose_mul``).
  The fold is bound by device-memory bytes: the plain twin
  (:func:`..checkerboard.fold`) makes one read and one write of the field
  per bond group, the kernel one of each per fold. It takes the three
  coefficient forms of :func:`..checkerboard.check_coeffs`: ``[Nb]``,
  per-chain ``[C, Nb]`` (the JAX package ran the Pallas kernel under
  ``vmap`` for those) and per-(chain, bond, column) ``[C, Nb, K]`` (the SSH
  fermion operator, which the JAX package folded outside Pallas). It has a
  complex mode (complex64 / complex128 fields and tables of the field's
  dtype): complex hopping, whose bond blocks are the Hermitian
  ``[c s; s̄ c]``, the second endpoint taking ``conj(s)`` (the JAX package
  folded those outside Pallas too).
* :func:`fold_fused` replaces ``ckb_pallas.py:_fold_fused_kernel`` (driven
  by ``fold_kn_fused``): one KPM Chebyshev step
  ``a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev`` in one pass, per-chain ``a``,
  ``b``, ``pre``, ``post``, and ``[Nb]`` or per-chain ``[C, Nb]`` bond
  coefficients, real fields only (a complex field is a ``TypeError``). The
  same pass adds the step's term of the KPM Chebyshev sum,
  ``acc ← acc + c_m(ω) ⊙ v`` on the stacked-real halves (``acc=``,
  ``coeff=``, ``init=``). Its plain twin is
  :func:`..checkerboard.fold_fused`.

Design (Hopper): a thread-block cluster of ``cs`` CTAs owns one ``[N, K]``
row of the ``[B, N, K]`` field; rank ``r`` keeps the contiguous site range
``[r·N/cs, (r+1)·N/cs)`` in shared memory, moved in and out by the bulk
copy engine, and the bond groups run on the cluster, partners held by
another rank reached through distributed shared memory. Where a row is too
large for 16 such slabs the kernels also tile K. The host side here lists
the launch geometries worth trying (:func:`choose_cluster`,
:func:`candidates`: cluster size, column tile, block size) and builds each
rank's owned-bond tables with local indices (:func:`cluster_plan`), cached
on the spec; none of it touches CUDA, so the CPU tests reach it. On a
shape's first launch the wrapper times the candidates on the card and keeps
the fastest (every geometry computes the same values).

Each source is built by ``nvcc`` at first use (``-gencode
arch=compute_90a,code=sm_90a``) into its own shared library under
``elphdynamics_tpu_torch/build/``, keyed by a hash of the source and the
shared header, all compilers started together, and loaded with ``ctypes``.

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
twin; a CUDA tensor launches the kernel or raises. ``launches`` and
``fused_launches`` count kernel launches (never twin calls), and
``table_launches`` the same launches by kernel and coefficient form
(``"fold/shared"``, ``"fold/chain"``, ``"fold/column"``,
``"fused/shared"``, ``"fused/chain"``, and K1's complex mode as
``"fold/shared/complex"``, ``"fold/chain/complex"``,
``"fold/column/complex"``); ``launch_shapes`` counts the same launches by
(form key, field shape, dtype), so that a caller can see at which shapes,
and how often at each, a run went through the kernels;
``fused_acc_launches`` counts the fused launches that carried the
coefficient accumulation (also counted under their ``fused/<form>`` key,
so its share of those is the accumulation's engagement). A CUDA graph's
capture launches nothing on the card: its launches are counted into the
graph's record, and each replay of the graph counts them again
(``utils/capture.py``, ``dynamics/graphs.py``). A capture that reaches a
shape's first launch (the geometry tuning, the bond-plan upload) raises.
The nvcc build and a shape's geometry tuning are the spans ``ckb.build``
and ``ckb.tune`` (``utils/spans.py``) while spans record.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.utils import capture, spans

# kernel launches since import (or since a caller last set them to 0)
launches = 0
fused_launches = 0
fused_acc_launches = 0    # fused launches that added into a Chebyshev sum
TABLE_FORMS = ("shared", "chain", "column")   # [Nb], [C, Nb], [C, Nb, K]
table_launches = {"fold/shared": 0, "fold/chain": 0, "fold/column": 0,
                  "fused/shared": 0, "fused/chain": 0, "fold/shared/complex": 0,
                  "fold/chain/complex": 0, "fold/column/complex": 0}
launch_shapes: dict = {}      # {(form key, field shape, dtype): counted launches}


def reset_counts() -> None:
    """Set every launch count to 0 and forget the launches' shapes."""
    global launches, fused_launches, fused_acc_launches
    launches = fused_launches = fused_acc_launches = 0
    for k in table_launches:
        table_launches[k] = 0
    launch_shapes.clear()


def _add(form: str, n: int) -> None:
    global launches, fused_launches
    if form.startswith("fold/"):
        launches += n
    else:
        fused_launches += n
    table_launches[form] += n


def _add_shape(shape, n: int) -> None:
    launch_shapes[shape] = launch_shapes.get(shape, 0) + n


def _add_acc(_key, n: int) -> None:
    global fused_acc_launches
    fused_acc_launches += n


def _count(kernel: str, cosh_b, v) -> None:
    form = f"{kernel}/{TABLE_FORMS[cosh_b.ndim - 1]}" + ("/complex" if v.is_complex() else "")
    capture.count(_add, form)
    capture.count(_add_shape, (form, tuple(v.shape), v.dtype))
    if kernel == "fused":
        capture.count(_add_acc, "fused_acc")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"ckb_fold": CSRC / "ckb_fold.cu", "ckb_fold_fused": CSRC / "ckb_fold_fused.cu"}
HEADERS = (CSRC / "ckb_fold_groups.cuh",)
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

MAX_CLUSTER = 16      # CTAs per cluster on an H100 (non-portable above 8)
PORTABLE_CLUSTER = 8  # the largest cluster the grid-filling rule asks for
MAX_THREADS = 512     # threads per CTA: two CTAs share an SM (csrc kMaxThreads)
MAX_KT = 512          # columns per tile, so a block holds one thread per chunk
CTA_RESERVE = 1024    # shared memory the runtime keeps per CTA (bytes)
MAX_ROWS = 65535      # grid.y

_PTR, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# entry-point suffix of each field dtype, and the dtype code of the
# ``<name>_resident_clusters`` queries; K2 takes the real types only
DTYPES = {torch.float32: ("f32", 0), torch.float64: ("f64", 1),
          torch.complex64: ("c64", 2), torch.complex128: ("c128", 3)}
KERNEL_DTYPES = {"ckb_fold": tuple(DTYPES), "ckb_fold_fused": (torch.float32, torch.float64)}
# argument types of each library's ``<name>_<suffix>`` entry points
_ARGTYPES = {
    "ckb_fold": [_PTR] * 6 + [_I32, _F64] + [_I32] * 9 + [_I64, _I32, _PTR],
    "ckb_fold_fused": ([_PTR] * 7 + [_I32, _F64] + [_PTR] * 4 + [_F64] + [_I32] * 9
                       + [_I64, _PTR, _PTR, _I32, _PTR]),
}

_libs: dict = {}
_device_info: dict[int, tuple[int, int]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA checkerboard kernels cannot be built")


def _library(name: str) -> Path:
    """Where the library of source ``name`` is built for its current text."""
    text = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(verbose: bool = False) -> dict[str, Path]:
    """Compile every source not yet built for its current text, one ``nvcc``
    per source, all started together; return ``{name: library path}``."""
    todo = {name: _library(name) for name in SOURCES}
    missing = [name for name, so in todo.items() if not so.is_file()]
    if not missing:
        return todo
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    with spans.span("ckb.build"):
        for name in missing:
            tmp = todo[name].with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-I", str(CSRC), "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
        for name, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{SOURCES[name].name} ({proc.returncode}):\n{err}")
                continue
            if verbose:
                print(err.strip())
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return todo


def _load(name: str):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        lib.ckb_smem_optin.argtypes = [_I32]
        lib.ckb_smem_optin.restype = _I32
        for dtype in KERNEL_DTYPES[name]:
            fn = getattr(lib, f"{name}_{DTYPES[dtype][0]}")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = _I32
        query = getattr(lib, f"{name}_resident_clusters")
        query.argtypes = [_I32] * 8
        query.restype = _I32
        _libs[name] = lib
    return lib


def _entry(name: str, dtype: torch.dtype):
    """The entry point of library ``name`` for fields of ``dtype``."""
    return getattr(_load(name), f"{name}_{DTYPES[dtype][0]}")


# ---------------------------------------------------------------------------
# host-side plan: which rank owns which bonds
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClusterPlan:
    """The group sweep of one fold direction split over a cluster of ``cs``
    ranks. Rank ``r`` holds sites ``site0[r] .. site0[r+1]-1``; at step
    ``k`` (group ``steps[k]``) it owns the bonds
    ``bonds[offsets[r, k]:offsets[r, k+1]]``, the bonds whose first
    endpoint it holds, each as (local i, local j, rank holding j, bond
    index into the coefficient arrays). ``crosses[k]``: some bond of step
    ``k`` has its endpoints with two ranks (the kernels then need a
    cluster-wide barrier around that step)."""

    cs: int
    site0: np.ndarray     # [cs + 1]
    steps: np.ndarray     # [G] group id applied at each step
    bonds: np.ndarray     # [P, 4] int32
    offsets: np.ndarray   # [cs, G + 1] int64
    crosses: np.ndarray   # [G] bool

    def owned(self, rank: int, step: int) -> np.ndarray:
        return self.bonds[self.offsets[rank, step]:self.offsets[rank, step + 1]]


def cluster_plan(spec: ckb.CheckerboardSpec, cs: int, reverse: bool = False) -> ClusterPlan:
    """The :class:`ClusterPlan` of ``spec`` over ``cs`` ranks, groups in
    forward (or, with ``reverse``, reversed) order. The sign of a direction
    does not change the plan."""
    N, G, nb = spec.nsites, spec.ngroups, spec.nbonds
    if not 1 <= cs <= max(N, 1):
        raise ValueError(f"a cluster of {cs} ranks cannot split {N} sites")
    site0 = np.arange(cs + 1, dtype=np.int64) * N // cs
    bi, bj = spec.neighbor_table
    ri = np.searchsorted(site0, bi, side="right") - 1
    rj = np.searchsorted(site0, bj, side="right") - 1
    step_of_bond = (G - 1 - spec.groups) if reverse else spec.groups
    key = ri * G + step_of_bond
    order = np.argsort(key, kind="stable")
    bonds = np.stack([bi - site0[ri], bj - site0[rj], rj, np.arange(nb)], axis=1)
    starts = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=cs * G))])
    offsets = starts[np.arange(cs)[:, None] * G + np.arange(G + 1)[None, :]]
    steps = np.arange(G)[::-1] if reverse else np.arange(G)
    crosses = np.bincount(step_of_bond[ri != rj], minlength=G)[:G] > 0
    return ClusterPlan(cs=cs, site0=site0, steps=steps.copy(),
                       bonds=bonds[order].astype(np.int32).reshape(nb, 4),
                       offsets=offsets.astype(np.int64), crosses=crosses)


def owned_max(spec: ckb.CheckerboardSpec, cs: int) -> int:
    """The most bonds one of ``cs`` ranks owns over all groups (the same in
    every direction), cached on the spec."""
    key = ("cluster_owned_max", cs)
    out = spec._cache.get(key)
    if out is None:
        off = cluster_plan(spec, cs).offsets
        out = spec._cache[key] = int((off[:, -1] - off[:, 0]).max())
    return out


def _device_plan(spec: ckb.CheckerboardSpec, cs: int, reverse: bool, device: torch.device):
    """(bonds [P, 4], offsets [cs·(G+1)] then crossing flags [G]) int32
    tensors on ``device``, cached on the spec per (cs, direction, device)."""
    key = ("cluster_plan", cs, bool(reverse), str(device))
    out = spec._cache.get(key)
    if out is None:
        capture.refuse(device, "a bond plan upload")
        plan = cluster_plan(spec, cs, reverse)
        table = np.concatenate([plan.offsets.ravel(), plan.crosses]).astype(np.int32)
        out = (torch.as_tensor(plan.bonds, device=device).contiguous(),
               torch.as_tensor(table, device=device))
        spec._cache[key] = out
    return out


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

def _cta_bytes(N: int, cs: int, kt: int, itemsize: int, owned: int = 0,
               per_column: bool = False) -> int:
    """Dynamic shared memory of one CTA: a slab of ``ceil(N/cs)`` sites by
    ``kt`` columns rounded up to 128 bytes, the tables of ``owned`` bonds
    (an int4 entry each, and two coefficients unless they are per column,
    rounded up to 16 bytes) and an mbarrier (csrc ``slab_bytes``,
    ``table_bytes``)."""
    slab = math.ceil(math.ceil(N / cs) * kt * itemsize / 128) * 128
    entry = 16 + (0 if per_column else 2 * itemsize)
    return slab + math.ceil(owned * entry / 16) * 16 + 16


def choose_cluster(B: int, N: int, K: int, itemsize: int, smem_bytes: int, n_sms: int,
                   owned=lambda cs: 0, per_column: bool = False) -> tuple[int, int]:
    """(cs, kt): cluster size and columns per tile of a launch on a
    ``[B, N, K]`` field. The smallest cluster whose CTA (its slab and the
    tables of the ``owned(cs)`` bonds of its busiest rank) fits in half the
    SM's shared memory with all K columns, so that two CTAs share an SM;
    where no cluster of up to 16 holds the row, 16 ranks and K cut into
    tiles (in the whole budget where half cannot hold one column). Then cs
    doubles, up to 8, while the grid has fewer CTAs than the card has SMs:
    an H100 holds 30 clusters of 8 at two CTAs per SM but only 14 of 16,
    so 16 is taken only where the slab needs it. ``per_column``: the
    coefficients are per column and stay out of shared memory."""
    half = (smem_bytes + CTA_RESERVE) // 2 - CTA_RESERVE
    sizes = [cs for cs in (1, 2, 4, 8, MAX_CLUSTER) if cs <= max(N, 1)]
    kt = min(K, MAX_KT)

    def cta(cs, kt):
        return _cta_bytes(N, cs, kt, itemsize, owned(cs), per_column)

    cs = next((cs for cs in sizes if cta(cs, kt) <= half), None)
    if cs is None:
        cs = sizes[-1]
        per_col = math.ceil(N / cs) * itemsize
        fixed = cta(cs, 0) + 128
        fits = [(budget - fixed) // per_col for budget in (half, smem_bytes)]
        kt = min(kt, next((k for k in fits if k >= 1), 0))
        if kt < 1:
            raise ValueError(
                f"a [{math.ceil(N / cs)}] site column of {itemsize}-byte values needs "
                f"{cta(cs, 1)} bytes of shared memory; the "
                f"card offers {smem_bytes}")
        if kt >= 4:
            kt -= kt % 4   # keep 16-byte vectors where K allows them
    ntile = math.ceil(K / kt)
    while cs < min(sizes[-1], PORTABLE_CLUSTER) and B * ntile * cs < n_sms:
        cs = sizes[sizes.index(cs) + 1]
    return cs, kt


def vector_width(kt: int, K: int, itemsize: int) -> int:
    """Elements per shared-memory access of the sweep: up to 16 bytes,
    dividing both the tile and the row."""
    return next(v for v in (4, 2, 1) if v * itemsize <= 16 and kt % v == 0 and K % v == 0)


@dataclass(frozen=True)
class Geometry:
    B: int
    N: int
    K: int
    cs: int
    kt: int
    vec: int
    threads: int
    owned: int      # bond-table entries per CTA (the busiest rank's)
    per_column: bool = False   # per-column coefficients: no coefficients in the tables


def geometry(B: int, N: int, K: int, itemsize: int, smem_bytes: int, n_sms: int,
             owned=lambda cs: 0, per_column: bool = False) -> Geometry:
    """The whole launch geometry: :func:`choose_cluster`, the vector width
    and a block size that is a multiple of the chunks per site row."""
    cs, kt = choose_cluster(B, N, K, itemsize, smem_bytes, n_sms, owned, per_column)
    vec = vector_width(kt, K, itemsize)
    nvec = kt // vec
    return Geometry(B=B, N=N, K=K, cs=cs, kt=kt, vec=vec,
                    threads=(MAX_THREADS // nvec) * nvec, owned=owned(cs),
                    per_column=per_column)


TUNE_THREADS = (256, 384, 512)   # block sizes tried, rounded down to whole site rows


def candidates(B: int, N: int, K: int, itemsize: int, smem_bytes: int, n_sms: int,
               owned=lambda cs: 0, per_column: bool = False) -> list[Geometry]:
    """The launch geometries timed on a shape's first launch: :func:`geometry`
    first, then every cluster size whose CTA (all K columns) fits two to an
    SM, each at about 256, 384 and 512 threads. Where K is tiled, only the
    block size varies. No one rule picks the fastest: on an H100 the best
    (cs, threads) differs between the main path's shapes by 4–7% (PERF.md)."""
    base = geometry(B, N, K, itemsize, smem_bytes, n_sms, owned, per_column)
    half = (smem_bytes + CTA_RESERVE) // 2 - CTA_RESERVE
    sizes = [base.cs]
    if base.kt == K:
        sizes += [cs for cs in (1, 2, 4, 8, MAX_CLUSTER) if cs != base.cs and cs <= max(N, 1)
                  and _cta_bytes(N, cs, K, itemsize, owned(cs), per_column) <= half]
    nvec = base.kt // base.vec
    out = [base]
    for cs in sizes:
        for t in TUNE_THREADS:
            threads = max(1, t // nvec) * nvec
            g = Geometry(B=B, N=N, K=K, cs=cs, kt=base.kt, vec=base.vec, threads=threads,
                         owned=owned(cs), per_column=per_column)
            if threads <= MAX_THREADS and g not in out:
                out.append(g)
    return out


def fastest(cands: list[Geometry], times) -> Geometry:
    """The candidate of least time (the first of equals)."""
    return cands[min(range(len(cands)), key=lambda i: times[i])]


def _resident_clusters(name: str, dtype: torch.dtype, g: Geometry) -> int:
    """How many clusters of launch ``g`` of library ``name`` the current card
    holds at once (0: the launch cannot run)."""
    n = getattr(_load(name), f"{name}_resident_clusters")(
        DTYPES[dtype][1], g.vec, g.N, g.kt, g.cs, g.owned, g.threads, int(g.per_column))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed ({-n})")
    return n


def _time_candidates(cands: list[Geometry], run, reps: int = 3) -> list[float]:
    """Device ms of ``reps`` launches of each candidate (CUDA events), summed
    over two passes, in order and reversed, after one launch of each."""
    for g in cands:
        run(g)
    times = [0.0] * len(cands)
    for order in (range(len(cands)), reversed(range(len(cands)))):
        marks = []
        for i in order:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                run(cands[i])
            b.record()
            marks.append((i, a, b))
        marks[-1][2].synchronize()
        for i, a, b in marks:
            times[i] += a.elapsed_time(b)
    return times


def _check(spec, cosh_b, sinh_b, v, per_column: bool, name: str = "ckb_fold") -> tuple[int, int]:
    """Raise on what kernel ``name`` does not take; return the launch's (rows
    per chain, elements per chain's coefficient table): ``(1, 0)`` for one
    ``[Nb]`` table, ``(B/C, Nb)`` for ``[C, Nb]``, ``(B/C, Nb·K)`` for
    ``[C, Nb, K]`` (only with ``per_column``). Tables must be of the
    field's dtype (complex tables for a complex field)."""
    if v.dtype not in KERNEL_DTYPES[name]:
        raise TypeError(f"{name} takes {[str(d) for d in KERNEL_DTYPES[name]]} fields, "
                        f"got {v.dtype}")
    for label, t in (("cosh_b", cosh_b), ("sinh_b", sinh_b)):
        if t.device != v.device or t.dtype != v.dtype:
            raise ValueError(f"{label} must be {v.dtype} on {v.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    if v.ndim < 2 or v.shape[-2] != spec.nsites:
        raise ValueError(f"field must be [..., {spec.nsites}, K], got {tuple(v.shape)}")
    ckb.check_coeffs(spec, cosh_b, sinh_b, v, per_column=per_column)
    if not v.is_contiguous():
        raise ValueError("field must be contiguous")
    B = math.prod(v.shape[:-2])
    if B > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows of [N, K], got {B}")
    if cosh_b.ndim == 1:
        return 1, 0
    return max(B // v.shape[0], 1), cosh_b[0].numel()


def _device_index(v) -> int:
    return v.device.index if v.device.index is not None else torch.cuda.current_device()


def _card(name: str, dev: int) -> tuple[int, int]:
    """(opt-in shared memory per SM in bytes, SM count) of device ``dev``,
    read once per device."""
    info = _device_info.get(dev)
    if info is None:
        smem = _load(name).ckb_smem_optin(dev)
        if smem <= 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed ({-smem})")
        info = _device_info[dev] = (smem, torch.cuda.get_device_properties(dev)
                                    .multi_processor_count)
    return info


def launch_candidates(spec, v, name: str, per_column: bool = False) -> list[Geometry]:
    """The :func:`candidates` of a launch of library ``name`` (``"ckb_fold"``
    or ``"ckb_fold_fused"``) on the CUDA field ``v``: :func:`geometry`'s
    first, then the others that the card can hold. The wrapper keeps one of
    these."""
    N, K = v.shape[-2:]
    cands = candidates(math.prod(v.shape[:-2]), N, K, v.element_size(),
                       *_card(name, _device_index(v)),
                       owned=lambda cs: owned_max(spec, cs), per_column=per_column)
    return [cands[0]] + [c for c in cands[1:] if _resident_clusters(name, v.dtype, c) > 0]


def _geometry(spec, v, name: str, run, per_column: bool = False) -> Geometry:
    """The geometry of a launch of library ``name`` on ``v``, cached on the
    spec per (device, shape, dtype, library, coefficient mode). On a shape's
    first launch every one of its :func:`launch_candidates` runs through
    ``run(geometry)`` (which launches into the caller's output, and K2 into
    a scratch sum; the launches are not counted) and the fastest is kept."""
    N, K = v.shape[-2:]
    key = ("cluster_geometry", _device_index(v), math.prod(v.shape[:-2]), N, K,
           v.dtype, name, per_column)
    g = spec._cache.get(key)
    if g is None:
        capture.refuse(v.device, "tuning a launch geometry")
        with spans.span("ckb.tune"):
            cands = launch_candidates(spec, v, name, per_column)
            g = cands[0] if len(cands) == 1 else fastest(cands, _time_candidates(cands, run))
        spec._cache[key] = g
    return g


def _stream(dev: int) -> int:
    """The raw handle of ``dev``'s current stream (``torch.cuda.current_stream``
    builds a Python object per call, several µs of host time per launch)."""
    return torch._C._cuda_getCurrentRawStream(dev)


def _on_device(dev: int):
    """Make ``dev`` current for a launch; no switch where it already is."""
    return contextlib.nullcontext() if torch.cuda.current_device() == dev else torch.cuda.device(dev)


def _launch(spec, cosh_b, sinh_b, v, reverse: bool, sign: float, geometry) -> torch.Tensor:
    per_column = cosh_b.ndim == 3
    inner, cstride = _check(spec, cosh_b, sinh_b, v, per_column=True)
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    dev = _device_index(v)
    fn = _entry("ckb_fold", v.dtype)

    def run(g: Geometry) -> None:
        bonds, poff = _device_plan(spec, g.cs, reverse, v.device)
        err = fn(v.data_ptr(), out.data_ptr(), bonds.data_ptr(), poff.data_ptr(),
                 cosh_b.data_ptr(), sinh_b.data_ptr(), spec.ngroups, float(sign),
                 g.B, g.N, g.K, g.kt, g.cs, g.vec, g.owned, g.threads, inner, cstride,
                 int(per_column), _stream(dev))
        if err != 0:
            raise RuntimeError(f"ckb_fold kernel launch failed: CUDA error {err}")

    with _on_device(dev):
        run(geometry or _geometry(spec, v, "ckb_fold", run, per_column))
    _count("fold", cosh_b, v)
    return out


def fold(spec: ckb.CheckerboardSpec, cosh_b, sinh_b, v, *, reverse: bool = False,
         sign: float = 1.0, geometry: Geometry | None = None) -> torch.Tensor:
    """The whole checkerboard fold of ``v`` ``[..., N, K]`` in direction
    ``(reverse, sign)``, with coefficients ``[Nb]``, ``[C, Nb]`` or
    ``[C, Nb, K]`` for a ``[C, ..., N, K]`` field, real or complex (tables
    of the field's dtype): the CUDA kernel for a CUDA tensor, the plain twin
    for a CPU tensor. ``geometry``: launch with
    this one of :func:`launch_candidates` instead of the tuned one (to hold
    every candidate against the twin)."""
    if v.device.type == "cuda":
        return _launch(spec, cosh_b, sinh_b, v, reverse, sign, geometry)
    if v.device.type == "cpu":
        return ckb.fold(spec, cosh_b, sinh_b, v, reverse=reverse, sign=sign)
    raise ValueError(f"no checkerboard fold for device {v.device}")


def _launch_fused(spec, cosh_b, sinh_b, v, reverse, sign, pre, post, a, b, c,
                  prev, acc, coeff, init, geometry) -> torch.Tensor:
    _, cstride = _check(spec, cosh_b, sinh_b, v, per_column=False, name="ckb_fold_fused")
    ckb.check_fused_operands(spec, cosh_b, sinh_b, v, pre, post, a, b, prev, acc, coeff)
    for label, t in (("prev", prev), ("acc", acc), ("coeff", coeff)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
    pre, post, a, b = (None if t is None else t.contiguous() for t in (pre, post, a, b))
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    dev = _device_index(v)
    fn = _entry("ckb_fold_fused", v.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run(g: Geometry, sum_=acc, init_=init) -> None:
        bonds, poff = _device_plan(spec, g.cs, reverse, v.device)
        err = fn(v.data_ptr(), out.data_ptr(), ptr(prev), bonds.data_ptr(), poff.data_ptr(),
                 cosh_b.data_ptr(), sinh_b.data_ptr(), spec.ngroups, float(sign), ptr(pre),
                 ptr(post), ptr(a), ptr(b), float(c), g.B, g.N, g.K, g.kt, g.cs, g.vec,
                 g.B // v.shape[0], g.owned, g.threads, cstride, sum_.data_ptr(),
                 coeff.data_ptr(), int(init_), _stream(dev))
        if err != 0:
            raise RuntimeError(f"ckb_fold_fused kernel launch failed: CUDA error {err}")

    scratch = []

    def tune(g: Geometry) -> None:
        # timed on the traffic of most steps, which read the sum they add
        # into: a zeroed scratch sum, so the caller's acc is left alone
        if not scratch:
            scratch.append(torch.zeros_like(acc))
        run(g, scratch[0], False)

    with _on_device(dev):
        run(geometry or _geometry(spec, v, "ckb_fold_fused", tune))
    _count("fused", cosh_b, v)
    return out


def fold_fused(spec: ckb.CheckerboardSpec, cosh_b, sinh_b, v, *, reverse: bool = False,
               sign: float = 1.0, pre=None, post=None, a, b, c: float = 0.0,
               prev=None, acc, coeff, init: bool,
               geometry: Geometry | None = None) -> torch.Tensor:
    """One Chebyshev step ``a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev`` on a
    ``[C, ..., N, K]`` field: coefficients ``[Nb]`` or per-chain
    ``[C, Nb]``, per-chain ``a``, ``b`` (``[C]``) and
    ``pre``/``post`` (``[C, N]`` or None), one number ``c``, ``prev`` (v's
    shape) or None. The same pass adds the step's term of the Chebyshev
    sum into ``acc`` (v's shape), in place: ``acc ← acc + coeff ⊙ v`` as a
    complex product on the stacked-real halves, ``coeff`` ``[C, K]`` being
    the real then the imaginary parts of the step's per-chain complex
    coefficients on K = 2Lω (``init``: ``acc ← coeff ⊙ v``, acc not read).
    The CUDA kernel for a CUDA tensor, the plain twin
    :func:`..checkerboard.fold_fused` for a CPU tensor. The result is a new
    tensor (it never aliases ``v``, ``prev`` or ``acc``).
    ``geometry`` as in :func:`fold`."""
    if v.device.type == "cuda":
        return _launch_fused(spec, cosh_b, sinh_b, v, reverse, sign, pre, post,
                             a, b, c, prev, acc, coeff, init, geometry)
    if v.device.type == "cpu":
        return ckb.fold_fused(spec, cosh_b, sinh_b, v, reverse=reverse, sign=sign,
                              pre=pre, post=post, a=a, b=b, c=c, prev=prev, acc=acc,
                              coeff=coeff, init=init)
    raise ValueError(f"no fused checkerboard step for device {v.device}")


def ckb_mul(spec, cosh_b, sinh_b, v):
    """exp(−Δτ·K)·v (forward group order)."""
    return fold(spec, cosh_b, sinh_b, v)


def ckb_transpose_mul(spec, cosh_b, sinh_b, v):
    """exp(−Δτ·K)ᵀ·v (reversed group order)."""
    return fold(spec, cosh_b, sinh_b, v, reverse=True)


def ckb_inverse_mul(spec, cosh_b, sinh_b, v):
    """exp(+Δτ·K)·v (reversed group order, −s)."""
    return fold(spec, cosh_b, sinh_b, v, reverse=True, sign=-1.0)


def ckb_inverse_transpose_mul(spec, cosh_b, sinh_b, v):
    """exp(+Δτ·K)ᵀ·v (forward group order, −s)."""
    return fold(spec, cosh_b, sinh_b, v, sign=-1.0)
