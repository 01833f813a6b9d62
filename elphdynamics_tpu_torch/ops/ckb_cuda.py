"""The checkerboard fold and the fused Chebyshev step as hand-written CUDA
kernels (``csrc/ckb_fold.cu``, ``csrc/ckb_fold_fused.cu``).

* :func:`fold` replaces the Pallas TPU kernel ``elphdynamics_tpu/ops/
  ckb_pallas.py:_fold_kernel`` (driven by ``fold_2d``; wrappers ``ckb_mul``,
  ``ckb_transpose_mul``, ``ckb_inverse_mul``, ``ckb_inverse_transpose_mul``).
  The fold is bound by device-memory bytes: the plain twin
  (:func:`..checkerboard.fold`) makes one read and one write of the field
  per bond group, the kernel one of each per fold, because it holds a
  ``[N, kt]`` slab of the field in shared memory across all groups.
* :func:`fold_fused` replaces ``ckb_pallas.py:_fold_fused_kernel`` (driven
  by ``fold_kn_fused``): one KPM Chebyshev step
  ``a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev`` in one pass, per-chain ``a``,
  ``b``, ``pre``, ``post``. Its plain twin is
  :func:`..checkerboard.fold_fused`.

Each source is built by ``nvcc`` at first use (``-gencode
arch=compute_90a,code=sm_90a``) into its own shared library under
``elphdynamics_tpu_torch/build/``, keyed by a hash of the source and the
shared header, all compilers started together, and loaded with ``ctypes``.

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
twin; a CUDA tensor launches the kernel or raises. ``launches`` and
``fused_launches`` count kernel launches (never twin calls).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from elphdynamics_tpu_torch.ops import checkerboard as ckb

# kernel launches since import (or since a caller last set them to 0)
launches = 0
fused_launches = 0

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"ckb_fold": CSRC / "ckb_fold.cu", "ckb_fold_fused": CSRC / "ckb_fold_fused.cu"}
HEADERS = (CSRC / "ckb_fold_groups.cuh",)
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
THREADS = 1024

_PTR, _I32, _F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argument types of each library's ``<name>_f32`` / ``<name>_f64`` entry point
_ARGTYPES = {
    "ckb_fold": [_PTR] * 7 + [_I32, _I32, _F64] + [_I32] * 5 + [_PTR],
    "ckb_fold_fused": [_PTR] * 8 + [_I32, _I32, _F64] + [_PTR] * 4 + [_F64] + [_I32] * 6 + [_PTR],
}

_libs: dict = {}
_smem_budget: dict[int, int] = {}


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
    for name in missing:
        tmp = todo[name].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    failed = []
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
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = _I32
        _libs[name] = lib
    return lib


def _entry(name: str, dtype: torch.dtype):
    """The ``float32``/``float64`` entry point of library ``name``."""
    return getattr(_load(name), f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")


def _device_tables(spec: ckb.CheckerboardSpec, device: torch.device):
    """(bi, bj, goff) int32 bond tables on ``device``, cached on the spec."""
    key = ("cuda_fold", str(device))
    out = spec._cache.get(key)
    if out is None:
        nt = spec.neighbor_table
        out = (torch.as_tensor(nt[0], dtype=torch.int32, device=device).contiguous(),
               torch.as_tensor(nt[1], dtype=torch.int32, device=device).contiguous(),
               torch.as_tensor(spec.group_offsets, dtype=torch.int32, device=device))
        spec._cache[key] = out
    return out


def choose_tile(B: int, N: int, K: int, itemsize: int, smem_bytes: int,
                n_sms: int) -> int:
    """Columns per block: as many as the shared-memory budget allows, cut
    so that the grid fills the SMs in one wave where it can."""
    kt_max = smem_bytes // (N * itemsize)
    if kt_max < 1:
        raise ValueError(
            f"a [{N}] site column of {itemsize}-byte values needs "
            f"{N * itemsize} bytes of shared memory; the card offers {smem_bytes}")
    n_tiles = max(math.ceil(K / kt_max), min(K, max(1, n_sms // B)))
    return math.ceil(K / n_tiles)


def _check(spec, cosh_b, sinh_b, v) -> None:
    """Raise on what the kernels do not take."""
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ckb fold kernels take float32/float64, got {v.dtype}")
    for name, t in (("cosh_b", cosh_b), ("sinh_b", sinh_b)):
        if t.device != v.device or t.dtype != v.dtype or t.shape != (spec.nbonds,):
            raise ValueError(f"{name} must be [{spec.nbonds}] {v.dtype} on {v.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.ndim < 2 or v.shape[-2] != spec.nsites:
        raise ValueError(f"field must be [..., {spec.nsites}, K], got {tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError("field must be contiguous")


def _geometry(spec, v, name: str):
    """(device index, B, N, K, kt, bond tables) of a launch of library
    ``name`` on ``v``; the card's shared-memory budget is read once per
    device."""
    N, K = v.shape[-2:]
    B = math.prod(v.shape[:-2])
    dev = v.device.index if v.device.index is not None else torch.cuda.current_device()
    smem = _smem_budget.get(dev)
    if smem is None:
        smem = _load(name).ckb_smem_optin(dev)
        if smem <= 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed ({-smem})")
        _smem_budget[dev] = smem
    kt = choose_tile(B, N, K, v.element_size(), smem,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    return dev, B, N, K, kt, _device_tables(spec, v.device)


def _launch(spec, cosh_b, sinh_b, v, reverse: bool, sign: float) -> torch.Tensor:
    global launches
    _check(spec, cosh_b, sinh_b, v)
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    dev, B, N, K, kt, (bi, bj, goff) = _geometry(spec, v, "ckb_fold")
    fn = _entry("ckb_fold", v.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(v.data_ptr(), out.data_ptr(), bi.data_ptr(), bj.data_ptr(),
                 cosh_b.data_ptr(), sinh_b.data_ptr(), goff.data_ptr(),
                 spec.ngroups, int(reverse), float(sign), B, N, K, kt, THREADS,
                 stream)
    if err != 0:
        raise RuntimeError(f"ckb_fold kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def fold(spec: ckb.CheckerboardSpec, cosh_b, sinh_b, v, *, reverse: bool = False,
         sign: float = 1.0) -> torch.Tensor:
    """The whole checkerboard fold of ``v`` ``[..., N, K]`` in direction
    ``(reverse, sign)``: the CUDA kernel for a CUDA tensor, the plain twin
    for a CPU tensor."""
    if v.device.type == "cuda":
        return _launch(spec, cosh_b, sinh_b, v, reverse, sign)
    if v.device.type == "cpu":
        return ckb.fold(spec, cosh_b, sinh_b, v, reverse=reverse, sign=sign)
    raise ValueError(f"no checkerboard fold for device {v.device}")


def _launch_fused(spec, cosh_b, sinh_b, v, reverse, sign, pre, post, a, b, c,
                  prev) -> torch.Tensor:
    global fused_launches
    _check(spec, cosh_b, sinh_b, v)
    ckb.check_fused_operands(v, pre, post, a, b, prev)
    if prev is not None and not prev.is_contiguous():
        raise ValueError("prev must be contiguous")
    pre, post, a, b = (None if t is None else t.contiguous() for t in (pre, post, a, b))
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    dev, B, N, K, kt, (bi, bj, goff) = _geometry(spec, v, "ckb_fold_fused")
    fn = _entry("ckb_fold_fused", v.dtype)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(v.data_ptr(), out.data_ptr(), ptr(prev), bi.data_ptr(), bj.data_ptr(),
                 cosh_b.data_ptr(), sinh_b.data_ptr(), goff.data_ptr(),
                 spec.ngroups, int(reverse), float(sign), ptr(pre), ptr(post),
                 ptr(a), ptr(b), float(c), B, N, K, kt, B // v.shape[0],
                 THREADS, stream)
    if err != 0:
        raise RuntimeError(f"ckb_fold_fused kernel launch failed: CUDA error {err}")
    fused_launches += 1
    return out


def fold_fused(spec: ckb.CheckerboardSpec, cosh_b, sinh_b, v, *, reverse: bool = False,
               sign: float = 1.0, pre=None, post=None, a, b, c: float = 0.0,
               prev=None) -> torch.Tensor:
    """One Chebyshev step ``a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev`` on a
    ``[C, ..., N, K]`` field: per-chain ``a``, ``b`` (``[C]``) and
    ``pre``/``post`` (``[C, N]`` or None), one number ``c``, ``prev`` (v's
    shape) or None. The CUDA kernel for a CUDA tensor, the plain twin
    :func:`..checkerboard.fold_fused` for a CPU tensor. The result is a new
    tensor (it never aliases ``v`` or ``prev``)."""
    if v.device.type == "cuda":
        return _launch_fused(spec, cosh_b, sinh_b, v, reverse, sign, pre, post,
                             a, b, c, prev)
    if v.device.type == "cpu":
        return ckb.fold_fused(spec, cosh_b, sinh_b, v, reverse=reverse, sign=sign,
                              pre=pre, post=post, a=a, b=b, c=c, prev=prev)
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
