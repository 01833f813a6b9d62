"""The checkerboard fold as a hand-written CUDA kernel (``csrc/ckb_fold.cu``).

Replaces the Pallas TPU kernel ``elphdynamics_tpu/ops/ckb_pallas.py:
_fold_kernel`` (driven by ``fold_2d``; wrappers ``ckb_mul``,
``ckb_transpose_mul``, ``ckb_inverse_mul``, ``ckb_inverse_transpose_mul``).
The fold is bound by device-memory bytes: the plain twin
(:func:`..checkerboard.fold`) makes one read and one write of the field per
bond group, the kernel one of each per fold, because it holds a ``[N, kt]``
slab of the field in shared memory across all groups.

The library is built from the repository's source by ``nvcc`` at first use
(``-gencode arch=compute_90a,code=sm_90a``) into ``elphdynamics_tpu_torch/
build/``, keyed by a hash of the source, and loaded with ``ctypes``.

Dispatch is by the tensor's device only: a CPU tensor goes to the plain
twin; a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches (never twin calls).
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

# kernel launches since import (or since a caller last set it to 0)
launches = 0

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ckb_fold.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
THREADS = 1024

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA checkerboard kernel cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/ckb_fold.cu`` (if not already built for this source)
    and return the shared library's path."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libckb_fold_{digest}.so"
    if so.is_file():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ckb_smem_optin.argtypes = [i32]
        lib.ckb_smem_optin.restype = i32
        for name in ("ckb_fold_f32", "ckb_fold_f64"):
            fn = getattr(lib, name)
            fn.argtypes = ([ptr] * 7 + [i32, i32, ctypes.c_double]
                           + [i32] * 5 + [ptr])
            fn.restype = i32
        _lib = lib
    return _lib


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


def _launch(spec, cosh_b, sinh_b, v, reverse: bool, sign: float) -> torch.Tensor:
    global launches
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ckb fold kernel takes float32/float64, got {v.dtype}")
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
    N, K = v.shape[-2:]
    B = math.prod(v.shape[:-2])
    out = torch.empty_like(v)
    if v.numel() == 0 or spec.ngroups == 0:
        out.copy_(v)
        return out
    lib = _load()
    dev = v.device.index if v.device.index is not None else torch.cuda.current_device()
    smem = lib.ckb_smem_optin(dev)
    if smem <= 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed ({-smem})")
    kt = choose_tile(B, N, K, v.element_size(), smem,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    bi, bj, goff = _device_tables(spec, v.device)
    fn = lib.ckb_fold_f32 if v.dtype == torch.float32 else lib.ckb_fold_f64
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
