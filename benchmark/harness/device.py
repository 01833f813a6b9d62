"""The card: its presence, its name and its peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full 700 W power
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor
cores. A share of a peak is stated with the card's power limit beside it
(``nvidia-smi``).
"""

from __future__ import annotations

import shutil
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


class NoDevice(RuntimeError):
    pass


def require_cards(n: int) -> None:
    """Raise unless ``n`` CUDA cards are visible: a run never falls back to
    the CPU."""
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the port on an NVIDIA card")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell needs {n} CUDA cards, {torch.cuda.device_count()} visible")


def describe(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str | None:
    """``name, power.limit`` of the card as ``nvidia-smi`` reads them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds for ``nbytes`` of memory traffic and ``flops``
    float32 operations: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
