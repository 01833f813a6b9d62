"""The device an entry point runs on.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU (``device="cpu"``, as the tests do). Without a card a CUDA
request raises; it never carries on on the CPU.
"""

from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raise ``RuntimeError`` if it is
    a CUDA device and no card is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (run on the CPU with device='cpu')")
    return device
