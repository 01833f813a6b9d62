"""The benchmark's CPU tests run from the repository root:

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need an NVIDIA card and skip without one (the
``card`` fixture decides, at run time)."""

import sys
from pathlib import Path

import pytest

import torch

HERE = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)     # several test workers share the CPU
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a small cell the CPU runs in seconds: 4×4, β = 1 (Lτ = 10), 4 chains
TINY = {"holstein": {"lattice.L": 4, "holstein.beta": 1.0, "chains": 4},
        "ssh": {"lattice.L": 4, "ssh.beta": 1.0, "chains": 4,
                "solver.preconditioner.max_order": 8}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    return TINY
