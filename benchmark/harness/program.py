"""The system under test: the port's objects for one cell.

The mix names the port's entry (``entries/<entry>.py``) and the parts each
step runs (``parts/<part>.py``); the program builds the entry and runs a
part through the part's ``port``. The benchmark takes from the port its
entry, its counters (``solvers.host_reads``, ``ops.ckb_cuda``'s launch
counts and shapes) and the kernel names in the trace. Everything it hands
the port (the parsed input file, the initial field, every draw) it made
itself.
"""

from __future__ import annotations

import torch

from harness import spec

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Program:
    """One cell's port objects on ``device``, built by the entry ``entry``."""

    def __init__(self, entry: str, run_cfg: dict, chains: int, dtype: str, device, seed: int,
                 here=spec.HERE):
        self.entry = spec.load_module("entries", entry, here)
        self.dtype = DTYPES[dtype]
        self.device = torch.device(device)
        self.example = self.entry.build(run_cfg, chains, self.device, self.dtype, seed)

    def state(self, x):
        return self.entry.state(self.example, x)

    def step(self, part, state, d):
        """One step of the part module ``part``: (state, stats)."""
        return part.port(self, state, d)

    def retries(self) -> int:
        return self.entry.retries(self.example)

    def close(self) -> None:
        """Drop the port's objects (graphs, workspaces, tables)."""
        self.example = None


def counters() -> dict:
    """The port's counters now: host reads, the kernels' launches by form
    and their shapes."""
    from elphdynamics_tpu_torch import solvers
    from elphdynamics_tpu_torch.ops import ckb_cuda

    return {"host_reads": solvers.host_reads, "launch_shapes": set(ckb_cuda.launch_shapes),
            "table_launches": dict(ckb_cuda.table_launches)}


def host_reads() -> int:
    from elphdynamics_tpu_torch import solvers

    return solvers.host_reads


def reset_counts() -> None:
    """Set the kernels' launch counts and shapes to nothing (the port's own
    ``ckb_cuda.reset_counts``)."""
    from elphdynamics_tpu_torch.ops import ckb_cuda

    ckb_cuda.reset_counts()
