"""The port's driver step for an ``[hmc]`` input file: ``bench.build_hmc_example``.

An entry is a module ``entries/<name>.py`` that a mix names under
``"entry"``; the harness finds it by name. It gives ``build`` (the port's
objects for a cell), ``state`` (the port's state for an initial field) and
``retries`` (the port's eager retries so far, for the run's log).
"""

from __future__ import annotations

import torch


def build(run_cfg: dict, chains: int, device, dtype: torch.dtype, seed: int):
    """The port's example (``.step``, ``.reflect``, ``.swap``, ``.measure``,
    ``.params``) of the parsed input file ``run_cfg`` for ``chains`` chains."""
    from elphdynamics_tpu_torch.bench import build_hmc_example

    return build_hmc_example(run_cfg, n_chains=chains, device=device, dtype=dtype,
                             seed=int(seed))


def state(example, x: torch.Tensor):
    from elphdynamics_tpu_torch.dynamics.hmc import HMCState

    return HMCState(x=x, v=torch.zeros_like(x))


def retries(example) -> int:
    """The update's eager retries of a failed verification so far
    (``graphs.Workspace.retries``; 0 before its first call)."""
    workspace = getattr(example.step, "workspace", None)
    ws = workspace() if workspace is not None else None
    return 0 if ws is None else int(getattr(ws, "retries", 0))
