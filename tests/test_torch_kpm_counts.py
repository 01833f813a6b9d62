"""The KPM preconditioner's Chebyshev-step counter (``ops/kpm.cheb_steps``):
the complex-hopping recurrence counts its steps, ``max_order`` a pass, the
real recurrences count none, and ``kpm.reset_counts`` sets the count to 0."""

from pathlib import Path

import pytest
import torch

from elphdynamics_tpu_torch.bench import build_hmc_example
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.utils.dtypes import field_dtype

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.mark.parametrize("example, fold, steps", [
    ("holstein_hmc_twisted", False, 2 * 64),   # complex hopping: two passes of the cap 64
    ("holstein_hmc_square", False, 0),         # the model's dense Ā (composed)
    ("ssh_hmc_square", True, 0),               # Ā as a fold: the fused steps
])
def test_cheb_steps_per_recurrence(example, fold, steps, monkeypatch):
    if fold:
        monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    ex = build_hmc_example(str(EXAMPLES / f"{example}.toml"), 2, "cpu", torch.float64, 3)
    st = ex.precond.setup(ex.params, ex.state.x)
    kpm.reset_counts()
    v = torch.randn((2, 1, ex.ops.Nsites, ex.ops.Ltau), dtype=torch.float64)
    ex.precond.symmetric(st, v.to(field_dtype(ex.params, v.dtype)))
    assert kpm.cheb_steps == {"complex": steps}
    kpm.reset_counts()
    assert kpm.cheb_steps == {"complex": 0}
