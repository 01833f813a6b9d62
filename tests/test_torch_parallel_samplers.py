"""The PyTorch port's other samplers on a site-sharded Holstein model,
against the port's one-rank samplers from equal generators, on 2 and 4
gloo ranks on the CPU in float64.

On a 4×4 lattice with 2 chains and the KPM preconditioner: three
reflection moves and three swap moves (the swapped rows travel by
all-reduce), one Euler, Runge-Kutta and Heun Langevin step, and a
Green's-function sample of 4 probes (the probes drawn for every site and
cut to the block, the solutions gathered afterwards), plain and twisted.
Fields agree to 1e-12 (probe solutions to 1e-10); acceptance rates and
solver iterations are equal.
"""

import numpy as np
import pytest

import torch_parallel_workers as W
from elphdynamics_tpu_torch.parallel.multihost import launch

TIMEOUT = 180


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", ["plain", "twist"])
def test_sharded_samplers_match_one_rank(case, D, tmp_path):
    out = launch(W.sampler_worker, D, "gloo", "cpu", (4, case, 2), timeout_s=TIMEOUT,
                 threads=1, store_dir=str(tmp_path))
    for r in out:
        for name in ("reflection", "swap"):
            diff, rate1, rate2 = r[name]
            assert diff < 1e-12, (name, diff)
            assert rate1 == rate2, (name, rate1, rate2)
        # the moves did something: some accepted, some rejected over both
        rates = np.asarray(r["reflection"][1] + r["swap"][1])
        assert rates.max() > 0
        for method in ("euler", "rk", "heun"):
            diff, it1, it2 = r[method]
            assert diff < 1e-12, (method, diff)
            assert it1 == it2, (method, it1, it2)
        dz, dR, it1, it2 = r["greens"]
        assert dR == 0.0
        assert dz < 1e-10, dz
        assert it1 == it2
