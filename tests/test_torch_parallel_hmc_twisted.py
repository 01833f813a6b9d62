"""The site-sharded Holstein HMC update of the PyTorch port on a twisted
lattice (complex hopping: complex halos, conj(s) on the second endpoint of
a bond) and with a dynamic dt (the burn-in tuner's step), against the JAX
package's unsharded ``make_hmc_step`` and the port's one-rank step on 2 and
4 gloo ranks; the checks of ``test_torch_parallel_hmc.py``.
"""

import pytest

from test_torch_parallel_hmc import _check


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case,dt", [("twist", None), ("plain", 0.04)],
                         ids=["twist", "dynamic_dt"])
def test_sharded_hmc_update_matches_jax(case, dt, D, tmp_path):
    _check(case, dt, D, tmp_path)
