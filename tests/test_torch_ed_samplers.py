"""The PyTorch port's samplers on the exactly solvable single-site Holstein
model (β = 2, Δτ = 0.1, ω = 1, λ = 1, μ = −0.5), against exact
diagonalisation (``tests/ed_reference.py``): the counterparts of
``tests/test_samplers.py``'s HMC, Langevin and 2MN anchors, with their
models, counts and tolerances, float64 on the CPU. Phonon moments from
every recorded update of every chain agree with ED up to the Trotter
(O(Δτ²)) and statistical error.
"""

import pytest
import torch

import torch_ed_helpers as E
from ed_reference import single_site_holstein_ed
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step

# minutes each on a CPU: they run only when their marker is selected
# (`pytest -m ed_anchor tests/test_torch_ed_*.py`) and skip otherwise
pytestmark = [pytest.mark.ed_anchor,
              pytest.mark.skipif("'ed_anchor' not in config.getoption('markexpr')",
                                 reason="exact-diagonalisation anchor: select it with "
                                        "-m ed_anchor")]

BETA, OMEGA, LAM, MU = 2.0, 1.0, 1.0, -0.5


def test_hmc_single_site_matches_ed():
    ops, params = E.single_site()
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-6, maxiter=500)
    xh, acc = E.run_hmc_chains(ops, params, cfg, n_chains=48, burnin=80, nsteps=300)
    assert acc.mean() > 0.6, f"HMC acceptance too low: {acc.mean()}"
    ed = single_site_holstein_ed(BETA, OMEGA, LAM, MU)
    assert E.near("hmc x", xh.mean(), ed["x"], 0.05)
    assert E.near("hmc x2", (xh ** 2).mean(), ed["x2"], 0.06)


def test_langevin_single_site_matches_ed():
    ops, params = E.single_site()
    step = make_langevin_step(ops, E.q_table(ops, params), dt=0.02, method="rk",
                              scfg=SolverConfig(tol=1e-7, maxiter=500))
    g = torch.Generator().manual_seed(2)
    x = E.start_fields(ops, params, 64, g)
    for _ in range(500):          # burn-in
        x, _ = step(params, x, g)
    xs = []
    for _ in range(1500):
        x, _ = step(params, x, g)
        xs.append(x.clone())
    xh = torch.stack(xs).numpy()
    ed = single_site_holstein_ed(BETA, OMEGA, LAM, MU)
    assert E.near("langevin x", xh.mean(), ed["x"], 0.1)
    assert E.near("langevin x2", (xh ** 2).mean(), ed["x2"], 0.1)


def test_hmc_2mn_single_site_matches_ed():
    """2MN at twice the leapfrog dt samples the same distribution."""
    ops, params = E.single_site()
    cfg = HMCConfig(dt=0.1, trajectory_time=1.0, Nb=4, tol=1e-6, maxiter=500,
                    integrator="2mn")
    xh, acc = E.run_hmc_chains(ops, params, cfg, n_chains=48, burnin=80, nsteps=300)
    assert acc.mean() > 0.9, f"2MN acceptance too low: {acc.mean()}"
    ed = single_site_holstein_ed(BETA, OMEGA, LAM, MU)
    assert E.near("2mn x", xh.mean(), ed["x"], 0.05)
    assert E.near("2mn x2", (xh ** 2).mean(), ed["x2"], 0.06)
