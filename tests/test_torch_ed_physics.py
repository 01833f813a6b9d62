"""Full-pipeline physics anchors of the PyTorch port: the counterparts of
``tests/test_physics_integration.py`` with its models, counts and
tolerances, float64 on the CPU, through the port's own samplers,
stochastic estimator and measurement assembly.

1. Single-site Holstein: the measured density, double occupancy and ⟨x²⟩
   against exact diagonalisation.
2. 4×4 Holstein: HMC and RK Langevin sample the same ensemble (density,
   ⟨x⟩ and ⟨x²⟩ within the combined statistical error).
3. The two-site SSH dimer (``examples/ssh_hmc_two_site.toml``) under HMC
   and under Langevin: density, ⟨x⟩ and ⟨x²⟩ against ED.
4. The two-site Holstein dimer away from half filling under HMC: density,
   ⟨x⟩ and ⟨x²⟩ against ED.
"""

import pytest

import torch_ed_helpers as E
from ed_reference import single_site_holstein_ed, two_site_holstein_ed, two_site_ssh_ed
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure.measurements import MeasurementSpec
from elphdynamics_tpu_torch.models import holstein as H
from elphdynamics_tpu_torch.models.adapter import make_model_ops

# minutes each on a CPU: they run only when their marker is selected
# (`pytest -m ed_anchor tests/test_torch_ed_*.py`) and skip otherwise
pytestmark = [pytest.mark.ed_anchor,
              pytest.mark.skipif("'ed_anchor' not in config.getoption('markexpr')",
                                 reason="exact-diagonalisation anchor: select it with "
                                        "-m ed_anchor")]


def test_single_site_full_pipeline_matches_ed():
    beta, dtau, lam, mu = 2.0, 0.1, 1.0, -0.5
    ops, params = E.single_site(beta, dtau, 1.0, lam, mu)
    ed = single_site_holstein_ed(beta, 1.0, lam, mu)
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-6, maxiter=1000)
    res, _ = E.run_hmc_with_measurements(ops, params, cfg, MeasurementSpec(nv=10),
                                         n_chains=24, burnin=60, nmeas=150)
    assert E.near("single site density", E.scalar(res, "global", "density"), ed["n"], 0.08)
    assert E.near("single site docc", E.scalar(res, "onsite", "double_occ"), ed["docc"], 0.08)
    assert E.near("single site x2", E.scalar(res, "onsite", "x2"), ed["x2"], 0.08)


def test_hmc_langevin_agree_4x4():
    lat = Lattice.create(UnitCell.create(*E.SQUARE), 4)
    spec, params = H.build_holstein(lat, beta=1.0, dtau=0.1, t_assignments=E.SQUARE_HOPS,
                                    omega=1.0, lam=0.5, mu=0.0, device="cpu")
    ops = make_model_ops(spec)
    mspec = MeasurementSpec(nv=6)
    cfg = HMCConfig(dt=0.05, trajectory_time=0.5, Nb=4, tol=1e-6, maxiter=1000)
    res_h, _ = E.run_hmc_with_measurements(ops, params, cfg, mspec, n_chains=8, burnin=40,
                                           nmeas=80)
    res_l = E.run_langevin_with_measurements(ops, params, mspec, n_chains=8, burnin=400,
                                             nmeas=80, every=10, dt=0.01, seed=5)
    assert E.near("4x4 density hmc vs langevin", E.scalar(res_h, "global", "density"),
                  E.scalar(res_l, "global", "density"), 0.08)
    for key, tol in (("x", 0.1), ("x2", 0.12)):
        assert E.near(f"4x4 {key} hmc vs langevin", E.scalar(res_h, "onsite", key),
                      E.scalar(res_l, "onsite", key), tol)


def test_two_site_ssh_dimer_hmc_matches_ed():
    beta, dtau, t, alpha, omega = 2.0, 0.1, 1.0, 0.5, 1.0
    ops, params = E.ssh_dimer(beta, dtau, t, alpha, omega)
    ed = two_site_ssh_ed(beta, omega, t, alpha)
    cfg = HMCConfig(dt=0.1, trajectory_time=1.0, Nb=10, tol=1e-6, maxiter=2000)
    res, _ = E.run_hmc_with_measurements(ops, params, cfg, MeasurementSpec(nv=8),
                                         n_chains=24, burnin=80, nmeas=250)
    assert E.near("ssh dimer hmc density", E.scalar(res, "global", "density"), ed["n"], 0.08)
    assert E.near("ssh dimer hmc x", E.scalar(res, "intersite", "x"), ed["x"], 0.08)
    assert E.near("ssh dimer hmc x2", E.scalar(res, "intersite", "x2"), ed["x2"], 0.1)


def test_two_site_ssh_dimer_langevin_matches_ed():
    beta, dtau, t, alpha, omega = 2.0, 0.1, 1.0, 0.5, 1.0
    ops, params = E.ssh_dimer(beta, dtau, t, alpha, omega)
    ed = two_site_ssh_ed(beta, omega, t, alpha)
    res = E.run_langevin_with_measurements(ops, params, MeasurementSpec(nv=8), n_chains=24,
                                           burnin=300, nmeas=120, every=5, dt=0.02, seed=3)
    assert E.near("ssh dimer langevin density", E.scalar(res, "global", "density"), ed["n"],
                  0.08)
    assert E.near("ssh dimer langevin x", E.scalar(res, "intersite", "x"), ed["x"], 0.1)
    assert E.near("ssh dimer langevin x2", E.scalar(res, "intersite", "x2"), ed["x2"], 0.12)


def test_two_site_holstein_dimer_hmc_matches_ed():
    beta, dtau, t, omega, lam, mu = 2.0, 0.1, 1.0, 1.0, 0.6, -0.4
    lat = Lattice.create(UnitCell.create(1, 2, [[1.0]], [[0.0], [0.5]]), 1)
    spec, params = H.build_holstein(lat, beta=beta, dtau=dtau,
                                    t_assignments=[(t, 0.0, 0, 1, (0, 0, 0))],
                                    omega=omega, lam=lam, mu=mu, device="cpu")
    ops = make_model_ops(spec)
    ed = two_site_holstein_ed(beta, omega, t, lam, mu=mu)
    cfg = HMCConfig(dt=0.1, trajectory_time=1.0, Nb=10, tol=1e-6, maxiter=2000)
    res, _ = E.run_hmc_with_measurements(ops, params, cfg, MeasurementSpec(nv=8),
                                         n_chains=24, burnin=80, nmeas=250)
    assert E.near("holstein dimer density", E.scalar(res, "global", "density"), ed["n"], 0.08)
    assert E.near("holstein dimer x", E.site_mean(res, "onsite", "x"), ed["x"], 0.08)
    assert E.near("holstein dimer x2", E.site_mean(res, "onsite", "x2"), ed["x2"], 0.1)
