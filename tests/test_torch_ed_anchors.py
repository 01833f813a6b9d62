"""The remaining exact-diagonalisation anchors of the JAX suite, ported to
the PyTorch port with their models, counts and tolerances, on the CPU:

* ``tests/test_tempering.py::test_tempering_rung0_matches_ed``: a 2-rung
  coupling ladder (λ·(1, 0.7)) composed with batched HMC; rung 0's
  single-site phonon moments against ED, so the exchange does not bias
  the target;
* ``tests/test_accum.py::test_f32_single_site_observables_match_ed``: the
  single site through the full pipeline in float32 (the dtype of every card
  run): density and ⟨x²⟩ against ED;
* ``tests/test_free_fermion_anchor.py::test_8x8_atomic_limit_hmc_anchor``:
  t = 0 at 8×8, β = 4, 64 independent single sites under the full
  production-shape sampler, against single-site ED.
"""

import numpy as np
import pytest
import torch

import torch_ed_helpers as E
from ed_reference import single_site_holstein_ed
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.tempering import (
    TemperingConfig, ladder_params, make_exchange_step, target_mask)
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


def test_tempering_rung0_matches_ed():
    BETA, OMEGA, LAM, MU = 2.0, 1.0, 1.0, -0.5
    ops, params = E.single_site(BETA, 0.1, OMEGA, LAM, MU)
    tcfg = TemperingConfig(ladder=(1.0, 0.7), freq=2, tol=1e-6)
    C = 48  # 24 per rung
    ps = ladder_params(params, tcfg, C)
    mask = target_mask(tcfg, C)
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-6, maxiter=500)
    step = make_hmc_step(ops, E.mass_table(ops, params), cfg)
    ex = make_exchange_step(ops, tcfg, C)
    g = torch.Generator().manual_seed(5)
    x = E.start_fields(ops, params, C, g)
    st = HMCState(x=x, v=torch.zeros_like(x))
    xh, exch_acc = [], []
    for n in range(380):
        st, _ = step(ps, st, g)
        if (n + 1) % tcfg.freq == 0:
            xn, vn, acc, _, fl = ex(ps, st.x, st.v, (n // tcfg.freq) % 2, g)
            assert int(fl) == 0
            st = HMCState(x=xn, v=vn)
            exch_acc.append(float(acc))
        if n >= 80:
            xh.append(st.x.numpy()[mask])
    xh = np.concatenate(xh)
    ed = single_site_holstein_ed(BETA, OMEGA, LAM, MU)
    assert np.mean(exch_acc) > 0.05, np.mean(exch_acc)
    assert E.near("tempering rung 0 x", xh.mean(), ed["x"], 0.05)
    assert E.near("tempering rung 0 x2", (xh ** 2).mean(), ed["x2"], 0.06)


def test_f32_single_site_observables_match_ed():
    beta, dtau, lam, mu = 2.0, 0.1, 1.0, -0.5
    ops, params = E.single_site(beta, dtau, 1.0, lam, mu, dtype=torch.float32)
    ed = single_site_holstein_ed(beta, 1.0, lam, mu)
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-5, maxiter=1000,
                    construct_guess=True)
    res, _ = E.run_hmc_with_measurements(ops, params, cfg, MeasurementSpec(nv=10),
                                         n_chains=24, burnin=60, nmeas=120)
    assert res["global"]["density"].dtype == torch.float32
    assert E.near("f32 single site density", E.scalar(res, "global", "density"), ed["n"], 0.08)
    assert E.near("f32 single site x2", E.scalar(res, "onsite", "x2"), ed["x2"], 0.1)


def test_8x8_atomic_limit_hmc_anchor():
    L, beta, dtau = 8, 4.0, 0.1
    omega, lam, mu = 1.0, 0.8, -0.4
    lat = Lattice.create(UnitCell.create(*E.SQUARE), L)
    spec, params = H.build_holstein(lat, beta=beta, dtau=dtau, omega=omega, lam=lam, mu=mu,
                                    device="cpu")
    ops = make_model_ops(spec)
    ed = single_site_holstein_ed(beta, omega, lam, mu)
    cfg = HMCConfig(dt=0.05, trajectory_time=1.0, Nb=4, tol=1e-6, maxiter=1000)
    res, _ = E.run_hmc_with_measurements(ops, params, cfg, MeasurementSpec(nv=6),
                                         n_chains=6, burnin=40, nmeas=60)
    assert E.near("8x8 atomic density", E.scalar(res, "global", "density"), ed["n"], 0.05)
    assert E.near("8x8 atomic docc", E.scalar(res, "onsite", "double_occ"), ed["docc"], 0.05)
    assert E.near("8x8 atomic x", E.scalar(res, "onsite", "x"), ed["x"], 0.05)
    assert E.near("8x8 atomic x2", E.scalar(res, "onsite", "x2"), ed["x2"], 0.07)
    # the anchor is only meaningful away from the trivial point
    assert abs(ed["n"] - 1.0) > 0.05 and abs(ed["x"]) > 0.05
