"""One whole HMC update of the PyTorch port against the JAX package.

Same model, same start fields, and JAX's own random draws fed to the port
(``HMCDraws``), on the dense branch and on the fold branch
(``dense_threshold=0``), 2 chains, float64 on the CPU, and once with the
verbose per-timestep energies. ΔH agrees to 1e-9
absolute, x and v to 1e-10, and the accept decisions, flags and mean CG
iterations are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch.dynamics.hmc import (
    HMCConfig, HMCDraws, HMCState, init_deflation, make_hmc_step)
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import kpm

torch.set_num_threads(1)

L, BETA, DTAU = 4, 1.0, 0.1
T_ASSIGN = [(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))]
CFG = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-5, maxiter=500,
           construct_guess=True, guess_order=3)
KPM = dict(max_order=4)
N_CHAINS = 2


def _models(dense_threshold):
    kw = dict(t_assignments=T_ASSIGN, omega=1.0, lam=1.0, mu=0.0,
              dense_threshold=dense_threshold)
    uc = JUnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    jspec, jparams = j_build_holstein(JLattice.create(uc, L), BETA, DTAU,
                                      rng=np.random.default_rng(5), **kw)
    uct = UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    tspec, tparams = build_holstein(Lattice.create(uct, L), BETA, DTAU,
                                    rng=np.random.default_rng(5), device="cpu", **kw)
    return jspec, jparams, tspec, tparams


def _jax_draws(keys, N, Ltau):
    """The draws of elphdynamics_tpu/dynamics/hmc.py:_step for each chain
    key, and the KPM start vectors of kpm.make_symmetric_precond."""
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (N, Ltau), dtype=jnp.float64)))
        Rpm.append(np.asarray(jax.random.normal(k_p, (2, N, Ltau), dtype=jnp.float64)))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    start = tuple(torch.as_tensor(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64)))
                  for k in (k1, k2))
    return HMCDraws(momentum=torch.as_tensor(np.stack(R)),
                    pseudofermion=torch.as_tensor(np.stack(Rpm)),
                    uniform=torch.as_tensor(np.asarray(U)), kpm_start=start)


@pytest.mark.parametrize("dense_threshold,verbose", [(2048, False), (0, False), (2048, True)],
                         ids=["dense", "fold", "dense_verbose"])
def test_hmc_update_matches_jax(dense_threshold, verbose):
    jspec, jparams, tspec, tparams = _models(dense_threshold)
    assert tspec.dense_ckb == (dense_threshold > 0)
    N, Ltau = jspec.Nsites, jspec.Ltau
    mass = build_mass(np.asarray(jparams.omega), DTAU, Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((N_CHAINS, N, 1)) + 0.1 * rng.standard_normal((N_CHAINS, N, Ltau))
    v0 = rng.standard_normal((N_CHAINS, N, Ltau))

    jops = j_make_model_ops(jspec)
    cfg = {**CFG, "log_verbose": verbose}
    jstep = j_make_hmc_step(jops, mass, JHMCConfig(**cfg),
                            jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM)))
    keys = jax.random.split(jax.random.PRNGKey(3), N_CHAINS)
    # chains one at a time through one compiled step (equal to the vmapped
    # step chain by chain, and cheaper to compile)
    jit_step = jax.jit(jstep)
    runs = [jit_step(jparams, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(N_CHAINS)]
    jstate = jax.tree.map(lambda *a: np.stack(a), *[r[0] for r in runs])
    jstats = jax.tree.map(lambda *a: np.stack(a), *[r[1] for r in runs])

    tops = make_model_ops(tspec)
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg),
                          kpm.make_symmetric_precond(tops, kpm.KPMConfig(**KPM)))
    tstate, tstats = tstep(tparams, HMCState(x=torch.as_tensor(x0), v=torch.as_tensor(v0)),
                           draws=_jax_draws(keys, N, Ltau))

    np.testing.assert_allclose(tstats.delta_H.numpy(), np.asarray(jstats.delta_H), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tstats.accepted.numpy(), np.asarray(jstats.accepted))
    np.testing.assert_array_equal(tstats.flag.numpy(), np.asarray(jstats.flag))
    np.testing.assert_array_equal(tstats.iters.numpy(), np.asarray(jstats.iters))
    np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tstate.v.numpy(), np.asarray(jstate.v), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tstats.H.numpy(), np.asarray(jstats.H), rtol=1e-12)
    assert np.all(np.asarray(jstats.flag) == 0)
    if verbose:  # the per-timestep rows of the verbose HMC log
        for name in ("traj_H", "traj_S", "traj_K"):
            np.testing.assert_allclose(getattr(tstats, name).numpy(),
                                       np.asarray(getattr(jstats, name)), rtol=1e-12)
        np.testing.assert_array_equal(tstats.traj_iters.numpy(), np.asarray(jstats.traj_iters))
    else:
        assert tstats.traj_H is None


def test_hmc_update_draws_from_generator():
    """Without injected draws the step draws from its generator: the same
    seed gives the same update, another seed another one."""
    _, _, tspec, tparams = _models(2048)
    tops = make_model_ops(tspec)
    mass = build_mass(tparams.omega.numpy(), DTAU, tspec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    step = make_hmc_step(tops, mass, HMCConfig(**CFG),
                         kpm.make_symmetric_precond(tops, kpm.KPMConfig(**KPM)))
    x0 = torch.zeros((N_CHAINS, tspec.Nph, tspec.Ltau), dtype=torch.float64)
    state = HMCState(x=x0, v=torch.zeros_like(x0))
    out = [step(tparams, state, torch.Generator().manual_seed(s))[1].delta_H for s in (1, 1, 2)]
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], out[2])
    assert torch.isfinite(out[0]).all()


def test_hmc_unported_options_raise():
    """Every sampler option of the JAX package builds and runs: the 2MN
    integrator, the dynamic-dt step of the burn-in tuner and deflation (each
    one finite update); an unknown solver kind or integrator raises."""
    _, _, tspec, tparams = _models(2048)
    tops = make_model_ops(tspec)
    mass = build_mass(tparams.omega.numpy(), DTAU, tspec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    pre = kpm.make_symmetric_precond(tops, kpm.KPMConfig(**KPM))
    x0 = 0.1 * torch.ones((N_CHAINS, tspec.Nph, tspec.Ltau), dtype=torch.float64)
    for opts, dyn in ((dict(integrator="2mn"), False), (dict(tune_dt=True), True),
                      (dict(deflate_k=2), False)):
        cfg = HMCConfig(**{**CFG, **opts})
        step = make_hmc_step(tops, mass, cfg, pre, dynamic_dt=dyn)
        defl = init_deflation(tops, cfg, N_CHAINS, torch.Generator().manual_seed(1),
                              device="cpu")
        assert (defl is None) == (cfg.deflate_k == 0)
        state = HMCState(x=x0, v=torch.zeros_like(x0), defl=defl)
        args = (torch.tensor(0.04, dtype=torch.float64),) if dyn else ()
        out, stats = step(tparams, state, *args, torch.Generator().manual_seed(2))
        assert torch.isfinite(out.x).all() and torch.isfinite(stats.delta_H).all()
        assert (stats.flag == 0).all()
        if cfg.deflate_k:
            assert out.defl.W.shape == (N_CHAINS, 2, tspec.Nsites, tspec.Ltau)
    with pytest.raises(ValueError):
        make_hmc_step(tops, mass, HMCConfig(**{**CFG, "solver_kind": "minres"}))
    with pytest.raises(ValueError, match="integrator"):
        make_hmc_step(tops, mass, HMCConfig(**{**CFG, "integrator": "verlet"}))
    # ported before: block CG, the other solver kinds, the KPM options
    for ok in (dict(block=True), dict(solver_kind="gmres"), dict(solver_kind="bicgstab")):
        assert callable(make_hmc_step(tops, mass, HMCConfig(**{**CFG, **ok})))
    for ok in (dict(stacked=True), dict(exact_lowfreq=2)):
        assert kpm.make_symmetric_precond(tops, kpm.KPMConfig(**ok)).left is None
