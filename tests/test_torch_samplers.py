"""The 2MN integrator and the dynamic-dt update of the PyTorch port against
the JAX package, float64 on the CPU.

* One 2MN update (``integrator="2mn"``), Nb ∈ {1, 4}, for a 4×4 Holstein
  model on the dense and the fold branch (``dense_threshold=0``) and a 4×4
  SSH model with the dense Ā and with the dense gate closed in both
  packages: x, v and ΔH within 1e-10, equal accept decisions, flags and
  mean CG iterations, with JAX's draws injected (``HMCDraws``).
* The dynamic-dt update (``dynamic_dt=True``) at a dt other than
  ``cfg.dt``, leapfrog and 2MN: the same tolerances.
* The 2MN update makes 2·Nt + 2 solves (one preconditioner refresh each),
  and its verbose per-step rows equal JAX's.
* The warm-start history (``zhist_*``) against an unrolled buffer oracle.
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
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch.dynamics.hmc import (
    LAM_2MN, HMCConfig, HMCDraws, HMCState, make_hmc_step, zhist_guess, zhist_init,
    zhist_last, zhist_push, zhist_size)
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import kpm

torch.set_num_threads(1)

C = 2
UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
HOP = dict(t=1.0, t_std=0.1, alpha=0.3, alpha_std=0.05, alpha2=0.1, alpha2_std=0.02,
           omega=1.0, omega_std=0.1, omega4=0.05, o1=0, o2=0)
KPM = dict(max_order=4)
BASE = dict(trajectory_time=0.2, tol=1e-5, maxiter=500, construct_guess=True, guess_order=3)


def T(a):
    return torch.as_tensor(np.asarray(a))


def _holstein(dense_threshold):
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, lam=1.0, mu=0.0, dense_threshold=dense_threshold)
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC), 4), 1.0, 0.1,
                              rng=np.random.default_rng(5), **kw)
    ts, tp = build_holstein(Lattice.create(UnitCell.create(*UC), 4), 1.0, 0.1,
                            rng=np.random.default_rng(5), device="cpu", **kw)
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((C, js.Nsites, 1)) + 0.1 * rng.standard_normal(
        (C, js.Nsites, js.Ltau))
    return js, jp, ts, tp, x0, rng.standard_normal(x0.shape)


def _ssh():
    hops = [dict(HOP, dL=(1, 0, 0), name="x"), dict(HOP, dL=(0, 1, 0), name="y")]
    js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*UC), 4), 1.0, 0.1, hoppings=hops,
                          mu_assignments=[(-0.2, 0.1, None)], rng=np.random.default_rng(3))
    ts, tp = TS.build_ssh(Lattice.create(UnitCell.create(*UC), 4), 1.0, 0.1, hoppings=hops,
                          mu_assignments=[(-0.2, 0.1, None)], rng=np.random.default_rng(3),
                          dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    x0 = TS.tie_fields(ts, T(0.3 * rng.standard_normal((C, ts.Nph, ts.Ltau)))).numpy()
    v0 = TS.tie_fields(ts, T(rng.standard_normal(x0.shape))).numpy()
    return js, jp, ts, tp, x0, v0


def _model(name, monkeypatch):
    """(JAX spec, params, port spec, params, x0, v0) of ``name``: Holstein on
    the dense or fold branch, SSH with the dense Ā or the fold Ā."""
    if name.startswith("holstein"):
        return _holstein(2048 if name.endswith("dense") else 0)
    if name.endswith("fold"):
        monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
        monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    return _ssh()


def _jax_draws(keys, Nph, N, Ltau):
    """The draws of the JAX update from each chain key, and the KPM start
    vectors of its preconditioner."""
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (Nph, Ltau), dtype=jnp.float64)))
        Rpm.append(np.asarray(jax.random.normal(k_p, (2, N, Ltau), dtype=jnp.float64)))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    start = tuple(T(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64))) for k in (k1, k2))
    return HMCDraws(momentum=T(np.stack(R)), pseudofermion=T(np.stack(Rpm)),
                    uniform=T(np.asarray(U)), kpm_start=start)


def _run_both(model, cfg, dt=None):
    """One update of each chain by the JAX step (with ``dt``: its dynamic-dt
    form) and one batched update by the port's, from the same fields and
    draws."""
    js, jp, ts, tp, x0, v0 = model
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    mass = build_mass(tp.omega.numpy(), ts.dtau, ts.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM)),
                                    dynamic_dt=dt is not None))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    extra = () if dt is None else (jnp.asarray(dt, jnp.float64),)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c], *extra)
            for c in range(C)]
    jstate = jax.tree.map(lambda *a: np.stack(a), *[r[0] for r in runs])
    jstats = jax.tree.map(lambda *a: np.stack(a), *[r[1] for r in runs])
    refreshes = []
    base = kpm.make_symmetric_precond(tops, kpm.KPMConfig(**KPM))
    counted = kpm.Preconditioner(
        setup=base.setup, symmetric=base.symmetric,
        refresh=lambda st, p, x: refreshes.append(1) or base.refresh(st, p, x))
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg), counted, dynamic_dt=dt is not None)
    draws = _jax_draws(keys, ts.Nph, ts.Nsites, ts.Ltau)
    state = HMCState(x=T(x0), v=T(v0))
    if dt is None:
        tstate, tstats = tstep(tp, state, draws=draws)
    else:
        tstate, tstats = tstep(tp, state, torch.tensor(dt, dtype=torch.float64), draws=draws)
    return jstate, jstats, tstate, tstats, len(refreshes)


def _check(jstate, jstats, tstate, tstats):
    np.testing.assert_allclose(tstats.delta_H.numpy(), jstats.delta_H, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tstate.x.numpy(), jstate.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tstate.v.numpy(), jstate.v, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tstats.accepted.numpy(), jstats.accepted)
    np.testing.assert_array_equal(tstats.flag.numpy(), jstats.flag)
    np.testing.assert_array_equal(tstats.iters.numpy(), jstats.iters)
    assert np.all(jstats.flag == 0)


MODELS = ["holstein_dense", "holstein_fold", "ssh_dense", "ssh_fold"]


@pytest.mark.parametrize("Nb", [1, 4], ids=["Nb1", "Nb4"])
@pytest.mark.parametrize("name", MODELS)
def test_2mn_update_matches_jax(name, Nb, monkeypatch):
    cfg = dict(BASE, dt=0.1, Nb=Nb, integrator="2mn")
    jstate, jstats, tstate, tstats, n_solves = _run_both(_model(name, monkeypatch), cfg)
    _check(jstate, jstats, tstate, tstats)
    # Nt = 2 steps of two solves each, and the two endpoint solves
    assert HMCConfig(**cfg).Nt == 2 and n_solves == 2 * 2 + 2


@pytest.mark.parametrize("integrator", ["leapfrog", "2mn"])
def test_dynamic_dt_update_matches_jax(integrator, monkeypatch):
    """dt = 0.04 handed to the step; cfg.dt = 0.05 fixes Nt = 4."""
    cfg = dict(BASE, dt=0.05, Nb=2, integrator=integrator)
    jstate, jstats, tstate, tstats, n_solves = _run_both(_model("holstein_dense", monkeypatch),
                                                          cfg, dt=0.04)
    _check(jstate, jstats, tstate, tstats)
    assert n_solves == (2 if integrator == "2mn" else 1) * 4 + 2
    # a different dt gives a different trajectory than cfg.dt's
    _, _, fixed, _, _ = _run_both(_model("holstein_dense", monkeypatch), cfg)
    assert not torch.allclose(fixed.x, tstate.x) or not torch.equal(fixed.v, tstate.v)


def test_2mn_verbose_rows_match_jax(monkeypatch):
    """The per-step rows of the verbose log: the energies at the end of each
    2MN step and the iterations of both its solves."""
    cfg = dict(BASE, dt=0.1, Nb=2, integrator="2mn", log_verbose=True)
    jstate, jstats, tstate, tstats, _ = _run_both(_model("ssh_dense", monkeypatch), cfg)
    _check(jstate, jstats, tstate, tstats)
    for name in ("traj_H", "traj_S", "traj_K"):
        np.testing.assert_allclose(getattr(tstats, name).numpy(), getattr(jstats, name),
                                   rtol=1e-12)
    np.testing.assert_array_equal(tstats.traj_iters.numpy(), jstats.traj_iters)
    assert tstats.traj_H.shape == (C, 2)


def test_2mn_coefficient_and_unknown_integrator():
    assert LAM_2MN == pytest.approx(0.1931833275037836, abs=0)
    _, _, ts, _, _, _ = _holstein(2048)
    with pytest.raises(ValueError, match="integrator"):
        make_hmc_step(make_model_ops(ts), np.ones((ts.Nph, ts.Ltau)),
                      HMCConfig(dt=0.1, trajectory_time=0.2, integrator="verlet"))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_zhist_rotation_matches_unrolled_oracle(order):
    """The warm-start history reproduces explicit newest-first buffers: the
    same extrapolated guess at every step, and a chain's history frozen
    once its liveness mask drops (chain 1 after 5 steps, chain 0 after 8)."""
    rng = np.random.default_rng(7)
    z0 = T(rng.normal(size=(2, 2, 5, 3)))
    zs = [T(rng.normal(size=z0.shape)) for _ in range(11)]
    hist = zhist_init(z0, order)
    assert len(hist) == zhist_size(order) == max(1, min(order, 4))
    bufs = [[z0[c]] * 4 for c in range(2)]

    def oracle(buf):
        zp, zp2, zp3, zp4 = buf
        if order >= 4:
            return 4.0 * zp - 6.0 * zp2 + 4.0 * zp3 - zp4
        if order == 3:
            return 3.0 * zp - 3.0 * zp2 + zp3
        if order == 2:
            return 2.0 * zp - zp2
        return zp

    for step, z in enumerate(zs):
        guess = zhist_guess(hist, order)
        for c in range(2):
            assert torch.equal(guess[c], oracle(bufs[c]))
            assert torch.equal(zhist_last(hist)[c], bufs[c][0])
        ok = torch.tensor([step < 8, step < 5])
        hist = zhist_push(hist, z, ok)
        for c in range(2):
            if bool(ok[c]):
                bufs[c] = [z[c]] + bufs[c][:3]
