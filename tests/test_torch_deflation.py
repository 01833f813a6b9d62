"""Slow-mode deflation of the PyTorch port against the JAX package, float64
on the CPU.

* From the same starting basis, ``refresh`` gives JAX's projector W†W and
  λmax within 1e-8, on a static diagonal operator (real) and a static
  Hermitian one (complex), with a bulk near 1 and a few small outliers (the
  shape of a preconditioned deep-β spectrum). The projector is compared, not
  W: sign, phase and order of the basis are free.
* ``project`` is exact within the span; a deflated CG on the static operator
  reaches the same solution at tol 1e-8 in a quarter of the iterations.
* One HMC update with ``deflate_k > 0`` (real and twisted hopping) equals
  JAX's within 1e-10 in x, v and ΔH with equal iterations, from the same
  float64 basis.
* A missing basis, and a real basis under complex hopping, are
  ``ValueError`` s.
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
from elphdynamics_tpu.ops import deflation as jdefl
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.dynamics.hmc import (
    HMCConfig, HMCDraws, HMCState, init_deflation, make_hmc_step)
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import deflation, kpm

torch.set_num_threads(1)

N, LT = 4, 8
C = 2


def _operator(cplx: bool, seed=0, n_slow=6):
    """(eigenvalues, ascending eigenvectors [n, n], JAX apply, port apply) of
    a static SPD / Hermitian PD operator on [N, Lτ] fields."""
    rng = np.random.default_rng(seed)
    n = N * LT
    vals = np.concatenate([np.geomspace(0.001, 0.05, 8)[:n_slow],
                           np.exp(rng.uniform(np.log(0.85), np.log(1.0), n - n_slow))])
    if cplx:
        U, _ = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    else:
        U = np.eye(n)
    A = (U * vals) @ U.conj().T
    A = 0.5 * (A + A.conj().T)
    if not cplx:
        A = A.real
    Aj, At = jnp.asarray(A), torch.as_tensor(A)

    def j_apply(v):
        return jnp.einsum("ij,...j->...i", Aj, v.reshape(v.shape[:-2] + (-1,))).reshape(v.shape)

    def t_apply(v):
        return torch.einsum("ij,...j->...i", At.to(v.dtype),
                            v.reshape(v.shape[:-2] + (-1,))).reshape(v.shape)

    return vals, U[:, np.argsort(vals)], j_apply, t_apply


def _dense(apply, dtype):
    """The operator of ``apply`` as a dense ``[n, n]`` matrix."""
    eye = torch.eye(N * LT, dtype=dtype).reshape(N * LT, N, LT)
    return apply(eye).reshape(N * LT, -1).mT


def _jax_states(k, cplx, seeds=(0, 1)):
    dt = jnp.complex128 if cplx else jnp.float64
    return [jdefl.init(jax.random.PRNGKey(s), k, N, LT, dtype=dt) for s in seeds]


def _port_state(jstates):
    """The JAX per-chain states stacked on a leading chain axis."""
    return deflation.DeflationState(*(torch.as_tensor(np.stack([np.asarray(getattr(s, f))
                                                                for s in jstates]))
                                      for f in ("W", "chol", "pvec", "lam_max")))


def _projector(W):
    """Σᵢ wᵢ·wᵢ† over the basis rows of one chain ``[k, N, Lτ]``."""
    Wf = np.asarray(W).reshape(W.shape[0], -1)
    return Wf.T @ Wf.conj()


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_refresh_matches_jax(cplx):
    _, _, j_apply, t_apply = _operator(cplx)
    cfg = deflation.DeflationConfig(k=8, filter_degree=6, power_iters=8)
    jcfg = jdefl.DeflationConfig(k=8, filter_degree=6, power_iters=8)
    jst = _jax_states(cfg.k, cplx)
    tst = _port_state(jst)
    for _ in range(3):
        jst = [jdefl.refresh(s, j_apply, lambda v: v, jcfg) for s in jst]
        tst = deflation.refresh(tst, t_apply, lambda v: v, cfg)
    assert tst.W.shape == (C, cfg.k, N, LT) and tst.W.is_complex() == cplx
    for c in range(C):
        np.testing.assert_allclose(_projector(tst.W[c].numpy()), _projector(jst[c].W),
                                   rtol=0, atol=1e-8)
        assert float(tst.lam_max[c]) == pytest.approx(float(jst[c].lam_max), rel=1e-8)
        # the stored factor is that of WᵀAW at this basis, plus the jitter
        # 1e-6·tr/k on the diagonal
        Wf = tst.W[c].reshape(cfg.k, -1)
        G = Wf.conj() @ t_apply(tst.W[c]).reshape(cfg.k, -1).mT
        G = G + 1e-6 * G.diagonal().real.sum() / cfg.k * torch.eye(cfg.k)
        L = tst.chol[c]
        np.testing.assert_allclose((L @ L.mH).numpy(), G.numpy(), atol=1e-12)


def test_refresh_converges_to_the_slow_modes():
    vals, evecs, _, t_apply = _operator(True)
    cfg = deflation.DeflationConfig(k=8, filter_degree=6, power_iters=8)
    st = deflation.init(C, cfg.k, N, LT, dtype=torch.complex128, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for _ in range(6):
        st = deflation.refresh(st, t_apply, lambda v: v, cfg)
    P = _projector(st.W[0].numpy())
    for j in range(6):
        e = evecs[:, j]
        assert np.linalg.norm(e - P @ e) < 0.05


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_project_exact_within_span(cplx):
    _, _, _, t_apply = _operator(cplx, n_slow=0)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((N * LT, 2)) + (1j * rng.standard_normal((N * LT, 2)) if cplx else 0)
    q, _ = np.linalg.qr(q)
    W = torch.as_tensor(q.T.reshape(2, N, LT))
    G = W.reshape(2, -1).conj() @ t_apply(W).reshape(2, -1).mT
    st = deflation.DeflationState(W=W[None].expand(C, 2, N, LT), chol=torch.linalg.cholesky(G)
                                  .expand(C, 2, 2), pvec=torch.zeros((C, N, LT), dtype=W.dtype),
                                  lam_max=torch.ones(C, dtype=torch.float64))
    coef = ((1.7 - 0.6j, 0.4 + 1.1j) if cplx else (1.7, 0.4))
    x_true = (coef[0] * W[0] + coef[1] * W[1]).expand(C, 3, N, LT)
    b = t_apply(x_true)
    x0 = deflation.project(st, b, torch.zeros_like(b))
    np.testing.assert_allclose(x0.numpy(), x_true.numpy(), atol=1e-12)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_deflated_cg_same_solution_fewer_iterations(cplx):
    _, _, _, t_apply = _operator(cplx)
    cfg = deflation.DeflationConfig(k=8, filter_degree=6, power_iters=8)
    dt = torch.complex128 if cplx else torch.float64
    st = deflation.init(C, cfg.k, N, LT, dtype=dt, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for _ in range(12):
        st = deflation.refresh(st, t_apply, lambda v: v, cfg)
    g = torch.Generator().manual_seed(3)
    b = torch.randn((C, 2, N, LT), generator=g, dtype=torch.float64)
    if cplx:
        b = torch.complex(b, torch.randn((C, 2, N, LT), generator=g, dtype=torch.float64))
    tol = 1e-8
    plain = solvers.cg(t_apply, b, tol=tol, maxiter=2000)
    defl = solvers.cg(t_apply, b, tol=tol, maxiter=2000, deflate=st)
    assert bool(plain.converged.all()) and bool(defl.converged.all())
    # both within the error a 1e-8 residual allows, tol·|b|/λmin, of the
    # exact solution
    exact = torch.linalg.solve(_dense(t_apply, dt), b.reshape(C, 2, -1).mT).mT
    bound = tol * torch.linalg.vector_norm(b, dim=(-2, -1)).max() / 0.001
    for res in (plain, defl):
        assert float((res.x.reshape(C, 2, -1) - exact).abs().max()) < float(bound)
    # the slow modes are gone from the start: a quarter of the iterations
    assert int(defl.iters.max()) * 3 <= int(plain.iters.min())


def _holstein(twist):
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, lam=1.0, mu=0.0, dense_threshold=2048)
    if twist:
        kw["twist"] = (0.3, 0.2)
    uc = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*uc), 4), 1.0, 0.1,
                              rng=np.random.default_rng(5), **kw)
    ts, tp = build_holstein(Lattice.create(UnitCell.create(*uc), 4), 1.0, 0.1,
                            rng=np.random.default_rng(5), device="cpu", **kw)
    return js, jp, ts, tp


def _jax_draws(keys, N_, Ltau, cplx):
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (N_, Ltau), dtype=jnp.float64)))
        r = np.asarray(jax.random.normal(k_p, (2, N_, Ltau), dtype=jnp.float64))
        Rpm.append((r[0] + 1j * r[1])[None] if cplx else r)
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    # the KPM power-iteration start vectors (complex for a complex operator)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    sdt = jnp.complex128 if cplx else jnp.float64
    start = tuple(torch.as_tensor(np.array(jax.random.normal(k, (N_, 1), dtype=sdt)))
                  for k in (k1, k2))
    return HMCDraws(momentum=torch.as_tensor(np.stack(R)),
                    pseudofermion=torch.as_tensor(np.stack(Rpm)),
                    uniform=torch.as_tensor(np.asarray(U)), kpm_start=start)


@pytest.mark.parametrize("twist", [False, True], ids=["real", "twisted"])
def test_hmc_update_with_deflation_matches_jax(twist):
    js, jp, ts, tp = _holstein(twist)
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    mass = build_mass(tp.omega.numpy(), ts.dtau, ts.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = dict(dt=0.1, trajectory_time=0.2, Nb=2, tol=1e-6, maxiter=500, construct_guess=True,
               guess_order=2, deflate_k=4, deflate_filter=4, deflate_power=3)
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((C, ts.Nsites, 1)) + 0.1 * rng.standard_normal(
        (C, ts.Nsites, ts.Ltau))
    v0 = rng.standard_normal(x0.shape)
    dt = jnp.complex128 if twist else jnp.float64
    jdefls = [jdefl.init(jax.random.PRNGKey(40 + c), 4, ts.Nsites, ts.Ltau, dtype=dt)
              for c in range(C)]
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(max_order=4))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c]), defl=jdefls[c]),
                  keys[c]) for c in range(C)]
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg),
                          kpm.make_symmetric_precond(tops, kpm.KPMConfig(max_order=4)))
    tstate, tstats = tstep(tp, HMCState(x=torch.as_tensor(x0), v=torch.as_tensor(v0),
                                        defl=_port_state(jdefls)),
                           draws=_jax_draws(keys, ts.Nsites, ts.Ltau, twist))
    for c, (jstate, jstats, _) in enumerate(runs):
        np.testing.assert_allclose(float(tstats.delta_H[c]), float(jstats.delta_H), atol=1e-10)
        np.testing.assert_allclose(tstate.x[c].numpy(), np.asarray(jstate.x), atol=1e-10)
        np.testing.assert_allclose(tstate.v[c].numpy(), np.asarray(jstate.v), atol=1e-10)
        assert int(tstats.iters[c]) == int(jstats.iters)
        assert bool(tstats.accepted[c]) == bool(jstats.accepted) and int(jstats.flag) == 0
        np.testing.assert_allclose(_projector(tstate.defl.W[c].numpy()),
                                   _projector(jstate.defl.W), atol=1e-8)


def test_hmc_deflation_errors():
    _, _, ts, tp = _holstein(False)
    ops = make_model_ops(ts)
    mass = np.ones((ts.Nph, ts.Ltau))
    cfg = HMCConfig(dt=0.1, trajectory_time=0.2, deflate_k=4)
    step = make_hmc_step(ops, mass, cfg, None)
    x = torch.zeros((C, ts.Nph, ts.Ltau), dtype=torch.float64)
    with pytest.raises(ValueError, match="deflate_k"):
        step(tp, HMCState(x=x, v=x), torch.Generator().manual_seed(0))
    _, _, ts2, tp2 = _holstein(True)
    step2 = make_hmc_step(make_model_ops(ts2), mass, cfg, None)
    real = init_deflation(make_model_ops(ts2), cfg, C, device="cpu")
    assert not real.W.is_complex()
    with pytest.raises(ValueError, match="complex deflation basis"):
        step2(tp2, HMCState(x=x, v=x, defl=real), torch.Generator().manual_seed(0))
    cplx = init_deflation(make_model_ops(ts2), cfg, C, params=tp2, device="cpu")
    assert cplx.W.dtype == torch.complex64 and cplx.W.shape == (C, 4, ts2.Nsites, ts2.Ltau)
