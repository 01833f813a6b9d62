"""The non-CG solver surface of the PyTorch port against the JAX package,
float64 on the CPU (float32 where the JAX test is a float32 regression).

* ``bicgstab``, ``gmres`` (batched, mid-cycle freeze), ``block_cg``,
  ``block_solve_checked`` and ``cg_split`` on the dense systems of
  ``tests/test_solvers.py``: solutions to 1e-9, iteration counts equal.
  GMRES may differ by one iteration: the port orthogonalises by classical
  Gram-Schmidt applied twice against the whole basis, the JAX package by
  modified Gram-Schmidt row by row, so a residual estimate within rounding
  of the tolerance can fall on either side.
* the left and right KPM applies and the ``stacked`` / ``exact_lowfreq``
  options against ``elphdynamics_tpu/ops/kpm.py`` on the dense branch and,
  with the dense-Ā gate closed in both packages, on the fold branch (the
  JAX side through its XLA fold): 1e-10.
* ``solve_minv`` / ``solve_oinv`` per solver kind with the preconditioner
  (the cases of ``tests/test_solver_dispatch.py``).
* one HMC update with BiCGStab and one with ``block=True`` against the JAX
  step on JAX's draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu import solvers as jsolvers
from elphdynamics_tpu.dynamics import solve as jsolve
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
from elphdynamics_tpu_torch import solvers as tsolvers
from elphdynamics_tpu_torch.dynamics import solve as tsolve
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCDraws, HMCState, make_hmc_step
from elphdynamics_tpu_torch.lattice import Lattice as TLattice
from elphdynamics_tpu_torch.lattice import UnitCell as TUnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops as t_make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein as t_build_holstein
from elphdynamics_tpu_torch.ops import deflation as tdefl
from elphdynamics_tpu_torch.ops import kpm as tkpm

torch.set_num_threads(1)

UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
KEY = jax.random.PRNGKey(0)


def _close(got, want, rtol=1e-9):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _both(A, dtype=np.float64):
    """The operator v ↦ A·v over the site axis for both packages."""
    Aj, At = jnp.asarray(A, dtype), torch.as_tensor(np.asarray(A, dtype))
    return (lambda v: jnp.einsum("...ij,...jk->...ik", Aj, v)), (lambda v: torch.matmul(At, v))


def _spd(n=24, seed=0, cond=50.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ np.diag(np.linspace(1.0, cond, n)) @ Q.T


# --- the dense systems of tests/test_solvers.py ------------------------------

def test_bicgstab_matches_jax():
    rng = np.random.default_rng(2)
    n = 24
    A = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal((3, n, 2))
    jA, tA = _both(A)
    dinv = 1.0 / np.diag(A)[:, None]
    for pre in (False, True):
        want = jsolvers.bicgstab(jA, jnp.asarray(b), tol=1e-10, maxiter=200,
                                 apply_P=(lambda v: jnp.asarray(dinv) * v) if pre else None)
        got = tsolvers.bicgstab(tA, torch.as_tensor(b), tol=1e-10, maxiter=200,
                                apply_P=(lambda v: torch.as_tensor(dinv) * v) if pre else None)
        np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
        np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
        _close(got.x.numpy(), want.x)
        assert np.allclose(A @ got.x.numpy(), b, atol=1e-6)


def test_bicgstab_breakdown_is_masked():
    """b = 0 for one system gives ρ = 0 at once: that system stops through
    the masks (no NaN), the other one converges."""
    A = np.eye(6) + 0.1 * np.random.default_rng(0).standard_normal((6, 6))
    b = np.random.default_rng(1).standard_normal((2, 6, 1))
    b[0] = 0.0
    got = tsolvers.bicgstab(_both(A)[1], torch.as_tensor(b), tol=1e-10, maxiter=50)
    assert torch.isfinite(got.x).all() and int(got.iters[0]) == 0
    assert np.allclose(A @ got.x[1].numpy(), b[1], atol=1e-8)


def test_gmres_batched_matches_jax():
    rng = np.random.default_rng(4)
    n = 16
    easy = np.eye(n) + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n)
    hard = np.eye(n) + 0.45 * rng.standard_normal((n, n)) / np.sqrt(n)
    As = np.stack([easy, hard])
    b = rng.standard_normal((2, n, 3))
    jA, tA = _both(As)
    want = jsolvers.gmres(jA, jnp.asarray(b), tol=1e-10, maxiter=200, restart=8)
    got = tsolvers.gmres(tA, torch.as_tensor(b), tol=1e-10, maxiter=200, restart=8)
    assert got.iters.shape == (2,) and int(got.iters[0]) < int(got.iters[1])
    assert np.all(np.abs(got.iters.numpy() - np.asarray(want.iters)) <= 1)
    assert bool(got.converged.all())
    # both stop at a 1e-10 residual; one iteration more or less moves x by that
    _close(got.x.numpy(), want.x, 1e-8)
    assert np.allclose(np.einsum("bij,bjk->bik", As, got.x.numpy()), b, atol=1e-8)
    # a two-axis batch
    b4 = rng.standard_normal((2, 2, n, 3))
    want4 = jsolvers.gmres(jA, jnp.asarray(b4), tol=1e-8, maxiter=200, restart=8)
    got4 = tsolvers.gmres(tA, torch.as_tensor(b4), tol=1e-8, maxiter=200, restart=8)
    assert got4.iters.shape == (2, 2)
    assert np.all(np.abs(got4.iters.numpy() - np.asarray(want4.iters)) <= 1)
    _close(got4.x.numpy(), want4.x, 1e-6)


@pytest.mark.parametrize("side", ["right", "left"])
def test_gmres_f32_midcycle_convergence_stays_accurate(side):
    """A system that converges in the middle of a restart cycle freezes: the
    floor-level Arnoldi columns after it never reach the back-substitution
    (float32, near-exact preconditioner, as the JAX package's regression)."""
    rng = np.random.default_rng(7)
    n = 24
    A = np.eye(n) + 0.2 * rng.standard_normal((n, n)) / np.sqrt(n)
    P = np.linalg.inv(A) + 1e-3 * rng.standard_normal((n, n))
    b = rng.standard_normal((n, 2)).astype(np.float32)
    (jA, tA), (jP, tP) = _both(A, np.float32), _both(P, np.float32)
    want = jsolvers.gmres(jA, jnp.asarray(b), apply_P=jP, tol=1e-5, maxiter=40, restart=20,
                          side=side)
    got = tsolvers.gmres(tA, torch.as_tensor(b), apply_P=tP, tol=1e-5, maxiter=40, restart=20,
                         side=side)
    assert got.x.dtype == torch.float32
    assert int(got.iters) < 10 and abs(int(got.iters) - int(want.iters)) <= 1
    err = np.linalg.norm(A @ got.x.numpy().astype(np.float64) - b) / np.linalg.norm(b)
    assert err < 5e-5, (side, err)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-5)


def test_gmres_frozen_system_keeps_its_solution():
    """Two systems in one batch, one converging in its first Arnoldi step
    and one needing several cycles: the early one's solution is that of
    solving it alone."""
    rng = np.random.default_rng(8)
    n = 20
    A = np.eye(n) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal((2, n, 1))
    As = np.stack([np.eye(n) * 2.0, A])
    tA = _both(As)[1]
    both = tsolvers.gmres(tA, torch.as_tensor(b), tol=1e-10, maxiter=100, restart=6)
    alone = tsolvers.gmres(lambda v: 2.0 * v, torch.as_tensor(b[:1]), tol=1e-10, maxiter=100,
                           restart=6)
    assert int(both.iters[0]) == int(alone.iters[0]) == 1
    _close(both.x[0].numpy(), alone.x[0].numpy(), 1e-14)
    assert np.allclose(A @ both.x[1].numpy(), b[1], atol=1e-8)


def test_block_cg_matches_jax():
    A = _spd(cond=80.0)
    B = np.random.default_rng(11).standard_normal((2, 5, 24, 2))
    jA, tA = _both(A)
    want = jsolvers.block_cg(jA, jnp.asarray(B), tol=1e-10, maxiter=500)
    got = tsolvers.block_cg(tA, torch.as_tensor(B), tol=1e-10, maxiter=500)
    assert got.iters.shape == (2, 5)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert bool(got.converged.all())
    _close(got.x.numpy(), want.x)
    expect = np.linalg.solve(A, B.reshape(-1, 24, 2))
    np.testing.assert_allclose(got.x.numpy().reshape(-1, 24, 2), expect, atol=1e-8)
    with pytest.raises(ValueError):
        tsolvers.block_cg(tA, torch.as_tensor(B[0, 0]))


def test_block_cg_two_columns_and_isolated_modes():
    """s = 2 takes the closed-form Gram inverse; with a few isolated small
    eigenvalues the shared block needs fewer iterations than independent
    CG, as in the JAX package."""
    rng = np.random.default_rng(12)
    n = 96
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.geomspace(1e-4, 1e-3, 6), np.linspace(0.5, 1.0, n - 6)])
    A = Q @ np.diag(eigs) @ Q.T
    jA, tA = _both(A)
    for s in (2, 8):
        B = rng.standard_normal((s, n, 1))
        want = jsolvers.block_cg(jA, jnp.asarray(B), tol=1e-8, maxiter=3000)
        got = tsolvers.block_cg(tA, torch.as_tensor(B), tol=1e-8, maxiter=3000)
        # an ill-conditioned system (κ = 1e4): rounding moves the count by a few
        assert np.all(np.abs(got.iters.numpy() - np.asarray(want.iters)) <= 3)
        assert bool(got.converged.all())
        np.testing.assert_allclose(np.einsum("ij,bjk->bik", A, got.x.numpy()), B, atol=1e-6)
    plain = tsolvers.cg(tA, torch.as_tensor(B), tol=1e-8, maxiter=3000)
    assert int(got.iters.max()) < int(plain.iters.max())


def test_block_cg_f32_early_column_freeze_stays_accurate():
    rng = np.random.default_rng(13)
    n = 64
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.geomspace(1e-3, 1e-2, 4), np.linspace(0.5, 1.0, n - 4)])
    A64 = Q @ np.diag(eigs) @ Q.T
    B64 = rng.standard_normal((6, n, 1))
    B64[0, :, 0] = Q[:, -1]       # an eigen-direction: converges at once
    tA = _both(A64, np.float32)[1]
    res = tsolvers.block_cg(tA, torch.as_tensor(B64.astype(np.float32)), tol=1e-5, maxiter=2000)
    assert res.x.dtype == torch.float32
    x = res.x.numpy().astype(np.float64)
    err = (np.linalg.norm(np.einsum("ij,bjk->bik", A64, x) - B64, axis=(1, 2))
           / np.linalg.norm(B64, axis=(1, 2)))
    assert int(res.iters[0]) < int(res.iters.max())
    assert np.all(err < 5e-4), err


def test_block_solve_checked_fallback_matches_jax():
    A = _spd(cond=100.0)
    rng = np.random.default_rng(14)
    bad = rng.standard_normal((24, 24))
    B = rng.standard_normal((4, 24, 1))
    (jA, tA), (jP, tP) = _both(A), _both(bad)
    want = jsolvers.block_solve_checked(jA, jnp.asarray(B), apply_P=jP, tol=1e-8, maxiter=30)
    got = tsolvers.block_solve_checked(tA, torch.as_tensor(B), apply_P=tP, tol=1e-8, maxiter=30)
    np.testing.assert_array_equal(got.flag.numpy(), np.asarray(want.flag))
    assert np.all(got.flag.numpy() == 0)
    # the first (garbage-preconditioned) solve ran its 30 iterations in both;
    # the retry converges from zero
    assert np.all(got.iters.numpy() > 30)
    assert np.all(np.abs(got.iters.numpy() - np.asarray(want.iters)) <= 1)
    np.testing.assert_allclose(np.einsum("ij,bjk->bik", A, got.x.numpy()), B, atol=1e-6)
    _close(got.x.numpy(), want.x, 1e-7)


def test_cg_split_matches_jax():
    rng = np.random.default_rng(7)
    n = 24
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    d = np.sqrt(np.diag(A))[:, None]
    b = rng.standard_normal((3, n, 2))
    jA, tA = _both(A)
    want = jsolvers.cg_split(jA, jnp.asarray(b), apply_Linv=lambda v: v / jnp.asarray(d),
                             apply_LTinv=lambda v: v / jnp.asarray(d), tol=1e-10, maxiter=500)
    got = tsolvers.cg_split(tA, torch.as_tensor(b), apply_Linv=lambda v: v / torch.as_tensor(d),
                            apply_LTinv=lambda v: v / torch.as_tensor(d), tol=1e-10, maxiter=500)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert bool(got.converged.all())
    _close(got.x.numpy(), want.x)
    for bi in range(3):
        np.testing.assert_allclose(A @ got.x[bi].numpy(), b[bi], atol=1e-6)


# --- the KPM applies -----------------------------------------------------------

C = 2


@pytest.fixture(scope="module", params=["dense", "fold"])
def model(request):
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, omega_std=0.1, lam=0.6, mu=-0.36,
              dense_threshold=2048 if request.param == "dense" else 0)
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC), 4), 2.0, 0.1,
                              rng=np.random.default_rng(1), **kw)
    ts, tp = t_build_holstein(TLattice.create(TUnitCell.create(*UC), 4), 2.0, 0.1,
                              rng=np.random.default_rng(1), device="cpu", **kw)
    x = 0.3 * np.random.default_rng(2).standard_normal((C, ts.Nph, ts.Ltau))
    return j_make_model_ops(js), jp, t_make_model_ops(ts), tp, x, request.param


def _start(key, N):
    k1, k2 = jax.random.split(key)
    return tuple(torch.as_tensor(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64)))
                 for k in (k1, k2))


def _setups(model, cfg_kw):
    jops, jp, tops, tp, x, _ = model
    jst = [jkpm.setup(jops, jp, jnp.asarray(x[c]), jkpm.KPMConfig(**cfg_kw), KEY)
           for c in range(C)]
    tst = tkpm.setup(tops, tp, torch.as_tensor(x), tkpm.KPMConfig(**cfg_kw),
                     _start(KEY, tops.Nsites))
    return jst, tst


@pytest.mark.parametrize("abar", ["dense_abar", "folded_abar"])
def test_kpm_left_right_match_jax(model, abar, monkeypatch):
    """Ā dense (the CPU default at this size) or, with the gate closed in
    both packages and the model on its fold branch, through the fold: the
    port's fused-step recurrence against the JAX package's XLA fold."""
    jops, jp, tops, tp, x, branch = model
    if abar == "folded_abar":
        monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
        monkeypatch.setattr(tkpm, "_DENSE_ABAR_MAX_SITES", 0)
    cfg_kw = dict(max_order=8)
    jst, tst = _setups(model, cfg_kw)
    if abar == "folded_abar" and branch == "fold":
        assert tst.expK is None and jst[0].expK is None
    v = np.random.default_rng(6).standard_normal((C, 3, tops.Nsites, tops.Ltau))
    pre = tkpm.make_precond(tops, tkpm.KPMConfig(**cfg_kw))
    for name, tfn, jfn in (("left", pre.left, jkpm.apply_left),
                           ("right", pre.right, jkpm.apply_right),
                           ("symmetric", pre.symmetric, jkpm.apply_symmetric)):
        got = tfn(tst, torch.as_tensor(v))
        for c in range(C):
            want = jfn(jops, jst[c], jnp.asarray(v[c]), jkpm.KPMConfig(**cfg_kw))
            _close(got[c].numpy(), want, 1e-10)
    # the pair is the symmetric apply: right then left
    _close(pre.left(tst, pre.right(tst, torch.as_tensor(v))).numpy(),
           pre.symmetric(tst, torch.as_tensor(v)).numpy(), 1e-10)


@pytest.mark.parametrize("cfg_kw", [dict(max_order=8, stacked=True),
                                    dict(max_order=8, exact_lowfreq=3),
                                    dict(max_order=6, stacked=True, exact_lowfreq=2)],
                         ids=["stacked", "exact_lowfreq", "both"])
def test_kpm_stacked_and_exact_lowfreq_match_jax(model, cfg_kw):
    jops, jp, tops, tp, x, _ = model
    jst, tst = _setups(model, cfg_kw)
    assert (tst.S_fwd is not None) == bool(cfg_kw.get("stacked"))
    assert (tst.G_low is not None) == bool(cfg_kw.get("exact_lowfreq"))
    x2 = x + 0.05
    tref = tkpm.refresh(tops, tst, tp, torch.as_tensor(x2))
    v = np.random.default_rng(9).standard_normal((C, 2, tops.Nsites, tops.Ltau))
    tcfg, jcfg = tkpm.KPMConfig(**cfg_kw), jkpm.KPMConfig(**cfg_kw)
    for tstate, jstates in ((tst, jst),
                            (tref, [jkpm.refresh(jops, jst[c], jp, jnp.asarray(x2[c]))
                                    for c in range(C)])):
        for tfn, jfn in ((tkpm.apply_symmetric, jkpm.apply_symmetric),
                         (tkpm.apply_left, jkpm.apply_left),
                         (tkpm.apply_right, jkpm.apply_right)):
            got = tfn(tops, tstate, torch.as_tensor(v), tcfg)
            for c in range(C):
                _close(got[c].numpy(), jfn(jops, jstates[c], jnp.asarray(v[c]), jcfg), 1e-10)
    for c in range(C):
        if tst.G_low is not None:
            _close(tst.G_low[c].real.numpy(), jst[c].G_re, 1e-10)
            _close(tst.G_low[c].imag.numpy(), jst[c].G_im, 1e-10)
        if tst.S_fwd is not None:
            N = tops.Nsites
            _close(tst.S_fwd[c].reshape(-1, N).numpy(), jst[c].S_fwd, 1e-10)
    # the stack equals the recurrence
    if cfg_kw.get("stacked") and not cfg_kw.get("exact_lowfreq"):
        plain = tkpm.setup(tops, tp, torch.as_tensor(x), tkpm.KPMConfig(max_order=8),
                           _start(KEY, tops.Nsites))
        _close(tkpm.apply_symmetric(tops, tst, torch.as_tensor(v)).numpy(),
               tkpm.apply_symmetric(tops, plain, torch.as_tensor(v)).numpy(), 1e-10)


# --- the dispatch: tests/test_solver_dispatch.py -----------------------------

@pytest.fixture(scope="module")
def dispatch_model():
    kw = dict(t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
              omega=1.0, lam=0.5, mu=-0.25)
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC), 3), 1.0, 0.1, **kw)
    ts, tp = t_build_holstein(TLattice.create(TUnitCell.create(*UC), 3), 1.0, 0.1,
                              device="cpu", **kw)
    rng = np.random.default_rng(0)
    x = 0.2 * rng.standard_normal((js.Nph, js.Ltau))
    b = rng.standard_normal((2, js.Nsites, js.Ltau))
    return j_make_model_ops(js), jp, t_make_model_ops(ts), tp, x, b


KPM_STRONG = dict(max_order=48, c1=4.0, c2=4.0)


def _dispatch_setup(dispatch_model, kpm_kw):
    jops, jp, tops, tp, x, b = dispatch_model
    jpre = jkpm.make_precond(jops, jkpm.KPMConfig(**kpm_kw))
    jpa = jsolve.resolve_precond(jpre, jp, jnp.asarray(x))
    tpre = tkpm.make_precond(tops, tkpm.KPMConfig(**kpm_kw))
    tx = torch.as_tensor(x[None])
    tpa = tsolve.precond_applies(tpre, tsolve.precond_state(
        tpre, tp, tx, start=_start(jax.random.PRNGKey(1234), tops.Nsites)))
    jd = jops.derived(jp, jnp.asarray(x))
    td = tops.stack(tops.derived(tp, tx))
    return jpa, tpa, jd, td


@pytest.mark.parametrize("kind", ["cg", "bicgstab", "gmres"])
def test_solve_minv_kinds_match_jax(dispatch_model, kind):
    jops, jp, tops, tp, x, b = dispatch_model
    jpa, tpa, jd, td = _dispatch_setup(dispatch_model, KPM_STRONG)
    kw = dict(tol=1e-9, maxiter=2000, kind=kind, restart=30)
    want = jsolve.solve_minv(jops, jp, jd, jnp.asarray(b), jsolve.SolverConfig(**kw),
                             None if kind == "cg" else jpa)
    got = tsolve.solve_minv(tops, tp, td, torch.as_tensor(b[None]), tsolve.SolverConfig(**kw),
                            None if kind == "cg" else tpa)
    assert np.all(got.flag.numpy() == 0) and np.all(np.asarray(want.flag) == 0)
    slack = 1 if kind == "gmres" else 0     # see the module docstring
    assert np.all(np.abs(got.iters[0].numpy() - np.asarray(want.iters)) <= slack)
    _close(got.x[0].numpy(), want.x, 1e-8)
    back = tops.mulM(tp, td, got.x)
    assert np.allclose(back[0].numpy(), b, atol=1e-6)


@pytest.mark.parametrize("kind", ["cg", "bicgstab", "gmres"])
def test_solve_oinv_kinds_match_jax(dispatch_model, kind):
    jops, jp, tops, tp, x, b = dispatch_model
    jpa, tpa, jd, td = _dispatch_setup(dispatch_model, KPM_STRONG)
    kw = dict(tol=1e-9, maxiter=2000, kind=kind, restart=30)
    want = jsolve.solve_oinv(jops, jp, jd, jnp.asarray(b), jsolve.SolverConfig(**kw), jpa)
    got = tsolve.solve_oinv(tops, tp, td, torch.as_tensor(b[None]), tsolve.SolverConfig(**kw), tpa)
    assert np.all(got.flag.numpy() == 0) and np.all(np.asarray(want.flag) == 0)
    slack = 2 if kind == "gmres" else 0     # two GMRES solves in sequence
    assert np.all(np.abs(got.iters[0].numpy() - np.asarray(want.iters)) <= slack)
    _close(got.x[0].numpy(), want.x, 1e-7)
    assert np.allclose(tops.mulMTM(tp, td, got.x)[0].numpy(), b, atol=1e-5)


def test_solve_block_gates_match_jax(dispatch_model):
    """``block`` routes solve_minv (asked with block=True) and solve_oinv at
    tol >= 1e-6 through block CG; at a tighter tolerance, or without the
    block axis, the batched path runs. Iterations as the JAX package's."""
    jops, jp, tops, tp, x, b = dispatch_model
    jpa, tpa, jd, td = _dispatch_setup(dispatch_model, dict(max_order=8))
    B = np.random.default_rng(3).standard_normal((5, tops.Nsites, tops.Ltau))
    for tol in (1e-6, 1e-9):
        kw = dict(tol=tol, maxiter=500, block=True)
        for fn_j, fn_t, extra in ((jsolve.solve_minv, tsolve.solve_minv, dict(block=True)),
                                  (jsolve.solve_oinv, tsolve.solve_oinv, {})):
            want = fn_j(jops, jp, jd, jnp.asarray(B), jsolve.SolverConfig(**kw), jpa, **extra)
            got = fn_t(tops, tp, td, torch.as_tensor(B[None]), tsolve.SolverConfig(**kw), tpa,
                       **extra)
            np.testing.assert_array_equal(got.iters[0].numpy(), np.asarray(want.iters))
            assert np.all(got.flag.numpy() == 0)
            _close(got.x[0].numpy(), want.x, 1e-8 if tol < 1e-8 else 1e-5)
    batched = tsolve.solve_minv(tops, tp, td, torch.as_tensor(B[None]),
                                tsolve.SolverConfig(tol=1e-6, maxiter=500), tpa, block=True)
    assert int(got.iters.max()) > 0 and batched.iters.shape == (1, 5)
    # a deflation basis closes the block gate in both packages: the batched,
    # init-projected CG runs
    N, Lt = tops.Nsites, tops.Ltau
    jdef = jdefl.init(jax.random.PRNGKey(7), 3, N, Lt, dtype=jnp.float64)
    tdef = tdefl.DeflationState(*(torch.as_tensor(np.asarray(getattr(jdef, f)))[None]
                                  for f in ("W", "chol", "pvec", "lam_max")))
    kw = dict(tol=1e-6, maxiter=500, block=True)
    want = jsolve.solve_oinv(jops, jp, jd, jnp.asarray(B), jsolve.SolverConfig(**kw), jpa,
                             deflate=jdef)
    got = tsolve.solve_oinv(tops, tp, td, torch.as_tensor(B[None]), tsolve.SolverConfig(**kw),
                            tpa, deflate=tdef)
    plain = tsolve.solve_oinv(tops, tp, td, torch.as_tensor(B[None]),
                              tsolve.SolverConfig(tol=1e-6, maxiter=500), tpa, deflate=tdef)
    np.testing.assert_array_equal(got.iters[0].numpy(), np.asarray(want.iters))
    assert torch.equal(got.x, plain.x) and torch.equal(got.iters, plain.iters)
    with pytest.raises(ValueError):
        tsolve.SolverConfig(kind="minres")


# --- one HMC update per solver kind -------------------------------------------

L, BETA, DTAU = 4, 1.0, 0.1
HMC_CFG = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-5, maxiter=500,
               construct_guess=True, guess_order=3)
N_CHAINS = 2


def _hmc_draws(keys, N, Ltau):
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (N, Ltau), dtype=jnp.float64)))
        Rpm.append(np.asarray(jax.random.normal(k_p, (2, N, Ltau), dtype=jnp.float64)))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    return HMCDraws(momentum=torch.as_tensor(np.stack(R)),
                    pseudofermion=torch.as_tensor(np.stack(Rpm)),
                    uniform=torch.as_tensor(np.asarray(U)),
                    kpm_start=_start(jax.random.PRNGKey(1234), N))


@pytest.mark.parametrize("extra", [dict(solver_kind="bicgstab"), dict(block=True)],
                         ids=["bicgstab", "block"])
def test_hmc_update_solver_kinds_match_jax(extra):
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, lam=1.0, mu=0.0)
    jspec, jparams = j_build_holstein(JLattice.create(JUnitCell.create(*UC), L), BETA, DTAU,
                                      rng=np.random.default_rng(5), **kw)
    tspec, tparams = t_build_holstein(TLattice.create(TUnitCell.create(*UC), L), BETA, DTAU,
                                      rng=np.random.default_rng(5), device="cpu", **kw)
    N, Ltau = jspec.Nsites, jspec.Ltau
    mass = build_mass(np.asarray(jparams.omega), DTAU, Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((N_CHAINS, N, 1)) + 0.1 * rng.standard_normal((N_CHAINS, N, Ltau))
    v0 = rng.standard_normal((N_CHAINS, N, Ltau))
    cfg = {**HMC_CFG, **extra}
    kcfg = dict(max_order=16)

    jops = j_make_model_ops(jspec)
    jit_step = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg),
                                       jkpm.make_precond(jops, jkpm.KPMConfig(**kcfg))))
    keys = jax.random.split(jax.random.PRNGKey(3), N_CHAINS)
    runs = [jit_step(jparams, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(N_CHAINS)]
    jstate = jax.tree.map(lambda *a: np.stack(a), *[r[0] for r in runs])
    jstats = jax.tree.map(lambda *a: np.stack(a), *[r[1] for r in runs])

    tops = t_make_model_ops(tspec)
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg),
                          tkpm.make_precond(tops, tkpm.KPMConfig(**kcfg)))
    tstate, tstats = tstep(tparams, HMCState(x=torch.as_tensor(x0), v=torch.as_tensor(v0)),
                           draws=_hmc_draws(keys, N, Ltau))
    assert np.all(np.asarray(jstats.flag) == 0)
    np.testing.assert_array_equal(tstats.flag.numpy(), np.asarray(jstats.flag))
    np.testing.assert_array_equal(tstats.accepted.numpy(), np.asarray(jstats.accepted))
    np.testing.assert_array_equal(tstats.iters.numpy(), np.asarray(jstats.iters))
    np.testing.assert_allclose(tstats.delta_H.numpy(), np.asarray(jstats.delta_H), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tstate.v.numpy(), np.asarray(jstate.v), rtol=0, atol=1e-10)


def test_precond_applies_binds_left_and_right():
    ts, tp = t_build_holstein(TLattice.create(TUnitCell.create(*UC), 2), 0.5, 0.1,
                              t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0))], device="cpu")
    tops = t_make_model_ops(ts)
    x = torch.zeros((1, ts.Nph, ts.Ltau), dtype=torch.float64)
    sym = tsolve.resolve_precond(tkpm.make_symmetric_precond(tops, tkpm.KPMConfig(max_order=4)),
                                 tp, x)
    full = tsolve.resolve_precond(tkpm.make_precond(tops, tkpm.KPMConfig(max_order=4)), tp, x)
    assert sym.left is None and sym.right is None
    assert callable(full.left) and callable(full.right)
    assert dataclasses.is_dataclass(full)
