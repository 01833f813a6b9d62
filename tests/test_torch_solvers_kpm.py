"""Reductions, CG, the KPM preconditioner, Fourier acceleration and the
τ↔ω transforms of the PyTorch port against the JAX package, float64 on the
CPU, on the dense branch and on the fold branch (``dense_threshold=0``).
Chain-batched port states are compared chain by chain with JAX states."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu import solvers as jsolvers
from elphdynamics_tpu.dynamics import init_phonons as jinit
from elphdynamics_tpu.dynamics import solve as jsolve
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import deflation as jdefl
from elphdynamics_tpu.ops import fourier_accel as jfa
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops import timefreqfft as jtf
from elphdynamics_tpu.utils import dtypes as jdt
from elphdynamics_tpu_torch import solvers as tsolvers
from elphdynamics_tpu_torch.dynamics import init_phonons as tinit
from elphdynamics_tpu_torch.dynamics import solve as tsolve
from elphdynamics_tpu_torch.lattice import Lattice as TLattice
from elphdynamics_tpu_torch.lattice import UnitCell as TUnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops as t_make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein as t_build_holstein
from elphdynamics_tpu_torch.ops import deflation as tdefl
from elphdynamics_tpu_torch.ops import fourier_accel as tfa
from elphdynamics_tpu_torch.ops import kpm as tkpm
from elphdynamics_tpu_torch.ops import timefreqfft as ttf
from elphdynamics_tpu_torch.utils import dtypes as tdt

torch.set_num_threads(1)

BRANCHES = {"dense": 2048, "fold": 0}
C = 2
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", params=list(BRANCHES), ids=list(BRANCHES))
def model(request):
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, omega_std=0.1, lam=0.6, mu=-0.36,
              dense_threshold=BRANCHES[request.param])
    uc_args = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*uc_args), 4), 2.0, 0.1,
                              rng=np.random.default_rng(1), **kw)
    ts, tp = t_build_holstein(TLattice.create(TUnitCell.create(*uc_args), 4), 2.0, 0.1,
                              rng=np.random.default_rng(1), device="cpu", **kw)
    x = 0.3 * np.random.default_rng(2).standard_normal((C, ts.Nph, ts.Ltau))
    return j_make_model_ops(js), jp, t_make_model_ops(ts), tp, x


def _start(key, N):
    """The power-iteration start vectors JAX's kpm.setup draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return tuple(torch.as_tensor(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64)))
                 for k in (k1, k2))


def _setups(model, cfg_kw):
    jops, jp, tops, tp, x = model
    jst = [jkpm.setup(jops, jp, jnp.asarray(x[c]), jkpm.KPMConfig(**cfg_kw), KEY)
           for c in range(C)]
    tst = tkpm.setup(tops, tp, torch.as_tensor(x), tkpm.KPMConfig(**cfg_kw),
                     _start(KEY, tops.Nsites))
    return jst, tst


def _first_chain(st):
    """The port's KPM state of chain 0 alone (a batch of one chain)."""
    return dataclasses.replace(st, **{f: getattr(st, f)[:1] for f in
                                      ("expnV_bar", "lam_avg", "lam_mag", "coeff", "active")})


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


# --- accurate reductions ----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fdot_fsum_match_jax(dtype):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((3, 50, 40)) * 10.0 ** rng.integers(-3, 3, (3, 50, 40))).astype(dtype)
    b = rng.standard_normal((3, 50, 40)).astype(dtype)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for dim in ((-2, -1), (0, -2, -1)):
        want = np.asarray(jdt.fdot(jnp.asarray(a), jnp.asarray(b), axis=dim))
        got = tdt.fdot(ta, tb, dim=dim)
        assert got.dtype == torch.float64
        _close(got.numpy(), want, 1e-13)
        _close(tdt.fdot_fast(ta, tb, dim=dim).numpy(), want, 1e-13)
    exact = math.fsum(a.astype(np.float64).ravel().tolist())
    assert abs(tdt.fsum(ta).item() - exact) <= 1e-12 * np.abs(a).sum()
    _close(tdt.fsum(ta, dim=(-2, -1)).numpy(),
           np.asarray(jdt.fsum(jnp.asarray(a), axis=(-2, -1))), 1e-13)


def test_pseudofermion_noise_shape():
    g = torch.Generator().manual_seed(0)
    R = tdt.pseudofermion_noise((3, 16, 10), torch.float32, "cpu", g)
    assert R.shape == (3, 2, 16, 10) and R.dtype == torch.float32


# --- CG -----------------------------------------------------------------------

def _systems(model):
    """JAX MᵀM operator of chain 0 on [2, N, Lτ] and the port's on
    [1, 2, N, Lτ], with a shared right-hand side."""
    jops, jp, tops, tp, x = model
    jenv = jops.derived(jp, jnp.asarray(x[0]))
    tenv = tops.derived(tp, torch.as_tensor(x[:1]))[:, None]
    rhs = np.random.default_rng(4).standard_normal((2, tops.Nsites, tops.Ltau))
    return (lambda v: jops.mulMTM(jp, jenv, v), lambda v: tops.mulMTM(tp, tenv, v),
            jnp.asarray(rhs), torch.as_tensor(rhs[None]), jenv, tenv)


# unpreconditioned CG needs ~100 iterations; a looser tol keeps its count
# away from a last-digit tie between the two packages' rounding
@pytest.mark.parametrize("precond,tol", [(False, 1e-6), (True, 1e-9)], ids=["plain", "kpm"])
def test_cg_matches_jax(model, precond, tol):
    jA, tA, jb, tb, _, _ = _systems(model)
    jP = tP = None
    if precond:
        jst, tst = _setups(model, dict(max_order=8))
        jP = lambda v: jkpm.apply_symmetric(model[0], jst[0], v)  # noqa: E731
        tst1 = _first_chain(tst)
        tP = lambda v: tkpm.apply_symmetric(model[2], tst1, v)  # noqa: E731
    want = jsolvers.cg(jA, jb, apply_P=jP, tol=tol, maxiter=400)
    got = tsolvers.cg(tA, tb, apply_P=tP, tol=tol, maxiter=400)
    np.testing.assert_array_equal(got.iters[0].numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged[0].numpy(), np.asarray(want.converged))
    _close(got.x[0].numpy(), want.x, 1e-9)


def test_solve_checked_retry_matches_jax(model):
    """maxiter=3 fails every preconditioned solve, so the unpreconditioned
    retry runs (the converging path is test_solve_oinv_matches_jax)."""
    maxiter, tol = 3, 1e-8
    jA, tA, jb, tb, _, _ = _systems(model)
    jst, tst = _setups(model, dict(max_order=4))
    tst1 = _first_chain(tst)
    x0 = 0.1 * np.random.default_rng(5).standard_normal(jb.shape)
    want = jsolvers.solve_checked(jA, jb, jnp.asarray(x0), tol=tol, maxiter=maxiter,
                                  apply_P=lambda v: jkpm.apply_symmetric(model[0], jst[0], v))
    got = tsolvers.solve_checked(tA, tb, torch.as_tensor(x0[None]), tol=tol, maxiter=maxiter,
                                 apply_P=lambda v: tkpm.apply_symmetric(model[2], tst1, v))
    np.testing.assert_array_equal(got.iters[0].numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.flag[0].numpy(), np.asarray(want.flag))
    _close(got.x[0].numpy(), want.x, 1e-8)
    _close(got.residual[0].numpy(), want.residual, 1e-6)
    assert np.all(np.asarray(want.iters) > maxiter)   # the retry ran


def test_solve_oinv_matches_jax(model):
    jops, jp, tops, tp, x = model
    _, _, jb, tb, jenv, tenv = _systems(model)
    jst, tst = _setups(model, dict(max_order=4))
    tst1 = _first_chain(tst)
    want = jsolve.solve_oinv(jops, jp, jenv, jb, jsolve.SolverConfig(tol=1e-7, maxiter=300),
                             jsolve.PrecondApplies(lambda v: jkpm.apply_symmetric(jops, jst[0], v),
                                                   None, None))
    got = tsolve.solve_oinv(tops, tp, tenv, tb, tsolve.SolverConfig(tol=1e-7, maxiter=300),
                            tsolve.PrecondApplies(lambda v: tkpm.apply_symmetric(tops, tst1, v)))
    np.testing.assert_array_equal(got.iters[0].numpy(), np.asarray(want.iters))
    _close(got.x[0].numpy(), want.x, 1e-9)
    # with a deflation basis: one refresh of the same float64 basis in both
    # packages, then the init-projected CG
    jP = lambda v: jkpm.apply_symmetric(jops, jst[0], v)  # noqa: E731
    tP = lambda v: tkpm.apply_symmetric(tops, tst1, v)  # noqa: E731
    jdef = jdefl.refresh(jdefl.init(jax.random.PRNGKey(7), 4, tops.Nsites, tops.Ltau,
                                    dtype=jnp.float64),
                         lambda v: jops.mulMTM(jp, jenv, v), jP,
                         jdefl.DeflationConfig(k=4, filter_degree=4, power_iters=3))
    tdef = tdefl.DeflationState(*(torch.as_tensor(np.asarray(getattr(jdef, f)))[None]
                                  for f in ("W", "chol", "pvec", "lam_max")))
    want = jsolve.solve_oinv(jops, jp, jenv, jb, jsolve.SolverConfig(tol=1e-7, maxiter=300),
                             jsolve.PrecondApplies(jP, None, None), deflate=jdef)
    got = tsolve.solve_oinv(tops, tp, tenv, tb, tsolve.SolverConfig(tol=1e-7, maxiter=300),
                            tsolve.PrecondApplies(tP), deflate=tdef)
    np.testing.assert_array_equal(got.iters[0].numpy(), np.asarray(want.iters))
    _close(got.x[0].numpy(), want.x, 1e-9)


# --- KPM ----------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw", [dict(max_order=4), dict(max_order=16, c1=2.0)],
                         ids=["order4", "order16"])
def test_kpm_setup_matches_jax(model, cfg_kw):
    jst, tst = _setups(model, cfg_kw)
    assert tst.coeff.shape == (C,) + tuple(jst[0].coeff.shape)
    for c in range(C):
        _close(tst.lam_avg[c].item(), jst[c].lam_avg)
        _close(tst.lam_mag[c].item(), jst[c].lam_mag)
        _close(tst.coeff[c].numpy(), jst[c].coeff, 1e-11)
        assert bool(tst.active[c]) == bool(jst[c].active)
        _close(tst.expnV_bar[c].numpy(), jst[c].expnV_bar)
        assert (tst.expK is None) == (jst[c].expK is None)
        if tst.expK is not None:
            _close(tst.expK.numpy(), jst[c].expK)
            _close(tst.expK_inv.numpy(), jst[c].expK_inv)


@pytest.mark.parametrize("use_cfg", [True, False], ids=["dft", "fft"])
def test_kpm_apply_symmetric_matches_jax(model, use_cfg):
    jops, jp, tops, tp, x = model
    cfg_kw = dict(max_order=8)
    jst, tst = _setups(model, cfg_kw)
    v = np.random.default_rng(6).standard_normal((C, 2, tops.Nsites, tops.Ltau))
    got = tkpm.apply_symmetric(tops, tst, torch.as_tensor(v),
                               tkpm.KPMConfig(**cfg_kw) if use_cfg else None)
    for c in range(C):
        want = jkpm.apply_symmetric(jops, jst[c], jnp.asarray(v[c]),
                                    jkpm.KPMConfig(**cfg_kw) if use_cfg else None)
        _close(got[c].numpy(), want, 1e-11)


def test_kpm_folded_abar_matches_jax(model, monkeypatch):
    """With the dense-Ā gate closed in both packages, the fold branch applies
    Ā, Āᵀ and Ā⁻¹ through the checkerboard fold (the path a CUDA state takes
    above 2048 sites)."""
    jops, jp, tops, tp, x = model
    monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
    monkeypatch.setattr(tkpm, "_DENSE_ABAR_MAX_SITES", 0)
    cfg_kw = dict(max_order=8)
    jst, tst = _setups(model, cfg_kw)
    assert (tst.expK is None) == (not tops.spec.dense_ckb)
    v = np.random.default_rng(12).standard_normal((C, 2, tops.Nsites, tops.Ltau))
    got = tkpm.apply_symmetric(tops, tst, torch.as_tensor(v), tkpm.KPMConfig(**cfg_kw))
    for c in range(C):
        assert (jst[c].expK is None) == (tst.expK is None)
        _close(tst.lam_avg[c].item(), jst[c].lam_avg)
        _close(tst.coeff[c].numpy(), jst[c].coeff, 1e-11)
        want = jkpm.apply_symmetric(jops, jst[c], jnp.asarray(v[c]), jkpm.KPMConfig(**cfg_kw))
        _close(got[c].numpy(), want, 1e-11)


def test_kpm_refresh_and_precond_matches_jax(model):
    jops, jp, tops, tp, x = model
    cfg_kw = dict(max_order=4)
    jst, tst = _setups(model, cfg_kw)
    x2 = x + 0.05
    tref = tkpm.refresh(tops, tst, tp, torch.as_tensor(x2))
    pre = tkpm.make_symmetric_precond(tops, tkpm.KPMConfig(**cfg_kw))
    v = np.random.default_rng(7).standard_normal((C, 2, tops.Nsites, tops.Ltau))
    got = pre.symmetric(tref, torch.as_tensor(v))
    for c in range(C):
        jref = jkpm.refresh(jops, jst[c], jp, jnp.asarray(x2[c]))
        _close(tref.expnV_bar[c].numpy(), jref.expnV_bar)
        want = jkpm.apply_symmetric(jops, jref, jnp.asarray(v[c]), jkpm.KPMConfig(**cfg_kw))
        _close(got[c].numpy(), want, 1e-11)


def test_kpm_inactive_chain_is_identity(model):
    _, _, tops, tp, x = model
    _, tst = _setups(model, dict(max_order=4))
    off = dataclasses.replace(tst, active=torch.tensor([True, False]))
    v = torch.as_tensor(np.random.default_rng(8).standard_normal((C, 2, tops.Nsites, tops.Ltau)))
    out = tkpm.apply_symmetric(tops, off, v)
    assert torch.equal(out[1], v[1]) and not torch.equal(out[0], v[0])


# --- Fourier acceleration, τ↔ω, initial phonons ------------------------------

@pytest.mark.parametrize("power", [-0.5, -1.0, 1.0])
@pytest.mark.parametrize("Ltau", [20, 300], ids=["circulant", "fft"])
def test_accelerate_matches_jax(power, Ltau):
    omega = np.where(np.arange(6) % 2 == 0, 1.0, 2.0)   # two distinct spectra
    blocks = [dict(omega_min=0.0, omega_max=1.5, mass=0.5),
              dict(omega_min=1.5, omega_max=10.0, mass=0.3, c=1.0)]
    table = jfa.build_mass(omega, 0.1, Ltau, blocks)
    np.testing.assert_array_equal(tfa.build_mass(omega, 0.1, Ltau, blocks), table)
    np.testing.assert_array_equal(tfa.build_Q(omega, 0.1, Ltau, blocks),
                                  jfa.build_Q(omega, 0.1, Ltau, blocks))
    v = np.random.default_rng(9).standard_normal((3, 6, Ltau))
    want = jfa.accelerate(table, jnp.asarray(v), power)
    _close(tfa.accelerate(table, torch.as_tensor(v), power).numpy(), want, 1e-12)
    op = tfa.MassOperator(table, (power,), "cpu", torch.float64)
    _close(op.apply(torch.as_tensor(v), power).numpy(), want, 1e-12)


def test_tau_omega_match_jax():
    v = np.random.default_rng(10).standard_normal((3, 7, 12))
    w = ttf.tau_to_omega(torch.as_tensor(v))
    _close(w.numpy(), jtf.tau_to_omega(jnp.asarray(v)), 1e-13)
    _close(ttf.omega_to_tau(w).numpy(), v, 1e-13)
    _close(ttf.omega_to_tau(w, real=False).numpy(),
           jtf.omega_to_tau(jnp.asarray(w.numpy()), real=False), 1e-13)


def test_init_phonons_matches_jax(model):
    jops, jp, tops, tp, _ = model
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    want, normals, ints = [], [], []
    for key in keys:
        want.append(np.asarray(jinit.init_phonons_half_filled(jops, jp, key)[0]))
        _, k1, k2 = jax.random.split(key, 3)
        normals.append(np.asarray(jax.random.normal(k1, (jops.Nph,), dtype=jnp.float64)))
        ints.append(np.asarray(jax.random.randint(k2, (jops.Nph,), -1, 2)))
    got = tinit.init_phonons_half_filled(tops, tp, C, draws=(torch.as_tensor(np.stack(normals)),
                                                           torch.as_tensor(np.stack(ints))))
    _close(got.numpy(), np.stack(want), 1e-14)
    drawn = tinit.init_phonons_half_filled(tops, tp, C, torch.Generator().manual_seed(0))
    assert drawn.shape == (C, tops.Nph, tops.Ltau)
    assert torch.equal(drawn[..., 0:1].expand_as(drawn), drawn)
