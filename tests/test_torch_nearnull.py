"""The two-level near-null preconditioner of the PyTorch port, float64 on the
CPU.

* The coarse correction equals the dense W·G⁻¹·Wᵀ within 1e-8 (W the chunked,
  whitened basis written out, G⁻¹ the port's inverse, which inverts the
  Galerkin matrix (MW)ᵀ(MW) with its ``reg`` jitter), and JAX's
  ``apply_correction`` built from the same test vectors within 1e-6 (JAX
  inverts G by a Newton–Schulz sweep, the port by a float64 Cholesky
  factorisation).
* A near-null-preconditioned CG solve at deep-ish β reaches its tolerance,
  with iterations within ±2 of JAX's on the same test vectors and KPM start.
* The three refusals: complex hopping, no ``[solver.preconditioner]``, a
  solver other than CG.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu import solvers as jsolvers
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops import nearnull as jnn
from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.io import config as tconfig
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.ops.nearnull import (
    NearNullConfig, _build, _chunk_counts, _smooth, apply_correction, make_nearnull_precond)

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])


def _model(L, beta):
    kw = dict(t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
              omega=1.0, lam=1.0, mu=0.0)
    js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC), L), beta, 0.1,
                              rng=np.random.default_rng(0), **kw)
    ts, tp = build_holstein(Lattice.create(UnitCell.create(*UC), L), beta, 0.1,
                            rng=np.random.default_rng(0), device="cpu", **kw)
    x = 0.5 * np.random.default_rng(3).standard_normal((ts.Nph, ts.Ltau))
    return j_make_model_ops(js), jp, make_model_ops(ts), tp, x


def _jax_start(N):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    return tuple(torch.as_tensor(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64)))
                 for k in (k1, k2))


def _dense_W(ops, nn, cfg):
    """The ``[N·Lτ, D]`` basis of chain 0 that ``apply_correction`` implies:
    column (J, i) = Σ_m χ_J·T_m·C_J[m, i]."""
    N, Lt = ops.Nsites, ops.Ltau
    c, nt = _chunk_counts(Lt, cfg)
    T, C = nn.T[0].numpy(), nn.C[0].numpy()
    Tc = T.reshape(cfg.k, N, nt, c)
    W = np.zeros((N * Lt, nt * cfg.k))
    for J in range(nt):
        for i in range(cfg.k):
            col = np.zeros((N, nt, c))
            col[:, J, :] = np.einsum("mns,m->ns", Tc[:, :, J, :], C[J, :, i])
            W[:, J * cfg.k + i] = col.reshape(-1)
    return W


def test_correction_matches_dense_and_jax():
    jops, jp, ops, tp, x = _model(4, 1.6)
    cfg = NearNullConfig(k=4, c=4)
    jcfg = jnn.NearNullConfig(k=4, c=4)
    assert _chunk_counts(ops.Ltau, cfg) == (4, 4)
    kcfg = kpm.KPMConfig(max_order=4)
    xt = torch.as_tensor(x)[None]
    derived = ops.stack(ops.derived(tp, xt))
    kst = kpm.setup(ops, tp, xt, kcfg, _jax_start(ops.Nsites))
    T0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (cfg.k, ops.Nsites, ops.Ltau),
                                      dtype=jnp.float64))
    T = _smooth(ops, tp, derived, kst, kcfg, torch.as_tensor(T0)[None], 5)
    nn = _build(ops, tp, derived, T, cfg)

    # the basis is orthonormal per chunk, up to the reg jitter
    W = _dense_W(ops, nn, cfg)
    np.testing.assert_allclose(W.T @ W, np.eye(W.shape[1]), atol=5e-4)
    # G⁻¹ inverts the Galerkin matrix of the dense M, with reg·diag(G) added
    MW = np.stack([ops.mulM(tp, derived, torch.as_tensor(W[:, j].reshape(1, 1, ops.Nsites,
                                                                         ops.Ltau))).reshape(-1)
                   .numpy() for j in range(W.shape[1])], axis=1)
    G = MW.T @ MW
    Ginv = nn.Ginv[0].numpy()
    np.testing.assert_allclose(Ginv @ (G + cfg.reg * np.diag(np.diag(G))), np.eye(G.shape[0]),
                               atol=1e-8)
    # the correction is W·G⁻¹·Wᵀ·r
    r = np.random.default_rng(0).standard_normal((3, ops.Nsites, ops.Ltau))
    got = apply_correction(ops, nn, torch.as_tensor(r)[None], cfg)[0].numpy()
    want = np.stack([(W @ (Ginv @ (W.T @ ri.ravel()))).reshape(ri.shape) for ri in r])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())

    # JAX's correction from the same smoothed vectors
    jder = jops.derived(jp, jnp.asarray(x))
    jnst = jnn._build(jops, jp, jder, jnp.asarray(T[0].numpy()), jcfg)
    jgot = np.stack([np.asarray(jnn.apply_correction(jops, jnst, jnp.asarray(ri), jcfg))
                     for ri in r])
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-6 * np.abs(jgot).max())


def test_nearnull_solve_reaches_tol_like_jax():
    jops, jp, ops, tp, x = _model(4, 1.6)
    kcfg = kpm.KPMConfig(max_order=4)
    cfg, jcfg = NearNullConfig(k=8, c=4), jnn.NearNullConfig(k=8, c=4)
    T0 = np.array(jax.random.normal(jax.random.PRNGKey(jcfg.seed),
                                    (cfg.k, ops.Nsites, ops.Ltau), dtype=jnp.float64))
    two = make_nearnull_precond(ops, kcfg, cfg, test_vectors=torch.as_tensor(T0))
    jtwo = jnn.make_nearnull_precond(jops, jkpm.KPMConfig(max_order=4), jcfg)
    xt = torch.as_tensor(x)[None]
    st = two.setup(tp, xt, start=_jax_start(ops.Nsites))
    jst = jtwo.setup(jp, jnp.asarray(x))
    b = np.random.default_rng(1).standard_normal((2, ops.Nsites, ops.Ltau))
    derived = ops.stack(ops.derived(tp, xt))
    jder = jops.derived(jp, jnp.asarray(x))

    def A(v):
        return ops.mulMTM(tp, derived, v)

    tol = 1e-8
    res = solvers.cg(A, torch.as_tensor(b)[None], apply_P=lambda v: two.symmetric(st, v),
                     tol=tol, maxiter=2000)
    jres = jsolvers.cg(lambda v: jops.mulMTM(jp, jder, v), jnp.asarray(b),
                       apply_P=lambda v: jtwo.symmetric(jst, v), tol=tol, maxiter=2000)
    resid = (torch.linalg.vector_norm(A(res.x) - torch.as_tensor(b)[None], dim=(-2, -1))
             / torch.linalg.vector_norm(torch.as_tensor(b), dim=(-2, -1)))
    assert bool(res.converged.all()) and float(resid.max()) < tol
    assert np.all(np.abs(res.iters[0].numpy() - np.asarray(jres.iters)) <= 2), (
        res.iters, jres.iters)
    # a refresh at the same field keeps the solve converging
    st2 = two.refresh(st, tp, xt)
    res2 = solvers.cg(A, torch.as_tensor(b)[None], apply_P=lambda v: two.symmetric(st2, v),
                      tol=tol, maxiter=2000)
    assert bool(res2.converged.all())


def _cfg(edit):
    cfg = tconfig.load_toml(os.path.join(EXAMPLES, "holstein_hmc_square.toml"))
    cfg["solver"]["nearnull"] = {"k": 4}
    edit(cfg)
    return cfg


@pytest.mark.parametrize("edit,err", [
    (lambda c: c["holstein"].update(twist=[0.3, 0.0]), NotImplementedError),
    (lambda c: c["solver"].pop("preconditioner"), ValueError),
    (lambda c: c["solver"].update(type="GMRES"), ValueError),
], ids=["complex_hopping", "no_preconditioner", "not_cg"])
def test_nearnull_refusals(edit, err, tmp_path):
    with pytest.raises(err, match="nearnull"):
        tconfig.build_setup(copy.deepcopy(_cfg(edit)), str(tmp_path), "cpu", torch.float64)
