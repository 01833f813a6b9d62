"""Hermitian block CG on complex fields (complex hopping) in the PyTorch
port, against dense solves and against the JAX package's converged
solutions, in float64 on the CPU unless stated.

The port's ``block_cg`` on complex fields forms the Hermitian Grams U†W
and solves complex s×s systems: the search runs over the complex span of
the s directions. The JAX package's block CG forms its Grams without the
conjugate (``elphdynamics_tpu/solvers.py:339-347``), so on complex fields it
is not a Krylov method for a Hermitian operator; its ``block_solve_checked``
reaches the tolerance only through the unpreconditioned CG retry. The port
is held against dense solves and against the JAX package's converged
answers, not against its iteration counts.

* (a) ``block_cg`` on a random Hermitian positive definite dense operator
  with a batch axis, s ∈ {1, 2, 3, 10}, complex64 and complex128, against
  ``torch.linalg.solve``: relative error ≤ 4·κ·tol (κ the operator's
  condition number; the error of a solve whose residual is tol·|b|), no
  more iterations per column than CG's + 1, plus a frozen column that
  starts converged and stays as given. The s×s Gram
  solve against ``torch.linalg.solve`` on complex Hermitian G (1e-12); the
  complex KPM apply is ℂ-linear, Hermitian and positive definite (1e-12),
  which is what Hermitian block CG asks of a preconditioner.
* (b) ``solve_minv(block=True)`` on twisted 4×4 Holstein and SSH models
  with the KPM preconditioner, tol 1e-10, against a dense solve of M
  (``tests/dense_reference.py``): 1e-8 relative; each system's iterations
  at most the port's own CG's + 1 (the block Krylov space holds each
  system's own).
* (c) the same inputs through the JAX package (parameters carried across
  with ``convert``, probes from numpy, the same KPM start vectors): its
  block solves end with flag 0, and those that reach tol agree with the
  port's to 1e-7 relative. Measured here, the reference fault: its block
  CG stops at its 500 iterations (one system at 316, by the κ bound) with
  true residuals of the normal equations from 2e-6 up to 1e36; its retry
  re-solves the systems above √tol by unpreconditioned CG, so it takes
  384–570 iterations per system on the twisted Holstein model and 554–556
  on the twisted SSH model, against the port's 13 (the port's CG: 14 and
  15). Three systems of one Holstein chain end at residuals 1.9e-6, 4.1e-6
  and 6.0e-6, under its √tol = 1e-5 check: they pass unretried, 4e-6 from
  the port's solution (``scripts/block_complex_reference.py`` prints these
  counts and residuals).
* (d) a twisted measurement (``sample_greens`` and the correlations built
  on it) with ``[solver] block`` against the JAX package's, the same
  circular complex probes: every increment to 1e-8 relative to its
  array's largest entry.
* (e) one twisted HMC update whose trajectory solves run block CG (the
  spins packed into one complex entry: s = 1), and one Runge-Kutta
  Langevin step with ``block = true``: against the port's ``block = false``
  run, x to 1e-10 and equal decisions; against the JAX package's block
  update (its trajectory solves end in its CG retry), x to 1e-8, ΔH to
  1e-6, equal decisions. The Langevin force solves hold one system per
  chain and run CG in both packages whatever ``block`` says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics import solve as jsolve
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.dynamics.langevin import make_langevin_step as j_make_langevin_step
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.models import holstein as JH
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass, build_Q
from elphdynamics_tpu.utils import dtypes as jdtypes
from elphdynamics_tpu_torch import convert, solvers
from elphdynamics_tpu_torch.dynamics import langevin as tl
from elphdynamics_tpu_torch.dynamics import solve as tsolve
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCDraws, HMCState, make_hmc_step
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.models import holstein as TH
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import kpm
from tests.dense_reference import dense_expK, dense_M

torch.set_num_threads(1)

SQUARE = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
TWIST = (0.7, 0.3)
C, NV = 2, 4
KPM = dict(max_order=8)


def _T(a):
    return torch.as_tensor(np.array(a))


def _cnormal(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    """Per-system ‖a − b‖ / ‖b‖ over the two field axes."""
    a, b = np.asarray(a), np.asarray(b)
    return (np.linalg.norm((a - b).reshape(a.shape[:-2] + (-1,)), axis=-1)
            / np.linalg.norm(b.reshape(b.shape[:-2] + (-1,)), axis=-1))


# ---------------------------------------------------------------------------
# (a) dense Hermitian positive definite operators
# ---------------------------------------------------------------------------

def _hpd(rng, batch, n, cond):
    """Hermitian positive definite [batch, n, n] with eigenvalues spread
    geometrically over [1, cond] in random unitary bases."""
    Q = np.linalg.qr(_cnormal(rng, (batch, n, n)))[0]
    lam = np.geomspace(1.0, cond, n)
    return np.einsum("bij,j,bkj->bik", Q, lam, Q.conj())


@pytest.mark.parametrize("s,dtype,frozen", [
    (1, torch.complex128, False), (2, torch.complex128, False), (3, torch.complex128, False),
    (10, torch.complex128, False), (1, torch.complex64, False), (2, torch.complex64, False),
    (3, torch.complex64, False), (10, torch.complex64, False), (3, torch.complex128, True)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_block_cg_complex_dense_hpd(s, dtype, frozen):
    rng = np.random.default_rng(s)
    n, Lt, cond = 8, 10, 100.0
    A = _hpd(rng, 2, n * Lt, cond)
    At = torch.as_tensor(A)
    B = torch.as_tensor(_cnormal(rng, (2, s, n, Lt))).to(dtype)
    want = torch.linalg.solve(At[:, None], B.to(torch.complex128).reshape(2, s, n * Lt, 1))
    want = want.reshape(B.shape)

    def apply_A(v):
        return torch.matmul(At.to(v.dtype)[:, None], v.reshape(2, s, n * Lt, 1)).reshape(v.shape)

    tol = 1e-10 if dtype == torch.complex128 else 1e-5
    X0 = None
    if frozen:
        X0 = torch.zeros_like(B)
        X0[:, 1] = want[:, 1]
    res = solvers.block_cg(apply_A, B, X0, tol=tol, maxiter=2000)
    assert res.x.dtype == dtype and bool(res.converged.all())
    err = _rel(res.x.to(torch.complex128).numpy(), want.numpy())
    assert err.max() <= 4 * cond * tol, err
    # the block Krylov space holds each column's own: no more iterations
    # than CG on that column (+ 1 for rounding at the tolerance)
    cg = solvers.cg(apply_A, B, X0, tol=tol, maxiter=2000)
    assert bool((res.iters <= cg.iters + 1).all()), (res.iters, cg.iters)
    if frozen:
        assert torch.equal(res.x[:, 1], X0[:, 1]) and int(res.iters[:, 1].max()) == 0
        assert int(res.iters[:, 0].min()) > 0


@pytest.mark.parametrize("s", [2, 3])
def test_colsolve_complex_hermitian_matches_linalg_solve(s):
    """The scaled s×s Gram solve (closed form at s = 2, LU above) on a
    complex Hermitian G."""
    rng = np.random.default_rng(s)
    G = torch.as_tensor(_hpd(rng, 5, s, 30.0) * rng.uniform(0.5, 4.0, (5, 1, 1)))
    R = torch.as_tensor(_cnormal(rng, (5, s, s)))
    torch.testing.assert_close(solvers._colsolve(G, R), torch.linalg.solve(G, R),
                               rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the twisted 4×4 models in both packages
# ---------------------------------------------------------------------------

def _holstein():
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, lam=0.6, mu=-0.1, twist=TWIST, dense_threshold=0)
    js, jp = JH.build_holstein(JLattice.create(JUnitCell.create(*SQUARE), 4), 1.0, 0.1,
                               rng=np.random.default_rng(5), **kw)
    ts, _ = TH.build_holstein(Lattice.create(UnitCell.create(*SQUARE), 4), 1.0, 0.1,
                              rng=np.random.default_rng(5), device="cpu", **kw)
    return js, jp, ts


def _ssh():
    hop = dict(t=1.0, alpha=0.3, omega=1.0, o1=0, o2=0)
    kw = dict(hoppings=[dict(hop, dL=(1, 0, 0), name="x"), dict(hop, dL=(0, 1, 0), name="y")],
              mu_assignments=[(-0.2, 0.0, None)], twist=TWIST)
    js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*SQUARE), 4), 0.8, 0.1,
                          rng=np.random.default_rng(0), **kw)
    ts, _ = TS.build_ssh(Lattice.create(UnitCell.create(*SQUARE), 4), 0.8, 0.1,
                         rng=np.random.default_rng(0), device="cpu", **kw)
    return js, jp, ts


def _model(name):
    """Both packages' model (the port's parameters carried across from the
    JAX package's), both ModelOps, and a random phonon field per chain."""
    js, jp, ts = _ssh() if name == "ssh" else _holstein()
    fields = TS.SSHParams if name == "ssh" else TH.HolsteinParams
    tp = convert.params_from_jax({f: None if getattr(jp, f) is None else np.asarray(getattr(jp, f))
                                  for f in fields.__dataclass_fields__}, "cpu")
    x = 0.3 * np.random.default_rng(7).standard_normal((C, ts.Nph, ts.Ltau))
    if name == "ssh":
        x = TS.tie_fields(ts, _T(x)).numpy()
    return js, jp, j_make_model_ops(js), ts, tp, make_model_ops(ts), x


def _jax_start(N):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    return tuple(_T(jax.random.normal(k, (N, 1), dtype=jnp.complex128)) for k in (k1, k2))


def _port_pa(tops, tp, x):
    """The port's symmetric KPM apply, set up from the JAX package's start
    vectors (as the JAX package's ``make_symmetric_precond`` draws them)."""
    st = kpm.setup(tops, tp, _T(x), kpm.KPMConfig(**KPM), _jax_start(tops.Nsites))
    return tsolve.PrecondApplies(symmetric=lambda v: kpm.apply_symmetric(
        tops, st, v, kpm.KPMConfig(**KPM)))


def _dense_M(ts, tp, x, name):
    """The dense fermion matrix of one chain's field ``x``."""
    if name == "ssh":
        co = TS.ckb_coeffs(ts, tp, _T(x[None]))
        cB, sB = co.cosh[0].numpy(), co.sinh[0].numpy()
        emu = np.diag(np.exp(ts.dtau * tp.mu.numpy()))
        return dense_M([dense_expK(ts.Nsites, ts.ckb.neighbor_table, ts.ckb.groups, cB[:, t],
                                   sB[:, t]) @ emu for t in range(ts.Ltau)])
    env = TH.expnV(ts, tp, _T(x)).numpy()
    K = dense_expK(ts.Nsites, ts.ckb.neighbor_table, ts.ckb.groups, tp.cosht.numpy(),
                   tp.sinht.numpy())
    return dense_M([K @ np.diag(env[:, t]) for t in range(ts.Ltau)])


def test_complex_kpm_apply_is_hermitian_positive_and_c_linear():
    """P(i·v) = i·P(v), u†P(v) = conj(v†P(u)) and v†P(v) > 0 for the
    symmetric KPM apply of a twisted model: the conditions under which
    complex Grams make block CG a Krylov method."""
    js, jp, jops, ts, tp, tops, x = _model("holstein")
    P = _port_pa(tops, tp, x).symmetric
    rng = np.random.default_rng(3)
    u, v = (_T(_cnormal(rng, (C, 1, ts.Nsites, ts.Ltau))) for _ in range(2))
    Pv, Pu = P(v), P(u)
    scale = Pv.abs().max().item()
    torch.testing.assert_close(P(1j * v), 1j * Pv, rtol=0, atol=1e-12 * scale)

    def dot(a, b):
        return (a.conj() * b).sum(dim=(-2, -1))

    torch.testing.assert_close(dot(u, Pv), dot(v, Pu).conj(), rtol=1e-12, atol=0)
    assert bool((dot(v, Pv).real > 0).all())
    assert dot(v, Pv).imag.abs().max() <= 1e-12 * dot(v, Pv).real.abs().max()


# ---------------------------------------------------------------------------
# (b), (c) probe solves of M against a dense solve and the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["holstein", "ssh"])
def test_block_minv_matches_dense_and_jax(name):
    js, jp, jops, ts, tp, tops, x = _model(name)
    N, Lt = ts.Nsites, ts.Ltau
    R = _cnormal(np.random.default_rng(11), (C, NV, N, Lt)) / np.sqrt(2.0)
    ds = tops.stack(tops.derived(tp, _T(x)))
    pa = _port_pa(tops, tp, x)
    kw = dict(tol=1e-10, maxiter=500)
    blk = tsolve.solve_minv(tops, tp, ds, _T(R), tsolve.SolverConfig(block=True, **kw), pa,
                            block=True)
    cg = tsolve.solve_minv(tops, tp, ds, _T(R), tsolve.SolverConfig(**kw), pa, block=True)
    assert blk.x.dtype == torch.complex128 and int(blk.flag.max()) == 0
    # (b) a dense solve of M, one chain at a time
    for c in range(C):
        M = _dense_M(ts, tp, x[c], name)
        want = np.linalg.solve(M, R[c].reshape(NV, -1).T).T.reshape(NV, N, Lt)
        assert _rel(blk.x[c].numpy(), want).max() <= 1e-8
        assert _rel(cg.x[c].numpy(), want).max() <= 1e-8
    assert bool((blk.iters <= cg.iters + 1).all()), (blk.iters, cg.iters)
    # (c) the JAX package's block solve, chain by chain, the same KPM start
    jcfg = jkpm.KPMConfig(**KPM)
    for c in range(C):
        xc = jnp.asarray(x[c])
        jst = jkpm.setup(jops, jp, xc, jcfg, jax.random.PRNGKey(1234))
        jpa = jsolve.PrecondApplies(symmetric=lambda v: jkpm.apply_symmetric(jops, jst, v, jcfg),
                                    left=None, right=None)
        want = jsolve.solve_minv(jops, jp, jops.derived(jp, xc), jnp.asarray(R[c]),
                                 jsolve.SolverConfig(block=True, **kw), jpa, block=True)
        assert int(np.max(want.flag)) == 0
        # its block CG ran out its iterations on every system and its retry
        # re-solved the ones above √tol
        assert int(np.max(want.iters)) > kw["maxiter"]
        # a system it solved to tol agrees with the port's; one whose block
        # CG stopped between tol and √tol passed its check unretried
        done = np.asarray(want.residual) <= 10 * kw["tol"]
        assert bool(done.any()) and float(np.max(want.residual)) <= kw["tol"] ** 0.5
        assert _rel(blk.x[c].numpy(), np.asarray(want.x))[done].max() <= 1e-7
    assert int(blk.iters.max()) < 50


# ---------------------------------------------------------------------------
# (d) a twisted measurement with [solver] block
# ---------------------------------------------------------------------------

ONSITE = tuple((k, True) for k in ("Greens", "DenDen", "SpinSpin", "PairGreens"))


@pytest.mark.parametrize("name", ["holstein", "ssh"])
def test_block_measurement_matches_jax(name):
    js, jp, jops, ts, tp, tops, x = _model(name)
    mspec = dict(nv=NV, onsite_corr=ONSITE, intersite_corr=(("CurrentCurrent", True),))
    kw = dict(tol=1e-10, maxiter=500, block=True)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jstep = jax.jit(jm.make_measurement_step(jops, jm.MeasurementSpec(**mspec),
                                             jsolve.SolverConfig(**kw)))
    jres = [jstep(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    R = np.stack([np.asarray(jdtypes.trace_noise(jax.random.split(k)[1], jp,
                                                 (NV, tops.Nsites, tops.Ltau), jnp.float64))
                  for k in keys])
    tstep = tm.make_measurement_step(tops, tm.MeasurementSpec(**mspec), tsolve.SolverConfig(**kw))
    inc, stats, _ = tstep(tp, _T(x), R=_T(R))
    assert int(stats["flag"].max()) == 0
    for c, (jinc, jstats, _, _) in enumerate(jres):
        assert int(jstats["flag"]) == 0 and set(inc) == set(jinc)
        for group in inc:
            for k, v in inc[group].items():
                want = np.asarray(jinc[group][k])
                np.testing.assert_allclose(v[c].numpy(), want, rtol=0,
                                           atol=1e-8 * max(np.abs(want).max(), 1e-300),
                                           err_msg=f"{group}/{k}")
        # the JAX package's answer came from its retry, the port's from block CG
        assert int(jstats["iters"]) > 500 and int(stats["iters"][c]) < 50


# ---------------------------------------------------------------------------
# (e) an HMC update and a Langevin step with block = true
# ---------------------------------------------------------------------------

HMC = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-6, maxiter=500, construct_guess=True,
           guess_order=3)


def _pf(key, N, Lt):
    """JAX's packed pseudofermion draw: (R↑ + i·R↓)[None]."""
    r = np.asarray(jax.random.normal(key, (2, N, Lt), dtype=jnp.float64))
    return (r[0] + 1j * r[1])[None]


@pytest.mark.parametrize("name", ["holstein", "ssh"])
def test_block_hmc_update_matches_cg_and_jax(name, monkeypatch):
    js, jp, jops, ts, tp, tops, x0 = _model(name)
    N, Lt, Nph = ts.Nsites, ts.Ltau, ts.Nph
    rng = np.random.default_rng(12)
    v0 = rng.standard_normal((C, Nph, Lt))
    if name == "ssh":
        v0 = TS.tie_fields(ts, _T(v0)).numpy()
    mass = build_mass(np.asarray(jp.omega), 0.1, Lt, [dict(omega_min=0.0, omega_max=10.0,
                                                          mass=0.5)])
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(block=True, **HMC),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    jruns = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
             for c in range(C)]
    Rm, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        Rm.append(np.asarray(jax.random.normal(k_v, (Nph, Lt), dtype=jnp.float64)))
        Rpm.append(_pf(k_p, N, Lt))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    draws = HMCDraws(momentum=_T(np.stack(Rm)), pseudofermion=_T(np.stack(Rpm)),
                     uniform=_T(np.asarray(U)), kpm_start=_jax_start(N))
    # every block CG solve starts in block_cg_init, the eager update's
    # (solvers.block_cg) and the segmented update's (graphs.CGSolve) alike
    block_cg_init, shapes = solvers.block_cg_init, []

    def counted(apply_A, B, *a, **kw):
        shapes.append(tuple(B.shape))
        return block_cg_init(apply_A, B, *a, **kw)

    monkeypatch.setattr(solvers, "block_cg_init", counted)
    runs = {}
    for block in (True, False):
        shapes.clear()
        step = make_hmc_step(tops, mass, HMCConfig(block=block, **HMC),
                             kpm.make_symmetric_precond(tops, kpm.KPMConfig(**KPM)))
        runs[block] = step(tp, HMCState(x=_T(x0), v=_T(v0)), draws=draws)
        # block = true: every trajectory solve, one complex entry per chain
        assert set(shapes) == ({(C, 1, N, Lt)} if block else set())
    (st, stats), (st_cg, stats_cg) = runs[True], runs[False]
    np.testing.assert_allclose(st.x.numpy(), st_cg.x.numpy(), rtol=0, atol=1e-10)
    assert torch.equal(stats.accepted, stats_cg.accepted)
    assert int(stats.flag.max()) == 0
    for c, (jst, jstats, _) in enumerate(jruns):
        np.testing.assert_allclose(st.x[c].numpy(), np.asarray(jst.x), rtol=0, atol=1e-8)
        np.testing.assert_allclose(stats.delta_H[c].item(), float(jstats.delta_H), atol=1e-6)
        assert bool(stats.accepted[c]) == bool(jstats.accepted)
        assert int(jstats.flag) == 0
    assert float(np.abs(st.x.numpy() - x0).max()) > 1e-3


def test_block_langevin_step_matches_cg_and_jax():
    js, jp, jops, ts, tp, tops, x0 = _model("holstein")
    N, Lt = ts.Nsites, ts.Ltau
    Q = build_Q(np.asarray(jp.omega), 0.1, Lt, [dict(omega_min=0.0, omega_max=10.0, mass=0.0)])
    kw = dict(tol=1e-8, maxiter=4000, block=True)
    jstep = jax.jit(j_make_langevin_step(jops, Q, 1e-3, "rk", jsolve.SolverConfig(**kw)))
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    jruns = [jstep(jp, jnp.asarray(x0[c]), keys[c]) for c in range(C)]
    eta, gs = [], [[], []]
    for key in keys:
        key, kn = jax.random.split(key)
        eta.append(np.asarray(jax.random.normal(kn, (N, Lt), dtype=jnp.float64)))
        for g in gs:
            key, kg = jax.random.split(key)
            g.append(np.asarray(jdtypes.trace_noise(kg, jp, (N, Lt), jnp.float64)))
    draws = tl.LangevinDraws(eta=_T(np.stack(eta)), g=tuple(_T(np.stack(g)) for g in gs))
    out = {}
    for block in (True, False):
        step = tl.make_langevin_step(tops, Q, 1e-3, "rk",
                                     tsolve.SolverConfig(**dict(kw, block=block)))
        out[block] = step(tp, _T(x0), draws=draws)
    (x1, stats), (x1_cg, stats_cg) = out[True], out[False]
    np.testing.assert_allclose(x1.numpy(), x1_cg.numpy(), rtol=0, atol=1e-10)
    assert torch.equal(stats.iters, stats_cg.iters) and int(stats.flag.max()) == 0
    for c, (jx, jstats, _) in enumerate(jruns):
        np.testing.assert_allclose(x1[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)
        assert int(stats.iters[c]) == int(jstats.iters)
