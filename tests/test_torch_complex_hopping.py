"""Complex hopping (twisted boundaries, Peierls phases) in the PyTorch port
against the JAX package.

The same lattices, parameters, fields and random draws (made with numpy or
drawn with JAX's keys and handed to the port) go through both packages, in
float64 on the CPU, where the port's folds are the plain twin of the CUDA
kernel's complex mode. Tolerances: operators and folds 1e-12 absolute on
O(1) fields, solves 1e-10 relative in x with equal iteration counts
(unpreconditioned CG at a tight tolerance and GMRES: within one; the float64
sums run in another order, and GMRES's Gram-Schmidt differs from the JAX
package's), a whole HMC
update 1e-12 in x, a Langevin step 1e-10. Where the JAX package's own test
checks physics (the dense reference, Hermiticity, the real two-spin limit,
gauge equivalence of a 2π twist), the port's test checks the same physics
itself as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics import special_updates as jsu
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.dynamics.langevin import make_langevin_step as j_make_langevin_step
from elphdynamics_tpu.dynamics import solve as jsolve
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models import holstein as JH
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.ops import checkerboard as jckb
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass, build_Q
from elphdynamics_tpu.utils import dtypes as jdtypes
from elphdynamics_tpu_torch import convert
from elphdynamics_tpu_torch.dynamics import langevin as tl
from elphdynamics_tpu_torch.dynamics import solve as tsolve
from elphdynamics_tpu_torch.dynamics import special_updates as tsu
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCDraws, HMCState, make_hmc_step
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models import holstein as TH
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.ops import ckb_cuda, kpm
from elphdynamics_tpu_torch.utils import dtypes as tdtypes
from tests.dense_reference import dense_expK, dense_M, flatten_field

torch.set_num_threads(1)

SQUARE = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
CHAIN = (1, 1, [[1.0]], [[0.0]])
T_ASSIGN = [(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))]
TWIST = (0.7, 0.3)
DIRECTIONS = [(False, 1.0), (True, 1.0), (True, -1.0), (False, -1.0)]
DIRECTION_IDS = ["forward", "transpose", "inverse", "inverse_transpose"]


def _holstein(L=4, beta=0.8, dtau=0.1, twist=TWIST, seed=5, t_assignments=T_ASSIGN,
              **kw):
    """The same Holstein model in both packages (JAX, port on the CPU)."""
    kw = dict(t_assignments=t_assignments, omega=1.0, lam=0.6, mu=-0.1, twist=twist, **kw)
    js, jp = JH.build_holstein(JLattice.create(JUnitCell.create(*SQUARE), L), beta, dtau,
                               rng=np.random.default_rng(seed), **kw)
    ts, tp = TH.build_holstein(Lattice.create(UnitCell.create(*SQUARE), L), beta, dtau,
                               rng=np.random.default_rng(seed), device="cpu", **kw)
    return js, jp, ts, tp


def _ssh(L=4, Ltau=8, alpha=0.4, alpha2=0.1, twist=(0.7,), seed=0):
    """The twisted SSH chain of the JAX package's tests in both packages,
    and a tied random phonon field."""
    kw = dict(hoppings=[dict(t=1.0, omega=1.0, alpha=alpha, alpha2=alpha2, o1=0, o2=0,
                             dL=(1, 0, 0), name="ph")],
              mu_assignments=[(-0.2, 0.0, None)], twist=twist)
    js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*CHAIN), L), Ltau * 0.1, 0.1,
                          rng=np.random.default_rng(seed), **kw)
    ts, tp = TS.build_ssh(Lattice.create(UnitCell.create(*CHAIN), L), Ltau * 0.1, 0.1,
                          rng=np.random.default_rng(seed), device="cpu", **kw)
    x = 0.3 * np.random.default_rng(seed + 1).standard_normal((ts.Nph, ts.Ltau))
    return js, jp, ts, tp, np.asarray(JS.tie_fields(js, jnp.asarray(x)))


def _cnormal(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _T(a):
    return torch.as_tensor(np.array(a))


def _jax_start(N):
    """The complex power-iteration start vectors of the JAX package's KPM
    setup (seed 1234)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    return tuple(_T(jax.random.normal(k, (N, 1), dtype=jnp.complex128)) for k in (k1, k2))


# ---------------------------------------------------------------------------
# model build, tables, the checkerboard twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fold"])
def test_twist_zero_keeps_real_dtype(dense):
    """No twist (or a zero one) keeps the real tables; a twist makes the
    tables, t and expK complex, equal to the JAX package's."""
    thr = 4096 if dense else 0
    for tw in (None, (0.0, 0.0)):
        _, jp, ts, tp = _holstein(twist=tw, dense_threshold=thr)
        assert not tp.cosht.is_complex() and not tdtypes.params_are_complex(tp)
        np.testing.assert_array_equal(tp.sinht.numpy(), np.asarray(jp.sinht))
    _, jp, ts, tp = _holstein(dense_threshold=thr)
    assert tp.cosht.dtype == tp.sinht.dtype == tp.t.dtype == torch.complex128
    assert tdtypes.params_are_complex(tp) and ts.dense_ckb == dense
    names = ("cosht", "sinht", "t") + (("expK", "expK_inv") if dense else ())
    for name in names:
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fold"])
def test_complex_expk_matches_dense_reference_and_is_hermitian(dense):
    js, jp, ts, tp = _holstein(dense_threshold=4096 if dense else 0)
    ref = dense_expK(ts.Nsites, ts.ckb.neighbor_table, ts.ckb.groups, tp.cosht.numpy(),
                     tp.sinht.numpy())
    assert np.abs(ref.imag).max() > 1e-3
    eye = torch.eye(ts.Nsites, dtype=torch.complex128)
    got = TH.apply_expK(ts, tp, eye).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-12)
    np.testing.assert_allclose(TH.apply_expK_T(ts, tp, eye).numpy(), ref.conj().T, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(JH.apply_expK(js, jp, jnp.asarray(eye.numpy()))),
                               atol=1e-13)
    if not dense:
        v = _T(_cnormal(np.random.default_rng(0), (ts.Nsites, 3)))
        back = ckb.ckb_inverse_mul(ts.ckb, tp.cosht, tp.sinht, TH.apply_expK(ts, tp, v))
        torch.testing.assert_close(back, v, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ckb.dense_matrix(ts.ckb, tp.cosht.numpy(), tp.sinht.numpy()),
                                   jckb.dense_matrix(js.ckb, np.asarray(jp.cosht),
                                                     np.asarray(jp.sinht)), atol=1e-14)


@pytest.mark.parametrize("rev,sign", DIRECTIONS, ids=DIRECTION_IDS)
@pytest.mark.parametrize("form", ["shared", "chain", "column"])
def test_complex_fold_twin_matches_jax(form, rev, sign):
    """The plain twin of K1's complex mode in its three table forms against
    the JAX fold (which takes [Nb] or [Nb, K] tables: per chain here), with
    a complex c (the kernel and the twin carry it complex)."""
    js, jp, ts, tp = _holstein(L=6, dense_threshold=0)
    rng = np.random.default_rng(3)
    C, K, nb = 3, 5, ts.Nbonds
    c0, s0 = tp.cosht.numpy(), tp.sinht.numpy()
    shape = {"shared": (nb,), "chain": (C, nb), "column": (C, nb, K)}[form]
    base = (slice(None), None) if form == "column" else (slice(None),)
    c = c0[base] * (1 + 0.1 * _cnormal(rng, shape))
    s = s0[base] * (1 + 0.2 * _cnormal(rng, shape))
    v = _cnormal(rng, (C, 2, ts.Nsites, K))
    got = ckb.fold(ts.ckb, _T(c), _T(s), _T(v), reverse=rev, sign=sign).numpy()
    assert torch.equal(_T(got), ckb_cuda.fold(ts.ckb, _T(c), _T(s), _T(v), reverse=rev,
                                              sign=sign))
    jfn = {(False, 1.0): jckb.ckb_mul, (True, 1.0): jckb.ckb_transpose_mul,
           (True, -1.0): jckb.ckb_inverse_mul, (False, -1.0): jckb.ckb_inverse_transpose_mul}
    for k in range(C):
        ck, sk = (c, s) if form == "shared" else (c[k], s[k])
        want = np.asarray(jfn[rev, sign](js.ckb, jnp.asarray(ck), jnp.asarray(sk),
                                          jnp.asarray(v[k])))
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-12)


def test_complex_tables_must_match_the_field():
    _, _, ts, tp = _holstein(dense_threshold=0)
    v = torch.zeros((2, ts.Nsites, 3), dtype=torch.complex64)
    with pytest.raises(ValueError, match="field's dtype"):
        ckb.fold(ts.ckb, tp.cosht, tp.sinht, v)
    with pytest.raises(ValueError, match="field's dtype"):
        ckb.fold(ts.ckb, tp.cosht, tp.sinht, v.real)


# ---------------------------------------------------------------------------
# operators, solves, the packed action
# ---------------------------------------------------------------------------

def test_complex_mulM_and_adjoint_match_dense():
    js, jp, ts, tp = _holstein()
    rng = np.random.default_rng(2)
    x = 0.4 * rng.standard_normal((ts.Nsites, ts.Ltau))
    env = TH.expnV(ts, tp, _T(x))
    jenv = JH.expnV(js, jp, jnp.asarray(x))
    expK = dense_expK(ts.Nsites, ts.ckb.neighbor_table, ts.ckb.groups, tp.cosht.numpy(),
                      tp.sinht.numpy())
    Mref = dense_M([expK @ np.diag(env.numpy()[:, t]) for t in range(ts.Ltau)])
    v = _cnormal(rng, (ts.Nsites, ts.Ltau))
    fv = flatten_field(v)
    for name, want, tol in (("mulM", Mref @ fv, 1e-12), ("mulMT", Mref.conj().T @ fv, 1e-12),
                            ("mulMTM", Mref.conj().T @ (Mref @ fv), 1e-11),
                            ("mulMMT", Mref @ (Mref.conj().T @ fv), 1e-11)):
        got = getattr(TH, name)(ts, tp, env, _T(v)).numpy()
        np.testing.assert_allclose(flatten_field(got), want, atol=tol)
        np.testing.assert_allclose(got, np.asarray(getattr(JH, name)(js, jp, jenv,
                                                                      jnp.asarray(v))),
                                   atol=1e-12)
    u = _cnormal(rng, (ts.Nsites, ts.Ltau))
    got = TH.muldMdx(ts, tp, env, _T(x), _T(u), _T(v))
    assert not got.is_complex()
    np.testing.assert_allclose(got.numpy(), np.asarray(JH.muldMdx(
        js, jp, jenv, jnp.asarray(x), jnp.asarray(u), jnp.asarray(v))), atol=1e-13)


def test_complex_cg_solves_hermitian_normal_equations():
    """CG on M†M (and on M through M†) with complex right-hand sides: the
    port's residuals are tiny, its solutions and iteration counts those of
    the JAX package."""
    js, jp, ts, tp = _holstein()
    rng = np.random.default_rng(3)
    x = 0.4 * rng.standard_normal((ts.Nsites, ts.Ltau))
    rhs = _cnormal(rng, (2, ts.Nsites, ts.Ltau))
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    jenv = jops.derived(jp, jnp.asarray(x))
    tenv = tops.stack(tops.derived(tp, _T(x[None])))
    for fn, jfn, op in ((tsolve.solve_oinv, jsolve.solve_oinv, tops.mulMTM),
                        (tsolve.solve_minv, jsolve.solve_minv, tops.mulM)):
        got = fn(tops, tp, tenv, _T(rhs[None]), tsolve.SolverConfig(tol=1e-9, maxiter=3000),
                 None)
        want = jfn(jops, jp, jenv, jnp.asarray(rhs), jsolve.SolverConfig(tol=1e-9, maxiter=3000),
                   None)
        assert int(got.flag.max()) == 0 and got.x.is_complex()
        r = op(tp, tenv, got.x) - _T(rhs[None])
        assert (r.abs().pow(2).sum().sqrt() / np.linalg.norm(rhs)).item() < 1e-8
        # 50+ unpreconditioned iterations: the last one may fall either side
        # of the tolerance with the sums in another order
        assert np.all(np.abs(got.iters[0].numpy() - np.asarray(want.iters)) <= 1)
        np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x),
                                   atol=1e-8 * np.abs(np.asarray(want.x)).max())


def test_complex_f32_smoke():
    """complex64: dense operators and CG to a float32 tolerance."""
    ts, tp = TH.build_holstein(Lattice.create(UnitCell.create(*SQUARE), 4), 0.8, 0.1,
                               t_assignments=T_ASSIGN, omega=1.0, lam=0.6, twist=TWIST,
                               dtype=torch.float32, device="cpu")
    assert tp.cosht.dtype == torch.complex64 and tp.mu.dtype == torch.float32
    tops = make_model_ops(ts)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(0.4 * rng.standard_normal((1, ts.Nsites, ts.Ltau)), dtype=torch.float32)
    rhs = torch.as_tensor(_cnormal(rng, (1, 2, ts.Nsites, ts.Ltau)), dtype=torch.complex64)
    res = tsolve.solve_oinv(tops, tp, tops.stack(tops.derived(tp, x)), rhs,
                            tsolve.SolverConfig(tol=1e-4, maxiter=2000), None)
    assert int(res.flag.max()) == 0 and res.x.dtype == torch.complex64
    assert float(res.residual.max()) < 3e-2


def test_complex_packed_action_and_forces_match_real_two_spin():
    """At zero twist (complex t forces the complex type), S and ∂S/∂x from
    the packed pseudofermion φ = M†(R↑ + i·R↓) equal the two real spins'."""
    kw = dict(beta=0.8, dtau=0.1, twist=None, seed=7)
    _, _, ts_r, tp_r = _holstein(**kw)
    _, _, ts_c, tp_c = _holstein(t_assignments=[(complex(t), s, *rest) for t, s, *rest in T_ASSIGN],
                                 **kw)
    assert tp_c.sinht.is_complex() and not tp_r.sinht.is_complex()
    rng = np.random.default_rng(7)
    x = _T(0.4 * rng.standard_normal((1, ts_r.Nsites, ts_r.Ltau)))
    R = rng.standard_normal((2, ts_r.Nsites, ts_r.Ltau))
    scfg = tsolve.SolverConfig(tol=1e-12, maxiter=5000)

    def pipeline(ts, tp, Rs):
        ops = make_model_ops(ts)
        d = ops.stack(ops.derived(tp, x))
        Lam = ops.calc_Lambda(tp, x)[:, None]
        phi = ops.mulLambdaInv(Lam, ops.mulMT(tp, d, Rs))
        Lphi = ops.mulLambda(Lam, phi)
        z = tsolve.solve_oinv(ops, tp, d, Lphi, scfg, None).x
        S = tdtypes.fdot(Lphi, z, dim=(1, -2, -1)) / 2
        F = (-ops.muldMdx(tp, d, x[:, None], ops.mulM(tp, d, z), z)
             + ops.muldLambdadx(tp, x[:, None], Lam, phi, z)).sum(dim=1)
        return S, F

    S_r, F_r = pipeline(ts_r, tp_r, _T(R[None]))
    S_c, F_c = pipeline(ts_c, tp_c, _T((R[0] + 1j * R[1])[None, None]))
    assert not S_c.is_complex() and not F_c.is_complex()
    np.testing.assert_allclose(S_c.numpy(), S_r.numpy(), rtol=1e-9)
    np.testing.assert_allclose(F_c.numpy(), F_r.numpy(), atol=1e-8)


def _logdet(ts, tp, x):
    """log|det M| and the phase of det M, from the port's own dense expK."""
    env = TH.expnV(ts, tp, x).numpy()
    eye = torch.eye(ts.Nsites, dtype=tp.cosht.dtype)
    expK = TH.apply_expK(ts, tp, eye).numpy()
    sign, logabs = np.linalg.slogdet(dense_M([expK @ np.diag(env[:, t])
                                              for t in range(ts.Ltau)]))
    return sign, logabs


def test_twist_2pi_is_gauge_equivalent_to_zero():
    """A twist whose flux through each cycle is 2π is a pure gauge: det M is
    unchanged. The JAX package's test builds the model without hopping,
    where this holds trivially; it is checked here so too. With hopping,
    both packages put a bond's phase on its first endpoint after the
    canonical sort (smaller site first), so the bond that wraps around the
    torus carries the conjugate phase and a cycle of L bonds holds the flux
    (L−2)·θ/L, not θ (kept for parity, ROADMAP §3): θ = 2π·L/(L−2) is then
    the gauge-trivial twist and θ = 2π is not."""
    x = _T(0.4 * np.random.default_rng(5).standard_normal((16, 8)))
    for t_assign, flux_2pi, other in (((), 2 * np.pi, None),
                                      (T_ASSIGN, 2 * np.pi * 4 / 2, 2 * np.pi)):
        _, _, ts0, tp0 = _holstein(twist=None, t_assignments=t_assign)
        js2, jp2, ts2, tp2 = _holstein(twist=(flux_2pi, 0.0), t_assignments=t_assign)
        np.testing.assert_allclose(tp2.sinht.numpy(), np.asarray(jp2.sinht), atol=1e-15)
        (s0, l0), (s2, l2) = _logdet(ts0, tp0, x), _logdet(ts2, tp2, x)
        np.testing.assert_allclose(l2, l0, rtol=1e-10)
        np.testing.assert_allclose(s2, complex(s0), atol=1e-9)
        if other is not None:
            _, _, tso, tpo = _holstein(twist=(other, 0.0), t_assignments=t_assign)
            assert abs(_logdet(tso, tpo, x)[1] - l0) > 1e-3


# ---------------------------------------------------------------------------
# the preconditioner and the other solver kinds
# ---------------------------------------------------------------------------

def _kpm_model(name):
    if name == "ssh":
        js, jp, ts, tp, x = _ssh(Ltau=10, alpha2=0.0)
        return j_make_model_ops(js), jp, make_model_ops(ts), tp, x
    js, jp, ts, tp = _holstein(L=3, beta=1.0, dense_threshold=4096 if name == "dense" else 0)
    x = 0.3 * np.random.default_rng(1).standard_normal((ts.Nsites, ts.Ltau))
    return j_make_model_ops(js), jp, make_model_ops(ts), tp, x


@pytest.mark.parametrize("name", ["dense", "fold", "ssh"])
def test_complex_kpm_matches_jax(name):
    """The full-spectrum complex pipeline: bounds, coefficients and the
    symmetric, left and right applies equal the JAX package's, with its
    complex power-iteration start vectors. ``stacked`` and ``exact_lowfreq``
    are ignored on a complex state, as there."""
    jops, jp, tops, tp, x = _kpm_model(name)
    cfg = dict(max_order=8)
    jst = jkpm.setup(jops, jp, jnp.asarray(x), jkpm.KPMConfig(**cfg), jax.random.PRNGKey(1234))
    tcfg = kpm.KPMConfig(**cfg)
    tst = kpm.setup(tops, tp, _T(x[None]), tcfg, _jax_start(tops.Nsites))
    assert kpm._state_is_complex(tst) and tst.coeff.shape[-1] == tops.Ltau
    np.testing.assert_allclose(tst.lam_avg.numpy()[0], float(jst.lam_avg), rtol=1e-12)
    np.testing.assert_allclose(tst.coeff.numpy()[0], np.asarray(jst.coeff), atol=1e-12)
    v = _cnormal(np.random.default_rng(2), (2, tops.Nsites, tops.Ltau))
    for apply, japply in ((kpm.apply_symmetric, jkpm.apply_symmetric),
                          (kpm.apply_left, jkpm.apply_left), (kpm.apply_right, jkpm.apply_right)):
        got = apply(tops, tst, _T(v[None]), tcfg)[0].numpy()
        want = np.asarray(japply(jops, jst, jnp.asarray(v), jkpm.KPMConfig(**cfg)))
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())
    odd = kpm.setup(tops, tp, _T(x[None]), kpm.KPMConfig(stacked=True, exact_lowfreq=2, **cfg),
                    _jax_start(tops.Nsites))
    assert odd.S_fwd is None and odd.G_low is None


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_complex_solver_kinds_match_jax(kind):
    """BiCGStab and GMRES run on complex fields (the real ℝ²ⁿ embedding
    through the Hermitian product), M⁻¹ with the left KPM apply and (M†M)⁻¹
    as two solves, as in the JAX package."""
    jops, jp, tops, tp, x = _kpm_model("dense")
    b = _cnormal(np.random.default_rng(6), (2, tops.Nsites, tops.Ltau))
    cfg = dict(max_order=32, c1=4.0, c2=4.0)
    jpa = jsolve.precond_applies(jkpm.make_precond(jops, jkpm.KPMConfig(**cfg)), jkpm.setup(
        jops, jp, jnp.asarray(x), jkpm.KPMConfig(**cfg), jax.random.PRNGKey(1234)))
    tpre = kpm.make_precond(tops, kpm.KPMConfig(**cfg))
    tpa = tsolve.precond_applies(tpre, tsolve.precond_state(tpre, tp, _T(x[None]),
                                                            start=_jax_start(tops.Nsites)))
    jd = jops.derived(jp, jnp.asarray(x))
    td = tops.stack(tops.derived(tp, _T(x[None])))
    kw = dict(tol=1e-9, maxiter=2000, kind=kind, restart=30)
    for fn, jfn, slack in ((tsolve.solve_minv, jsolve.solve_minv, 1),
                           (tsolve.solve_oinv, jsolve.solve_oinv, 2)):
        want = jfn(jops, jp, jd, jnp.asarray(b), jsolve.SolverConfig(**kw), jpa)
        got = fn(tops, tp, td, _T(b[None]), tsolve.SolverConfig(**kw), tpa)
        assert int(got.flag.max()) == 0 and int(np.asarray(want.flag).max()) == 0
        if kind == "bicgstab":
            slack = 0
        assert np.all(np.abs(got.iters[0].numpy() - np.asarray(want.iters)) <= slack)
        wx = np.asarray(want.x)
        np.testing.assert_allclose(got.x[0].numpy(), wx, atol=1e-7 * np.abs(wx).max())


def test_complex_cg_split_matches_jax():
    """``cg_split`` (split-preconditioned CG) on a Hermitian positive
    definite operator and complex right-hand sides, with a real diagonal
    split: the JAX package's iterations and solutions."""
    from elphdynamics_tpu import solvers as jsolvers
    from elphdynamics_tpu_torch import solvers as tsolvers

    rng = np.random.default_rng(7)
    n = 24
    Q = _cnormal(rng, (n, n))
    A = Q @ Q.conj().T + n * np.eye(n)
    d = np.sqrt(np.diag(A).real)[:, None]
    b = _cnormal(rng, (3, n, 2))
    Aj, At = jnp.asarray(A), _T(A)
    want = jsolvers.cg_split(lambda v: jnp.einsum("ij,...jk->...ik", Aj, v), jnp.asarray(b),
                             apply_Linv=lambda v: v / jnp.asarray(d),
                             apply_LTinv=lambda v: v / jnp.asarray(d), tol=1e-10, maxiter=500)
    got = tsolvers.cg_split(lambda v: torch.matmul(At, v), _T(b),
                            apply_Linv=lambda v: v / _T(d), apply_LTinv=lambda v: v / _T(d),
                            tol=1e-10, maxiter=500)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert bool(got.converged.all()) and got.x.is_complex()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(want.x)).max())
    np.testing.assert_allclose(np.einsum("ij,bjk->bik", A, got.x.numpy()), b, atol=1e-6)


def test_block_cg_refuses_complex_fields():
    """Block CG takes complex blocks (Hermitian block CG, slice F4; the JAX
    package's forms its Grams without a conjugate): on the identity it
    returns a complex block in one iteration. What it still refuses is a
    complex field without its block axis."""
    from elphdynamics_tpu_torch import solvers

    B = _T(_cnormal(np.random.default_rng(0), (1, 2, 4, 3)))
    res = solvers.block_cg(lambda v: v, B, tol=1e-12)
    assert res.x.dtype == torch.complex128 and bool(res.converged.all())
    torch.testing.assert_close(res.x, B, rtol=0, atol=1e-14)
    assert res.iters.tolist() == [[1, 1]]
    with pytest.raises(ValueError, match="s, N, Ltau"):
        solvers.block_cg(lambda v: v, B[0, 0])


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------

def _pf(key, N, Lt):
    """JAX's packed pseudofermion draw: (R↑ + i·R↓)[None]."""
    r = np.asarray(jax.random.normal(key, (2, N, Lt), dtype=jnp.float64))
    return (r[0] + 1j * r[1])[None]


def twisted_update_against_jax(name):
    """One KPM-preconditioned HMC update on a twisted lattice, 2 chains,
    with the JAX package's draws, through both packages: the port's step,
    its new state and stats, and the JAX runs per chain. ``name``: the
    dense or fold Holstein branch, or SSH."""
    if name == "ssh":
        js, jp, ts, tp, xs = _ssh(Ltau=10, alpha=0.3, alpha2=0.0)
        rng = np.random.default_rng(11)
        x0 = np.stack([xs, np.asarray(JS.tie_fields(js, jnp.asarray(
            xs + 0.1 * rng.standard_normal(xs.shape))))])
        max_order = 8
    else:
        js, jp, ts, tp = _holstein(L=4, beta=1.0, dense_threshold=2048 if name == "dense" else 0)
        rng = np.random.default_rng(11)
        x0 = 0.5 * rng.standard_normal((2, ts.Nph, 1)) + 0.1 * rng.standard_normal(
            (2, ts.Nph, ts.Ltau))
        max_order = 4
    N, Lt, Nph = ts.Nsites, ts.Ltau, ts.Nph
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    v0 = rng.standard_normal((2, Nph, Lt))
    if name == "ssh":
        v0 = np.stack([np.asarray(JS.tie_fields(js, jnp.asarray(v))) for v in v0])
    mass = build_mass(np.asarray(jp.omega), 0.1, Lt, [dict(omega_min=0.0, omega_max=10.0,
                                                          mass=0.5)])
    cfg = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-7, maxiter=500,
               construct_guess=True, guess_order=3)
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg), jkpm.make_symmetric_precond(
        jops, jkpm.KPMConfig(max_order=max_order))))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(2)]
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (Nph, Lt), dtype=jnp.float64)))
        Rpm.append(_pf(k_p, N, Lt))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    draws = HMCDraws(momentum=_T(np.stack(R)), pseudofermion=_T(np.stack(Rpm)),
                     uniform=_T(np.asarray(U)), kpm_start=_jax_start(N))
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg),
                          kpm.make_symmetric_precond(tops, kpm.KPMConfig(max_order=max_order)))
    st, stats = tstep(tp, HMCState(x=_T(x0), v=_T(v0)), draws=draws)
    return tstep, st, stats, runs


@pytest.mark.parametrize("name", ["dense", "fold", "ssh"])
def test_twisted_hmc_update_matches_jax(name):
    """One KPM-preconditioned HMC update on a twisted lattice, 2 chains, with
    the JAX package's draws: x and v within 1e-12, ΔH within 1e-10, equal
    iterations, flags and accept decisions; the update accepts with a small
    |ΔH| (the JAX package's physics check). The port's update is the
    graphed one (its segments, run directly on the CPU)."""
    tstep, st, stats, runs = twisted_update_against_jax(name)
    assert tstep.segmented and tstep.workspace() is not None
    for c, (jst, jstats, _) in enumerate(runs):
        np.testing.assert_allclose(st.x[c].numpy(), np.asarray(jst.x), rtol=0, atol=1e-12)
        np.testing.assert_allclose(st.v[c].numpy(), np.asarray(jst.v), rtol=0, atol=1e-12)
        np.testing.assert_allclose(stats.delta_H[c].item(), float(jstats.delta_H), atol=1e-10)
        assert int(stats.iters[c]) == int(jstats.iters)
        assert bool(stats.accepted[c]) == bool(jstats.accepted)
        assert int(stats.flag[c]) == int(jstats.flag) == 0
    assert not st.x.is_complex() and bool(stats.accepted.all())
    assert float(stats.delta_H.abs().max()) < 0.5


def test_twisted_langevin_step_matches_jax():
    """One Runge-Kutta step on a twisted lattice with JAX's circular complex
    force probes (E[gg†] = I): real x within 1e-10, equal iterations."""
    js, jp, ts, tp = _holstein(L=4, beta=1.0, twist=(0.5, 0.9))
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    N, Lt = ts.Nsites, ts.Ltau
    Q = build_Q(np.asarray(jp.omega), 0.1, Lt, [dict(omega_min=0.0, omega_max=10.0, mass=0.0)])
    x0 = 0.3 * np.random.default_rng(2).standard_normal((2, N, Lt))
    scfg = dict(tol=1e-8, maxiter=4000)
    jstep = jax.jit(j_make_langevin_step(jops, Q, 1e-3, "rk", jsolve.SolverConfig(**scfg)))
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    runs = [jstep(jp, jnp.asarray(x0[c]), keys[c]) for c in range(2)]
    eta, gs = [], [[], []]
    for key in keys:
        key, kn = jax.random.split(key)
        eta.append(np.asarray(jax.random.normal(kn, (N, Lt), dtype=jnp.float64)))
        for g in gs:
            key, kg = jax.random.split(key)
            g.append(np.asarray(jdtypes.trace_noise(kg, jp, (N, Lt), jnp.float64)))
    draws = tl.LangevinDraws(eta=_T(np.stack(eta)), g=tuple(_T(np.stack(g)) for g in gs))
    assert draws.g[0].is_complex()
    tstep = tl.make_langevin_step(tops, Q, 1e-3, "rk", tsolve.SolverConfig(**scfg))
    x1, stats = tstep(tp, _T(x0), draws=draws)
    assert not x1.is_complex() and tstep.segmented and tstep.workspace() is not None
    for c, (jx, jstats, _) in enumerate(runs):
        np.testing.assert_allclose(x1[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)
        assert int(stats.iters[c]) == int(jstats.iters)
        assert int(stats.flag[c]) == int(jstats.flag) == 0


@pytest.mark.parametrize("kind", ["reflect", "swap"])
def test_twisted_special_updates_match_jax(kind):
    """Reflection and swap on a twisted lattice: the exact-S₀ φ refresh packs
    the spins into one complex field; with JAX's draws the moves make the
    same decisions and fields."""
    js, jp, ts, tp = _holstein(L=4, beta=1.0)
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    N, Lt = ts.Nsites, ts.Ltau
    n_moves = 2
    cfg = dict(freq=1, n_moves=n_moves, tol=1e-9, maxiter=4000)
    jmake = jsu.make_reflection_update if kind == "reflect" else jsu.make_swap_update
    tmake = tsu.make_reflection_update if kind == "reflect" else tsu.make_swap_update
    jupd = jax.jit(jmake(jops, jsu.SpecialUpdateConfig(**cfg)))
    x = 0.3 * np.random.default_rng(4).standard_normal((2, N, Lt))
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    jres = [jupd(jp, jnp.asarray(x[c]), keys[c]) for c in range(2)]
    picks, pfs, unis = [], [], []
    for key in keys:
        if kind == "reflect":
            key, ks = jax.random.split(key)
            picks.append(np.asarray(jax.random.randint(ks, (n_moves,), 0, ts.Nph)))
        pf, uni, bonds = [], [], []
        for _ in range(n_moves):
            if kind == "swap":
                key, kb = jax.random.split(key)
                bonds.append(int(jax.random.randint(kb, (), 0, ts.Nbonds)))
            key, kp = jax.random.split(key)
            pf.append(_pf(kp, N, Lt))
            key, ka = jax.random.split(key)
            uni.append(float(jax.random.uniform(ka, dtype=jnp.float64)))
        if kind == "swap":
            picks.append(np.asarray(bonds))
        pfs.append(np.stack(pf))
        unis.append(np.asarray(uni))
    draws = tsu.SpecialDraws(picks=_T(np.stack(picks, axis=1)),
                             pseudofermion=_T(np.stack(pfs, axis=1)),
                             uniform=_T(np.stack(unis, axis=1)))
    tupd = tmake(tops, tsu.SpecialUpdateConfig(**cfg))
    x_new, rate = tupd(tp, _T(x), draws=draws)
    assert not x_new.is_complex() and tupd.segmented and tupd.workspace() is not None
    for c, (jx, jrate, _) in enumerate(jres):
        assert round(rate[c].item() * n_moves) == round(float(jrate) * n_moves)
        np.testing.assert_allclose(x_new[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# SSH
# ---------------------------------------------------------------------------

def test_ssh_twist_zero_keeps_real():
    for tw in (None, (0.0,)):
        _, _, _, tp, _ = _ssh(twist=tw)
        assert tp.t_phase is None and not tdtypes.params_are_complex(tp)
    _, jp, ts, tp, x = _ssh()
    assert tdtypes.params_are_complex(tp) and not tp.t.is_complex()
    np.testing.assert_allclose(tp.t_phase.numpy(), np.asarray(jp.t_phase), atol=1e-15)
    d = TS.ckb_coeffs(ts, tp, _T(x[None]))
    assert d.cosh.dtype == d.sinh.dtype == torch.complex128


def test_ssh_complex_mulM_and_adjoint_match_dense():
    js, jp, ts, tp, x = _ssh()
    coeffs = TS.ckb_coeffs(ts, tp, _T(x[None]))
    jcoeffs = JS.ckb_coeffs(js, jp, jnp.asarray(x))
    np.testing.assert_allclose(coeffs.sinh[0].numpy(), np.asarray(jcoeffs.sinh), atol=1e-15)
    cB, sB = coeffs.cosh[0].numpy(), coeffs.sinh[0].numpy()
    emu = np.exp(ts.dtau * tp.mu.numpy())
    M = dense_M([dense_expK(ts.Nsites, ts.ckb.neighbor_table, ts.ckb.groups, cB[:, t], sB[:, t])
                 @ np.diag(emu) for t in range(ts.Ltau)])
    assert np.abs(M.imag).max() > 1e-3
    v = _cnormal(np.random.default_rng(7), (ts.Nsites, ts.Ltau))
    for name, want, tol in (("mulM", M @ v.reshape(-1), 1e-12),
                            ("mulMT", M.conj().T @ v.reshape(-1), 1e-12),
                            ("mulMTM", M.conj().T @ (M @ v.reshape(-1)), 1e-11)):
        got = getattr(TS, name)(ts, tp, coeffs, _T(v[None]))[0].numpy()
        np.testing.assert_allclose(got.reshape(-1), want, atol=tol)
        np.testing.assert_allclose(got, np.asarray(getattr(JS, name)(js, jp, jcoeffs,
                                                                      jnp.asarray(v))),
                                   atol=1e-12)
    # the per-τ densifier takes the conj(s) convention (the JAX package's
    # dense_K does not, and never runs on complex tables)
    Kd = TS.dense_K(ts, coeffs.cosh[0], coeffs.sinh[0]).numpy()
    for t in (0, ts.Ltau - 1):
        np.testing.assert_allclose(Kd[t], dense_expK(ts.Nsites, ts.ckb.neighbor_table,
                                                     ts.ckb.groups, cB[:, t], sB[:, t]),
                                   atol=1e-13)


def test_ssh_complex_muldMdx_matches_autodiff_and_jax():
    """d/dx Re(u†·M(x)·v) by torch autograd (α₂ = 0) equals the group-walk
    force, which equals the JAX package's."""
    js, jp, ts, tp, x = _ssh(alpha2=0.0)
    rng = np.random.default_rng(10)
    u, v = _cnormal(rng, (ts.Nsites, ts.Ltau)), _cnormal(rng, (ts.Nsites, ts.Ltau))
    tx = _T(x[None])
    coeffs = TS.ckb_coeffs(ts, tp, tx)
    got = TS.muldMdx(ts, tp, coeffs, tx, _T(u[None]), _T(v[None]))
    assert not got.is_complex()
    xr = tx.clone().requires_grad_(True)
    f = (_T(u[None]).conj() * TS.mulM(ts, tp, TS.ckb_coeffs(ts, tp, xr), _T(v[None]))).sum().real
    (grad,) = torch.autograd.grad(f, xr)
    np.testing.assert_allclose(got.numpy(), grad.numpy(), atol=1e-10)
    want = JS.muldMdx(js, jp, JS.ckb_coeffs(js, jp, jnp.asarray(x)), jnp.asarray(x),
                      jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-13)


# ---------------------------------------------------------------------------
# noise, inner products, parameter transfer, the configuration
# ---------------------------------------------------------------------------

def test_complex_fdot_and_noise():
    rng = np.random.default_rng(0)
    a, b = _cnormal(rng, (3, 4, 5)), _cnormal(rng, (3, 4, 5))
    np.testing.assert_allclose(tdtypes.fdot(_T(a), _T(b)).numpy(),
                               np.asarray(jdtypes.fdot(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-14)
    np.testing.assert_allclose(tdtypes.fdot(_T(a), _T(b.real)).numpy(),
                               (a.real * b.real).sum(axis=(-2, -1)), rtol=1e-14)
    g = torch.Generator().manual_seed(3)
    pf = tdtypes.pseudofermion_noise((2, 4, 5), torch.complex128, "cpu", g)
    assert pf.shape == (2, 1, 4, 5) and pf.dtype == torch.complex128
    g = torch.Generator().manual_seed(3)
    real = tdtypes.pseudofermion_noise((2, 4, 5), torch.float64, "cpu", g)
    torch.testing.assert_close(pf, torch.complex(real[:, :1], real[:, 1:]), rtol=0, atol=0)
    t = tdtypes.trace_noise((20000,), torch.complex64, "cpu", torch.Generator().manual_seed(1))
    assert t.dtype == torch.complex64 and abs(t.abs().pow(2).mean().item() - 1.0) < 0.03
    assert abs(t.pow(2).mean().item()) < 0.03            # circular: E[g²] = 0
    assert tdtypes.field_dtype(_holstein()[3], torch.float32) == torch.complex64


@pytest.mark.parametrize("model", ["holstein", "ssh"])
def test_params_from_jax_carries_complex_hopping(model):
    if model == "ssh":
        js, jp, ts, tp, _ = _ssh()
        names = [f for f in TS.SSHParams.__dataclass_fields__]
    else:
        js, jp, ts, tp = _holstein()
        names = [f for f in TH.HolsteinParams.__dataclass_fields__]
    np_params = {f: (None if getattr(jp, f) is None else np.asarray(getattr(jp, f)))
                 for f in names}
    conv = convert.params_from_jax(np_params, "cpu")
    assert tdtypes.params_are_complex(conv)
    for f in names:
        if getattr(tp, f) is not None:
            torch.testing.assert_close(getattr(conv, f), getattr(tp, f), rtol=0, atol=1e-15)
    c32 = convert.params_from_jax(np_params, "cpu", torch.float32)
    cplx = "t_phase" if model == "ssh" else "sinht"
    assert getattr(c32, cplx).dtype == torch.complex64 and c32.mu.dtype == torch.float32
    back = convert.params_to_numpy(conv)
    assert np.iscomplexobj(back[cplx])
