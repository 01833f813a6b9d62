"""The optical SSH model of the PyTorch port against the JAX package,
float64 on the CPU.

Two models, both with disorder on every parameter: a 4×4 square lattice
with bond types x and y, and a 3×3 one whose two bond types share one
phonon name (aliased fields). Per chain, the port's chain-batched results
are compared with the JAX package's single-chain ones:

* ``build_ssh`` (parameters and bond bookkeeping from one numpy seed),
  ``ckb_coeffs``, the fermion operators, ``muldMdx``, the phonon action and
  its gradient, ``tie_fields``: 1e-12 relative to the largest value;
* ``muldMdx`` against torch autograd, and the cases of tests/test_ssh.py
  against dense matrices;
* the KPM preconditioner (setup, refresh, apply) on the dense branch and,
  with the dense-Ā gate closed in both packages, on the fold branch with
  per-chain tables: 1e-11;
* one HMC update with JAX's draws injected: ΔH to 1e-9, x and v to 1e-10,
  equal accept decisions, flags and CG iterations;
* the swap update with JAX's draws: equal accept counts, fields to 1e-10;
* the initial phonons and ``convert.params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense_reference import dense_expK, dense_M
from elphdynamics_tpu.dynamics import init_phonons as jinit
from elphdynamics_tpu.dynamics import special_updates as jsu
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch import bench, convert
from elphdynamics_tpu_torch.dynamics import init_phonons as tinit
from elphdynamics_tpu_torch.dynamics import special_updates as tsu
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCDraws, HMCState, make_hmc_step
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import ckb_cuda
from elphdynamics_tpu_torch.ops import kpm

torch.set_num_threads(1)

C = 2
BETA, DTAU = 1.0, 0.1
UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
HOP = dict(t=1.0, t_std=0.1, alpha=0.3, alpha_std=0.05, alpha2=0.1, alpha2_std=0.02,
           omega=1.0, omega_std=0.1, omega4=0.05, o1=0, o2=0)
MODELS = {
    "4x4": (4, [dict(HOP, dL=(1, 0, 0), name="x"), dict(HOP, dL=(0, 1, 0), name="y")]),
    "3x3_alias": (3, [dict(HOP, dL=(1, 0, 0), name="shared"),
                      dict(HOP, dL=(0, 1, 0), name="shared")]),
}
MU = [(-0.2, 0.1, None)]


def T(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _build(L, hoppings, seed=3):
    js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*UC), L), BETA, DTAU,
                          hoppings=hoppings, mu_assignments=MU, rng=np.random.default_rng(seed))
    ts, tp = TS.build_ssh(Lattice.create(UnitCell.create(*UC), L), BETA, DTAU,
                          hoppings=hoppings, mu_assignments=MU, rng=np.random.default_rng(seed),
                          device="cpu")
    return js, jp, ts, tp


@pytest.fixture(scope="module", params=list(MODELS), ids=list(MODELS))
def model(request):
    L, hoppings = MODELS[request.param]
    js, jp, ts, tp = _build(L, hoppings)
    rng = np.random.default_rng(5)
    x = TS.tie_fields(ts, T(0.3 * rng.standard_normal((C, ts.Nph, ts.Ltau)) + 0.1)).numpy()
    return js, jp, ts, tp, x


def test_build_ssh_matches_jax(model):
    js, jp, ts, tp, _ = model
    for f in ("mu", "t", "omega", "omega4", "alpha", "alpha2"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), f)
    assert tp.t_phase is None and jp.t_phase is None
    for f in ("ckb_to_bond", "bond_to_ckb", "bond_to_phonon", "phonon_to_bond",
              "primary_phonon", "bond_to_definition"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), f)
    for f in ("partner", "bond_of_site", "mask", "neighbor_table", "groups"):
        np.testing.assert_array_equal(getattr(ts.ckb, f), getattr(js.ckb, f), f)
    assert ts.bond_defs == js.bond_defs
    assert (ts.Nsites, ts.Nbonds, ts.Nph, ts.Ltau) == (js.Nsites, js.Nbonds, js.Nph, js.Ltau)
    assert not js.dense_ckb      # the port has no dense per-τ mode


def _port_op(name, ts, tp, x, u, v):
    d = TS.ckb_coeffs(ts, tp, T(x))
    return {
        "cosh": lambda: d.cosh, "sinh": lambda: d.sinh,
        "t_prime": lambda: TS.hopping_t_prime(ts, tp, T(x)),
        "mulM": lambda: TS.mulM(ts, tp, d, T(v)),
        "mulMT": lambda: TS.mulMT(ts, tp, d, T(v)),
        "mulMTM": lambda: TS.mulMTM(ts, tp, d, T(v)),
        "mulMMT": lambda: TS.mulMMT(ts, tp, d, T(v)),
        "muldMdx": lambda: TS.muldMdx(ts, tp, d, T(x)[:, None], T(u), T(v)),
        "calc_Sb": lambda: TS.calc_Sb(ts, tp, T(x)),
        "calc_dSbdx": lambda: TS.calc_dSbdx(ts, tp, T(x)),
        "tie_fields": lambda: TS.tie_fields(ts, T(u).flatten(1, 2)),
    }[name]().numpy()


def _jax_op(name, js, jp, x, u, v):
    d = JS.ckb_coeffs(js, jp, jnp.asarray(x))
    return {
        "cosh": lambda: d.cosh, "sinh": lambda: d.sinh,
        "t_prime": lambda: JS.hopping_t_prime(js, jp, jnp.asarray(x)),
        "mulM": lambda: JS.mulM(js, jp, d, v),
        "mulMT": lambda: JS.mulMT(js, jp, d, v),
        "mulMTM": lambda: JS.mulMTM(js, jp, d, v),
        "mulMMT": lambda: JS.mulMMT(js, jp, d, v),
        "muldMdx": lambda: JS.muldMdx(js, jp, d, x, u, v),
        "calc_Sb": lambda: JS.calc_Sb(js, jp, x),
        "calc_dSbdx": lambda: JS.calc_dSbdx(js, jp, x),
        "tie_fields": lambda: JS.tie_fields(js, jnp.asarray(u.reshape(js.Nph, -1))),
    }[name]()


OPS = ["cosh", "sinh", "t_prime", "mulM", "mulMT", "mulMTM", "mulMMT", "muldMdx", "calc_Sb",
       "calc_dSbdx", "tie_fields"]


@pytest.mark.parametrize("name", OPS)
def test_operator_matches_jax(model, name):
    """Chain-batched operators (spin-stacked [C, 2, N, Lτ] fields, one
    [C, Nb, Lτ] table pair) against JAX chain by chain."""
    js, jp, ts, tp, x = model
    rng = np.random.default_rng(7)
    u, v = (rng.standard_normal((C, 2, ts.Nsites, ts.Ltau)) for _ in range(2))
    got = _port_op(name, ts, tp, x, u, v)
    for c in range(C):
        _close(got[c], _jax_op(name, js, jp, x[c], u[c], v[c]))


def test_adapter_and_derived_state(model):
    """The SSH ModelOps: no Λ shift, tied noise, and a derived state that
    acts on spin stacks as it is (the fold maps a chain's table to its
    rows)."""
    _, _, ts, tp, x = model
    ops = make_model_ops(ts)
    assert not ops.is_holstein and ops.calc_Lambda is None and ops.Nph == ts.Nph
    d = ops.derived(tp, T(x))
    assert ops.stack(d) is d and tuple(d.cosh.shape) == (C, ts.Nbonds, ts.Ltau)
    v = T(np.random.default_rng(8).standard_normal((C, 2, ts.Nsites, ts.Ltau)))
    torch.testing.assert_close(ops.mulMTM(tp, d, v), TS.mulMTM(ts, tp, d, v), rtol=0, atol=0)
    before = ckb_cuda.launches
    ops.mulM(tp, d, v)
    assert ckb_cuda.launches == before      # a CPU field takes the plain twin


def test_dense_K_matches_jax(model):
    js, jp, ts, tp, x = model
    d = TS.ckb_coeffs(ts, tp, T(x))
    jd = JS.ckb_coeffs(js, jp, jnp.asarray(x[1]))
    _close(TS.dense_K(ts, d.cosh[1], d.sinh[1]).numpy(), JS.dense_K(js, jd.cosh, jd.sinh))


def test_muldMdx_matches_autograd():
    """Without the quadratic coupling (whose reference derivative α + 2α₂x
    drops sign(x)) and without aliases, muldMdx is the gradient of
    Σ uᵀM(x)v."""
    _, _, ts, tp = _build(4, [dict(HOP, alpha2=0.0, alpha2_std=0.0, dL=(1, 0, 0), name="x"),
                              dict(HOP, alpha2=0.0, alpha2_std=0.0, dL=(0, 1, 0), name="y")])
    rng = np.random.default_rng(9)
    x = T(0.3 * rng.standard_normal((C, ts.Nph, ts.Ltau)))
    u, v = (T(rng.standard_normal((C, ts.Nsites, ts.Ltau))) for _ in range(2))
    xg = x.clone().requires_grad_()
    (u * TS.mulM(ts, tp, TS.ckb_coeffs(ts, tp, xg), v)).sum().backward()
    got = TS.muldMdx(ts, tp, TS.ckb_coeffs(ts, tp, x), x, u, v)
    _close(got.numpy(), xg.grad.numpy(), 1e-11)


# --- the cases of tests/test_ssh.py, through the port -------------------------

def _chain_model(alpha2=0.1, L=4, Ltau=4):
    """tests/test_ssh.py's 1D chain: one bond type, μ = −0.3, one chain."""
    spec, params = TS.build_ssh(
        Lattice.create(UnitCell.create(1, 1, [[1.0]], [[0.0]]), L), Ltau * 0.1, 0.1,
        hoppings=[dict(t=1.0, omega=1.0, alpha=0.4, alpha2=alpha2, o1=0, o2=0, dL=(1, 0, 0),
                       name="ph")],
        mu_assignments=[(-0.3, 0.0, None)], rng=np.random.default_rng(0), device="cpu")
    x = TS.tie_fields(spec, T(0.3 * np.random.default_rng(1).standard_normal(
        (1, spec.Nph, spec.Ltau))))
    return spec, params, x


def _dense_model_M(spec, params, x):
    d = TS.ckb_coeffs(spec, params, x)
    cB, sB = d.cosh[0].numpy(), d.sinh[0].numpy()
    emu = TS.exp_mu(spec, params)[:, 0].numpy()
    return dense_M([dense_expK(spec.Nsites, spec.ckb.neighbor_table, spec.ckb.groups,
                               cB[:, tau], sB[:, tau]) @ np.diag(emu)
                    for tau in range(spec.Ltau)])


@pytest.mark.parametrize("transpose", [False, True], ids=["mulM", "mulMT"])
def test_mulM_matches_dense(transpose):
    spec, params, x = _chain_model()
    M = _dense_model_M(spec, params, x)
    v = np.random.default_rng(7).standard_normal((1, spec.Nsites, spec.Ltau))
    fn = TS.mulMT if transpose else TS.mulM
    got = fn(spec, params, TS.ckb_coeffs(spec, params, x), T(v)).numpy().reshape(-1)
    np.testing.assert_allclose(got, (M.T if transpose else M) @ v.reshape(-1), atol=1e-12)


def test_chain_muldMdx_autodiff():
    spec, params, x = _chain_model(alpha2=0.0)
    rng = np.random.default_rng(10)
    u, v = (T(rng.standard_normal((1, spec.Nsites, spec.Ltau))) for _ in range(2))
    xg = x.clone().requires_grad_()
    (u * TS.mulM(spec, params, TS.ckb_coeffs(spec, params, xg), v)).sum().backward()
    got = TS.muldMdx(spec, params, TS.ckb_coeffs(spec, params, x), x, u, v)
    np.testing.assert_allclose(got.numpy(), xg.grad.numpy(), atol=1e-10)


def test_muldMdx_matches_reference_formula_quadratic():
    """With α₂ ≠ 0: the chain rule through t′ with the reference's
    d(t′)/dx = −(α + 2α₂x), then the primary tying."""
    spec, params, x = _chain_model(alpha2=0.2)
    rng = np.random.default_rng(11)
    u, v = (T(rng.standard_normal((1, spec.Nsites, spec.Ltau))) for _ in range(2))
    got = TS.muldMdx(spec, params, TS.ckb_coeffs(spec, params, x), x, u, v)[0].numpy()
    tp = TS.hopping_t_prime(spec, params, x).clone().requires_grad_()
    arg = spec.dtau * tp.index_select(-2, torch.as_tensor(spec.ckb_to_bond))
    (u * TS.mulM(spec, params, TS.SSHDerived(torch.cosh(arg), torch.sinh(arg)), v)).sum().backward()
    btp = np.maximum(spec.bond_to_phonon, 0)
    dtpdx = -(params.alpha.numpy()[btp][:, None]
              + 2 * params.alpha2.numpy()[btp][:, None] * x[0].numpy()[btp])
    contrib = np.where((spec.bond_to_phonon >= 0)[:, None], tp.grad[0].numpy() * dtpdx, 0.0)
    want = np.zeros((spec.Nph, spec.Ltau))
    for b in range(spec.Nbonds):
        if spec.bond_to_phonon[b] >= 0:
            want[spec.bond_to_phonon[b]] += contrib[b]
    tied = np.zeros_like(want)
    np.add.at(tied, spec.primary_phonon, want)
    np.testing.assert_allclose(got, tied[spec.primary_phonon], atol=1e-10)


def test_Sb_gradient():
    spec, params, x = _chain_model()
    assert np.all(spec.primary_phonon == np.arange(spec.Nph))
    xg = x.clone().requires_grad_()
    TS.calc_Sb(spec, params, xg).sum().backward()
    np.testing.assert_allclose(TS.calc_dSbdx(spec, params, x).numpy(), xg.grad.numpy(),
                               atol=1e-11)


def test_primary_field_tying():
    """Two same-named hopping definitions alias their phonons."""
    h = dict(t=1.0, omega=1.0, alpha=0.3, name="shared")
    spec, _ = TS.build_ssh(
        Lattice.create(UnitCell.create(1, 2, [[1.0]], [[0.0], [0.5]]), 3), 0.4, 0.1,
        hoppings=[dict(h, o1=0, o2=1, dL=(0, 0, 0)), dict(h, o1=1, o2=0, dL=(1, 0, 0))],
        mu_assignments=[(0.0, 0.0, None)], device="cpu")
    assert spec.Nph == 6
    np.testing.assert_array_equal(spec.primary_phonon, [0, 1, 2, 0, 1, 2])
    xt = TS.tie_fields(spec, T(np.random.default_rng(1).standard_normal((1, 6, spec.Ltau))))
    torch.testing.assert_close(xt[:, 3:], xt[:, :3])


def test_twisted_ssh_refused():
    """Twisted SSH, refused until complex hopping was ported, now builds the
    JAX package's complex Peierls phases (t stays real)."""
    kw = dict(hoppings=[dict(HOP, dL=(1, 0, 0))], twist=(0.3, 0.0))
    _, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*UC), 2), 1.0, 0.1, **kw)
    _, tp = TS.build_ssh(Lattice.create(UnitCell.create(*UC), 2), 1.0, 0.1, device="cpu", **kw)
    assert tp.t_phase.dtype == torch.complex128 and not tp.t.is_complex()
    np.testing.assert_allclose(tp.t_phase.numpy(), np.asarray(jp.t_phase), rtol=0, atol=1e-15)


def test_params_from_jax(model):
    js, jp, ts, tp, x = model
    names = [f.name for f in dataclasses.fields(TS.SSHParams)]
    np_params = {f: (None if getattr(jp, f) is None else np.asarray(getattr(jp, f)))
                 for f in names}
    conv = convert.params_from_jax(np_params, "cpu")
    assert isinstance(conv, TS.SSHParams) and conv.t_phase is None
    for f in names[:-1]:
        torch.testing.assert_close(getattr(conv, f), getattr(tp, f), rtol=0, atol=0)
    back = convert.params_to_numpy(conv)
    for f in names[:-1]:
        np.testing.assert_array_equal(back[f], np_params[f])
    phases = np.exp(0.3j * np.arange(ts.Nbonds))    # twisted SSH's t_phase
    conv = convert.params_from_jax({**np_params, "t_phase": phases}, "cpu")
    np.testing.assert_array_equal(conv.t_phase.numpy(), phases)


def test_init_phonons_matches_jax(model):
    js, jp, ts, tp, _ = model
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    want, normals = [], []
    for key in keys:
        want.append(np.asarray(jinit.init_phonons_half_filled(jops, jp, key)[0]))
        _, k1, _ = jax.random.split(key, 3)
        normals.append(np.asarray(jax.random.normal(k1, (jops.Nph,), dtype=jnp.float64)))
    got = tinit.init_phonons_half_filled(tops, tp, C, draws=(T(np.stack(normals)), None))
    _close(got.numpy(), np.stack(want), 1e-14)
    drawn = tinit.init_phonons_half_filled(tops, tp, C, torch.Generator().manual_seed(0))
    torch.testing.assert_close(TS.tie_fields(ts, drawn), drawn, rtol=0, atol=0)


# --- the KPM preconditioner ----------------------------------------------------

KPM_KW = dict(max_order=8)


def _start(N):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return tuple(T(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64))) for k in (k1, k2))


@pytest.fixture(params=["dense", "fold"])
def branch(request, monkeypatch):
    """The dense Ā (default at these sizes) or, with the dense gate closed in
    both packages, the fold with per-chain tables."""
    if request.param == "fold":
        monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
        monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    return request.param


def test_kpm_matches_jax(model, branch):
    js, jp, ts, tp, x = model
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    key = jax.random.PRNGKey(0)
    jst = [jkpm.setup(jops, jp, jnp.asarray(x[c]), jkpm.KPMConfig(**KPM_KW), key)
           for c in range(C)]
    tst = kpm.setup(tops, tp, T(x), kpm.KPMConfig(**KPM_KW), _start(ts.Nsites))
    assert tuple(tst.cosh_bar.shape) == (C, ts.Nbonds)
    assert (tst.expK is None) == (branch == "fold")
    x2 = TS.tie_fields(ts, T(x + 0.05 * np.random.default_rng(6).standard_normal(x.shape)))
    tref = kpm.refresh(tops, tst, tp, x2)
    v = np.random.default_rng(12).standard_normal((C, 2, ts.Nsites, ts.Ltau))
    got = kpm.apply_symmetric(tops, tst, T(v), kpm.KPMConfig(**KPM_KW)).numpy()
    got_ref = kpm.apply_symmetric(tops, tref, T(v), kpm.KPMConfig(**KPM_KW)).numpy()
    for c in range(C):
        for f in ("lam_avg", "lam_mag"):
            _close(getattr(tst, f)[c].item(), getattr(jst[c], f))
        _close(tst.coeff[c].numpy(), jst[c].coeff, 1e-11)
        assert bool(tst.active[c]) == bool(jst[c].active)
        for f in ("expnV_bar", "cosh_bar", "sinh_bar"):
            _close(getattr(tst, f)[c].numpy(), getattr(jst[c], f))
        if branch == "dense":
            _close(tst.expK[c].numpy(), jst[c].expK)
            _close(tst.expK_inv[c].numpy(), jst[c].expK_inv)
        want = jkpm.apply_symmetric(jops, jst[c], jnp.asarray(v[c]), jkpm.KPMConfig(**KPM_KW))
        _close(got[c], want, 1e-11)
        jref = jkpm.refresh(jops, jst[c], jp, jnp.asarray(x2[c].numpy()))
        if branch == "dense":
            _close(tref.expK[c].numpy(), jref.expK)
        want = jkpm.apply_symmetric(jops, jref, jnp.asarray(v[c]), jkpm.KPMConfig(**KPM_KW))
        _close(got_ref[c], want, 1e-11)


# --- one HMC update, the swap update -----------------------------------------

HMC_KW = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-5, maxiter=500,
              construct_guess=True, guess_order=3)


def _mass(ts, tp):
    return build_mass(tp.omega.numpy(), ts.dtau, ts.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])


def _jax_draws(keys, Nph, N, Ltau):
    """The draws of the JAX update from each chain key (momenta untied: both
    steps tie them), and the KPM start vectors of its preconditioner."""
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


def test_hmc_update_matches_jax(model, branch):
    js, jp, ts, tp, x0 = model
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    mass = _mass(ts, tp)
    v0 = TS.tie_fields(ts, T(np.random.default_rng(13).standard_normal(x0.shape))).numpy()
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**HMC_KW),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM_KW))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(C)]
    jstate = jax.tree.map(lambda *a: np.stack(a), *[r[0] for r in runs])
    jstats = jax.tree.map(lambda *a: np.stack(a), *[r[1] for r in runs])
    tstep = make_hmc_step(tops, mass, HMCConfig(**HMC_KW),
                          kpm.make_symmetric_precond(tops, kpm.KPMConfig(**KPM_KW)))
    tstate, tstats = tstep(tp, HMCState(x=T(x0), v=T(v0)),
                           draws=_jax_draws(keys, ts.Nph, ts.Nsites, ts.Ltau))
    np.testing.assert_allclose(tstats.delta_H.numpy(), jstats.delta_H, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tstats.accepted.numpy(), jstats.accepted)
    np.testing.assert_array_equal(tstats.flag.numpy(), jstats.flag)
    np.testing.assert_array_equal(tstats.iters.numpy(), jstats.iters)
    np.testing.assert_allclose(tstate.x.numpy(), jstate.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tstate.v.numpy(), jstate.v, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tstats.H.numpy(), jstats.H, rtol=1e-12)
    assert np.all(jstats.flag == 0)


def _swap_draws(key, n_moves, Nph, N, Lt):
    """The draws of the JAX SSH swap update from ``key``: per move a pair of
    distinct phonons, the pseudofermions and the accept uniform."""
    picks, pf, uni = [], [], []
    for _ in range(n_moves):
        key, k1, k2 = jax.random.split(key, 3)
        i = int(jax.random.randint(k1, (), 0, Nph))
        j = int(jax.random.randint(k2, (), 0, Nph - 1))
        picks.append((i, j + 1 if j >= i else j))
        key, kp = jax.random.split(key)
        pf.append(np.asarray(jax.random.normal(kp, (2, N, Lt), dtype=jnp.float64)))
        key, ka = jax.random.split(key)
        uni.append(float(jax.random.uniform(ka, dtype=jnp.float64)))
    return np.asarray(picks), np.stack(pf), np.asarray(uni)


def test_swap_update_matches_jax(model):
    js, jp, ts, tp, x = model
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    n_moves = 4
    cfg = dict(freq=1, n_moves=n_moves, tol=1e-5, maxiter=2000)
    jprec = jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM_KW))
    jupd = jax.jit(jsu.make_swap_update(jops, jsu.SpecialUpdateConfig(**cfg), jprec))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    jres = [jupd(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    per_chain = [_swap_draws(keys[c], n_moves, ts.Nph, ts.Nsites, ts.Ltau) for c in range(C)]
    draws = tsu.SpecialDraws(*(T(np.stack([d[k] for d in per_chain], axis=1)) for k in range(3)))
    start = _jax_draws(keys, ts.Nph, ts.Nsites, ts.Ltau).kpm_start
    cfg_k = kpm.KPMConfig(**KPM_KW)
    tprec = kpm.Preconditioner(
        setup=lambda params, x_, start_=None: kpm.setup(tops, params, x_, cfg_k, start),
        refresh=lambda st, params, x_: kpm.refresh(tops, st, params, x_),
        symmetric=lambda st, v: kpm.apply_symmetric(tops, st, v, cfg_k))
    x_new, rate = tsu.make_swap_update(tops, tsu.SpecialUpdateConfig(**cfg), tprec)(
        tp, T(x), draws=draws)
    for c in range(C):
        jx, jrate, _ = jres[c]
        # JAX's rate is a float32 quotient of the accept count
        assert round(rate[c].item() * n_moves) == round(float(jrate) * n_moves)
        np.testing.assert_allclose(x_new[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    # the generator's own draws: distinct pairs, a finite rate
    _, rate = tsu.make_swap_update(tops, tsu.SpecialUpdateConfig(**cfg), tprec)(
        tp, T(x), torch.Generator().manual_seed(1))
    assert torch.isfinite(rate).all()


def test_reflection_is_a_null_move(model):
    _, _, ts, tp, x = model
    upd = tsu.make_reflection_update(make_model_ops(ts), tsu.SpecialUpdateConfig(n_moves=3))
    x_new, rate = upd(tp, T(x), torch.Generator().manual_seed(0))
    assert torch.equal(x_new, T(x)) and torch.equal(rate, torch.zeros(C, dtype=torch.float64))


def test_bench_ssh_step_on_cpu():
    """The SSH bench step at 4×4 on the CPU: one update, finite, tied."""
    assert bench.SSH_64X64.model == "ssh" and bench.SSH_64X64.L == 64
    b = bench.build_ssh_step(4, 1.0, 0.1, 0.05, 2, "cpu", torch.float64, trajectory_time=0.2)
    state, stats = b.step(b.params, b.state, b.generator)
    assert tuple(state.x.shape) == (2, 32, 10) and torch.isfinite(state.x).all()
    assert torch.isfinite(stats.delta_H).all() and int(stats.flag.max()) == 0
    torch.testing.assert_close(TS.tie_fields(b.ops.spec, state.x), state.x, rtol=0, atol=0)
