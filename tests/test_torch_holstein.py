"""The Holstein operators of the PyTorch port against the JAX package, on
the dense branch and on the fold branch (``dense_threshold=0``), float64 on
the CPU, rtol 1e-12; the force against autograd; parameter conversion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models import holstein as JH
from elphdynamics_tpu_torch import convert
from elphdynamics_tpu_torch.lattice import Lattice as TLattice
from elphdynamics_tpu_torch.lattice import UnitCell as TUnitCell
from elphdynamics_tpu_torch.models import holstein as TH
from elphdynamics_tpu_torch.models.adapter import make_model_ops

torch.set_num_threads(1)

RTOL = 1e-12
BRANCHES = {"dense": 2048, "fold": 0}
PARAM_FIELDS = ("mu", "omega", "omega4", "lam", "lam2", "cosht", "sinht", "wij", "t",
                "expK", "expK_inv")


def _models(dense_threshold, L=4, beta=1.0):
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (0.9, 0.1, 0, 0, (0, 1, 0))],
              mu=-0.2, mu_std=0.1, omega=1.1, omega_std=0.1, lam=0.8, lam_std=0.1,
              lam2=0.05, omega4=0.02,
              wij_assignments=[(0.3, 0.05, 1, 0, 0, (1, 0, 0))],
              dense_threshold=dense_threshold)
    uc_args = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    js, jp = JH.build_holstein(JLattice.create(JUnitCell.create(*uc_args), L), beta, 0.1,
                               rng=np.random.default_rng(9), **kw)
    ts, tp = TH.build_holstein(TLattice.create(TUnitCell.create(*uc_args), L), beta, 0.1,
                               rng=np.random.default_rng(9), device="cpu", **kw)
    return js, jp, ts, tp


@pytest.fixture(scope="module", params=list(BRANCHES), ids=list(BRANCHES))
def models(request):
    js, jp, ts, tp = _models(BRANCHES[request.param])
    assert ts.dense_ckb == (request.param == "dense")
    rng = np.random.default_rng(13)
    shape = (2, ts.Nsites, ts.Ltau)
    fields = dict(x=0.4 * rng.standard_normal(shape), u=rng.standard_normal(shape),
                  v=rng.standard_normal(shape))
    return js, jp, ts, tp, fields


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(a)


# operator name -> (jax call, port call) on (spec, params, fields)
OPERATORS = {
    "expnV": (lambda s, p, f: JH.expnV(s, p, _j(f["x"])),
              lambda s, p, f: TH.expnV(s, p, _t(f["x"]))),
    "apply_expK": (lambda s, p, f: JH.apply_expK(s, p, _j(f["v"])),
                   lambda s, p, f: TH.apply_expK(s, p, _t(f["v"]))),
    "apply_expK_T": (lambda s, p, f: JH.apply_expK_T(s, p, _j(f["v"])),
                     lambda s, p, f: TH.apply_expK_T(s, p, _t(f["v"]))),
    "mulM": (lambda s, p, f: JH.mulM(s, p, JH.expnV(s, p, _j(f["x"])), _j(f["v"])),
             lambda s, p, f: TH.mulM(s, p, TH.expnV(s, p, _t(f["x"])), _t(f["v"]))),
    "mulMT": (lambda s, p, f: JH.mulMT(s, p, JH.expnV(s, p, _j(f["x"])), _j(f["v"])),
              lambda s, p, f: TH.mulMT(s, p, TH.expnV(s, p, _t(f["x"])), _t(f["v"]))),
    "mulMTM": (lambda s, p, f: JH.mulMTM(s, p, JH.expnV(s, p, _j(f["x"])), _j(f["v"])),
               lambda s, p, f: TH.mulMTM(s, p, TH.expnV(s, p, _t(f["x"])), _t(f["v"]))),
    "muldMdx": (lambda s, p, f: JH.muldMdx(s, p, JH.expnV(s, p, _j(f["x"])), _j(f["x"]),
                                           _j(f["u"]), _j(f["v"])),
                lambda s, p, f: TH.muldMdx(s, p, TH.expnV(s, p, _t(f["x"])), _t(f["x"]),
                                           _t(f["u"]), _t(f["v"]))),
    "calc_Sb": (lambda s, p, f: JH.calc_Sb(s, p, _j(f["x"])),
                lambda s, p, f: TH.calc_Sb(s, p, _t(f["x"]))),
    "calc_Sb_shifted": (lambda s, p, f: JH.calc_Sb(s, p, _j(f["x"]), True),
                        lambda s, p, f: TH.calc_Sb(s, p, _t(f["x"]), True)),
    "calc_dSbdx": (lambda s, p, f: JH.calc_dSbdx(s, p, _j(f["x"])),
                   lambda s, p, f: TH.calc_dSbdx(s, p, _t(f["x"]))),
    "calc_dSbdx_shifted": (lambda s, p, f: JH.calc_dSbdx(s, p, _j(f["x"]), True),
                           lambda s, p, f: TH.calc_dSbdx(s, p, _t(f["x"]), True)),
    "calc_Lambda": (lambda s, p, f: JH.calc_Lambda(s, p, _j(f["x"])),
                    lambda s, p, f: TH.calc_Lambda(s, p, _t(f["x"]))),
    "mulLambda": (lambda s, p, f: JH.mulLambda(s, JH.calc_Lambda(s, p, _j(f["x"])), _j(f["v"])),
                  lambda s, p, f: TH.mulLambda(s, TH.calc_Lambda(s, p, _t(f["x"])), _t(f["v"]))),
    "mulLambdaInv": (lambda s, p, f: JH.mulLambdaInv(s, JH.calc_Lambda(s, p, _j(f["x"])),
                                                     _j(f["v"])),
                     lambda s, p, f: TH.mulLambdaInv(s, TH.calc_Lambda(s, p, _t(f["x"])),
                                                     _t(f["v"]))),
    "muldLambdadx": (lambda s, p, f: JH.muldLambdadx(s, p, _j(f["x"]),
                                                     JH.calc_Lambda(s, p, _j(f["x"])),
                                                     _j(f["u"]), _j(f["v"])),
                     lambda s, p, f: TH.muldLambdadx(s, p, _t(f["x"]),
                                                     TH.calc_Lambda(s, p, _t(f["x"])),
                                                     _t(f["u"]), _t(f["v"]))),
}


@pytest.mark.parametrize("op", list(OPERATORS))
def test_operator_matches_jax(models, op):
    js, jp, ts, tp, fields = models
    jfn, tfn = OPERATORS[op]
    want = np.asarray(jfn(js, jp, fields))
    got = tfn(ts, tp, fields).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_params_equal(models):
    _, jp, ts, tp, _ = models
    for f in PARAM_FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14, atol=1e-14,
                                       err_msg=f)
    np.testing.assert_array_equal(ts.wij_table, _models(0)[0].wij_table)


def test_adapter_matches_model_functions(models):
    _, _, ts, tp, fields = models
    ops = make_model_ops(ts)
    x, v = _t(fields["x"]), _t(fields["v"])
    env = ops.derived(tp, x)
    assert torch.equal(ops.mulMTM(tp, env, v), TH.mulMTM(ts, tp, env, v))
    assert torch.equal(ops.calc_dSbdx(tp, x), TH.calc_dSbdx(ts, tp, x))
    assert torch.equal(ops.tie(v), v)


def test_muldMdx_matches_autograd(models):
    """muldMdx(u, v)[i,τ] = ∂(uᵀ·M(x)·v)/∂x[i,τ]."""
    _, _, ts, tp, fields = models
    x = _t(fields["x"]).clone().requires_grad_(True)
    u, v = _t(fields["u"]), _t(fields["v"])
    y = (u * TH.mulM(ts, tp, TH.expnV(ts, tp, x), v)).sum()
    (grad,) = torch.autograd.grad(y, x)
    with torch.no_grad():
        got = TH.muldMdx(ts, tp, TH.expnV(ts, tp, x), x, u, v)
    np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=1e-10, atol=1e-12)


def test_muldLambdadx_matches_autograd(models):
    """muldLambdadx(vl, vr)[i,τ] = ∂(vlᵀ·Λᵀ(x)·vr)/∂x[i,τ] = ∂(vrᵀ·Λ(x)·vl)/∂x
    with Λ the shift operator of mulLambda (the HMC pairing φᵀ·∂Λᵀ/∂x·z)."""
    _, _, ts, tp, fields = models
    x = _t(fields["x"]).clone().requires_grad_(True)
    u, v = _t(fields["u"]), _t(fields["v"])
    y = (v * TH.mulLambda(ts, TH.calc_Lambda(ts, tp, x), u)).sum()
    (grad,) = torch.autograd.grad(y, x)
    with torch.no_grad():
        got = TH.muldLambdadx(ts, tp, x, TH.calc_Lambda(ts, tp, x), u, v)
    np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_params_from_jax_round_trip(branch):
    js, jp, ts, tp = _models(BRANCHES[branch])
    np_params = {f: (None if getattr(jp, f) is None else np.asarray(getattr(jp, f)))
                 for f in PARAM_FIELDS}
    conv = convert.params_from_jax(np_params, "cpu", torch.float64)
    for f in PARAM_FIELDS:
        a, b = getattr(conv, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14, atol=1e-14, err_msg=f)
    back = convert.params_to_numpy(conv)
    for f in PARAM_FIELDS:
        if np_params[f] is None:
            assert back[f] is None
        else:
            np.testing.assert_array_equal(back[f], np_params[f])
    # the converted parameters drive the operators like the port's own
    rng = np.random.default_rng(2)
    x, v = _t(0.3 * rng.standard_normal((ts.Nsites, ts.Ltau))), _t(rng.standard_normal((ts.Nsites, ts.Ltau)))
    assert torch.allclose(TH.mulMTM(ts, conv, TH.expnV(ts, conv, x), v),
                          TH.mulMTM(ts, tp, TH.expnV(ts, tp, x), v), rtol=1e-13, atol=1e-13)
    del np_params["expK"], np_params["expK_inv"], np_params["t"]
    assert convert.params_from_jax(np_params, "cpu").expK is None
    with pytest.raises(KeyError):
        convert.params_from_jax({"mu": np_params["mu"]}, "cpu")


def test_unported_hopping_raises():
    """Complex hopping, refused until it was ported (twisted boundaries and
    complex t): it now builds complex tables (complex128 for float64)."""
    uc = TUnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    lat = TLattice.create(uc, 2)
    _, tw = TH.build_holstein(lat, 1.0, 0.1, t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0))],
                              twist=(0.5, 0.0), device="cpu")
    _, im = TH.build_holstein(lat, 1.0, 0.1, t_assignments=[(1.0j, 0.0, 0, 0, (1, 0, 0))],
                              device="cpu")
    for p in (tw, im):
        assert p.cosht.dtype == p.sinht.dtype == p.expK.dtype == torch.complex128
        assert p.sinht.imag.abs().max() > 0
