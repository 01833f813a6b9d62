"""The split precision policy of ``[solver] loop_precision`` in the PyTorch
port (``dynamics/solve._cg_operators``, the counterpart of
``elphdynamics_tpu/dynamics/solve.py:_cg_operators``), on the CPU.

* The operator pair: ``(full, None)`` for None, "highest" and every
  tol < 1e-6; ``(cheaper, full)`` otherwise, the cheaper one passing the
  precision down to the model.
* On the CPU the cheaper operator is the full one, so "high" and
  "highest" give bitwise-equal HMC updates (float32 and float64, dense
  Holstein branch).
* A deliberately perturbed in-loop operator (MᵀM + 0.05·I), injected into
  the model, steers CG to a wrong answer; the full-precision verification
  flags it and the unpreconditioned retry with the full operator repairs
  it (flag 0, true residual ≤ √tol), while "highest" and tol < 1e-6 never
  call the perturbed operator.
* The bf16×3 matmul's arithmetic, emulated on the CPU, sits within the
  TPU's bf16×3 error of the float64 product.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.solve import (
    SolverConfig, _cg_operators, resolve_precond, solve_oinv)
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models import holstein as H
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.ops.fourier_accel import build_mass

torch.set_num_threads(1)

UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
T_ASSIGN = [(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))]
SHIFT = 0.05


def _model(dtype):
    spec, params = H.build_holstein(Lattice.create(UnitCell.create(*UC), 4), 1.0, 0.1,
                                    t_assignments=T_ASSIGN, omega=1.0, lam=1.0, mu=0.0,
                                    dtype=dtype, device="cpu")
    assert spec.dense_ckb
    return make_model_ops(spec), params


def _fields(ops, dtype, chains=2, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn((chains, ops.Nph, ops.Ltau), generator=g, dtype=torch.float64)
    rhs = torch.randn((chains, 2, ops.Nsites, ops.Ltau), generator=g, dtype=torch.float64)
    return x.to(dtype), rhs.to(dtype)


class _Recorder:
    """A stand-in ``ops`` whose ``mulMTM`` records the precision it is given."""

    def __init__(self):
        self.seen = []

    def mulMTM(self, params, derived, v, precision=None):
        self.seen.append(precision)
        return v


@pytest.mark.parametrize("prec,tol,split", [
    (None, 1e-5, False), ("highest", 1e-5, False), ("high", 1e-7, False),
    ("high", 1e-10, False), ("high", 1e-6, True), ("high", 1e-5, True),
    ("default", 1e-5, True)])
def test_cg_operator_pair(prec, tol, split):
    ops = _Recorder()
    hot, chk = _cg_operators(ops, None, None, SolverConfig(tol=tol, loop_precision=prec))
    v = torch.ones(2)
    hot(v)
    if not split:
        assert chk is None and ops.seen == [None]
        return
    chk(v)
    assert ops.seen == [prec, None]


def test_unknown_loop_precision_is_refused():
    with pytest.raises(ValueError, match="loop_precision"):
        SolverConfig(loop_precision="bf16")
    with pytest.raises(ValueError, match="loop_precision"):
        HMCConfig(dt=0.05, trajectory_time=0.1, loop_precision="low").check()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_high_and_highest_updates_are_bitwise_equal_on_cpu(dtype):
    ops, params = _model(dtype)
    mass = build_mass(params.omega.double().numpy(), ops.dtau, ops.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    pre = kpm.make_precond(ops, kpm.KPMConfig(max_order=4))
    x0, _ = _fields(ops, dtype)
    out = {}
    for prec in ("high", "highest"):
        cfg = HMCConfig(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-5, maxiter=500,
                        construct_guess=True, guess_order=3, loop_precision=prec)
        step = make_hmc_step(ops, mass, cfg, pre)
        state = HMCState(x=x0, v=torch.zeros_like(x0))
        for _ in range(2):
            state, stats = step(params, state, torch.Generator().manual_seed(11))
        out[prec] = (state.x, state.v, stats.delta_H, stats.iters, stats.flag, stats.accepted)
    for a, b in zip(out["high"], out["highest"]):
        assert torch.equal(a, b)


def _perturbed(ops):
    """``ops`` whose MᵀM is off by SHIFT·I whenever a precision is asked for
    (the cheaper in-loop operator, deliberately wrong)."""
    full = ops.mulMTM

    def mulMTM(p, d, v, precision=None):
        out = full(p, d, v)
        return out if precision is None else out + SHIFT * v

    return replace(ops, mulMTM=mulMTM)


def test_perturbed_loop_operator_is_caught_and_retried():
    ops, params = _model(torch.float64)
    bad_ops = _perturbed(ops)
    x, rhs = _fields(ops, torch.float64)
    derived = ops.stack(ops.derived(params, x))
    pre = kpm.make_precond(ops, kpm.KPMConfig(max_order=4))
    pa = resolve_precond(pre, params, x)
    tol = 1e-5

    def solve(o, prec, t=tol):
        return solve_oinv(o, params, derived, rhs, SolverConfig(tol=t, loop_precision=prec), pa)

    def true_residual(res):
        r = ops.mulMTM(params, derived, res.x) - rhs
        return (r.norm(dim=(-2, -1)) / rhs.norm(dim=(-2, -1))).max().item()

    good = solve(ops, "highest")
    assert int(good.flag.max()) == 0
    # "highest" and tol < 1e-6 never call the perturbed operator: bitwise
    # the unperturbed solves
    for prec, t in (("highest", tol), ("high", 1e-7)):
        a, b = solve(bad_ops, prec, t), solve(ops, prec, t)
        assert torch.equal(a.x, b.x) and torch.equal(a.iters, b.iters)
    # "high" runs the perturbed operator in the loop: CG converges to
    # (MᵀM + 0.05·I)⁻¹·rhs, which the full verification finds wrong, and the
    # retry from zero with the full operator repairs every system
    from elphdynamics_tpu_torch import solvers
    hot, chk = _cg_operators(bad_ops, params, derived, SolverConfig(tol=tol))
    first = solvers.cg(hot, rhs, apply_P=pa.symmetric, tol=tol, maxiter=1000)
    r1 = chk(first.x) - rhs
    err1 = (r1.norm(dim=(-2, -1)) / rhs.norm(dim=(-2, -1)))
    assert bool((err1 > tol ** 0.5).all()), err1
    res = solve(bad_ops, "high")
    assert int(res.flag.max()) == 0
    assert float(res.residual.max()) <= tol ** 0.5
    assert true_residual(res) <= tol ** 0.5
    assert bool((res.iters > first.iters).all())
    np.testing.assert_allclose(res.x.numpy(), good.x.numpy(), rtol=0,
                               atol=1e-3 * float(good.x.abs().max()))


def test_bf16x3_arithmetic_error_bound():
    """The three-product split on the CPU (float32 products of the bf16
    parts, the arithmetic of the card's bf16 GEMM with float32
    accumulation): relative error ≤ 2⁻¹⁴ of the float64 product at the dense
    branch's shapes, where one bf16 product is off by ~2⁻⁸."""
    ops, params = _model(torch.float32)
    A = params.expK
    y = torch.randn((2, 2, ops.Nsites, ops.Ltau), generator=torch.Generator().manual_seed(1))
    A_hi, A_lo = H._split_bf16(A)
    y_hi, y_lo = H._split_bf16(y)

    def mm(a, b):
        return torch.matmul(a.float(), b.float())

    three = mm(A_hi, y_hi) + mm(A_hi, y_lo) + mm(A_lo, y_hi)
    one = mm(A_hi, y_hi)
    exact = torch.matmul(A.double(), y.double())
    scale = torch.matmul(A.double().abs(), y.double().abs()).max()
    err3 = float((three.double() - exact).abs().max() / scale)
    err1 = float((one.double() - exact).abs().max() / scale)
    assert err3 <= 2.0 ** -14, err3
    assert err1 > 2.0 ** -12, err1


def test_cheaper_forms_are_loop_precisions():
    from elphdynamics_tpu_torch.dynamics.solve import LOOP_PRECISIONS
    assert set(H.BF16_PASSES) <= set(LOOP_PRECISIONS)
    assert None in LOOP_PRECISIONS and "highest" in LOOP_PRECISIONS
    assert not {None, "highest"} & set(H.BF16_PASSES)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("adjoint", [False, True])
def test_bf16_operand_is_split_once_per_matrix(passes, adjoint):
    """exp(−Δτ·K)'s bf16 operand is [hi | hi | lo] of A (Aᵀ for the
    adjoint), built on the first apply and reused while A is the matrix."""
    ops, params = _model(torch.float32)
    spec, A = ops.spec, params.expK
    op = H._bf16_operand(spec, A, passes, adjoint)
    a = A.mT if adjoint else A
    hi, lo = H._split_bf16(a)
    want = torch.cat([hi, hi, lo], dim=1) if passes == 3 else hi
    assert op.dtype == torch.bfloat16 and torch.equal(op, want)
    assert H._bf16_operand(spec, A, passes, adjoint) is op
    # hi + lo carries A to bf16×2 precision (16 bits)
    err = float(((hi.double() + lo.double()) - a.double()).abs().max() / a.abs().max())
    assert err <= 2.0 ** -16, err
    # a new matrix (other parameters on the same spec) is split anew
    B = 2.0 * A
    opB = H._bf16_operand(spec, B, passes, adjoint)
    assert opB is not op and torch.equal(opB.float(), 2.0 * op.float())


def test_bf16_operand_goes_with_its_matrix():
    """The cache keeps no matrix alive: a matrix that is dropped (a graphed
    step's workspace built anew clones its own) takes its operand out of
    the spec's cache, while a live matrix keeps its operand."""
    ops, params = _model(torch.float32)
    spec = ops.spec
    before = len(spec.ckb._cache)
    A = params.expK.clone()
    op = H._bf16_operand(spec, A, 3, False)
    H._bf16_operand(spec, A, 3, True)
    assert len(spec.ckb._cache) == before + 2
    assert H._bf16_operand(spec, A, 3, False) is op
    del A, op
    assert len(spec.ckb._cache) == before


@pytest.mark.parametrize("passes", [1, 3])
def test_bf16_field_operand_is_hi_lo_hi(passes):
    """The field's bf16 operand, built in one buffer, is bitwise the
    concatenation [hi; lo; hi] of its bf16 split (hi for one pass)."""
    y = torch.randn((4, 16, 10), generator=torch.Generator().manual_seed(2))
    hi, lo = H._split_bf16(y)
    want = torch.cat([hi, lo, hi], dim=1) if passes == 3 else hi
    got = H._bf16_stack(y, passes)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
