"""Model-level linear-solve dispatch (CG through MᵀM): z = (MᵀM)⁻¹·rhs for
the HMC forces and actions, x = M⁻¹·rhs for the Green's-function probes.

Counterpart of the CG path of ``elphdynamics_tpu/dynamics/solve.py``: with
CG, systems are solved through the SPD operator MᵀM with the symmetric KPM
preconditioner, and every solve ends in the residual verification + retry
of :func:`..solvers.solve_checked`. BiCGStab/GMRES, block CG and deflation
are not ported (ROADMAP slices E and I).
"""

from __future__ import annotations

from dataclasses import dataclass

from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.models.adapter import ModelOps


@dataclass(frozen=True)
class SolverConfig:
    """Linear-solver settings."""

    tol: float = 1e-5
    maxiter: int = 1000
    kappa_max: float = 1e12
    kind: str = "cg"
    block: bool = False
    # accepted for parity with the JAX package and not used yet: every
    # operator runs at the full precision of the field dtype (the TPU's
    # bf16×3 "high" has no H100 counterpart; a lower in-loop precision is a
    # later, measured change)
    loop_precision: str | None = "high"

    def check_ported(self) -> None:
        if self.kind != "cg":
            raise NotImplementedError(f"solver kind {self.kind!r}: ROADMAP slice E")
        if self.block:
            raise NotImplementedError("block CG: ROADMAP slice E")


@dataclass(frozen=True)
class PrecondApplies:
    symmetric: object  # (v) -> v   ≈ (MᵀM)⁻¹


def precond_state(precond, params, x, prev=None, start=None):
    """Full preconditioner setup (``prev=None``) or the cheap refresh of
    ``prev``. ``start`` overrides the power-iteration start vectors."""
    if precond is None:
        return None
    if prev is not None:
        return precond.refresh(prev, params, x)
    return precond.setup(params, x, start)


def precond_applies(precond, st) -> PrecondApplies | None:
    """Bind a preconditioner state into the apply closure."""
    if precond is None:
        return None
    return PrecondApplies(symmetric=lambda v: precond.symmetric(st, v))


def resolve_precond(precond, params, x, prev_state=None) -> PrecondApplies | None:
    """Set up (or refresh, given ``prev_state``) and bind the applies."""
    if precond is None:
        return None
    return precond_applies(precond, precond_state(precond, params, x, prev_state))


def _cg_operators(ops: ModelOps, params, derived, scfg: SolverConfig):
    """(in-loop, verification) MᵀM operators. Both are the full-precision
    operator here, so the verification operator is None (the loop's)."""
    return (lambda v: ops.mulMTM(params, derived, v)), None


def solve_minv(ops: ModelOps, params, derived, rhs, scfg: SolverConfig,
               pa: PrecondApplies | None):
    """x = M⁻¹·rhs for every leading index of ``rhs``, through CG on
    MᵀM·x = Mᵀ·rhs (the Green's-function probes). Block CG over the probe
    axis is ROADMAP slice E."""
    scfg.check_ported()
    b = ops.mulMT(params, derived, rhs)
    hot, chk = _cg_operators(ops, params, derived, scfg)
    return solvers.solve_checked(
        hot, b, apply_P=pa.symmetric if pa else None,
        tol=scfg.tol, maxiter=scfg.maxiter, kappa_max=scfg.kappa_max,
        apply_A_check=chk)


def solve_oinv(ops: ModelOps, params, derived, rhs, scfg: SolverConfig,
               pa: PrecondApplies | None, x0=None, deflate=None):
    """z = (MᵀM)⁻¹·rhs for every leading index of ``rhs``; ``x0`` warm
    starts the CG."""
    scfg.check_ported()
    if deflate is not None:
        raise NotImplementedError("deflation: ROADMAP slice I")
    hot, chk = _cg_operators(ops, params, derived, scfg)
    return solvers.solve_checked(
        hot, rhs, x0=x0, apply_P=pa.symmetric if pa else None,
        tol=scfg.tol, maxiter=scfg.maxiter, kappa_max=scfg.kappa_max,
        apply_A_check=chk)
