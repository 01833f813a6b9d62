"""Stochastic forces for the phonon-field dynamics, batched over chains.

Counterpart of ``elphdynamics_tpu/dynamics/force.py``. The fermionic force
is estimated from one Gaussian vector per evaluation:

    ∂S_f/∂xᵢ(τ) = −2·gᵀ·[∂M/∂xᵢ(τ)]·M⁻¹g

with ``M⁻¹g`` from :func:`..solve.solve_minv` (CG on MᵀM·z = Mᵀg, or
BiCGStab / GMRES on M). Fields are ``[C, Nph, Lτ]`` and ``g`` is
``[C, N, Lτ]``: one system per chain. Under complex hopping ``g`` is a
circular complex normal (E[gg†] = I) and the force is
−2·Re[g†·∂M·M⁻¹g] (the model's ``muldMdx`` takes the real part).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_minv
from elphdynamics_tpu_torch.models.adapter import ModelOps, force_sum


@dataclass(frozen=True)
class ForceResult:
    dSdx: torch.Tensor    # [C, Nph, Lτ]
    iters: torch.Tensor   # [C] solver iterations
    flag: torch.Tensor    # [C] solver flag


def fermionic_force(ops: ModelOps, params, x, derived, g, scfg: SolverConfig,
                    pa=None) -> ForceResult:
    """−2·gᵀ·[∂M/∂x]·M⁻¹g for the Gaussian vectors ``g`` ``[C, N, Lτ]``
    (on a site-sharded SSH model summed over the ranks, :func:`force_sum`)."""
    sol = solve_minv(ops, params, derived, g, scfg, pa)
    dSf = -2.0 * force_sum(ops, ops.muldMdx(params, derived, x, g, sol.x))
    return ForceResult(dSdx=dSf, iters=sol.iters, flag=sol.flag)


def total_force(ops: ModelOps, params, x, g, scfg: SolverConfig, precond=None,
                shifted: bool = True, pstate=None) -> ForceResult:
    """∂S/∂x = ∂Sb/∂x − 2gᵀ[∂M/∂x]M⁻¹g at ``x`` ``[C, Nph, Lτ]`` with the
    Gaussian vectors ``g``. ``precond`` is a :class:`..ops.kpm.Preconditioner`:
    set up in full at ``x``, or refreshed from the ``pstate`` of an earlier
    full setup (which keeps its spectral bounds and coefficients)."""
    derived = ops.derived(params, x)
    pa = resolve_precond(precond, params, x, prev_state=pstate)
    fres = fermionic_force(ops, params, x, derived, g, scfg, pa)
    return ForceResult(dSdx=fres.dSdx + ops.calc_dSbdx(params, x, shifted),
                       iters=fres.iters, flag=fres.flag)
