"""Fourier-accelerated Langevin dynamics (Euler, Runge-Kutta, Heun),
batched over chains.

Counterpart of ``elphdynamics_tpu/dynamics/langevin.py``. With Q the
acceleration table applied along τ:

* Euler:       Δx = √(2Δt)·√Q·η − Δt·Q·dS/dx;
* Runge-Kutta: a predictor step without acceleration, the two forces
  averaged, acceleration only at the final combine;
* Heun:        two stages with the acceleration applied to each force.

Every step is accepted: there is no Metropolis test and so no host read
beyond the solver's own. Preconditioner cadence: Euler does a full setup
for its force; RK and Heun one full setup per step and a refresh of it for
the second force.

Random draws are explicit, as in :mod:`.hmc`: a step takes optional
:class:`LangevinDraws`; without them it draws from its ``generator`` on the
field's device, first η and then one ``g`` per force evaluation in the
order the forces are evaluated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from elphdynamics_tpu_torch.dynamics.force import total_force
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, precond_state, site_reduce
from elphdynamics_tpu_torch.models.adapter import (
    ModelOps, global_phonons, global_sites, local_phonons, local_sites)
from elphdynamics_tpu_torch.ops.fourier_accel import MassOperator
from elphdynamics_tpu_torch.utils.dtypes import field_dtype, trace_noise

METHODS = ("euler", "rk", "heun")


@dataclass(frozen=True)
class LangevinStats:
    iters: torch.Tensor   # [C] solver iterations of the step's force solve(s)
    flag: torch.Tensor    # [C] max solver flag


@dataclass(frozen=True)
class LangevinDraws:
    """The random numbers of one step."""

    eta: torch.Tensor     # [C, Nph, Lτ] unit normals (tied by the step)
    # one [C, N, Lτ] unit-normal field per force evaluation (circular complex
    # normals, E[gg†] = I, under complex hopping)
    g: tuple


def n_forces(method: str) -> int:
    return 1 if method == "euler" else 2


def draw(ops: ModelOps, n_chains: int, method: str, dtype: torch.dtype, device,
         generator: torch.Generator | None = None, fdtype: torch.dtype | None = None
         ) -> LangevinDraws:
    """Draw one step's random numbers from ``generator``: η, then the force
    vectors in order (of the fermion-field dtype ``fdtype``, default
    ``dtype``). A site-sharded model draws for every site and keeps its
    block (SSH keeps the whole bond field's η)."""
    eta = torch.randn((n_chains, global_phonons(ops), ops.Ltau), generator=generator,
                      dtype=dtype, device=device)
    g = tuple(local_sites(ops, trace_noise((n_chains, global_sites(ops), ops.Ltau),
                                           fdtype or dtype, device, generator))
              for _ in range(n_forces(method)))
    return LangevinDraws(eta=local_phonons(ops, eta), g=g)


def make_langevin_step(ops: ModelOps, Q_table, dt: float, method: str = "euler",
                       scfg: SolverConfig = SolverConfig(), precond=None):
    """Build ``step(params, x, generator=None, draws=None) -> (x, stats)``
    (``step.draw(params, x, n_chains, generator)`` makes a step's draws)
    for ``method`` in {euler, rk (update_method 2), heun (update_method 3)}
    on fields ``x`` ``[C, Nph, Lτ]``. ``Q_table`` is the ``[Nph, Lτ]``
    acceleration spectrum (:func:`..ops.fourier_accel.build_Q`)."""
    if method not in METHODS:
        raise ValueError(f"unknown Langevin method {method!r} (one of {METHODS})")
    site_reduce(ops, scfg.kind)   # BiCGStab / GMRES stay refused on a site shard
    Q_table = local_phonons(ops, Q_table)
    q_ops: dict = {}
    amp = math.sqrt(2.0 * dt)

    def accel(like) -> MassOperator:
        key = (like.device, like.dtype)
        if key not in q_ops:
            q_ops[key] = MassOperator(Q_table, (0.5, 1.0), like.device, like.dtype)
        return q_ops[key]

    def force(params, x, g, pstate=None):
        return total_force(ops, params, x, g.to(x.device), scfg, precond, shifted=True,
                           pstate=pstate)

    def euler(params, x, eta, g, Q):
        f = force(params, x, g[0])
        x = x + amp * Q.apply(eta, 0.5) - dt * Q.apply(f.dSdx, 1.0)
        return x, LangevinStats(f.iters, f.flag)

    def rk(params, x, eta, g, Q):
        ps = precond_state(precond, params, x)
        f1 = force(params, x, g[0], ps)
        f2 = force(params, x + amp * eta - dt * f1.dSdx, g[1], ps)
        favg = (f1.dSdx + f2.dSdx) / 2.0
        x = x + amp * Q.apply(eta, 0.5) - dt * Q.apply(favg, 1.0)
        return x, LangevinStats(f2.iters, torch.maximum(f1.flag, f2.flag))

    def heun(params, x, eta, g, Q):
        xi = Q.apply(eta, 0.5)
        ps = precond_state(precond, params, x)
        f1 = force(params, x, g[0], ps)
        dG1 = Q.apply(f1.dSdx, 1.0)
        f2 = force(params, x + amp * xi - dt * dG1, g[1], ps)
        dG2 = Q.apply(f2.dSdx, 1.0)
        x = x + amp * xi - dt * (dG1 + dG2) / 2.0
        return x, LangevinStats((f1.iters + f2.iters) // 2, torch.maximum(f1.flag, f2.flag))

    scheme = {"euler": euler, "rk": rk, "heun": heun}[method]

    def step(params, x, generator: torch.Generator | None = None,
             draws: LangevinDraws | None = None):
        if x.ndim != 3:
            raise ValueError(f"x must be [C, Nph, Ltau], got {tuple(x.shape)}")
        if draws is None:
            draws = draw(ops, x.shape[0], method, x.dtype, x.device, generator,
                         field_dtype(params, x.dtype))
        return scheme(params, x, ops.tie(draws.eta.to(x)), draws.g, accel(x))

    def draw_step(params, x, n_chains: int, generator=None) -> LangevinDraws:
        """The draws of one step of ``n_chains`` chains like ``x``."""
        return draw(ops, n_chains, method, x.dtype, x.device, generator,
                    field_dtype(params, x.dtype))

    step.draw = draw_step
    return step
