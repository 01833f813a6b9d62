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

The step on one rank or a chain rank's block (the whole batch's draws cut
to it), real or complex hopping, with CG (no preconditioner, KPM with or
without the exact low-frequency blocks, or the near-null one) or
BiCGStab / GMRES, is a fixed sequence of segments over one workspace
(:mod:`.graphs`), as the HMC update is: the start (η tied, the step's full
KPM setup, the derived state, the right-hand side (CG's b = Mᵀg₀, else
g₀) and the solve's start), the solve's segments (CG's blocks of
``solvers.CG_SYNC_EVERY`` iterations and its verification,
:class:`.graphs.CGSolve`; BiCGStab's or GMRES's on M,
:class:`.graphs.NonsymSolve`), for RK and
Heun the middle (force 1, the predictor, the KPM refresh, the second
solve's start) and a second solve, and the end (the last force and the
field update). On a CUDA field each segment is captured once as a CUDA
graph and replayed, the host keeping the eager step's reads; on the CPU
the segments run directly, doing the eager step's arithmetic in its order.
Complex hopping takes the graphed step too (the force probes g, b = M†g
and the solution complex, x real). So does a site shard's step by CG,
its site group's all-reduces and halo exchanges inside the segments
(captured on NCCL ranks, one card each); a site group under gloo on a
card runs the eager step (:func:`.graphs.graphable` reads the group's
backend), as does a caller that asks for it by name (``eager=True``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.force import total_force
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, precond_state, site_reduce
from elphdynamics_tpu_torch.models.adapter import (
    ModelOps, force_sum, global_phonons, global_sites, local_phonons, local_sites)
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
                       scfg: SolverConfig = SolverConfig(), precond=None, eager: bool = False):
    """Build ``step(params, x, generator=None, draws=None) -> (x, stats)``
    (``step.draw(params, x, n_chains, generator)`` makes a step's draws)
    for ``method`` in {euler, rk (update_method 2), heun (update_method 3)}
    on fields ``x`` ``[C, Nph, Lτ]``. ``Q_table`` is the ``[Nph, Lτ]``
    acceleration spectrum (:func:`..ops.fourier_accel.build_Q`).

    ``eager`` asks for the eager step where the graphed one (module
    docstring) would run. ``step.segmented`` says whether the configuration
    takes the graphed step (on a real field or under complex hopping; on a
    site shard where :func:`.graphs.graphable` lets the call's device);
    ``step.workspace()`` is its :class:`.graphs.Workspace`
    (None before the first call), whose ``graphs`` (a CUDA field) count
    replays, capture seconds and pool bytes and whose ``retries`` count the
    verifications' retries."""
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

    # --- the graphed step: the segments over one workspace, each doing the
    # eager step's arithmetic in its order
    segmented = not eager
    box: dict = {}
    # CG on MᵀM·z = Mᵀg, or BiCGStab / GMRES on M·z = g
    solve = graphs.make_solve(ops, precond, scfg, rhs="b", stacked=False)

    def solved_force(ws, x, g):
        """The force at ``x`` from the finished solve for z = M⁻¹g
        (:func:`..force.total_force`: the fermionic force, then the shifted
        bosonic one)."""
        p = ws.params
        dSf = -2.0 * force_sum(ops, ops.muldMdx(p, ws.env, x, g, solve.result(ws)[0]))
        return dSf + ops.calc_dSbdx(p, x, True)

    def solve_start(ws, x, g, refresh: bool):
        """The derived state at ``x``, the preconditioner refreshed there
        from the step's setup (``refresh``), the right-hand side (CG's
        b = Mᵀg, else g) and the solve's start."""
        p = ws.params
        env = ws.put("env", ops.derived(p, x))
        if precond is not None and refresh:
            ws.load("kpm", precond.refresh(ws.kpm, p, x))
        ws.put("b", ops.mulMT(p, env, g) if scfg.kind == "cg" else g)
        solve.start(ws, scfg.tol)

    def seg_start(ws):
        """η tied, the step's full KPM setup at x, the first solve's start
        (RK and Heun solve with a refresh of the setup, Euler with the setup
        itself)."""
        p, x = ws.params, ws.x0
        eta = ws.put("eta", ops.tie(ws.eta_in))
        if method == "heun":
            ws.put("xi", accel(x).apply(eta, 0.5))
        if precond is not None:
            ws.load("kpm", precond.setup(p, x, ws.kpm_start))
        solve_start(ws, x, ws.g0, refresh=method != "euler")

    def seg_mid(ws):
        """Force 1, the predictor (RK: unaccelerated; Heun: its accelerated
        force) and the second solve's start there."""
        x = ws.x0
        f1 = ws.put("f1", solved_force(ws, x, ws.g0))
        _, iters1, flag1 = solve.result(ws)
        ws.put("iters1", iters1)
        ws.put("flag1", flag1)
        if method == "heun":
            dG1 = ws.put("dG1", accel(x).apply(f1, 1.0))
            xp = x + amp * ws.xi - dt * dG1
        else:
            xp = x + amp * ws.eta - dt * f1
        xp = ws.put("xp", xp)
        solve_start(ws, xp, ws.g1, refresh=True)

    def seg_end(ws):
        """The last force and the field update; the step's iterations and
        flag."""
        x, Q = ws.x0, accel(ws.x0)
        _, iters, flag = solve.result(ws)
        if method == "euler":
            f = solved_force(ws, x, ws.g0)
            x_new = x + amp * Q.apply(ws.eta, 0.5) - dt * Q.apply(f, 1.0)
        else:
            f2 = solved_force(ws, ws.xp, ws.g1)
            if method == "rk":
                favg = (ws.f1 + f2) / 2.0
                x_new = x + amp * Q.apply(ws.eta, 0.5) - dt * Q.apply(favg, 1.0)
            else:
                dG2 = Q.apply(f2, 1.0)
                x_new = x + amp * ws.xi - dt * (ws.dG1 + dG2) / 2.0
                iters = (ws.iters1 + iters) // 2
            flag = torch.maximum(ws.flag1, flag)
        ws.put("out_x", x_new)
        ws.put("iters", iters)
        ws.put("flag", flag)

    def segments(ws):
        """Every segment once, in the order of a step whose solves each
        stop after one CG block (the warm-up and the capture order)."""
        seq = [("start", lambda: seg_start(ws)), *solve.segments(ws, scfg.tol)]
        if method != "euler":
            seq += [("mid", lambda: seg_mid(ws)), *solve.segments(ws, scfg.tol)]
        return seq + [("end", lambda: seg_end(ws))]

    def graphed(params, x, draws):
        ws = graphs.step_workspace(box, params, x)
        ws.put("x0", x)
        ws.put("eta_in", draws.eta.to(x))
        for i, g in enumerate(draws.g):
            ws.put(f"g{i}", g.to(x.device))
        if precond is not None:
            ws.put_start(precond.start)
        ws.capture_once(lambda: segments(ws))

        ws.run("start", lambda: seg_start(ws))
        solve.solve(ws, scfg.tol)
        if method != "euler":
            ws.run("mid", lambda: seg_mid(ws))
            solve.solve(ws, scfg.tol)
        ws.run("end", lambda: seg_end(ws))
        return ws.out_x.clone(), LangevinStats(ws.iters.clone(), ws.flag.clone())

    def step(params, x, generator: torch.Generator | None = None,
             draws: LangevinDraws | None = None):
        if x.ndim != 3:
            raise ValueError(f"x must be [C, Nph, Ltau], got {tuple(x.shape)}")
        if draws is None:
            draws = draw(ops, x.shape[0], method, x.dtype, x.device, generator,
                         field_dtype(params, x.dtype))
        if segmented and graphs.graphable(ops.shard, x.device):
            return graphed(params, x, draws)
        return scheme(params, x, ops.tie(draws.eta.to(x)), draws.g, accel(x))

    def draw_step(params, x, n_chains: int, generator=None) -> LangevinDraws:
        """The draws of one step of ``n_chains`` chains like ``x``."""
        return draw(ops, n_chains, method, x.dtype, x.device, generator,
                    field_dtype(params, x.dtype))

    step.draw = draw_step
    step.segmented = segmented
    step.workspace = lambda: box.get("ws")
    return step
