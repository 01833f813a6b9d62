"""Hybrid Monte Carlo over the phonon fields, batched over chains.

Counterpart of ``elphdynamics_tpu/dynamics/hmc.py``. One update:

* momenta v = α·v + √(1−α²)·M^(−1/2)·R (Fourier-accelerated mass; R tied
  over aliased fields);
* auxiliary field φ± = Λ⁻¹·Mᵀ·R± per spin (Mᵀ·R± for SSH, which has no Λ
  shift); under complex hopping the two spins are one complex stack entry
  φ = Λ⁻¹·M†·(R↑ + i·R↓), the time-reversal-symmetric twist ensemble;
* Nt trajectory steps, each with a KPM-preconditioned, residual-checked
  solve of MᵀM·z = Λφ and the fermion forces: leapfrog (Nb bosonic
  substeps per step), or the 2MN minimum-norm integrator (Omelyan et al.,
  hep-lat/0506011: λ-kick, dt/2 drift, middle kick, dt/2 drift, λ-kick;
  two solves per step, each drift Nb substeps of its half step). The solve
  is CG (warm-started from the previous solutions; with ``block`` the two
  spins of a chain as one block CG; with deflation started from the
  slow-mode projection of :mod:`..ops.deflation`), or BiCGStab / GMRES
  through Mᵀ then M (never warm-started, as in the JAX package);
* a tol² endpoint solve, ΔH through float64 dots, and a Metropolis test.

A solver failure freezes that chain's trajectory (masked commits) and
rejects its update.

Shapes: ``x``, ``v`` are ``[C, Nph, Lτ]``; the two spin systems are
stacked as ``[C, 2, N, Lτ]`` (``[C, 1, N, Lτ]`` complex under complex
hopping) and solved as one batched CG, the model's
derived state shaped for the stack by ``ops.stack``. Every per-chain
quantity (KPM window, CG masks, flags, acceptance) stays per chain. The
kinetic energy counts primary fields only (SSH aliases).

Random draws are explicit: the step takes an optional :class:`HMCDraws`;
without one it draws from its ``generator``. With ``log_verbose`` the stats
carry each trajectory step's energies. ``dynamic_dt`` makes the step size
an argument (a 0-dim tensor on the device, the trajectory length Nt fixed
from ``cfg``), so the burn-in tuner (:func:`dt_tuner_update`, Nesterov dual
averaging toward ``target_acceptance``) changes it with no host read.

The update on one rank or a chain rank's block, leapfrog or 2MN,
Holstein or SSH, real or complex hopping, shared or per-chain (tempering
ladder) couplings, with CG (block CG, deflation and any preconditioner:
KPM with or without the ``exact_lowfreq`` blocks, the near-null one) or
BiCGStab / GMRES, is a fixed sequence of segments over one workspace
(:mod:`.graphs`): the start (momenta, φ, the preconditioner's setup, the
deflation basis's refresh, the tol² solve's start), the solve's segments
(a block of ``solvers.CG_SYNC_EVERY`` masked CG or block CG iterations
and the verification, :class:`.graphs.CGSolve`; BiCGStab's blocks or
GMRES's cycles, Arnoldi blocks and closes, and a verification, for each
of the two solves Mᵀ then M, :class:`.graphs.NonsymSolve`), a
trajectory step from a solved z to the next solve's start (its Nb bosonic
substeps included; 2MN's middle of a step, between its two solves, a
segment of its own), the end (ΔH, the Metropolis test, the masked state
update). On a CUDA field each segment is captured once as a CUDA graph and
replayed; the host keeps the loop control (the solvers' reads before a
block or cycle, the verification's ``any(bad)`` and its rare retry, run
eagerly).
On the CPU the segments run directly, doing the eager update's arithmetic
in its order. The model's derived state (Holstein's ``expnV``, SSH's
``SSHDerived`` tables) and the KPM state, SSH's per-chain τ-means and
dense Ā included, the near-null state and the deflation basis, are copied
into the workspace's tensors in place; the basis comes back as new tensors.
A site shard's update (leapfrog, CG or block CG, deflation, the dt
tuner's step) is segmented too, its site group's all-reduces and halo
exchanges inside the segments: captured on NCCL ranks, one card each; a
site group under gloo on a card runs the eager update
(:func:`.graphs.graphable` reads the group's backend), as does a caller
that asks for it by name (``eager=True``). Under complex hopping the
workspace holds the packed complex pseudofermions, φ, Λφ and the
warm-start history ``[C, 1, N, Lτ]``, SSH's complex tables and the complex
KPM state, while x, v and the forces stay real.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.solve import (
    SolverConfig, precond_applies, precond_state, resolve_precond, site_reduce, solve_oinv)
from elphdynamics_tpu_torch.models.adapter import (
    ModelOps, force_sum, global_phonons, global_sites, local_phonons, local_sites,
    phonon_sum, site_sum)
from elphdynamics_tpu_torch.models.ssh import primary_mask
from elphdynamics_tpu_torch.ops import deflation
from elphdynamics_tpu_torch.ops.fourier_accel import MassOperator
from elphdynamics_tpu_torch.utils import spans
from elphdynamics_tpu_torch.utils.device import require_device
from elphdynamics_tpu_torch.utils.dtypes import (
    fdot, field_dtype, params_are_complex, pseudofermion_noise)

# Omelyan's second-order minimum-norm coefficient (hep-lat/0506011 §2)
LAM_2MN = 0.1931833275037836
INTEGRATORS = ("leapfrog", "2mn")

# the refusal of 2MN under site sharding, and why (ROADMAP §3)
SITE_2MN = ("the 2MN integrator with --site-devices: the JAX package's sharded HMC steps "
            "ignore [hmc] integrator and run leapfrog, so there is no sharded 2MN to match "
            "(ROADMAP section 3, found in the reference)")


@dataclass(frozen=True)
class HMCConfig:
    dt: float
    trajectory_time: float
    alpha: float = 0.0        # partial momentum refresh fraction
    Nb: int = 1               # bosonic substeps per fermionic step
    tol: float = 1e-5
    maxiter: int = 1000
    kappa_max: float = 1e12
    solver_kind: str = "cg"   # "cg" | "bicgstab" | "gmres"
    restart: int = 20         # GMRES restart length
    block: bool = False       # block CG over the spin-stacked trajectory solves
    loop_precision: str | None = "high"   # in-loop CG operator (solve.SolverConfig)
    integrator: str = "leapfrog"          # "leapfrog" | "2mn"
    log_verbose: bool = False
    construct_guess: bool = False          # warm-start the trajectory solves
    guess_order: int = 1                   # polynomial extrapolation order
    # slow-mode deflation (ops/deflation.py): basis size (0 = off), filter
    # degree, power-iteration steps and band-stop cutoff per refresh
    deflate_k: int = 0
    deflate_filter: int = 8
    deflate_power: int = 4
    deflate_cutoff: float = 1 / 16
    # burn-in step-size tuning toward this mean acceptance (driver)
    tune_dt: bool = False
    target_acceptance: float = 0.8

    @property
    def Nt(self) -> int:
        return max(1, round(self.trajectory_time / self.dt))

    @property
    def dt_b(self) -> float:
        return self.dt / self.Nb

    @property
    def deflation(self) -> deflation.DeflationConfig:
        return deflation.DeflationConfig(self.deflate_k, self.deflate_filter,
                                         self.deflate_power, self.deflate_cutoff)

    def check(self) -> None:
        """Refuse an unknown integrator or solver kind."""
        if self.integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {self.integrator!r} "
                             "(expected 'leapfrog' or '2mn')")
        SolverConfig(kind=self.solver_kind, loop_precision=self.loop_precision)


@dataclass(frozen=True)
class HMCState:
    x: torch.Tensor   # [C, Nph, Lτ]
    v: torch.Tensor   # [C, Nph, Lτ]
    # per-chain ops.deflation.DeflationState when cfg.deflate_k > 0, else None
    defl: deflation.DeflationState | None = None


@dataclass(frozen=True)
class HMCStats:
    accepted: torch.Tensor   # [C] bool
    iters: torch.Tensor      # [C] mean CG iterations per solve
    flag: torch.Tensor       # [C] max solver flag
    delta_H: torch.Tensor    # [C] float64
    H: torch.Tensor
    S: torch.Tensor
    K: torch.Tensor
    # per-step [C, Nt] energies and solve iterations (2MN: both solves of
    # the step) when cfg.log_verbose (the driver's verbose hmc_sim_log.out rows)
    traj_H: torch.Tensor | None = None
    traj_S: torch.Tensor | None = None
    traj_K: torch.Tensor | None = None
    traj_iters: torch.Tensor | None = None


@dataclass(frozen=True)
class HMCDraws:
    """The random numbers of one update."""

    momentum: torch.Tensor        # [C, Nph, Lτ] unit normals
    # [C, 2, N, Lτ] unit normals; [C, 1, N, Lτ] R↑ + i·R↓ under complex hopping
    pseudofermion: torch.Tensor
    uniform: torch.Tensor         # [C] uniforms on [0, 1) (float64)
    # power-iteration start vectors of the KPM setup; None = the
    # preconditioner's fixed pair
    kpm_start: tuple | None = None


def draw(ops: ModelOps, n_chains: int, dtype: torch.dtype, device,
         generator: torch.Generator | None = None, fdtype: torch.dtype | None = None
         ) -> HMCDraws:
    """Draw one update's random numbers from ``generator``; ``fdtype`` is
    the fermion-field dtype (complex under complex hopping; default
    ``dtype``). A site-sharded model draws for every site and keeps its
    block (and the whole bond field's momenta for SSH)."""
    C = n_chains
    momentum = torch.randn((C, global_phonons(ops), ops.Ltau), generator=generator, dtype=dtype,
                           device=device)
    R = pseudofermion_noise((C, global_sites(ops), ops.Ltau), fdtype or dtype, device, generator)
    return HMCDraws(
        momentum=local_phonons(ops, momentum), pseudofermion=local_sites(ops, R),
        uniform=torch.rand((C,), generator=generator, dtype=torch.float64, device=device),
    )


# --- warm-start history: a tuple of H = clamp(order, 1, 4) solutions,
# newest first, rotated with masked copies each step

def zhist_size(order: int) -> int:
    return max(1, min(int(order), 4))


def zhist_init(z0, order: int):
    return (z0,) * zhist_size(order)


def zhist_last(hist):
    return hist[0]


def zhist_guess(hist, order: int):
    """Polynomial forward extrapolation over the newest ``order`` entries."""
    if order <= 1:
        return hist[0]
    if order == 2:
        return 2.0 * hist[0] - hist[1]
    if order == 3:
        return 3.0 * hist[0] - 3.0 * hist[1] + hist[2]
    return 4.0 * hist[0] - 6.0 * hist[1] + 4.0 * hist[2] - hist[3]


def zhist_push(hist, z, ok):
    """Chains with ``ok`` ``[C]`` shift ``z`` in as the newest entry; failed
    chains keep their history."""
    okb = ok.reshape(ok.shape + (1,) * (z.ndim - 1))
    return tuple(torch.where(okb, new, old) for new, old in zip((z,) + hist[:-1], hist))


def make_hmc_step(ops: ModelOps, mass_table, cfg: HMCConfig, precond=None,
                  dynamic_dt: bool = False, eager: bool = False):
    """Build the update ``step(params, state, generator=None, draws=None)
    -> (state, stats)``; with ``dynamic_dt`` the update
    ``step(params, state, dt, generator=None, draws=None)``, ``dt`` a 0-dim
    tensor on the fields' device (Nt stays ``cfg.Nt``).
    ``step.draw(params, x, n_chains, generator)`` makes an update's draws.
    On a site-sharded model (``ops.shard``) the same step runs on the
    rank's block of sites, its energies summed over the site group (SSH:
    the bond field, its momenta and the bosonic terms are whole on every
    rank, the fermionic force is summed once per evaluation), block CG and
    deflation with their Grams all-reduced. 2MN and BiCGStab / GMRES stay
    refused there (the JAX package's sharded steps run leapfrog and CG
    whatever is asked; ROADMAP §3).

    ``mass_table`` is the ``[Nph, Lτ]`` dynamical-mass spectrum; ``precond``
    a :class:`..ops.kpm.Preconditioner` (full setup once per update, a
    refresh before every solve). With ``cfg.deflate_k > 0`` the state
    carries a deflation basis (:func:`init_deflation`), refreshed once per
    update at the starting field and used by every solve of the update.

    ``eager`` asks for the eager update where the graphed one (module
    docstring: the update of either model and integrator, by any solver
    kind, block CG and deflation included; on a site shard leapfrog by CG,
    except on a gloo site group on a card) would run.
    ``step.segmented`` says whether the configuration takes the graphed
    update (on a real field or under complex hopping); on a site shard the
    device decides at each call (:func:`.graphs.graphable`), and on a gloo
    site group on a card the eager update runs although it is True;
    ``step.workspace()`` is its
    :class:`.graphs.Workspace` (None before the first call), whose
    ``graphs`` (a CUDA field) count replays, capture seconds and pool bytes
    and whose ``retries`` count the verifications' retries.
    """
    cfg.check()
    if ops.shard is not None and cfg.integrator != "leapfrog":
        raise NotImplementedError(SITE_2MN)
    site_reduce(ops, cfg.solver_kind)   # BiCGStab / GMRES stay refused on a site shard
    has_lambda = ops.calc_Lambda is not None
    mass_table = local_phonons(ops, mass_table)
    mass_ops: dict = {}

    def mass(like) -> MassOperator:
        """The Fourier-acceleration mass operator in float64 on ``like``'s
        device, for every field dtype: its circulants rounded to float32
        would put M (the kinetic energy), M⁻¹ (the accelerations) and M^−½
        (the refresh) ~u·κ(M) apart, biasing a float32 H and ΔH with one
        sign on every chain."""
        if like.device not in mass_ops:
            mass_ops[like.device] = MassOperator(mass_table, (-0.5, -1.0, 1.0), like.device,
                                                 torch.float64)
        return mass_ops[like.device]

    tol1 = cfg.tol
    tol2 = cfg.tol ** 2
    # only CG takes a warm start
    use_g = cfg.construct_guess and cfg.solver_kind == "cg"
    g_ord = cfg.guess_order if use_g else 1

    def lam_phi(params, x, phi):
        """Λ(x)·φ for spin-stacked φ (φ itself without a Λ shift)."""
        if not has_lambda:
            return phi
        return ops.mulLambda(ops.calc_Lambda(params, x)[:, None], phi)

    def solve_O(params, x, derived, Lphi, tol, pstate, z_guess=None, defl=None):
        """Spin-batched solve of MᵀM·z = Λφ with the preconditioner refreshed
        at ``x``; returns (z, per-chain iterations, per-chain flag)."""
        pa = resolve_precond(precond, params, x, prev_state=pstate)
        scfg = SolverConfig(tol=tol, maxiter=cfg.maxiter, kappa_max=cfg.kappa_max,
                            kind=cfg.solver_kind, restart=cfg.restart, block=cfg.block,
                            loop_precision=cfg.loop_precision)
        res = solve_oinv(ops, params, ops.stack(derived), Lphi, scfg, pa,
                         x0=z_guess if use_g else None, deflate=defl)
        ns = res.iters.shape[1]
        iters = (res.iters.sum(dim=1) + ns - 1) // ns
        return res.x, iters, res.flag.amax(dim=1)

    def forces(params, x, derived, phi, z):
        """Fermionic force −Σ±(Mz)ᵀ·∂M/∂x·z + Σ±φᵀ·∂Λᵀ/∂x·z, plus the bosonic
        force when Nb == 1 (else the substeps integrate it)."""
        ds, xs = ops.stack(derived), x[:, None]
        Mz = ops.mulM(params, ds, z)
        dSf = -force_sum(ops, ops.muldMdx(params, ds, xs, Mz, z).sum(dim=1))
        if has_lambda:
            Lam = ops.calc_Lambda(params, x)
            dSf = dSf + ops.muldLambdadx(params, xs, Lam[:, None], phi, z).sum(dim=1)
        if cfg.Nb == 1:
            return dSf + ops.calc_dSbdx(params, x, False)
        return dSf

    def calc_K(v):
        """½·vᵀ·M·v, in float64 (:func:`mass`)."""
        v = v.double()
        mv = mass(v).apply(v, 1.0)
        if not ops.is_holstein:
            # primary fields only: aliased SSH fields repeat them
            v = primary_mask(ops.spec, v) * v
        return phonon_sum(ops, fdot(v, mv, dim=(-2, -1))) / 2

    def calc_S(params, x, Lphi, z):
        return site_sum(ops, fdot(Lphi, z, dim=(1, -2, -1))) / 2 + ops.calc_Sb(params, x, False)

    def boson_substeps(params, x, v, qf, dt_b):
        QdSb = qf(ops.calc_dSbdx(params, x, False))
        for _ in range(cfg.Nb):
            v = v - dt_b / 2 * QdSb
            x = x + dt_b * v
            QdSb = qf(ops.calc_dSbdx(params, x, False))
            v = v - dt_b / 2 * QdSb
        return x, v

    def accel(like):
        """The Fourier acceleration M⁻¹·a (in float64, returned in a's dtype)."""
        mop = mass(like)
        return lambda a: mop.apply(a.double(), -1.0).to(a.dtype)

    def drift(params, qf, x, v, h):
        """Position update over ``h``: a plain drift (Nb = 1) or Nb bosonic
        substeps of h/Nb."""
        if cfg.Nb == 1:
            return x + h * v, v
        return boson_substeps(params, x, v, qf, h / cfg.Nb)

    def check_deflation(params, state) -> None:
        """Refuse a deflated update without a basis, or a real basis under
        complex hopping (host-side, before any work)."""
        if state.defl is None:
            raise ValueError("cfg.deflate_k > 0 requires HMCState.defl "
                             "(initialize with dynamics.hmc.init_deflation)")
        if params_are_complex(params) and not state.defl.W.is_complex():
            # the Hermitian Grams and projections need conjugated vectors
            raise ValueError("complex hopping parameters require a complex deflation "
                             "basis: initialize with init_deflation(ops, cfg, n_chains, "
                             "params=params)")

    def refine_deflation(params, defl, derived0, pstate, fdtype):
        """One refresh of the basis ``defl`` at the update's starting field,
        through P⁻¹A of the preconditioner's setup there."""
        pa0 = precond_applies(precond, pstate)
        ds0 = ops.stack(derived0)
        return deflation.refresh(
            defl, lambda v: ops.mulMTM(params, ds0, v.to(fdtype)),
            pa0.symmetric if pa0 is not None else (lambda v: v), cfg.deflation,
            reduce=site_reduce(ops))

    def _step(params, state: HMCState, dt, generator, draws):
        x0, v_in = state.x, state.v
        if x0.ndim != 3:
            raise ValueError(f"state.x must be [C, Nph, Ltau], got {tuple(x0.shape)}")
        fdtype = field_dtype(params, x0.dtype)
        if draws is None:
            draws = draw(ops, x0.shape[0], x0.dtype, x0.device, generator, fdtype)
        mop = mass(x0)
        qf = accel(x0)
        R = ops.tie(draws.momentum.to(x0)).double()
        v0 = (cfg.alpha * v_in.double()
              + math.sqrt(1.0 - cfg.alpha ** 2) * mop.apply(R, -0.5)).to(x0.dtype)

        derived0 = ops.derived(params, x0)
        MtR = ops.mulMT(params, ops.stack(derived0), draws.pseudofermion.to(x0.device))
        phi = (ops.mulLambdaInv(ops.calc_Lambda(params, x0)[:, None], MtR) if has_lambda
               else MtR)

        pstate = precond_state(precond, params, x0, start=draws.kpm_start)
        # the basis refined at the starting field (kept on reject too: it
        # only steers solver starts)
        defl = state.defl
        if cfg.deflate_k > 0:
            check_deflation(params, state)
            defl = refine_deflation(params, defl, derived0, pstate, fdtype)

        Lphi0 = lam_phi(params, x0, phi)
        z0, iters, flag = solve_O(params, x0, derived0, Lphi0, tol2, pstate, defl=defl)
        H0 = calc_S(params, x0, Lphi0, z0) + calc_K(v0)
        QdSdx = qf(forces(params, x0, derived0, phi, z0))

        def force_at(x, guess):
            """The tol¹ solve at ``x`` (warm-started from ``guess``) and the
            accelerated force."""
            d = ops.derived(params, x)
            Lphi_x = lam_phi(params, x, phi)
            z, it, fl = solve_O(params, x, d, Lphi_x, tol1, pstate, z_guess=guess, defl=defl)
            return qf(forces(params, x, d, phi, z)), z, it, fl, Lphi_x

        x, v = x0, v0
        hist = zhist_init(z0, g_ord)
        traj = []
        for _ in range(cfg.Nt):
            ok = flag == 0
            if cfg.integrator == "2mn":
                # the boundary λ-kicks of adjacent steps use the carried force,
                # as the leapfrog carries QdSdx; the two solves sit dt/2 apart,
                # so the warm-start extrapolation applies unchanged
                v1 = v - LAM_2MN * dt * QdSdx
                x1, v1 = drift(params, qf, x, v1, dt / 2)
                Qd_m, z_m, it_m, fl_m, _ = force_at(x1, zhist_guess(hist, g_ord))
                hist = zhist_push(hist, z_m, ok)
                v1 = v1 - (1.0 - 2.0 * LAM_2MN) * dt * Qd_m
                x1, v1 = drift(params, qf, x1, v1, dt / 2)
                Qd1, z1, it_e, fl_e, Lphi1 = force_at(x1, zhist_guess(hist, g_ord))
                hist = zhist_push(hist, z1, ok)
                v1 = v1 - LAM_2MN * dt * Qd1
                it1, fl1 = it_m + it_e, torch.maximum(fl_m, fl_e)
            else:
                v1 = v - dt / 2 * QdSdx
                x1, v1 = drift(params, qf, x, v1, dt)
                Qd1, z1, it1, fl1, Lphi1 = force_at(x1, zhist_guess(hist, g_ord))
                v1 = v1 - dt / 2 * Qd1
                hist = zhist_push(hist, z1, ok)
            okb = ok[:, None, None]
            x = torch.where(okb, x1, x)
            v = torch.where(okb, v1, v)
            QdSdx = torch.where(okb, Qd1, QdSdx)
            iters = iters + torch.where(ok, it1, torch.zeros_like(it1))
            flag = torch.maximum(flag, torch.where(ok, fl1, torch.zeros_like(fl1)))
            if cfg.log_verbose:
                # per-step energies reusing the step's (last) tol¹ solve
                S_t, K_t = calc_S(params, x, Lphi1, z1), calc_K(v)
                traj.append((S_t + K_t, S_t, K_t, it1))

        d1 = ops.derived(params, x)
        Lphi1 = lam_phi(params, x, phi)
        z1, it2, fl2 = solve_O(params, x, d1, Lphi1, tol2, pstate, z_guess=zhist_last(hist),
                               defl=defl)
        iters = iters + it2
        flag = torch.maximum(flag, fl2)
        S1 = calc_S(params, x, Lphi1, z1)
        K1 = calc_K(v)
        H1 = S1 + K1
        dH = H1 - H0
        P = torch.minimum(torch.ones_like(dH), torch.exp(-dH))
        accept = (draws.uniform.to(P) < P) & (flag == 0)

        acc = accept[:, None, None]
        x_new = torch.where(acc, x, x0)
        v_new = torch.where(acc, v, -v0)
        # solves per update: Nt tol¹ (2Nt for 2MN) and two tol² endpoints
        nsolves = (2 * cfg.Nt if cfg.integrator == "2mn" else cfg.Nt) + 2
        mean_iters = (iters + nsolves // 2) // nsolves
        stats = HMCStats(accepted=accept, iters=mean_iters, flag=flag, delta_H=dH,
                         H=H1, S=S1, K=K1)
        if traj:
            tH, tS, tK, tI = (torch.stack(col, dim=1) for col in zip(*traj))
            stats = replace(stats, traj_H=tH, traj_S=tS, traj_K=tK, traj_iters=tI)
        return HMCState(x=x_new, v=v_new, defl=defl), stats

    # --- the graphed update (leapfrog or 2MN; Holstein or SSH, real or
    # complex hopping; CG with block CG, deflation and any preconditioner,
    # or BiCGStab / GMRES; on a site shard leapfrog by CG, its collectives
    # inside the segments) as a fixed sequence of segments over one
    # workspace (dynamics/graphs.py), replayed as CUDA graphs on a CUDA
    # field and called directly on the CPU. Each segment does the eager
    # update's arithmetic in its order.
    segmented = not eager
    two_mn = cfg.integrator == "2mn"
    deflating = cfg.deflate_k > 0
    box: dict = {}
    cg = graphs.CGSolve(ops, precond, cfg.maxiter, cfg.kappa_max, cfg.loop_precision,
                        rhs="Lphi", stacked=True, deflate=deflating)
    bcg = graphs.CGSolve(ops, precond, cfg.maxiter, cfg.kappa_max, cfg.loop_precision,
                         rhs="Lphi", stacked=True, block=True)
    # BiCGStab / GMRES: Mᵀ then M, undeflated, never warm-started
    nonsym = (graphs.NonsymSolve(ops, precond, cfg.solver_kind, cfg.maxiter, cfg.restart,
                                 rhs="Lphi", stacked=True, oinv=True)
              if cfg.solver_kind != "cg" else None)

    def solver(tol):
        """The solve at ``tol``: BiCGStab / GMRES where ``cfg`` asks; else
        block CG over the spin stack where ``cfg.block`` asks and the solve
        is not deflated and tol ≥ 1e-6 (dynamics/solve.solve_oinv's gate),
        else CG."""
        if nonsym is not None:
            return nonsym
        return bcg if cfg.block and not deflating and tol >= 1e-6 else cg

    def solved(ws, tol):
        """The finished solve's z and its per-chain iterations and flag
        (the mean over the spin stack's systems, the largest flag)."""
        z, iters, flag = solver(tol).result(ws)
        ns = iters.shape[1]
        return z, (iters.sum(dim=1) + ns - 1) // ns, flag.amax(dim=1)

    def hist(ws):
        return tuple(getattr(ws, f"hist{i}") for i in range(zhist_size(g_ord)))

    def step_dt(ws):
        return ws.dt if dynamic_dt else cfg.dt

    def solve_setup(ws, x, guess, tol):
        """Refresh the preconditioner at ``x`` and start the solve of
        MᵀM·z = ws.Lphi at ``tol`` (ws.env holds the field's derived state)."""
        if precond is not None:
            with spans.mark("kpm.refresh"):
                ws.load("kpm", precond.refresh(ws.kpm, ws.params, x))
        solver(tol).start(ws, tol, guess if use_g else None)

    def seg_start(ws):
        """Momenta, φ = Λ⁻¹·MᵀR, the preconditioner's setup, the deflation
        basis's refresh and the tol² solve's start."""
        p, x0 = ws.params, ws.x0
        mop = mass(x0)
        R = ops.tie(ws.momentum.to(x0)).double()
        ws.put("v0", (cfg.alpha * ws.v_in.double()
                      + math.sqrt(1.0 - cfg.alpha ** 2) * mop.apply(R, -0.5)).to(x0.dtype))
        derived0 = ws.put("env", ops.derived(p, x0))
        MtR = ops.mulMT(p, ops.stack(derived0), ws.pseudofermion.to(x0.device))
        phi = ws.put("phi", ops.mulLambdaInv(ops.calc_Lambda(p, x0)[:, None], MtR)
                     if has_lambda else MtR)
        if precond is not None:
            with spans.mark("kpm.setup"):
                ws.load("kpm", precond.setup(p, x0, ws.kpm_start))
        if deflating:
            ws.load("defl", refine_deflation(p, ws.defl_in, derived0,
                                             ws.kpm if precond is not None else None,
                                             field_dtype(p, x0.dtype)))
        ws.put("Lphi", lam_phi(p, x0, phi))
        solve_setup(ws, x0, None, tol2)

    def start_solve_at(ws, x1, v1):
        """The trajectory solve at the drifted field: the derived state and
        Λφ there, the warm-start guess from the history."""
        ws.put("x1", x1)
        ws.put("v1", v1)
        ws.put("env", ops.derived(ws.params, ws.x1))
        ws.put("Lphi", lam_phi(ws.params, ws.x1, ws.phi))
        solve_setup(ws, ws.x1, zhist_guess(hist(ws), g_ord), tol1)

    def pre_step(ws):
        """A trajectory step up to its (first) solve's start: leapfrog's half
        kick and drift over dt, or 2MN's λ-kick and drift over dt/2."""
        p, dt = ws.params, step_dt(ws)
        ws.put("ok", ws.flag == 0)
        if two_mn:
            v1 = ws.v - LAM_2MN * dt * ws.QdSdx
            x1, v1 = drift(p, accel(ws.x0), ws.x, v1, dt / 2)
        else:
            v1 = ws.v - dt / 2 * ws.QdSdx
            x1, v1 = drift(p, accel(ws.x0), ws.x, v1, dt)
        start_solve_at(ws, x1, v1)

    def seg_mid(ws):
        """2MN's middle of a step, from the first solve's z: the force, the
        history, the middle kick, the second drift over dt/2 and the second
        solve's start."""
        p, dt = ws.params, step_dt(ws)
        z_m, it_m, fl_m = solved(ws, tol1)
        with spans.mark("force"):
            f_m = forces(p, ws.x1, ws.env, ws.phi, z_m)
        Qd_m = accel(ws.x0)(f_m)
        for i, h in enumerate(zhist_push(hist(ws), z_m, ws.ok)):
            ws.put(f"hist{i}", h)
        ws.put("it_m", it_m)
        ws.put("fl_m", fl_m)
        v1 = ws.v1 - (1.0 - 2.0 * LAM_2MN) * dt * Qd_m
        x1, v1 = drift(p, accel(ws.x0), ws.x1, v1, dt / 2)
        start_solve_at(ws, x1, v1)

    def post_step(ws):
        """A trajectory step from its (last) solved z: the force, the closing
        kick (leapfrog's half kick, 2MN's λ-kick), the warm-start history and
        the masked commit."""
        p, dt = ws.params, step_dt(ws)
        z1, it1, fl1 = solved(ws, tol1)
        with spans.mark("force"):
            f1 = forces(p, ws.x1, ws.env, ws.phi, z1)
        Qd1 = accel(ws.x0)(f1)
        if two_mn:
            v1 = ws.v1 - LAM_2MN * dt * Qd1
            it1, fl1 = ws.it_m + it1, torch.maximum(ws.fl_m, fl1)
        else:
            v1 = ws.v1 - dt / 2 * Qd1
        for i, h in enumerate(zhist_push(hist(ws), z1, ws.ok)):
            ws.put(f"hist{i}", h)
        okb = ws.ok[:, None, None]
        ws.put("x", torch.where(okb, ws.x1, ws.x))
        ws.put("v", torch.where(okb, v1, ws.v))
        ws.put("QdSdx", torch.where(okb, Qd1, ws.QdSdx))
        ws.put("iters", ws.iters + torch.where(ws.ok, it1, torch.zeros_like(it1)))
        ws.put("flag", torch.maximum(ws.flag, torch.where(ws.ok, fl1, torch.zeros_like(fl1))))
        if cfg.log_verbose:
            S_t, K_t = calc_S(p, ws.x, ws.Lphi, z1), calc_K(ws.v)
            for name, col in (("traj_H", S_t + K_t), ("traj_S", S_t), ("traj_K", K_t),
                              ("traj_iters", it1)):
                if name not in ws:
                    ws.put(name, torch.zeros(col.shape + (cfg.Nt,), dtype=col.dtype,
                                             device=col.device))
                getattr(ws, name).index_copy_(1, ws.k, col[:, None])
            ws.k.add_(1)

    def seg_first(ws):
        """After the tol² start solve: H₀, the first force, the history; then
        the first step up to its solve."""
        p, x0 = ws.params, ws.x0
        z0, it, fl = solved(ws, tol2)
        ws.put("iters", it)
        ws.put("flag", fl)
        ws.put("H0", calc_S(p, x0, ws.Lphi, z0) + calc_K(ws.v0))
        with spans.mark("force"):
            f0 = forces(p, x0, ws.env, ws.phi, z0)
        ws.put("QdSdx", accel(x0)(f0))
        ws.put("x", x0)
        ws.put("v", ws.v0)
        for i in range(zhist_size(g_ord)):
            ws.put(f"hist{i}", z0)
        if cfg.log_verbose:
            ws.k.zero_()
        pre_step(ws)

    def seg_step(ws):
        post_step(ws)
        pre_step(ws)

    def seg_last(ws):
        """After the last step's solve: its commit, then the tol² end solve's
        start at the final field."""
        post_step(ws)
        p = ws.params
        ws.put("env", ops.derived(p, ws.x))
        ws.put("Lphi", lam_phi(p, ws.x, ws.phi))
        solve_setup(ws, ws.x, zhist_last(hist(ws)), tol2)

    def seg_end(ws):
        """ΔH, the Metropolis test and the masked state update."""
        p = ws.params
        z1, it2, fl2 = solved(ws, tol2)
        iters = ws.iters + it2
        flag = torch.maximum(ws.flag, fl2)
        S1 = calc_S(p, ws.x, ws.Lphi, z1)
        K1 = calc_K(ws.v)
        H1 = S1 + K1
        dH = H1 - ws.H0
        Pacc = torch.minimum(torch.ones_like(dH), torch.exp(-dH))
        accept = (ws.uniform.to(Pacc) < Pacc) & (flag == 0)
        acc = accept[:, None, None]
        nsolves = (2 * cfg.Nt if two_mn else cfg.Nt) + 2
        for name, val in (("out_x", torch.where(acc, ws.x, ws.x0)),
                          ("out_v", torch.where(acc, ws.v, -ws.v0)), ("accepted", accept),
                          ("mean_iters", (iters + nsolves // 2) // nsolves),
                          ("out_flag", flag), ("delta_H", dH), ("H1", H1), ("S1", S1),
                          ("K1", K1)):
            ws.put(name, val)

    def segments(ws):
        """Every segment once, in the order of a first update whose solves
        each stop after one CG block (the warm-up and the capture order)."""
        s1, s2 = solver(tol1), solver(tol2)
        seq = [("start", lambda: seg_start(ws)), *s2.segments(ws, tol2),
               ("first", lambda: seg_first(ws)), *s1.segments(ws, tol1)]
        if two_mn:
            seq += [("mid", lambda: seg_mid(ws)), *s1.segments(ws, tol1)]
        if cfg.Nt > 1:
            seq += [("step", lambda: seg_step(ws)), *s1.segments(ws, tol1)]
        return seq + [("last", lambda: seg_last(ws)), *s2.segments(ws, tol2),
                      ("end", lambda: seg_end(ws))]

    def inputs(params, state: HMCState, dt, generator, draws):
        """The update's workspace with its inputs copied in, its graphs
        warmed up and captured on the first call."""
        x = state.x
        if x.ndim != 3:
            raise ValueError(f"state.x must be [C, Nph, Ltau], got {tuple(x.shape)}")
        if draws is None:
            draws = draw(ops, x.shape[0], x.dtype, x.device, generator,
                         field_dtype(params, x.dtype))
        if deflating:
            check_deflation(params, state)
        ws = graphs.step_workspace(box, params, x)
        dev = x.device
        if deflating:
            # the caller's basis; the refresh reads its W, pvec and lam_max
            # (its chol, float32 from init_deflation and in the field dtype
            # after a refresh, is rebuilt)
            ws.put("defl_in", state.defl)
        if cfg.log_verbose and "k" not in ws:
            ws.put("k", torch.zeros(1, dtype=torch.int64, device=dev))
        ws.put("x0", x)
        ws.put("v_in", state.v)
        ws.put("momentum", draws.momentum.to(x))
        ws.put("pseudofermion", draws.pseudofermion.to(dev))
        ws.put("uniform", draws.uniform.to(device=dev, dtype=torch.float64))
        if dynamic_dt:
            ws.put("dt", (dt if torch.is_tensor(dt) else torch.tensor(dt, dtype=torch.float64))
                   .to(dev))
        if precond is not None:
            ws.put_start(draws.kpm_start if draws.kpm_start is not None else precond.start)
        ws.capture_once(lambda: segments(ws))
        return ws

    # the span of each segment of the update's own (the solves' are theirs)
    seg_spans = {name: f"hmc.seg.{name}" for name in ("start", "first", "mid", "step", "last",
                                                       "end")}

    def graphed(params, state: HMCState, dt, generator, draws):
        """The segmented update: the spans ``hmc.inputs``, ``hmc.seg.<name>``
        for each of its own segments, ``solve`` for each solve and
        ``hmc.outputs``."""
        with spans.span("hmc.inputs"):
            ws = inputs(params, state, dt, generator, draws)

        def run(name, fn):
            with spans.span(seg_spans[name]):
                ws.run(name, fn)

        s1, s2 = solver(tol1), solver(tol2)
        run("start", lambda: seg_start(ws))
        s2.solve(ws, tol2)
        run("first", lambda: seg_first(ws))
        for k in range(cfg.Nt):
            s1.solve(ws, tol1)
            if two_mn:
                run("mid", lambda: seg_mid(ws))
                s1.solve(ws, tol1)
            if k + 1 < cfg.Nt:
                run("step", lambda: seg_step(ws))
        run("last", lambda: seg_last(ws))
        s2.solve(ws, tol2)
        run("end", lambda: seg_end(ws))

        with spans.span("hmc.outputs"):
            stats = HMCStats(accepted=ws.accepted.clone(), iters=ws.mean_iters.clone(),
                             flag=ws.out_flag.clone(), delta_H=ws.delta_H.clone(),
                             H=ws.H1.clone(), S=ws.S1.clone(), K=ws.K1.clone())
            if cfg.log_verbose:
                stats = replace(stats, traj_H=ws.traj_H.clone(), traj_S=ws.traj_S.clone(),
                                traj_K=ws.traj_K.clone(), traj_iters=ws.traj_iters.clone())
            defl = state.defl
            if deflating:
                # the refreshed basis, kept on a reject too, as new tensors
                defl = replace(ws.defl, **{name: getattr(ws.defl, name).clone()
                                           for name in ("W", "chol", "pvec", "lam_max")})
            return HMCState(x=ws.out_x.clone(), v=ws.out_v.clone(), defl=defl), stats

    def update(params, state: HMCState, dt, generator, draws):
        """The graphed update where the configuration is in its slice and
        the device can hold it (:func:`.graphs.graphable`), inside the root
        span ``hmc.update``, else the eager one."""
        if segmented and graphs.graphable(ops.shard, state.x.device):
            with spans.root("hmc.update", state.x.device):
                return graphed(params, state, dt, generator, draws)
        return _step(params, state, dt, generator, draws)

    def draw_update(params, x, n_chains: int, generator=None) -> HMCDraws:
        """The draws of one update of ``n_chains`` chains like ``x``."""
        return draw(ops, n_chains, x.dtype, x.device, generator, field_dtype(params, x.dtype))

    if dynamic_dt:
        def dyn_step(params, state: HMCState, dt, generator: torch.Generator | None = None,
                     draws: HMCDraws | None = None):
            return update(params, state, dt, generator, draws)
        dyn_step.draw = draw_update
        dyn_step.segmented = segmented
        dyn_step.workspace = lambda: box.get("ws")
        return dyn_step

    def step(params, state: HMCState, generator: torch.Generator | None = None,
             draws: HMCDraws | None = None):
        return update(params, state, cfg.dt, generator, draws)

    step.draw = draw_update
    step.segmented = segmented
    step.workspace = lambda: box.get("ws")
    return step


# --- burn-in step-size tuning: Nesterov dual averaging (Hoffman & Gelman
# 2014, "The No-U-Turn Sampler", §3.2) toward a mean acceptance

@dataclass(frozen=True)
class DtTunerState:
    """Dual-averaging state, float32 0-dim tensors on the device (the update
    runs there, with no host read)."""

    m: torch.Tensor            # tuning-iteration count
    log_dt: torch.Tensor       # current (exploring) log step size
    log_dt_avg: torch.Tensor   # averaged iterate: the value to freeze
    h_bar: torch.Tensor        # running mean of (target − acceptance)
    mu: torch.Tensor           # shrinkage point log(10·dt₀)
    lo: torch.Tensor           # clamp bounds on log_dt
    hi: torch.Tensor

    def as_list(self) -> list[float]:
        """The seven values (one host read), for a checkpoint."""
        return torch.stack([self.m, self.log_dt, self.log_dt_avg, self.h_bar, self.mu,
                            self.lo, self.hi]).cpu().tolist()

    @classmethod
    def from_list(cls, vals, device="cuda") -> "DtTunerState":
        device = require_device(device)
        return cls(*(torch.tensor(float(v), dtype=torch.float32, device=device) for v in vals))


def dt_tuner_init(dt0: float, lo: float | None = None, hi: float | None = None,
                  device="cuda") -> DtTunerState:
    """The tuner at step size ``dt0``, clamped to [dt0/64, 64·dt0] unless
    ``lo`` / ``hi`` say otherwise."""
    lo = dt0 / 64.0 if lo is None else lo
    hi = dt0 * 64.0 if hi is None else hi
    return DtTunerState.from_list([0.0, np.log(dt0), np.log(dt0), 0.0, np.log(10.0 * dt0),
                                   np.log(lo), np.log(hi)], device)


def dt_tuner_update(t: DtTunerState, accept_prob, target: float, gamma: float = 0.05,
                    t0: float = 10.0, kappa: float = 0.75) -> DtTunerState:
    """One dual-averaging step toward mean acceptance ``target``;
    ``accept_prob`` is the chain-mean min(1, e^{−ΔH}) of the update just
    taken at exp(t.log_dt) (a 0-dim tensor or a number), used in float32."""
    p = torch.as_tensor(accept_prob, device=t.m.device).to(torch.float32)
    m = t.m + 1.0
    w = 1.0 / (m + t0)
    h_bar = (1.0 - w) * t.h_bar + w * (target - p)
    log_dt = torch.clamp(t.mu - torch.sqrt(m) / gamma * h_bar, t.lo, t.hi)
    eta = m ** (-kappa)
    log_dt_avg = eta * log_dt + (1.0 - eta) * t.log_dt_avg
    return replace(t, m=m, h_bar=h_bar, log_dt=log_dt, log_dt_avg=log_dt_avg)


def init_deflation(ops: ModelOps, cfg: HMCConfig, n_chains: int,
                   generator: torch.Generator | None = None, params=None,
                   device="cuda") -> deflation.DeflationState | None:
    """A fresh per-chain deflation basis for ``HMCState.defl`` (None when
    ``cfg.deflate_k`` is 0): float32, complex64 when ``params`` have complex
    hopping (the Hermitian projector). ``ops`` is the whole model: a
    site-sharded run cuts this basis to its block
    (:func:`..ops.deflation.cut`)."""
    if cfg.deflate_k <= 0:
        return None
    dtype = (torch.complex64 if params is not None and params_are_complex(params)
             else torch.float32)
    return deflation.init(n_chains, cfg.deflate_k, ops.Nsites, ops.Ltau, dtype=dtype,
                          device=device, generator=generator)
