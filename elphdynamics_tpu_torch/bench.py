"""The port's main paths: one Holstein HMC update with the KPM-CG solver,
batched over chains, as the JAX package's ``bench.py`` times it; the SSH
update; and one Langevin time step of either model.

Model: square lattice, t = 1 on both bonds, ω = 1, λ = 1, μ = 0; Fourier
mass block ω ∈ (0, 10) with m = 0.5; HMC with trajectory time 1, Nb = 4,
tol 1e-5, maxiter 500, cubic warm starts; symmetric KPM at max_order 4;
half-filled initial phonons. Three configurations use it:

* ``BENCH_8X8``: 8×8, β = 4, Δτ = 0.1 (Lτ = 40), dt = 0.05, 128 chains —
  the dense branch (no kernel);
* ``BENCH_32X32``: the same at 32×32 (N = 1024), 32 chains, the second
  row of the JAX package's ``bench.py`` — the dense branch;
* ``KERNEL_64X64``: 64×64 (N = 4096), β = 4, Δτ = 0.1, dt = 0.025, 16
  chains — the checkerboard-fold branch, which runs the CUDA kernel on a
  card for both exp(−Δτ·K) and the KPM Ā.

The optical SSH update (``scripts/bench_ssh.py`` of the JAX package):
square lattice, bonds x and y with t = 1, α = 0.25, ω = 0.5, μ = 0;
Fourier mass block ω ∈ (0, 10) with m = 0.5; HMC with trajectory time 1,
Nb = 4, tol 1e-5, maxiter 500, cubic warm starts; symmetric KPM at
max_order 8; half-filled initial phonons; β = 4, Δτ = 0.1 (Lτ = 40).

* ``SSH_8X8``: 8×8, dt = 0.05, 64 chains, the JAX package's own SSH bench
  (``scripts/bench_ssh.py``) — the dense-Ā branch: on a card the fermion
  operator runs the fold kernel with per-(chain, bond, τ) coefficients, and
  every KPM refresh re-densifies each chain's Ā by the fold kernel with
  per-chain tables on a ``[C, N, N]`` identity;
* ``SSH_64X64``: 64×64, dt = 0.025, 8 chains (N = 4096, Nb = Nph = 8192, 4
  groups) — on a card the fermion operator runs the fold kernel with
  per-(chain, bond, τ) coefficients, the KPM Ā its per-chain tables, and
  every Chebyshev step the fused kernel.

Both SSH updates replay CUDA graphs on a card, as the Holstein ones do.

Twisted boundaries (complex hopping), the twist [π/4, π/8] of
``examples/*_hmc_twisted.toml``: every fold of a complex field runs the
fold kernel's complex mode (the fused Chebyshev step is real-only, so the
complex KPM recurrence is the fold plus elementwise passes).

* ``TWISTED_64X64``: ``KERNEL_64X64`` twisted, 16 chains — ``[Nb]`` tables
  for the fermion operator and Ā;
* ``SSH_TWISTED_64X64``: ``SSH_64X64`` twisted, 8 chains — ``[C, Nb, K]``
  tables for the fermion operator, ``[C, Nb]`` for Ā;
* ``TWISTED_LANGEVIN_64X64``: ``LANGEVIN_64X64`` twisted, 16 chains.

All three replay CUDA graphs on a card, as the real ones do;
:meth:`BenchStep.eager` and :meth:`LangevinBench.eager` are the eager twins.

The deep-β samplers on ``KERNEL_64X64``'s model (16 chains, N = 4096):

* ``KERNEL_2MN_64X64``: the 2MN integrator at dt = 0.05 — the same
  trajectory length, so 20 steps of two solves (42 solves per update, as
  leapfrog's 40 steps at dt = 0.025 make);
* ``TEMPERING_64X64``: 16 chains = 4 rungs × 4 lanes on the ladder (1.0,
  0.9, 0.8, 0.7), λ and λ₂ per chain (K2's per-chain ``pre`` / ``post``
  diagonals; the hopping tables stay ``[Nb]``), an exchange attempt every 2
  updates (:attr:`BenchStep.exchange`).

Both replay CUDA graphs on a card, the exchange too;
:meth:`BenchStep.eager` and :meth:`BenchStep.eager_exchange` are the eager
twins. :func:`shard_bench_step` cuts a step to a rank's chains or sites,
graphed either way (a site shard's collectives inside its graphs on NCCL
ranks; eager on a gloo site group on a card).

``DEEP_BETA_64X64`` (:func:`build_deep_beta_solves`) builds solves, not an
update: the Holstein model at 64×64, β = 16, Δτ = 0.1 (Lτ = 160), 4
chains, KPM ``max_order`` 8 (the stock deep-β example's), tol 1e-5,
from-zero solves of MᵀM·z = Mᵀ·R (2 spins per chain) at a τ-rough field
(half-filled worldlines plus free-phonon τ-fluctuations) by plain KPM-CG,
with slow-mode deflation (k 32, filter degree 8, 4 power steps, cutoff
1/16; the basis, in the field dtype, refreshed 4 times first) and with the
near-null preconditioner (k 16, c 4): K1 and K2 at K = Lτ = 160, and the
deflation filter's ``[4, 32, 4096, 160]`` batches.

Langevin dynamics (Runge-Kutta steps, dt = 1e-3, Fourier acceleration block
ω ∈ (0, 10) with m = 0.5, solver tol 1e-5, maxiter 500; a step is two force
solves of MᵀM·z = Mᵀg, no Metropolis test):

* ``LANGEVIN_64X64``: the Holstein model and KPM of ``KERNEL_64X64``, 16
  chains;
* ``SSH_LANGEVIN_64X64``: the SSH model and KPM of ``SSH_64X64``, 8 chains.

Both replay CUDA graphs on a card (the graphed Langevin step,
``dynamics/langevin.py``); :meth:`LangevinBench.eager` is the eager twin.

The nonsymmetric solvers (``BenchConfig.solver``; restart 20 for GMRES,
the JAX package's settings otherwise: tol 1e-5, tol² at the HMC endpoints,
maxiter 500), each (MᵀM)⁻¹ of an update two solves in sequence, Mᵀ with
the right KPM apply and then M with the left one, and the Langevin force's
M⁻¹ one solve with the left apply:

* ``GMRES_64X64`` and ``BICGSTAB_64X64``: ``KERNEL_64X64`` by GMRES and by
  BiCGStab;
* ``GMRES_LANGEVIN_64X64``: ``LANGEVIN_64X64`` by GMRES.

All three replay CUDA graphs on a card (``dynamics/graphs.NonsymSolve``),
with K1 in M and Mᵀ and K2 in the KPM applies.
:func:`build_langevin_example` builds a stock ``[langevin]`` file's step
as the driver does (``examples/holstein_langevin_square.toml``: 4×4, β = 2,
RK, KPM max_order 64).

:func:`build_hmc_example` builds a stock ``[hmc]`` file's whole driver
step as the driver does on one card: the HMC update, the reflection and
swap moves and the measurement (``examples/holstein_hmc_square.toml``: 4×4,
β = 2, 100 leapfrog steps of 10 bosonic substeps, 4 reflections and 4
swaps, nᵥ = 10 probes, KPM max_order 8; ``ssh_hmc_square.toml`` the same
with 4 swaps and KPM max_order 64; the twisted ``holstein_hmc_twisted.toml``
and ``ssh_hmc_twisted.toml``: 4×4, β = 4, complex hopping, no moves,
CurrentCurrent measured). All four parts replay CUDA graphs on a card,
under complex hopping too; :meth:`HMCExample.eager` is the eager twin.
:func:`wide_hmc_config` widens such a file to 64×64, β = 4 (dt 0.025, 4
bosonic substeps, nᵥ = 10, a measurement per update), where K1 (and for a
real field K2) runs inside every part.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field, fields, replace

import torch

from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.hmc import (
    HMCConfig, HMCState, init_deflation, make_hmc_step)
from elphdynamics_tpu_torch.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, precond_applies, solve_oinv
from elphdynamics_tpu_torch.dynamics.special_updates import (
    make_reflection_update, make_swap_update)
from elphdynamics_tpu_torch.dynamics.tempering import (
    TemperingConfig, chain_params, ladder_params, make_exchange_step)
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure.measurements import make_measurement_step
from elphdynamics_tpu_torch.models.adapter import ModelOps, make_model_ops
from elphdynamics_tpu_torch.models.holstein import HolsteinParams, build_holstein
from elphdynamics_tpu_torch.models.ssh import SSHParams, build_ssh
from elphdynamics_tpu_torch.ops import deflation, kpm
from elphdynamics_tpu_torch.ops.fourier_accel import build_Q, build_mass
from elphdynamics_tpu_torch.ops.nearnull import NearNullConfig, make_nearnull_precond
from elphdynamics_tpu_torch.solvers import SolveResult
from elphdynamics_tpu_torch.utils.device import require_device


@dataclass(frozen=True)
class BenchConfig:
    name: str
    L: int
    beta: float
    dtau: float
    dt: float
    n_chains: int
    model: str = "holstein"
    sampler: str = "hmc"       # "hmc" | "langevin"
    method: str = "rk"         # the Langevin scheme
    twist: tuple | None = None  # twisted-boundary flux angles (complex hopping)
    integrator: str = "leapfrog"
    ladder: tuple | None = None  # parallel-tempering coupling ladder (rung-major chains)
    # the CG solver aids: block CG over the spins, a deflation basis of
    # deflate_k fields, the near-null preconditioner (k, c), the KPM's exact
    # low-frequency blocks
    block: bool = False
    deflate_k: int = 0
    nearnull: tuple | None = None
    exact_lowfreq: int = 0
    # the solver kind ("cg", "bicgstab", "gmres") and GMRES's restart length
    solver: str = "cg"
    restart: int = 20


BENCH_8X8 = BenchConfig("bench_8x8", L=8, beta=4.0, dtau=0.1, dt=0.05, n_chains=128)
BENCH_32X32 = BenchConfig("bench_32x32", L=32, beta=4.0, dtau=0.1, dt=0.05, n_chains=32)
KERNEL_64X64 = BenchConfig("kernel_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025, n_chains=16)
SSH_8X8 = BenchConfig("ssh_8x8", L=8, beta=4.0, dtau=0.1, dt=0.05, n_chains=64, model="ssh")
SSH_64X64 = BenchConfig("ssh_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025, n_chains=8,
                        model="ssh")
LANGEVIN_64X64 = BenchConfig("langevin_64x64", L=64, beta=4.0, dtau=0.1, dt=1e-3, n_chains=16,
                             sampler="langevin")
SSH_LANGEVIN_64X64 = BenchConfig("ssh_langevin_64x64", L=64, beta=4.0, dtau=0.1, dt=1e-3,
                                 n_chains=8, model="ssh", sampler="langevin")
TWIST = (math.pi / 4, math.pi / 8)
TWISTED_64X64 = BenchConfig("twisted_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025, n_chains=16,
                            twist=TWIST)
SSH_TWISTED_64X64 = BenchConfig("ssh_twisted_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025,
                                n_chains=8, model="ssh", twist=TWIST)
TWISTED_LANGEVIN_64X64 = BenchConfig("twisted_langevin_64x64", L=64, beta=4.0, dtau=0.1,
                                     dt=1e-3, n_chains=16, sampler="langevin", twist=TWIST)
KERNEL_2MN_64X64 = BenchConfig("kernel_2mn_64x64", L=64, beta=4.0, dtau=0.1, dt=0.05,
                               n_chains=16, integrator="2mn")
TEMPERING_64X64 = BenchConfig("tempering_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025,
                              n_chains=16, ladder=(1.0, 0.9, 0.8, 0.7))
EXCHANGE_FREQ = 2   # updates per exchange attempt under a ladder
BLOCK_64X64 = BenchConfig("block_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025, n_chains=16,
                          block=True)
DEFLATED_64X64 = BenchConfig("deflated_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025,
                             n_chains=16, deflate_k=32)
NEARNULL_64X64 = BenchConfig("nearnull_64x64", L=64, beta=4.0, dtau=0.1, dt=0.025,
                             n_chains=16, nearnull=(16, 4))
LOWFREQ_32X32 = BenchConfig("lowfreq_32x32", L=32, beta=4.0, dtau=0.1, dt=0.05, n_chains=32,
                            exact_lowfreq=4)
GMRES_64X64 = replace(KERNEL_64X64, name="gmres_64x64", solver="gmres")
BICGSTAB_64X64 = replace(KERNEL_64X64, name="bicgstab_64x64", solver="bicgstab")
GMRES_LANGEVIN_64X64 = replace(LANGEVIN_64X64, name="gmres_langevin_64x64", solver="gmres")


@dataclass(frozen=True)
class BenchStep:
    ops: ModelOps
    params: HolsteinParams | SSHParams
    step: object            # step(params, state, generator) -> (state, stats)
    state: HMCState         # initial state
    generator: torch.Generator
    # under a ladder: exchange(params, x, v, parity, generator) -> (x, v,
    # acceptance, iterations, flag), attempted every ``exchange_freq`` updates
    exchange: object = None
    exchange_freq: int = 0
    # what the step was built from (for :func:`shard_bench_step`)
    mass: object = None
    hmc_cfg: HMCConfig | None = None
    kpm_cfg: kpm.KPMConfig | None = None
    tcfg: TemperingConfig | None = None
    nearnull_cfg: NearNullConfig | None = None

    def precond(self):
        """A new preconditioner of the step's configuration (KPM, or the
        near-null one): the same fixed start vectors and test vectors."""
        return _make_precond(self.ops, self.kpm_cfg, self.nearnull_cfg)

    def eager(self):
        """The same update asked for eager: the same model, and a
        preconditioner of the same configuration (the same fixed start
        vectors), so the same draws give the same update."""
        return make_hmc_step(self.ops, self.mass, self.hmc_cfg, self.precond(), eager=True)

    def eager_exchange(self):
        """Under a ladder, the exchange asked for eager, as :meth:`eager`
        builds the update (on the same chain block)."""
        return make_exchange_step(self.ops, self.tcfg, self.exchange.n_chains, self.precond(),
                                  chains=self.exchange.chains, eager=True)


@dataclass(frozen=True)
class LangevinBench:
    ops: ModelOps
    params: HolsteinParams | SSHParams
    step: object            # step(params, x, generator) -> (x, stats)
    x: torch.Tensor         # initial fields [C, Nph, Lτ]
    generator: torch.Generator
    precond: object         # the step's kpm.Preconditioner
    # what the step was built from
    Q: object               # the [Nph, Lτ] acceleration spectrum
    dt: float
    method: str
    solver: SolverConfig

    def eager(self):
        """The same step asked for eager (the same model and
        preconditioner, so the same draws give the same step)."""
        return make_langevin_step(self.ops, self.Q, self.dt, self.method, self.solver,
                                  self.precond, eager=True)


def build_bench_step(L: int, beta: float, dtau: float, dt: float, n_chains: int,
                     device="cuda", dtype: torch.dtype = torch.float32, *,
                     seed: int = 0, trajectory_time: float = 1.0,
                     dense_threshold: int = 2048,
                     pallas_threshold: int = 2048, twist=None, integrator: str = "leapfrog",
                     ladder=None, **aids) -> BenchStep:
    """Build the model (with ``twist``, twisted boundaries), the
    KPM-preconditioned HMC step (``integrator``) and a half-filled initial
    state of ``n_chains`` chains on ``device`` (the card unless the caller
    asks for the CPU); with a ``ladder``, per-chain couplings and the
    tempering exchange; ``aids`` are :class:`BenchConfig`'s solver aids
    (``block``, ``deflate_k``, ``nearnull``, ``exact_lowfreq``) and its
    solver kind and restart length (``solver``, ``restart``). The step
    (leapfrog or 2MN, real or complex hopping, with any aid) and the
    exchange replay CUDA graphs on the card (``dynamics/graphs.py``)."""
    device = require_device(device)
    spec, params = _holstein_model(L, beta, dtau, dtype, device, dense_threshold,
                                   pallas_threshold, twist)
    return _bench_step(spec, params, dt, n_chains, device, seed, trajectory_time, max_order=4,
                       integrator=integrator, ladder=ladder, **aids)


def build_ssh_step(L: int, beta: float, dtau: float, dt: float, n_chains: int,
                   device="cuda", dtype: torch.dtype = torch.float32, *,
                   seed: int = 0, trajectory_time: float = 1.0, twist=None,
                   integrator: str = "leapfrog", ladder=None, **aids) -> BenchStep:
    """The SSH model (with ``twist``, twisted boundaries), its
    KPM-preconditioned HMC step and a half-filled initial state of
    ``n_chains`` chains on ``device`` (the card unless the caller asks for
    the CPU); ``integrator``, ``ladder`` and ``aids`` as in
    :func:`build_bench_step` (the step and the exchange replay CUDA graphs
    on the card)."""
    device = require_device(device)
    spec, params = _ssh_model(L, beta, dtau, dtype, device, twist)
    return _bench_step(spec, params, dt, n_chains, device, seed, trajectory_time, max_order=8,
                       integrator=integrator, ladder=ladder, **aids)


def build_langevin_step(L: int, beta: float, dtau: float, dt: float, n_chains: int,
                        device="cuda", dtype: torch.dtype = torch.float32, *,
                        model: str = "holstein", method: str = "rk", seed: int = 0,
                        solver: SolverConfig = SolverConfig(tol=1e-5, maxiter=500),
                        dense_threshold: int = 2048,
                        pallas_threshold: int = 2048, twist=None) -> LangevinBench:
    """The Holstein (or SSH) model of the HMC configurations (with
    ``twist``, twisted boundaries), its KPM-preconditioned Langevin step
    (all three applies, so any solver kind runs) and half-filled initial
    fields of ``n_chains`` chains on ``device`` (the card unless the caller
    asks for the CPU)."""
    device = require_device(device)
    if model == "ssh":
        spec, params = _ssh_model(L, beta, dtau, dtype, device, twist)
    else:
        spec, params = _holstein_model(L, beta, dtau, dtype, device, dense_threshold,
                                       pallas_threshold, twist)
    ops = make_model_ops(spec)
    Q = build_Q(params.omega.double().cpu().numpy(), spec.dtau, spec.Ltau,
                [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    precond = kpm.make_precond(ops, kpm.KPMConfig(max_order=8 if model == "ssh" else 4))
    return _langevin_bench(ops, params, Q, dt, method, solver, precond, n_chains, device, seed)


def build_langevin_example(path: str, n_chains: int = 1, device="cuda",
                           dtype: torch.dtype = torch.float32, seed: int = 0) -> LangevinBench:
    """The Langevin step of the input file ``path`` (a ``[langevin]`` TOML
    such as ``examples/holstein_langevin_square.toml``) as the driver builds
    it on one card, its model drawn from ``seed``, and half-filled initial
    fields of ``n_chains`` chains on ``device``."""
    from elphdynamics_tpu_torch.io.config import build_setup, load_toml

    device = require_device(device)
    cfg = load_toml(path)
    cfg["simulation"]["random_seed"] = seed
    setup = build_setup(cfg, "", device, dtype)
    if setup.dynamics_type != "langevin":
        raise ValueError(f"{path}: not a [langevin] input file")
    ops = setup.ops
    precond = kpm.make_precond(ops, setup.kpm_cfg) if setup.kpm_cfg is not None else None
    return _langevin_bench(ops, setup.params, setup.fa_Q, setup.langevin_dt,
                           setup.langevin_method, setup.solver_cfg, precond, n_chains, device,
                           seed)


@dataclass(frozen=True)
class HMCExample:
    """One sampling step of a stock ``[hmc]`` input file as the driver runs
    it on one card: the HMC update, the reflection and swap moves, the
    measurement (``simulation._run``'s ``sim_step``, ``reflect``, ``swap``
    and ``mstep``, one preconditioner shared by all four)."""

    ops: ModelOps
    params: HolsteinParams | SSHParams
    setup: object           # the file's io.config.SimulationSetup
    precond: object         # the kpm.Preconditioner (None without one)
    step: object            # step(params, state, generator) -> (state, stats)
    reflect: object         # reflect(params, x, generator) -> (x, acceptance)
    swap: object            # swap(params, x, generator) -> (x, acceptance)
    measure: object         # measure(params, x, generator) -> (increments, stats, snapshots)
    state: HMCState         # initial state
    generator: torch.Generator

    def eager(self) -> "HMCExample":
        """The same step with every part asked for eager (the same model,
        preconditioner, state and generator, so the same draws give the same
        results)."""
        return _hmc_parts(self.setup, self.precond, self.state, self.generator, eager=True)


def wide_hmc_config(cfg: dict) -> dict:
    """A copy of the parsed ``[hmc]`` input file ``cfg`` at full width: L = 64,
    β = 4, dt = 0.025 with 4 bosonic substeps (the same trajectory time),
    nᵥ = 10 probes and a measurement after every update."""
    wide = copy.deepcopy(cfg)
    wide["lattice"]["L"] = 64
    wide["holstein" if "holstein" in wide else "ssh"]["beta"] = 4.0
    wide["hmc"].update(dt=0.025, num_multitimesteps=4, meas_freq=1)
    wide["measurements"]["num_random_vectors"] = 10
    return wide


def build_hmc_example(config, n_chains: int = 1, device="cuda",
                      dtype: torch.dtype = torch.float32, seed: int = 0,
                      eager: bool = False, chain_block: int | None = None) -> HMCExample:
    """The driver step of the ``[hmc]`` input file ``config`` (a path such as
    ``examples/holstein_hmc_square.toml``, or a parsed file, which is not
    changed) as the driver builds it on one card, its model drawn from
    ``seed``, and half-filled initial fields of ``n_chains`` chains on
    ``device`` (0: as many as the driver's ``--chains 0`` takes); ``eager`` asks for every part's eager form, ``chain_block``
    sets the measurement's chains per pass of its estimators (None: as the
    driver sizes them)."""
    from elphdynamics_tpu_torch.io.config import build_setup, load_toml

    device = require_device(device)
    cfg = load_toml(config) if isinstance(config, str) else copy.deepcopy(config)
    cfg["simulation"]["random_seed"] = seed
    setup = build_setup(cfg, "", device, dtype)
    if setup.dynamics_type != "hmc":
        raise ValueError(f"{config if isinstance(config, str) else 'config'}: "
                         "not an [hmc] input file")
    precond = kpm.make_precond(setup.ops, setup.kpm_cfg) if setup.kpm_cfg is not None else None
    gen = torch.Generator(device=device).manual_seed(seed)
    if n_chains == 0:
        from elphdynamics_tpu_torch.simulation import auto_chains

        n_chains = auto_chains(setup.ops.Nsites, setup.ops.Ltau, 1, setup.ops.is_holstein)
    x = init_phonons_half_filled(setup.ops, setup.params, n_chains, gen)
    return _hmc_parts(setup, precond, HMCState(x=x, v=torch.zeros_like(x)), gen, eager,
                      chain_block)


def _hmc_parts(setup, precond, state, gen, eager: bool,
               chain_block: int | None = None) -> HMCExample:
    ops = setup.ops
    return HMCExample(
        ops=ops, params=setup.params, setup=setup, precond=precond,
        step=make_hmc_step(ops, setup.fa_mass, setup.hmc_cfg, precond, eager=eager),
        reflect=make_reflection_update(ops, setup.reflect_cfg, precond, eager=eager),
        swap=make_swap_update(ops, setup.swap_cfg, precond, eager=eager),
        measure=make_measurement_step(ops, setup.mspec, setup.solver_cfg, precond, eager=eager,
                                      chain_block=chain_block),
        state=state, generator=gen)


def _langevin_bench(ops, params, Q, dt, method, solver, precond, n_chains, device,
                    seed) -> LangevinBench:
    gen = torch.Generator(device=device).manual_seed(seed)
    return LangevinBench(ops=ops, params=params,
                         step=make_langevin_step(ops, Q, dt, method, solver, precond),
                         x=init_phonons_half_filled(ops, params, n_chains, gen), generator=gen,
                         precond=precond, Q=Q, dt=dt, method=method, solver=solver)


def _holstein_model(L, beta, dtau, dtype, device, dense_threshold, pallas_threshold,
                    twist=None):
    return build_holstein(
        _square(L), beta=beta, dtau=dtau,
        t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))],
        omega=1.0, lam=1.0, mu=0.0, dtype=dtype, device=device,
        dense_threshold=dense_threshold, pallas_threshold=pallas_threshold, twist=twist)


def _ssh_model(L, beta, dtau, dtype, device, twist=None):
    hop = dict(t=1.0, alpha=0.25, omega=0.5, o1=0, o2=0)
    return build_ssh(
        _square(L), beta, dtau,
        hoppings=[dict(hop, dL=(1, 0, 0), name="x"), dict(hop, dL=(0, 1, 0), name="y")],
        mu_assignments=[(0.0, 0.0, None)], twist=twist, dtype=dtype, device=device)


def _square(L: int) -> Lattice:
    return Lattice.create(UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]]), L)


def _make_precond(ops, kcfg: kpm.KPMConfig, ncfg: NearNullConfig | None):
    """The KPM preconditioner of ``kcfg`` (all three applies), or with
    ``ncfg`` the near-null one over it."""
    if ncfg is not None:
        return make_nearnull_precond(ops, kcfg, ncfg)
    return kpm.make_precond(ops, kcfg)


def _bench_step(spec, params, dt, n_chains, device, seed, trajectory_time, max_order: int,
                integrator: str = "leapfrog", ladder=None, block: bool = False,
                deflate_k: int = 0, nearnull=None, exact_lowfreq: int = 0, solver: str = "cg",
                restart: int = 20) -> BenchStep:
    ops = make_model_ops(spec)
    mass = build_mass(params.omega.double().cpu().numpy(), spec.dtau, spec.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(dt=dt, trajectory_time=trajectory_time, Nb=4, tol=1e-5,
                    maxiter=500, construct_guess=True, guess_order=3, integrator=integrator,
                    block=block, deflate_k=deflate_k, solver_kind=solver, restart=restart)
    kcfg = kpm.KPMConfig(max_order=max_order, exact_lowfreq=exact_lowfreq)
    ncfg = None if nearnull is None else NearNullConfig(k=nearnull[0], c=nearnull[1])
    precond = _make_precond(ops, kcfg, ncfg)
    step = make_hmc_step(ops, mass, cfg, precond)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = init_phonons_half_filled(ops, params, n_chains, gen)
    # the deflation basis from its own seed, the main stream left as it is
    defl = init_deflation(ops, cfg, n_chains, torch.Generator(device=device).manual_seed(
        seed + 7919), params=params, device=device)
    exchange = None
    if ladder is not None:
        tcfg = TemperingConfig(ladder=tuple(ladder), freq=EXCHANGE_FREQ, tol=cfg.tol,
                               maxiter=cfg.maxiter)
        params = ladder_params(params, tcfg, n_chains)
        exchange = make_exchange_step(ops, tcfg, n_chains, precond)
    return BenchStep(ops=ops, params=params, step=step,
                     state=HMCState(x=x, v=torch.zeros_like(x), defl=defl), generator=gen,
                     exchange=exchange, exchange_freq=EXCHANGE_FREQ if exchange else 0,
                     mass=mass, hmc_cfg=cfg, kpm_cfg=kcfg,
                     tcfg=None if exchange is None else tcfg, nearnull_cfg=ncfg)


def shard_bench_step(b: BenchStep, shard=None, chains=None) -> BenchStep:
    """A :class:`BenchStep` on this rank's part of a run: its block of sites
    (``shard``, a :class:`..parallel.lattice_shard.SiteShard`; Holstein or
    SSH, the halo fold, no kernel) and of chains (``chains``, a
    :class:`..parallel.chains.ChainBlock`: the whole batch's draws cut to
    the block, a ladder's exchange across the chain ranks). Its parameters
    and initial state are cut; the generator is shared."""
    from elphdynamics_tpu_torch.parallel.lattice_shard import shard_model

    ops, params, x, v, defl = b.ops, b.params, b.state.x, b.state.v, b.state.defl
    if shard is not None:
        spec, params = shard_model(ops.spec, params, shard)
        ops = make_model_ops(spec)
        if ops.is_holstein:
            x, v = shard.local(x), shard.local(v)
        if defl is not None:
            defl = deflation.cut(defl, shard.local)
    precond = _make_precond(ops, b.kpm_cfg, b.nearnull_cfg)
    # graphed: a chain block's update replays the one-card graphs, a site
    # shard's holds its site group's collectives (captured under NCCL; a
    # gloo site group on a card runs it eagerly, dynamics/graphs.graphable)
    step = make_hmc_step(ops, b.mass, b.hmc_cfg, precond)
    exchange = None
    if b.tcfg is not None:
        exchange = make_exchange_step(ops, b.tcfg, b.state.x.shape[0], precond, chains=chains)
    if chains is not None:
        params = chain_params(params, chains.lo, chains.n)
        x, v = chains.local(x), chains.local(v)
        if defl is not None:
            defl = chains.local(defl)
        run = chains.wrap(step)

        def step(params, state, generator=None):
            return run(params, state, generator=generator)

        step.segmented, step.workspace = run.segmented, run.workspace
    return BenchStep(ops=ops, params=params, step=step, state=HMCState(x=x, v=v, defl=defl),
                     generator=b.generator, exchange=exchange, exchange_freq=b.exchange_freq,
                     mass=b.mass, hmc_cfg=b.hmc_cfg, kpm_cfg=b.kpm_cfg, tcfg=b.tcfg,
                     nearnull_cfg=b.nearnull_cfg)


@dataclass(frozen=True)
class DeepBetaConfig:
    name: str
    L: int
    beta: float
    dtau: float
    n_chains: int
    max_order: int = 8
    tol: float = 1e-5
    maxiter: int = 4000
    deflation: deflation.DeflationConfig = deflation.DeflationConfig()   # k 32, 8, 4, 1/16
    refreshes: int = 4            # deflation-basis refreshes before the solves
    nearnull: NearNullConfig = NearNullConfig()                           # k 16, c 4


DEEP_BETA_64X64 = DeepBetaConfig("deep_beta_64x64", L=64, beta=16.0, dtau=0.1, n_chains=4)
SOLVE_KINDS = ("plain", "deflation", "nearnull")


@dataclass(frozen=True)
class DeepBetaSolves:
    ops: ModelOps
    params: HolsteinParams
    x: torch.Tensor          # [C, N, Lτ] half-filled fields
    rhs: torch.Tensor        # [C, 2, N, Lτ] Mᵀ·R
    cfg: DeepBetaConfig
    seed: int                # the deflation basis's draw
    # the starting basis on the device ("basis"), and per kind the graphed
    # solve's preconditioner, CGSolve and workspace box
    kept: dict = field(default_factory=dict, repr=False, compare=False)

    def _precond(self, kind: str):
        kcfg = kpm.KPMConfig(max_order=self.cfg.max_order)
        return (make_nearnull_precond(self.ops, kcfg, self.cfg.nearnull) if kind == "nearnull"
                else kpm.make_precond(self.ops, kcfg))

    def _basis(self) -> deflation.DeflationState:
        """The starting basis, drawn on the host, so that every device
        starts from one basis; drawn and uploaded once, each prepare's
        refreshes start from it (they leave it as it is)."""
        if "basis" not in self.kept:
            x = self.x
            init = deflation.init(x.shape[0], self.cfg.deflation.k, self.ops.Nsites,
                                  self.ops.Ltau, dtype=x.dtype, device="cpu",
                                  generator=torch.Generator().manual_seed(self.seed))
            self.kept["basis"] = deflation.DeflationState(*(getattr(init, f.name).to(x.device)
                                                            for f in fields(init)))
        return self.kept["basis"]

    def _refreshed(self, defl, apply_P, derived):
        """``defl`` refreshed ``cfg.refreshes`` times at x."""
        p, x, cfg = self.params, self.x, self.cfg
        for _ in range(cfg.refreshes):
            defl = deflation.refresh(defl, lambda v: self.ops.mulMTM(p, derived, v.to(x.dtype)),
                                     apply_P, cfg.deflation)
        return defl

    def prepare(self, kind: str, eager: bool = False):
        """The solve of ``kind`` (one of :data:`SOLVE_KINDS`) made ready:
        its preconditioner set up at ``x`` (and the deflation basis refreshed
        ``cfg.refreshes`` times); returns ``run() -> SolveResult``, a
        from-zero solve of all right-hand sides.

        Graphed unless ``eager``: the set-up (the preconditioner's setup,
        the basis's refreshes and the solve's start, ``solvers.cg_init``)
        is one segment, replayed here, and ``run`` the solve's CG blocks,
        verification and an ``end`` segment that keeps the result
        (:class:`..dynamics.graphs.CGSolve`), on the card as CUDA graphs,
        host reads + 1 replays a call; a kind's workspace, graphs and preconditioner are made
        on its first graphed prepare and kept. The eager form sets up and
        solves through ``dynamics.solve.solve_oinv``, the same arithmetic."""
        if kind not in SOLVE_KINDS:
            raise ValueError(f"unknown solve kind {kind!r} (expected one of {SOLVE_KINDS})")
        if not eager:
            return self._prepare_graphed(kind)
        ops, p, x, cfg = self.ops, self.params, self.x, self.cfg
        precond = self._precond(kind)
        pa = precond_applies(precond, precond.setup(p, x))
        ds = ops.stack(ops.derived(p, x))
        defl = self._refreshed(self._basis(), pa.symmetric, ds) if kind == "deflation" else None
        scfg = SolverConfig(tol=cfg.tol, maxiter=cfg.maxiter)

        def run() -> SolveResult:
            return solve_oinv(ops, p, ds, self.rhs, scfg, pa, deflate=defl)

        return run

    def _prepare_graphed(self, kind: str):
        ops, cfg = self.ops, self.cfg
        deflate = kind == "deflation"
        if kind not in self.kept:
            precond = self._precond(kind)
            scfg = SolverConfig(tol=cfg.tol, maxiter=cfg.maxiter)
            self.kept[kind] = (precond, graphs.CGSolve(
                ops, precond, scfg.maxiter, scfg.kappa_max, scfg.loop_precision, rhs="rhs",
                stacked=True, deflate=deflate), {})
        precond, cg, box = self.kept[kind]
        ws = graphs.step_workspace(box, self.params, self.x)
        ws.put("x", self.x)
        ws.put("rhs", self.rhs)
        ws.put_start(precond.start)
        if deflate:
            ws.put("defl_in", self._basis())

        def setup():
            env = ws.put("env", ops.derived(ws.params, ws.x))
            ws.load("kpm", precond.setup(ws.params, ws.x, ws.kpm_start))
            if deflate:
                ws.load("defl", self._refreshed(
                    ws.defl_in, precond_applies(precond, ws.kpm).symmetric, ops.stack(env)))
            cg.start(ws, cfg.tol)

        def end():
            st = cg.state(ws)
            for name, val in (("out_x", st.x), ("out_iters", st.iters),
                              ("out_residual", ws.verdict.residual),
                              ("out_flag", ws.verdict.flag)):
                ws.put(name, val)

        ws.capture_once(lambda: [("setup", setup), *cg.segments(ws, cfg.tol), ("end", end)])
        ws.run("setup", setup)

        def run() -> SolveResult:
            cg.solve(ws, cfg.tol)
            ws.run("end", end)
            return SolveResult(x=ws.out_x.clone(), iters=ws.out_iters.clone(),
                               residual=ws.out_residual.clone(), flag=ws.out_flag.clone())

        run.workspace = ws
        return run


def build_deep_beta_solves(cfg: DeepBetaConfig = DEEP_BETA_64X64, device="cuda",
                           dtype: torch.dtype = torch.float32, seed: int = 0,
                           dense_threshold: int = 2048,
                           pallas_threshold: int = 2048) -> DeepBetaSolves:
    """The Holstein model of ``cfg`` (``KERNEL_64X64``'s couplings) on
    ``device`` (the card unless the caller asks for the CPU), fields of
    ``cfg.n_chains`` chains (half-filled worldlines with free-phonon
    τ-fluctuations) and the right-hand sides Mᵀ·R of normal R per spin, all
    drawn on the host from ``seed`` (the same inputs on every device)."""
    device = require_device(device)
    spec, params = _holstein_model(cfg.L, cfg.beta, cfg.dtau, dtype, device, dense_threshold,
                                   pallas_threshold)
    ops = make_model_ops(spec)
    C, Lt = cfg.n_chains, ops.Ltau
    g = torch.Generator().manual_seed(seed)
    x = init_phonons_half_filled(ops, params, C, draws=(
        torch.randn((C, ops.Nph), generator=g, dtype=torch.float64),
        torch.randint(-1, 2, (C, ops.Nph), generator=g)))
    # plus τ-fluctuations drawn from the free phonon action Δτ·Σ[ω²x²/2 +
    # (∂τx)²/2], exactly, through its circulant spectrum per site: a sampler's
    # field is rough in τ, and flat worldlines make a far better conditioned
    # operator
    k = torch.arange(Lt // 2 + 1, dtype=torch.float64)
    spectrum = (ops.dtau * params.omega.double().cpu()[:, None] ** 2
                + (2.0 - 2.0 * torch.cos(2.0 * math.pi * k / Lt)) / ops.dtau)
    noise = torch.randn((C, ops.Nph, Lt), generator=g, dtype=torch.float64)
    rough = torch.fft.irfft(torch.fft.rfft(noise, dim=-1) / spectrum.sqrt(), n=Lt, dim=-1)
    x = x + rough.to(device=device, dtype=dtype)
    R = torch.randn((C, 2, ops.Nsites, Lt), generator=g, dtype=torch.float64)
    rhs = ops.mulMT(params, ops.stack(ops.derived(params, x)), R.to(device=device, dtype=dtype))
    return DeepBetaSolves(ops=ops, params=params, x=x, rhs=rhs, cfg=cfg, seed=seed)


def build(cfg: BenchConfig, device="cuda", dtype: torch.dtype = torch.float32,
          **kw) -> BenchStep | LangevinBench:
    """:func:`build_bench_step` (for an SSH configuration
    :func:`build_ssh_step`, for a Langevin one :func:`build_langevin_step`)
    of one configuration."""
    if cfg.sampler == "langevin":
        return build_langevin_step(cfg.L, cfg.beta, cfg.dtau, cfg.dt, cfg.n_chains, device, dtype,
                                   model=cfg.model, method=cfg.method, twist=cfg.twist,
                                   solver=SolverConfig(tol=1e-5, maxiter=500, kind=cfg.solver,
                                                       restart=cfg.restart), **kw)
    make = build_ssh_step if cfg.model == "ssh" else build_bench_step
    return make(cfg.L, cfg.beta, cfg.dtau, cfg.dt, cfg.n_chains, device, dtype, twist=cfg.twist,
                integrator=cfg.integrator, ladder=cfg.ladder, block=cfg.block,
                deflate_k=cfg.deflate_k, nearnull=cfg.nearnull,
                exact_lowfreq=cfg.exact_lowfreq, solver=cfg.solver, restart=cfg.restart, **kw)
