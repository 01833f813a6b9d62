"""Sampler drivers shared by the PyTorch port's exact-diagonalisation
anchors (``tests/test_torch_ed_*.py``) and ``chip_smoke.py``'s float32
single-site phase. Imports no JAX.

Each mirrors a helper of the JAX package's slow tests with the chain axis
explicit: the chains run as one batch (the JAX tests ``vmap`` them), the
per-chain measurement increments are averaged over the chains and summed
over the measurements, and the bin is processed as the driver does.
"""

from __future__ import annotations

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics.hmc import HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.init_phonons import init_phonons_half_filled
from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure.measurements import (
    make_measurement_step, process_bin, zero_container)
from elphdynamics_tpu_torch.models import holstein as H
from elphdynamics_tpu_torch.models import ssh as S
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops.fourier_accel import build_mass, build_Q

FA = [dict(omega_min=0.0, omega_max=10.0, mass=1.0)]
SQUARE = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
SQUARE_HOPS = [(1.0, 0.0, 0, 0, (1, 0, 0)), (1.0, 0.0, 0, 0, (0, 1, 0))]


def single_site(beta=2.0, dtau=0.1, omega=1.0, lam=1.0, mu=-0.5, dtype=torch.float64,
                device="cpu"):
    """The single-site Holstein model (``examples/holstein_hmc_single_site.toml``)."""
    lat = Lattice.create(UnitCell.create(1, 1, [[1.0]], [[0.0]]), 1)
    spec, params = H.build_holstein(lat, beta=beta, dtau=dtau, omega=omega, lam=lam, mu=mu,
                                    dtype=dtype, device=device)
    return make_model_ops(spec), params


def ssh_dimer(beta=2.0, dtau=0.1, t=1.0, alpha=0.5, omega=1.0, device="cpu"):
    """The two-site SSH dimer of ``examples/ssh_hmc_two_site.toml`` (1-D,
    two orbitals, L = 1, one phonon-bearing bond)."""
    lat = Lattice.create(UnitCell.create(1, 2, [[1.0]], [[0.0], [0.5]]), 1)
    spec, params = S.build_ssh(
        lat, beta, dtau,
        hoppings=[dict(t=t, t_std=0.0, alpha=alpha, alpha_std=0.0, alpha2=0.0, alpha2_std=0.0,
                       omega=omega, omega_std=0.0, omega4=0.0, omega4_std=0.0, o1=0, o2=1,
                       dL=(0, 0, 0), name="dimer")],
        mu_assignments=[(0.0, 0.0, 0), (0.0, 0.0, 1)], device=device)
    return make_model_ops(spec), params


def mass_table(ops, params, blocks=FA):
    return build_mass(params.omega.double().cpu().numpy(), ops.dtau, ops.Ltau, blocks)


def q_table(ops, params, blocks=FA):
    return build_Q(params.omega.double().cpu().numpy(), ops.dtau, ops.Ltau, blocks)


def start_fields(ops, params, n_chains, generator):
    x = init_phonons_half_filled(ops, params, n_chains, generator)
    return x.to(params.omega.dtype)


def run_hmc_chains(ops, params, cfg, n_chains, burnin, nsteps, seed=0, precond=None):
    """HMC chains from the half-filled start: ``burnin`` updates, then
    ``nsteps`` recorded ones. Returns every recorded update's fields
    ``[nsteps, C, Nph, Lτ]`` and decisions ``[nsteps, C]`` as numpy."""
    dev = params.omega.device
    g = torch.Generator(device=dev).manual_seed(seed)
    step = make_hmc_step(ops, mass_table(ops, params), cfg, precond)
    x = start_fields(ops, params, n_chains, g)
    state = HMCState(x=x, v=torch.zeros_like(x))
    for _ in range(burnin):
        state, _ = step(params, state, g)
    xs, acc = [], []
    for _ in range(nsteps):
        state, stats = step(params, state, g)
        xs.append(state.x.double().cpu())
        acc.append(stats.accepted.cpu())
    return torch.stack(xs).numpy(), torch.stack(acc).numpy()


def _measure_into(acc: dict, inc: dict) -> None:
    for group, vals in acc.items():
        for k, a in vals.items():
            a.add_(inc[group][k].mean(dim=0))


def run_hmc_with_measurements(ops, params, cfg, mspec, n_chains, burnin, nmeas,
                              meas_every=1, seed=0, precond=None, history=None):
    """The JAX suite's ``run_hmc_with_measurements``: HMC burn-in, then
    ``nmeas`` times ``meas_every`` updates and one measurement (probe
    solves at tol 1e-7); the processed bin and the final state.
    ``history``, a list, receives each measurement's per-chain τ-mean x²
    ``[C]`` and the update's acceptance."""
    dev, dtype = params.omega.device, params.omega.dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    step = make_hmc_step(ops, mass_table(ops, params), cfg, precond)
    mstep = make_measurement_step(ops, mspec, SolverConfig(tol=1e-7, maxiter=2000), precond)
    x = start_fields(ops, params, n_chains, g)
    state = HMCState(x=x, v=torch.zeros_like(x))
    for _ in range(burnin):
        state, _ = step(params, state, g)
    acc = zero_container(ops, mspec, dtype, dev)
    for _ in range(nmeas):
        for _ in range(meas_every):
            state, stats = step(params, state, g)
        inc, _, _ = mstep(params, state.x, g)
        _measure_into(acc, inc)
        if history is not None:
            history.append((state.x.double().pow(2).mean(dim=(1, 2)).cpu(),
                            float(stats.accepted.double().mean())))
    return process_bin(ops, mspec, acc, bin_size=nmeas), state


def run_langevin_with_measurements(ops, params, mspec, n_chains, burnin, nmeas, every, dt,
                                   seed, scfg=SolverConfig(tol=1e-7, maxiter=2000),
                                   precond=None):
    """RK Langevin chains: ``burnin`` steps, then ``nmeas`` times ``every``
    steps and one measurement; the processed bin."""
    dev, dtype = params.omega.device, params.omega.dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    lstep = make_langevin_step(ops, q_table(ops, params), dt=dt, method="rk", scfg=scfg,
                               precond=precond)
    mstep = make_measurement_step(ops, mspec, scfg, precond)
    x = start_fields(ops, params, n_chains, g)
    for _ in range(burnin):
        x, _ = lstep(params, x, g)
    acc = zero_container(ops, mspec, dtype, dev)
    for _ in range(nmeas):
        for _ in range(every):
            x, _ = lstep(params, x, g)
        inc, _, _ = mstep(params, x, g)
        _measure_into(acc, inc)
    return process_bin(ops, mspec, acc, bin_size=nmeas)


def scalar(res, group, key, index=0) -> float:
    a = res[group][key]
    return float(a if a.ndim == 0 else a.reshape(-1)[index])


def site_mean(res, group, key) -> float:
    return float(np.mean(np.asarray(res[group][key].double().cpu())))


def near(name: str, got: float, want: float, tol: float) -> bool:
    """Print one anchor's value beside ED (seen with ``pytest -s``) and
    return whether it lies within ``tol``."""
    print(f"ED {name}: {got:.5f} against {want:.5f}, |diff| {abs(got - want):.5f}, tol {tol}",
          flush=True)
    return abs(got - want) < tol
