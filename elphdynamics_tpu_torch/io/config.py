"""TOML configuration: the same input files as the JAX package.

Counterpart of ``elphdynamics_tpu/io/config.py`` for what the port runs:
``[lattice]``, ``[holstein]`` or ``[ssh]``, ``[[fourier_acceleration]]``,
``[hmc]`` (with ``[hmc.burnin]`` overrides and the reflection / swap
updates; the reflection is Holstein's only) or ``[langevin]`` (``dt``,
``update_method`` 1 Euler / 2 Runge-Kutta / 3 Heun, ``burnin_timesteps``,
``simulation_timesteps``, ``meas_freq``), ``[simulation]``, ``[solver]``
(``type`` CG, BiCGStab or GMRES, ``restart``, ``block``) with
``[solver.preconditioner]`` (``stacked`` and ``exact_lowfreq`` included),
``[tune_density]`` and ``[measurements]`` (PhononGreens is on-site for
Holstein's site phonons, inter-site for SSH's bond phonons; BondBond,
CurrentCurrent and BondPairGreens over pairs of bond definitions). Orbit
indices are 1-based in the files and 0-based here. Complex hopping:
``[holstein] twist`` / ``[ssh] twist`` = [θ1, θ2(, θ3)] (twisted boundaries,
radians) and ``[[holstein.t]] imag`` (t = val + i·imag).

Beyond the reference, as in the JAX package: ``[hmc] integrator = "2mn"``,
``tune_dt`` / ``target_acceptance`` (with ``[hmc.burnin]`` overrides),
``[tempering]`` (``ladder``, ``freq``), ``[solver.deflation]`` (``k``,
``filter_degree``, ``power_iters``, ``cutoff``) and ``[solver.nearnull]``
(CG with ``[solver.preconditioner]`` and real hopping only). ``[solver]
block`` with complex hopping runs Hermitian block CG
(:func:`..solvers.block_cg`).

Disorder is drawn from ``numpy.random.default_rng(random_seed)`` in the
JAX package's order, so one seed builds the same parameters in both.
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.dynamics.special_updates import SpecialUpdateConfig
from elphdynamics_tpu_torch.dynamics.tempering import TemperingConfig
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure.measurements import MeasurementSpec
from elphdynamics_tpu_torch.models.adapter import ModelOps, make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.models.ssh import build_ssh
from elphdynamics_tpu_torch.ops.fourier_accel import build_Q, build_mass
from elphdynamics_tpu_torch.ops.kpm import KPMConfig
from elphdynamics_tpu_torch.ops.nearnull import NearNullConfig
from elphdynamics_tpu_torch.utils.dtypes import params_are_complex


@dataclass
class SimulationParams:
    """Run parameters of the ``[simulation]`` and sampler tables."""

    burnin: int
    nsteps: int
    meas_freq: int
    num_bins: int
    bin_size: int
    chckpnt_freq_s: float
    filepath: str
    foldername: str
    datafolder: str
    write_M_matrix: bool = False
    random_seed: int = 0

    def __post_init__(self):
        if self.nsteps % self.meas_freq != 0:
            raise ValueError(f"simulation_updates {self.nsteps} is not a multiple of "
                             f"meas_freq {self.meas_freq}")
        if (self.nsteps // self.meas_freq) % self.num_bins != 0:
            raise ValueError(f"{self.nsteps // self.meas_freq} measurements do not "
                             f"split into {self.num_bins} bins")


@dataclass
class SimulationSetup:
    """Everything a run needs, built from a parsed config."""

    ops: ModelOps
    params: Any
    sim_params: SimulationParams
    dynamics_type: str                  # "hmc" | "langevin"
    hmc_cfg: HMCConfig | None           # None for a Langevin run
    hmc_burnin_cfg: HMCConfig | None
    langevin_dt: float | None           # None for an HMC run
    langevin_method: str | None         # "euler" | "rk" | "heun"
    fa_Q: np.ndarray
    fa_mass: np.ndarray
    solver_cfg: SolverConfig
    kpm_cfg: KPMConfig | None
    mspec: MeasurementSpec
    reflect_cfg: SpecialUpdateConfig
    swap_cfg: SpecialUpdateConfig
    tune_density: dict | None
    read_phonon_config: str | None
    config: dict
    device: torch.device
    dtype: torch.dtype
    tempering_cfg: TemperingConfig | None = None
    nearnull_cfg: NearNullConfig | None = None


def load_toml(path: str) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def _build_lattice(cfg: dict) -> Lattice:
    lat = cfg["lattice"]
    uc = UnitCell.create(lat["ndim"], lat["norbits"], lat["lattice_vectors"],
                         lat["basis_vectors"])
    return Lattice.create(uc, lat["L"])


def _per_orbit(blocks) -> dict:
    out = {}
    for d in blocks:
        for orbit in d["orbit"]:
            out[orbit - 1] = (d["val"], d.get("stddev", 0.0))
    return out


def _dL(d) -> tuple:
    return tuple(list(d["dL"]) + [0] * (3 - len(d["dL"])))


def _build_ssh(cfg: dict, rng: np.random.Generator, dtype, device):
    s = cfg["ssh"]
    hoppings = [dict(t=d.get("t_avg", 0.0), t_std=d.get("t_std", 0.0),
                     alpha=d.get("alpha_avg", 0.0), alpha_std=d.get("alpha_std", 0.0),
                     alpha2=d.get("alpha2_avg", 0.0), alpha2_std=d.get("alpha2_std", 0.0),
                     omega=d.get("omega_avg", 0.0), omega_std=d.get("omega_std", 0.0),
                     omega4=d.get("omega4_avg", 0.0), omega4_std=d.get("omega4_std", 0.0),
                     o1=d["orbits"][0] - 1, o2=d["orbits"][1] - 1, dL=_dL(d),
                     name=d.get("name", ""))
                for d in s.get("hopping", [])]
    mu_assign = [(d["val"], d.get("stddev", 0.0), orbit - 1)
                 for d in s.get("mu", []) for orbit in d["orbit"]]
    return build_ssh(_build_lattice(cfg), s["beta"], s["dtau"], hoppings=hoppings,
                     mu_assignments=mu_assign, twist=s.get("twist"), rng=rng, dtype=dtype,
                     device=device)


def _build_model(cfg: dict, rng: np.random.Generator, dtype, device):
    if "ssh" in cfg:
        return _build_ssh(cfg, rng, dtype, device)
    h = cfg["holstein"]
    # TOML has no complex literal: a complex hopping is val + i·imag
    t_assign = [(d["val"] + (1j * d["imag"] if d.get("imag", 0.0) else 0.0),
                 d.get("stddev", 0.0), d["orbit"][0] - 1, d["orbit"][1] - 1, _dL(d))
                for d in h.get("t", [])]
    wij_assign = [(d["val"], d.get("stddev", 0.0), int(d.get("sign", 1)), d["orbit"][0] - 1,
                   d["orbit"][1] - 1, _dL(d)) for d in h.get("omega_ij", [])]
    per_orbit = {name: _per_orbit(h.get(key, []))
                 for name, key in (("omega", "omega"), ("mu", "mu"), ("lambda", "lambda"),
                                   ("lambda2", "lambda2"), ("omega4", "omega4"))}
    spec, params = build_holstein(
        _build_lattice(cfg), h["beta"], h["dtau"], t_assignments=t_assign,
        wij_assignments=wij_assign, per_orbit={k: v for k, v in per_orbit.items() if v},
        twist=h.get("twist"), rng=rng, dtype=dtype, device=device)
    return spec, params


def _measurement_spec(cfg: dict, is_holstein: bool) -> MeasurementSpec:
    m = cfg.get("measurements", {})

    def corr_list(kinds):
        out = []
        for kind in kinds:
            info = m.get(kind)
            if info and info.get("measure", False):
                pairs = info.get("pairs")
                if pairs is not None:
                    pairs = tuple((int(a) - 1, int(b) - 1) for a, b in pairs)
                out.append((kind, bool(info.get("time_dependent", False)), pairs))
        return tuple(out)

    # PhononGreens is on-site for Holstein (site phonons), inter-site for
    # SSH (bond phonons)
    onsite = ["Greens", "DenDen", "SpinSpin", "PairGreens"]
    inter = ["BondBond", "CurrentCurrent", "BondPairGreens"]
    (onsite if is_holstein else inter).append("PhononGreens")
    mspec = MeasurementSpec(
        nv=m.get("num_random_vectors", 10),
        onsite_corr=corr_list(onsite), intersite_corr=corr_list(inter),
        snapshots=tuple(k for k, v in m.get("Snapshots", {}).items() if v))
    mspec.check()
    return mspec


def _hmc_config(h: dict, b: dict, solver: SolverConfig, deflation: dict) -> HMCConfig:
    """The sampling ``[hmc]`` config (``b`` empty) or its ``[hmc.burnin]``
    overrides; ``deflation`` is the ``[solver.deflation]`` table."""
    cfg = HMCConfig(
        dt=b.get("dt", h["dt"]),
        trajectory_time=b.get("trajectory_time", h["trajectory_time"]),
        alpha=b.get("momentum_conservation_fraction", h.get("momentum_conservation_fraction", 0.0)),
        Nb=b.get("num_multitimesteps", h.get("num_multitimesteps", 1)),
        tol=solver.tol, maxiter=solver.maxiter, solver_kind=solver.kind,
        restart=solver.restart, block=solver.block,
        loop_precision=solver.loop_precision,
        integrator=str(b.get("integrator", h.get("integrator", "leapfrog"))).lower(),
        log_verbose=bool(h.get("verbose", False)),
        construct_guess=bool(h.get("construct_guess", False)),
        guess_order=int(h.get("guess_order", 3)),
        deflate_k=int(deflation.get("k", 0)),
        deflate_filter=int(deflation.get("filter_degree", 8)),
        deflate_power=int(deflation.get("power_iters", 4)),
        deflate_cutoff=float(deflation.get("cutoff", 1 / 16)),
        tune_dt=bool(b.get("tune_dt", h.get("tune_dt", False))),
        target_acceptance=float(b.get("target_acceptance", h.get("target_acceptance", 0.8))))
    cfg.check()
    return cfg


def build_setup(cfg: dict, datafolder: str, device, dtype: torch.dtype) -> SimulationSetup:
    """Every simulation object of a parsed config, with the model's tensors
    on ``device`` in ``dtype``."""
    if ("hmc" in cfg) == ("langevin" in cfg):
        raise ValueError("the config needs exactly one of [hmc] / [langevin]")
    if ("holstein" in cfg) == ("ssh" in cfg):
        raise ValueError("the config needs exactly one of [holstein] / [ssh]")
    device = torch.device(device)

    sim = cfg["simulation"]
    seed = sim.get("random_seed", np.random.SeedSequence().entropy % (2 ** 31))
    rng = np.random.default_rng(seed)
    spec, params = _build_model(cfg, rng, dtype, device)
    ops = make_model_ops(spec)

    h = cfg.get("hmc")
    if h is not None:
        burnin, nsteps, meas_freq = h["burnin_updates"], h["simulation_updates"], h["meas_freq"]
    else:
        lv = cfg["langevin"]
        burnin, nsteps, meas_freq = (lv["burnin_timesteps"], lv["simulation_timesteps"],
                                     lv["meas_freq"])
    num_bins = sim["num_bins"]
    sim_params = SimulationParams(
        burnin=burnin, nsteps=nsteps, meas_freq=meas_freq, num_bins=num_bins,
        bin_size=(nsteps // meas_freq) // num_bins,
        chckpnt_freq_s=60.0 * sim.get("checkpoint_freq", 10),
        filepath=sim.get("filepath", "."), foldername=sim.get("foldername", "run"),
        datafolder=datafolder, write_M_matrix=sim.get("write_M_matrix", False),
        random_seed=int(seed))

    sol = cfg["solver"]
    solver_cfg = SolverConfig(tol=sol.get("tol", 1e-5), maxiter=sol.get("maxiter", 1000),
                              kind=sol.get("type", "CG").lower(),
                              restart=sol.get("restart", 20),
                              block=bool(sol.get("block", False)),
                              loop_precision=sol.get("loop_precision", "high"))
    kpm_cfg = None
    if "preconditioner" in sol:
        p = sol["preconditioner"]
        kpm_cfg = KPMConfig(n_power=p.get("n", 20), buf=p.get("buf", 0.05),
                            c1=p.get("c1", 1.0), c2=p.get("c2", 1.0),
                            max_order=p.get("max_order", 64),
                            dft_matmul=p.get("dft_matmul", None),
                            stacked=p.get("stacked", False),
                            exact_lowfreq=int(p.get("exact_lowfreq", 0)))
    nearnull_cfg = None
    if "nearnull" in sol:
        nn = sol["nearnull"]
        nearnull_cfg = NearNullConfig(
            k=int(nn.get("k", 16)), c=int(nn.get("c", 4)),
            setup_iters=int(nn.get("setup_iters", 10)),
            setup_passes=int(nn.get("setup_passes", 2)),
            refresh_iters=int(nn.get("refresh_iters", 3)),
            refresh_mode=str(nn.get("refresh_mode", "smooth")), reg=float(nn.get("reg", 1e-6)))
        if solver_cfg.kind != "cg":
            raise ValueError("[solver.nearnull] requires the CG solver (it provides the "
                             "symmetric preconditioner)")
        if kpm_cfg is None:
            raise ValueError("[solver.nearnull] needs [solver.preconditioner] (the KPM "
                             "smoother it augments)")
        if params_are_complex(params):
            raise NotImplementedError("[solver.nearnull] with complex hopping: the near-null "
                                      "chunking and Galerkin products are real-only")

    omega = params.omega.detach().cpu().double().numpy()
    fa_blocks = cfg.get("fourier_acceleration", [])
    fa_Q = build_Q(omega, spec.dtau, spec.Ltau, fa_blocks)
    fa_mass = build_mass(omega, spec.dtau, spec.Ltau, fa_blocks)

    hmc_cfg = hmc_burnin_cfg = langevin_dt = langevin_method = None
    reflect_cfg = swap_cfg = SpecialUpdateConfig(freq=0, n_moves=0)
    if h is None:
        langevin_dt = float(cfg["langevin"]["dt"])
        method = cfg["langevin"].get("update_method", 1)
        if method not in (1, 2, 3):
            raise ValueError(f"[langevin] update_method {method!r}: 1 (Euler), 2 (Runge-Kutta) "
                             "or 3 (Heun)")
        langevin_method = {1: "euler", 2: "rk", 3: "heun"}[method]
    else:
        dfl = sol.get("deflation", {})
        hmc_cfg = _hmc_config(h, {}, solver_cfg, dfl)
        hmc_burnin_cfg = _hmc_config(h, h.get("burnin", {}), solver_cfg, dfl)
        if "reflection_update" in h and ops.is_holstein:
            reflect_cfg = SpecialUpdateConfig(freq=h["reflection_update"]["freq"],
                                              n_moves=h["reflection_update"]["nsites"],
                                              tol=solver_cfg.tol, maxiter=solver_cfg.maxiter)
        if "swap_update" in h:
            swap_cfg = SpecialUpdateConfig(freq=h["swap_update"]["freq"],
                                           n_moves=h["swap_update"]["nbonds"],
                                           tol=solver_cfg.tol, maxiter=solver_cfg.maxiter)

    tempering_cfg = None
    if "tempering" in cfg:
        t = cfg["tempering"]
        tempering_cfg = TemperingConfig(ladder=tuple(float(a) for a in t["ladder"]),
                                        freq=int(t.get("freq", 5)), tol=solver_cfg.tol,
                                        maxiter=solver_cfg.maxiter)

    mspec = _measurement_spec(cfg, ops.is_holstein)
    model_cfg = cfg["holstein" if ops.is_holstein else "ssh"]
    return SimulationSetup(
        ops=ops, params=params, sim_params=sim_params,
        dynamics_type="langevin" if h is None else "hmc", hmc_cfg=hmc_cfg,
        hmc_burnin_cfg=hmc_burnin_cfg, langevin_dt=langevin_dt,
        langevin_method=langevin_method, fa_Q=fa_Q, fa_mass=fa_mass,
        solver_cfg=solver_cfg, kpm_cfg=kpm_cfg, mspec=mspec, reflect_cfg=reflect_cfg,
        swap_cfg=swap_cfg, tune_density=cfg.get("tune_density"),
        read_phonon_config=(model_cfg.get("phonon_config_file")
                            if model_cfg.get("read_phonon_config", False) else None),
        config=cfg, device=device, dtype=dtype, tempering_cfg=tempering_cfg,
        nearnull_cfg=nearnull_cfg)
