"""Post-run summary: aggregate the bin files into mean ± error reports.

Counterpart of ``elphdynamics_tpu/io/summary.py``, writing the same files:
every per-bin output file is re-read, re-binned into ≤10 bins, and written
as ``mean ± error`` into ``*_stats.out`` files and a readable
``<foldername>_summary.out`` with the same sections (input-file echo, bond /
phonon / chemical-potential definitions, simulation info, global / on-site
/ inter-site measurements, susceptibilities and correlations).
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A parameter (tensor on any device, or array) as a numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def mean_and_error(bins: np.ndarray):
    """Mean and standard error over bin values, re-binned to ≤10 bins
    (SimulationSummary.jl:885-902)."""
    bins = np.asarray(bins)
    n = bins.shape[0]
    if n == 0:
        return 0.0, 0.0
    nb = min(10, n)
    m = (n // nb) * nb
    rebinned = bins[:m].reshape(nb, -1, *bins.shape[1:]).mean(axis=1)
    mean = rebinned.mean(axis=0)
    err = rebinned.std(axis=0, ddof=1) / np.sqrt(nb) if nb > 1 else np.zeros_like(mean)
    return mean, err


def _read_keyed_bins(folder, prefix):
    """Read per-bin 'key value' files -> {key: [values per bin]}."""
    vals = defaultdict(list)
    if not os.path.isdir(folder):
        return vals
    for fname in sorted(os.listdir(folder)):
        if not fname.startswith(prefix):
            continue
        with open(os.path.join(folder, fname)) as f:
            first = f.readline()
            lines = [first] if " " in first and not any(
                h in first for h in ("measurement", "index")) else []
            lines += f.readlines()
            for line in lines:
                parts = line.split()
                if len(parts) >= 2:
                    key = " ".join(parts[:-1])
                    try:
                        vals[key].append(float(parts[-1]))
                    except ValueError:
                        pass
    return vals


def _read_indexed_bins(folder, prefix):
    """Read per-bin correlation files -> array [nbins, nindex, 2]."""
    bins = []
    if not os.path.isdir(folder):
        return None
    for fname in sorted(os.listdir(folder)):
        if not fname.startswith(prefix) or not fname.endswith(".out"):
            continue
        if fname.endswith("_key.out"):
            # the coordinate-key companion file (index orbit r tau columns)
            # is NOT a data bin — including it silently biased every
            # correlation mean/err (its integer coordinates averaged in as
            # one extra 'bin'; found via a constant 1/3 imag column at
            # num_bins = 2)
            continue
        data = []
        with open(os.path.join(folder, fname)) as f:
            f.readline()
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    data.append((float(parts[1]), float(parts[2])))
        if data:
            bins.append(data)
    return np.asarray(bins) if bins else None


# ---------------------------------------------------------------------------
# TOML echo (SimulationSummary.jl:55-60 uses TOML.print; tomllib has no
# writer, so a minimal reference-shaped printer lives here)
# ---------------------------------------------------------------------------

def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return repr(v) if isinstance(v, float) else str(v)


def _toml_print(f, d: dict, prefix: str = ""):
    scalars = {k: v for k, v in d.items()
               if not isinstance(v, dict)
               and not (isinstance(v, list) and v and isinstance(v[0], dict))}
    tables = {k: v for k, v in d.items() if isinstance(v, dict)}
    arrays = {k: v for k, v in d.items()
              if isinstance(v, list) and v and isinstance(v[0], dict)}
    for k, v in scalars.items():
        f.write(f"{k} = {_toml_value(v)}\n")
    for k, v in tables.items():
        name = f"{prefix}{k}"
        f.write(f"\n[{name}]\n")
        _toml_print(f, v, prefix=name + ".")
    for k, lst in arrays.items():
        name = f"{prefix}{k}"
        for item in lst:
            f.write(f"\n[[{name}]]\n")
            _toml_print(f, item, prefix=name + ".")


# ---------------------------------------------------------------------------
# model-definition sections (SimulationSummary.jl:145-310)
# ---------------------------------------------------------------------------

def _avg_std(vals: np.ndarray):
    vals = np.asarray(vals).ravel()
    if np.iscomplexobj(vals):   # complex hopping: the real part here, imag below
        vals = vals.real
    vals = vals.astype(float)
    if vals.size == 0:
        return 0.0, 0.0
    return float(vals.mean()), float(vals.std(ddof=1)) if vals.size > 1 else 0.0


def _write_bond_definitions(f, setup):
    spec = setup.ops.spec
    t = _np(setup.params.t) if setup.params.t is not None else np.zeros(0)
    per_def = np.asarray(spec.bond_def_of_bond if setup.ops.is_holstein
                         else spec.bond_to_definition)
    for bid, d in enumerate(spec.bond_defs):
        o1, o2, dL = d[0], d[1], d[2]
        tvals = t[per_def == bid] if t.size else np.zeros(0)
        avg, std = _avg_std(tvals)
        f.write(f"Bond ID       = {bid + 1}\n")
        f.write(f"t_avg         = {avg}\n")
        f.write(f"t_std         = {std}\n")
        if np.iscomplexobj(tvals):
            f.write(f"t_imag_avg    = {float(tvals.imag.mean())}\n")
            f.write(f"t_imag_std    = "
                    f"{float(tvals.imag.std(ddof=1)) if tvals.size > 1 else 0.0}\n")
        f.write(f"Initial Orbit = {o1 + 1}\n")
        f.write(f"Final Orbit   = {o2 + 1}\n")
        f.write(f"Displacement  = {list(dL)}\n\n")


def _write_ssh_phonon_definitions(f, setup):
    """One section per phonon type: its couplings and its bond definition."""
    spec = setup.ops.spec
    p = setup.params
    ph_defs = [d for d in spec.bond_defs if d[3]]
    if not ph_defs or spec.Nph == 0:
        return
    per_type = spec.Nph // len(ph_defs)
    for pid, d in enumerate(ph_defs):
        sel = slice(pid * per_type, (pid + 1) * per_type)
        f.write(f"SSH Phonon ID = {pid + 1}\n")
        for label, arr in (("alpha", p.alpha), ("alpha2", p.alpha2),
                           ("omega", p.omega), ("omega4", p.omega4)):
            avg, std = _avg_std(_np(arr)[sel])
            f.write(f"{label}_avg = {avg}\n")
            f.write(f"{label}_std = {std}\n")
        f.write(f"Initial Orbit = {d[0] + 1}\n")
        f.write(f"Final Orbit   = {d[1] + 1}\n")
        f.write(f"Displacement  = {list(d[2])}\n\n")


def _write_phonon_definitions(f, setup):
    spec = setup.ops.spec
    p = setup.params
    if not setup.ops.is_holstein:
        _write_ssh_phonon_definitions(f, setup)
        return
    orbit = np.asarray(spec.lattice.site_to_orbit)
    for o in range(spec.lattice.unit_cell.norbits):
        sel = orbit == o
        f.write(f"Orbit = {o + 1}\n")
        for label, arr in (("Omega", p.omega), ("Omega4", p.omega4),
                           ("Lambda", p.lam), ("Lambda2", p.lam2)):
            avg, std = _avg_std(_np(arr)[sel])
            f.write(f"{label}_avg = {avg}\n")
            f.write(f"{label}_std = {std}\n")
        f.write("\n")


def _write_mu_definitions(f, setup):
    spec = setup.ops.spec
    orbit = np.asarray(spec.lattice.site_to_orbit)
    mu = _np(setup.params.mu)
    for o in range(spec.lattice.unit_cell.norbits):
        avg, std = _avg_std(mu[orbit == o])
        f.write(f"Orbit  = {o + 1}\n")
        f.write(f"Mu_avg = {avg}\n")
        f.write(f"Mu_std = {std}\n\n")


def _section(f, title):
    bar = "#" * (len(title) + 6)
    f.write(f"{bar}\n## {title} ##\n{bar}\n\n")


_SUSC_NAMES = ("PairSusc", "ChargeSusc", "SpinSusc", "BondPairSusc")


def write_summary(setup, sim_stats: dict, mu_tuner) -> str:
    """Aggregate all bins and write the summary + stats files."""
    sp = setup.sim_params
    datafolder = sp.datafolder
    summary_path = os.path.join(datafolder, f"{sp.foldername}_summary.out")

    # collect every correlation/susceptibility folder once
    corr_stats = {}
    for entry in sorted(os.listdir(datafolder)):
        if not entry.endswith("_f") or not os.path.isdir(os.path.join(datafolder, entry)):
            continue
        name = entry[:-2]
        if name in ("global_measurements", "onsite_measurements",
                    "intersite_measurements") or name.endswith("snapshots"):
            continue
        bins = _read_indexed_bins(os.path.join(datafolder, entry), name)
        if bins is None:
            continue
        corr_stats[name] = mean_and_error(bins)

    with open(summary_path, "w") as f:
        f.write("#########################\n## SIMULATION SUMMARY ##\n#########################\n\n")

        # ---- input file echo (SimulationSummary.jl:55-60)
        _section(f, "INPUT FILE CONTENTS")
        _toml_print(f, setup.config)
        f.write("\n")

        # ---- model definitions (:145-310)
        _section(f, "BOND DEFINITIONS")
        _write_bond_definitions(f, setup)
        _section(f, "PHONON DEFINITIONS")
        _write_phonon_definitions(f, setup)
        _section(f, "CHEMICAL POTENTIALS")
        _write_mu_definitions(f, setup)

        # ---- simulation info (:84-96)
        _section(f, "SIMULATION INFO")
        for k in ("burnin", "nsteps", "meas_freq", "num_bins", "bin_size", "random_seed"):
            f.write(f"{k} = {getattr(sp, k)}\n")
        total = (sim_stats["simulation_time"] + sim_stats["measurement_time"]
                 + sim_stats["write_time"])
        f.write(f"Total Time (min)        = {total / 60.0:.8f}\n")
        f.write(f"Simulation Time (min)   = {sim_stats['simulation_time'] / 60.0:.8f}\n")
        f.write(f"Measurement Time (min)  = {sim_stats['measurement_time'] / 60.0:.8f}\n")
        f.write(f"Write Time (min)        = {sim_stats['write_time'] / 60.0:.8f}\n")
        f.write(f"Iterative Solver Steps  = {sim_stats['iters']:.8f}\n")
        f.write(f"Acceptance Rate         = {sim_stats['acceptance_rate']:.8f}\n")
        f.write(f"Reflect Acceptance Rate = {sim_stats['reflect_acceptance_rate']:.8f}\n")
        f.write(f"Swap Acceptance Rate    = {sim_stats['swap_acceptance_rate']:.8f}\n")
        if sim_stats.get("solver_failures"):
            f.write(f"Solver Failures         = {sim_stats['solver_failures']}\n")
        if mu_tuner is not None and mu_tuner.active:
            f.write(f"tuned_mu = {mu_tuner.mu_avg:.8f} +- {mu_tuner.mu_err:.8f}\n")

        # ---- global measurements (+ compressibility, Measurements.jl:1323-1344)
        gvals = _read_keyed_bins(os.path.join(datafolder, "global_measurements_f"),
                                 "global_measurements")
        f.write("\n")
        _section(f, "GLOBAL MEASUREMENTS")
        stats = {}
        for k, v in sorted(gvals.items()):
            mean, err = mean_and_error(np.asarray(v))
            stats[k] = (mean, err)
            f.write(f"{k} = {mean:.8f} +- {err:.8f}\n")
        if "density" in stats and "Nsqr" in stats:
            beta = setup.ops.beta
            N = setup.ops.Nsites
            n_mean, n_err = stats["density"]
            N2_mean, N2_err = stats["Nsqr"]
            Nbar = N * n_mean
            dNbar = N * n_err
            kappa = beta * (N2_mean - Nbar ** 2) / N
            dkappa = beta * np.sqrt(N2_err ** 2 + (2 * Nbar * dNbar) ** 2) / N
            f.write(f"compressibility = {kappa:.8f} +- {dkappa:.8f}\n")

        for group, label in (("onsite_measurements", "ON-SITE MEASUREMENTS"),
                             ("intersite_measurements", "INTER-SITE MEASUREMENTS")):
            vals = _read_keyed_bins(os.path.join(datafolder, f"{group}_f"), group)
            f.write("\n")
            _section(f, label)
            for k, v in sorted(vals.items()):
                mean, err = mean_and_error(np.asarray(v))
                f.write(f"{k} = {mean:.8f} +- {err:.8f}\n")

        # ---- susceptibilities + correlations aggregated into the summary
        # (SimulationSummary.jl:312-880)
        for label, pick in (("SUSCEPTIBILITIES", True), ("CORRELATIONS", False)):
            f.write("\n")
            _section(f, label)
            for name in sorted(corr_stats):
                is_susc = any(name.startswith(s) for s in _SUSC_NAMES)
                if is_susc != pick:
                    continue
                mean, err = corr_stats[name]
                f.write(f"[{name}]\n")
                f.write(f"index {name}_mean_real {name}_mean_imag "
                        f"{name}_err_real {name}_err_imag\n")
                for i in range(mean.shape[0]):
                    f.write(f"{i + 1} {mean[i, 0]:.8f} {mean[i, 1]:.8f} "
                            f"{err[i, 0]:.8f} {err[i, 1]:.8f}\n")
                f.write("\n")

    # per-correlation stats files (SimulationSummary.jl:312-880)
    for name, (mean, err) in corr_stats.items():
        with open(os.path.join(datafolder, f"{name}_stats.out"), "w") as f:
            f.write(f"index {name}_mean_real {name}_mean_imag {name}_err_real {name}_err_imag\n")
            for i in range(mean.shape[0]):
                f.write(f"{i + 1} {mean[i, 0]:.8f} {mean[i, 1]:.8f} "
                        f"{err[i, 0]:.8f} {err[i, 1]:.8f}\n")

    return summary_path
