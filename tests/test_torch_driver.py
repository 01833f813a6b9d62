"""The PyTorch port's driver end to end on the CPU (2×2 lattice, β = 1,
float64, a few updates), as ``tests/test_simulation_driver.py`` drives the
JAX package: the output tree and summary, resuming from a checkpoint,
forced solver failures, the key files, and resuming a finished run; and a
free-fermion anchor of the measurement stack against the closed form.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.io import checkpoint as ckpt
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure.measurements import (
    MeasurementSpec, make_measurement_step, mean_over_chains, process_bin)
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.simulation import load_model, name_datafolder, simulate

torch.set_num_threads(1)

BASE_CFG = {
    "lattice": {"ndim": 2, "norbits": 1, "lattice_vectors": [[1.0, 0.0], [0.0, 1.0]],
                "basis_vectors": [[0.0, 0.0]], "L": 2},
    "holstein": {
        "beta": 1.0, "dtau": 0.1,
        "t": [{"val": 1.0, "orbit": [1, 1], "dL": [1, 0, 0]},
              {"val": 1.0, "orbit": [1, 1], "dL": [0, 1, 0]}],
        "omega": [{"orbit": [1], "val": 1.0}], "lambda": [{"orbit": [1], "val": 0.8}],
        "mu": [{"orbit": [1], "val": 0.0}], "omega4": [{"orbit": [1], "val": 0.0}],
    },
    "fourier_acceleration": [{"omega_min": 0.0, "omega_max": 10.0, "mass": 0.5}],
    "hmc": {
        "num_multitimesteps": 4, "burnin_updates": 2, "simulation_updates": 4,
        "trajectory_time": 0.4, "dt": 0.1, "meas_freq": 2,
        "momentum_conservation_fraction": 0.0, "log": True,
        "reflection_update": {"freq": 2, "nsites": 1},
        "swap_update": {"freq": 2, "nbonds": 1},
    },
    "simulation": {"filepath": ".", "foldername": "testrun", "num_bins": 2,
                   "random_seed": 7, "write_M_matrix": True},
    "solver": {"type": "CG", "tol": 1e-5, "maxiter": 2000,
               "preconditioner": {"n": 10, "buf": 0.05, "c1": 1.0, "c2": 1.0,
                                  "max_order": 8}},
    "measurements": {
        "num_random_vectors": 4,
        "Greens": {"measure": True, "time_dependent": True},
        "PhononGreens": {"measure": True, "time_dependent": True},
        "DenDen": {"measure": True, "time_dependent": True},
        "SpinSpin": {"measure": True, "time_dependent": False},
        "PairGreens": {"measure": True, "time_dependent": True},
        "Snapshots": {"density": True, "phonon_position": True},
    },
}
SECTIONS = ("INPUT FILE CONTENTS", "BOND DEFINITIONS", "PHONON DEFINITIONS",
            "CHEMICAL POTENTIALS", "SIMULATION INFO", "GLOBAL MEASUREMENTS",
            "ON-SITE MEASUREMENTS", "INTER-SITE MEASUREMENTS", "SUSCEPTIBILITIES",
            "CORRELATIONS")


def _cfg(tmp_path, **hmc):
    cfg = copy.deepcopy(BASE_CFG)
    cfg["simulation"]["filepath"] = str(tmp_path)
    cfg["hmc"].update(hmc)
    return cfg


def _sim(cfg, **kw):
    return simulate(cfg, device="cpu", dtype=torch.float64, **kw)


@pytest.fixture(scope="module")
def finished_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("run")
    stats = _sim(_cfg(root), n_chains=2)
    return root, os.path.join(str(root), "testrun-1"), stats


def _bin_values(folder, b=1):
    with open(os.path.join(folder, "global_measurements_f", f"global_measurements_{b:05d}.out")) as f:
        return [float(line.split()[-1]) for line in f]


def test_simulate_end_to_end(finished_run):
    root, folder, stats = finished_run
    txt = open(os.path.join(folder, "testrun_summary.out")).read()
    for section in SECTIONS:
        assert f"## {section} ##" in txt, section
    assert "[holstein]" in txt and "[[holstein.t]]" in txt and "compressibility" in txt
    assert "Lambda_avg" in txt and "Mu_avg" in txt
    assert "[PairSusc_position]" in txt and "[Greens_momentum]" in txt
    for b in (1, 2):
        vals = _bin_values(folder, b)
        assert len(vals) == 3 and all(np.isfinite(vals))
        for name in ("Greens_position", "Greens_momentum", "PairSusc_position"):
            data = np.loadtxt(os.path.join(folder, f"{name}_f", f"{name}_{b:05d}.out"),
                              skiprows=1)
            assert np.all(np.isfinite(data))
    for name in ("checkpoint.npz", "final_phonon_config.out", "M_matrix.out",
                 "ChargeSusc_position_stats.out", "testrun.log", "config.json", "input.toml",
                 os.path.join("density_snapshots_f", "density_snapshot_000002.out")):
        assert os.path.isfile(os.path.join(folder, name)), name
    assert stats["acceptance_rate"] > 0.2 and stats["iters"] > 0
    assert "solver_failures" not in stats
    # one row per update per chain after the header
    lines = open(os.path.join(folder, "hmc_sim_log.out")).readlines()
    assert lines[0].startswith("updates accepted") and len(lines) == 1 + 6 * 2
    # a finished folder resolves to itself (resume)
    assert name_datafolder(str(root), "testrun") == folder
    setup, params, x = load_model(folder, "cpu")
    assert tuple(x.shape) == (2, setup.ops.Nph, setup.ops.Ltau)
    assert torch.isfinite(x).all()


def test_key_files_written(finished_run):
    _, folder, _ = finished_run
    key = np.loadtxt(os.path.join(folder, "Greens_position_f", "Greens_position_key.out"),
                     skiprows=1)
    bin1 = np.loadtxt(os.path.join(folder, "Greens_position_f", "Greens_position_00001.out"),
                      skiprows=1)
    assert key.shape[0] == bin1.shape[0]
    assert key[0].tolist() == [1, 1, 1, 0, 0, 0, 0]
    assert key[1].tolist() == [2, 1, 1, 0, 0, 0, 1]  # tau fastest
    skey = np.loadtxt(os.path.join(folder, "PairSusc_position_f", "PairSusc_position_key.out"),
                      skiprows=1)
    sbin = np.loadtxt(os.path.join(folder, "PairSusc_position_f", "PairSusc_position_00001.out"),
                      skiprows=1)
    assert skey.shape[0] == sbin.shape[0]


def test_resume_completed_run_keeps_stats(finished_run, tmp_path):
    root, folder, stats1 = finished_run
    shutil.copytree(folder, tmp_path / "testrun-11")
    stats2 = _sim(_cfg(tmp_path), run_id=11, n_chains=2)  # nothing left to run
    assert stats2["acceptance_rate"] == pytest.approx(stats1["acceptance_rate"], abs=1e-12)
    assert stats2["iters"] == pytest.approx(stats1["iters"], abs=1e-12)


def test_checkpoint_resume_continues(finished_run, tmp_path):
    """Rewind a finished run's checkpoint to the middle of the sampling and
    resume: the run picks up at the stored counters and rewrites bin 2."""
    _, folder, _ = finished_run
    shutil.copytree(folder, tmp_path / "testrun-7")
    resumed = str(tmp_path / "testrun-7")
    st = ckpt.load_checkpoint(resumed)
    assert st["counters"]["sim_start"] == BASE_CFG["hmc"]["simulation_updates"]
    setup, params, _ = load_model(resumed, "cpu")
    st["counters"]["sim_start"] = 2
    ckpt.save_checkpoint(resumed, x=st["x"], v=st["v"], generator_state=torch.as_tensor(
        st["generator"]), params=params, container=st["container"], counters=st["counters"],
        sim_stats=st["sim_stats"], mu_tuner_state=st["mu_tuner"])
    path = os.path.join(resumed, "global_measurements_f", "global_measurements_00002.out")
    os.remove(path)
    lines_before = len(open(os.path.join(resumed, "hmc_sim_log.out")).readlines())
    _sim(_cfg(tmp_path), run_id=7, n_chains=2)
    assert os.path.isfile(path) and all(np.isfinite(_bin_values(resumed, 2)))
    # the two resumed updates appended their rows
    assert len(open(os.path.join(resumed, "hmc_sim_log.out")).readlines()) == lines_before + 4


def test_solver_failures_logged_and_masked(tmp_path):
    """maxiter = 2 forces solver failures: they reach the run log and the
    summary, every HMC update is rejected, and the bins stay finite."""
    cfg = _cfg(tmp_path, verbose=True)
    cfg["solver"]["maxiter"] = 2
    for k in ("reflection_update", "swap_update"):
        cfg["hmc"].pop(k)
    cfg["simulation"]["num_bins"] = 1
    cfg["simulation"]["write_M_matrix"] = False
    stats = _sim(cfg, n_chains=2)
    folder = os.path.join(str(tmp_path), "testrun-1")
    assert stats.get("solver_failures", 0) > 0
    assert stats["acceptance_rate"] == 0.0
    assert "solver failure" in open(os.path.join(folder, "testrun.log")).read()
    assert "Solver Failures" in open(os.path.join(folder, "testrun_summary.out")).read()
    assert all(np.isfinite(_bin_values(folder)))
    # verbose: per-leapfrog-step rows (t >= 1) besides the per-update rows
    rows = [line.split() for line in open(os.path.join(folder, "hmc_sim_log.out"))][1:]
    assert any(r[1] == "-1" and int(r[2]) >= 1 for r in rows)
    assert sum(r[2] == "-1" for r in rows) == 6 * 2


def test_deferred_stats_match_verbose(tmp_path):
    """With [hmc] log off the statistics are folded on the device and read
    once per window; they equal those of the verbose run, which reads them
    every update (the dynamics are the same)."""
    runs = []
    for sub, log in (("sync", {"log": True, "verbose": True}), ("async", {"log": False})):
        cfg = _cfg(tmp_path / sub, **log)
        cfg["solver"]["maxiter"] = 2
        cfg["simulation"]["num_bins"] = 1
        cfg["simulation"]["write_M_matrix"] = False
        os.makedirs(tmp_path / sub)
        runs.append(_sim(cfg, n_chains=2))
    for k in ("acceptance_rate", "iters", "reflect_acceptance_rate", "swap_acceptance_rate"):
        assert runs[0][k] == pytest.approx(runs[1][k], abs=1e-12), k
    assert runs[0]["solver_failures"] == runs[1]["solver_failures"] > 0


def test_free_fermion_greens_and_density_anchor():
    """λ = 0: M does not depend on x, and the Green's function has the
    closed form G(τ) = Bᵗ·(I + B^{Lτ})⁻¹ with B = exp(−Δτ·K)·e^{Δτμ}. The
    whole measurement stack (probes, batched solves, pair convolutions,
    translation averages, chain mean, bin normalization) must reproduce it
    and the density within the probes' stochastic error."""
    L, beta, dtau, mu = 4, 2.0, 0.1, -0.4
    lat = Lattice.create(UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]]), L)
    spec, params = build_holstein(lat, beta, dtau, omega=1.0, lam=0.0, mu=mu,
                                  t_assignments=[(1.0, 0.0, 0, 0, (1, 0, 0)),
                                                 (1.0, 0.0, 0, 0, (0, 1, 0))],
                                  device="cpu")
    ops = make_model_ops(spec)
    N, Lt = spec.Nsites, spec.Ltau
    B = ckb.dense_matrix(spec.ckb, params.cosht.numpy(), params.sinht.numpy()) * np.exp(dtau * mu)
    Gt = [np.linalg.inv(np.eye(N) + np.linalg.matrix_power(B, Lt))]
    for _ in range(1, Lt):
        Gt.append(B @ Gt[-1])
    Gt = np.stack(Gt)
    exact = np.zeros((L, L, Lt))
    for d1 in range(L):
        for d2 in range(L):
            rows = [lat.site_to_site(i, (d1, d2, 0), 0) for i in range(N)]
            exact[d1, d2] = Gt[:, rows, np.arange(N)].mean(axis=1)
    density_exact = 2.0 * (1.0 - np.trace(Gt[0]) / N)

    mspec = MeasurementSpec(nv=40, onsite_corr=(("Greens", True),))
    step = make_measurement_step(ops, mspec, SolverConfig(tol=1e-8, maxiter=4000))
    gen = torch.Generator().manual_seed(0)
    x = torch.as_tensor(0.3 * np.random.default_rng(1).standard_normal((4, N, Lt)))
    container, nsteps = None, 6
    for _ in range(nsteps):
        inc, stats, snaps = step(params, x, gen)
        assert int(stats["flag"].max()) == 0
        inc, _ = mean_over_chains(inc, snaps, stats["flag"])
        container = inc if container is None else {
            g: {k: container[g][k] + v for k, v in vals.items()} for g, vals in inc.items()}
    res = process_bin(ops, mspec, container, nsteps)
    got = res["onsite_corr"]["Greens"]["position"][0, :, :, 0, :Lt].real.numpy()
    # 4 chains × 6 steps × C(40,2) pairs. Over six generator seeds the rms
    # error was 3.2e-3–3.9e-3, the largest of the 320 points 8.5e-3–1.5e-2
    # and the density error at most 9.5e-3: the bounds are twice the worst
    assert np.max(np.abs(got - exact)) < 0.03
    assert abs(float(res["global"]["density"]) - density_exact) < 0.02
    assert abs(density_exact - 1.0) > 0.05


def test_mu_tuner_and_cli_on_cpu(tmp_path, capsys):
    """``python -m elphdynamics_tpu_torch input.toml --device cpu`` with
    [tune_density]: μ is retuned after every measurement of the burn-in and
    the sampling, and the summary reports the tuned μ."""
    from elphdynamics_tpu_torch import __main__ as cli
    from elphdynamics_tpu_torch.io.output import dump_toml

    cfg = _cfg(tmp_path, log=False)
    for k in ("reflection_update", "swap_update"):
        cfg["hmc"].pop(k)
    cfg["tune_density"] = {"density": 0.8, "memory": 0.5, "kappa_min": 0.1}
    cfg["simulation"]["write_M_matrix"] = False
    path = tmp_path / "tuned.toml"
    path.write_text(dump_toml(cfg))
    assert cli.main([str(path), "3", "--device", "cpu", "--x64"]) == 0
    assert "acceptance_rate" in capsys.readouterr().out
    folder = os.path.join(str(tmp_path), "testrun-3")
    lines = open(os.path.join(folder, "mu_tuner_log.out")).readlines()
    assert len(lines) == 1 + 1 + 2  # header, one burn-in and two sampling measurements
    assert "tuned_mu" in open(os.path.join(folder, "testrun_summary.out")).read()
    assert os.path.isfile(os.path.join(folder, "tuned.toml"))
