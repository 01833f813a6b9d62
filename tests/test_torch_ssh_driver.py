"""The optical SSH model through the PyTorch port's driver stack, against
the JAX package, float64 on the CPU.

* ``build_setup`` of ``examples/ssh_hmc_square.toml`` and
  ``examples/ssh_hmc_two_site.toml`` (stock and with disorder): the same
  parameters (to 1e-12) and settings; no reflection update for SSH.
* One measurement step on the square example (counts cut, 2 chains, JAX's
  probes and KPM start vectors injected): every increment, SSH's inter-site
  phonon statistics and bond PhononGreens included, to 1e-10;
  ``process_bin`` to 1e-10.
* The output files of SSH bins, the key files, the summary and the SSH
  phonon-configuration and K-matrix files, byte for byte.
* A CPU run of the CLI on the square example (counts cut) writes the
  output tree of the JAX package's driver on the same file.
* A physics anchor: at α = 0 the SSH model is free fermions, and the
  measured Green's function and density match the closed form.
"""

import copy
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics.force import SolverConfig as JSolverConfig
from elphdynamics_tpu.io import config as jconfig
from elphdynamics_tpu.io import output as jout
from elphdynamics_tpu.io import summary as jsummary
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.measure.mufinder import MuTuner as JMuTuner
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.simulation import simulate as jsimulate
from elphdynamics_tpu_torch import __main__ as cli
from elphdynamics_tpu_torch.convert import params_from_jax
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.io import config as tconfig
from elphdynamics_tpu_torch.io import output as tout
from elphdynamics_tpu_torch.io import summary as tsummary
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.measure.mufinder import MuTuner
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.simulation import load_model

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
C = 2


def _example(name, seed=11):
    cfg = jconfig.load_toml(os.path.join(EXAMPLES, f"{name}.toml"))
    cfg["simulation"]["random_seed"] = seed
    return cfg


def _with_disorder(cfg):
    """Disorder on every SSH parameter, so the rng stream is used."""
    cfg = copy.deepcopy(cfg)
    for h in cfg["ssh"]["hopping"]:
        h.update(t_std=0.1, alpha_std=0.05, omega_std=0.05, alpha2_avg=0.1, alpha2_std=0.02,
                 omega4_avg=0.02, omega4_std=0.01)
    for d in cfg["ssh"]["mu"]:
        d["stddev"] = 0.05
    return cfg


def _cut(cfg, tmp_path):
    """The square example with its counts cut (and the KPM order capped, so
    the CPU runs it in seconds)."""
    cfg = copy.deepcopy(cfg)
    cfg["hmc"].update(burnin_updates=2, simulation_updates=4, trajectory_time=0.1)
    cfg["simulation"].update(num_bins=2, filepath=str(tmp_path))
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"]["preconditioner"]["max_order"] = 8
    return cfg


@pytest.mark.parametrize("disorder", [False, True], ids=["stock", "disordered"])
@pytest.mark.parametrize("name", ["ssh_hmc_square", "ssh_hmc_two_site"])
def test_build_setup_matches_jax(name, disorder, tmp_path):
    cfg = _example(name)
    if disorder:
        cfg = _with_disorder(cfg)
    js = jconfig.build_setup(copy.deepcopy(cfg), str(tmp_path))
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path), "cpu", torch.float64)
    assert not ts.ops.is_holstein and js.model_type == "ssh"
    names = [f.name for f in dataclasses.fields(ts.params)]
    want = params_from_jax({f: getattr(js.params, f) for f in names}, "cpu")
    for f in names:
        a, b = getattr(ts.params, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=f)
    for f in ("ckb_to_bond", "bond_to_phonon", "primary_phonon", "bond_to_definition"):
        np.testing.assert_array_equal(getattr(ts.ops.spec, f), getattr(js.ops.spec, f))
    assert ts.ops.spec.bond_defs == js.ops.spec.bond_defs
    assert dataclasses.asdict(ts.sim_params) == dataclasses.asdict(js.sim_params)
    np.testing.assert_allclose(ts.fa_mass, js.fa_mass, rtol=1e-14)
    for field in ("dt", "trajectory_time", "Nb", "tol", "maxiter", "construct_guess"):
        assert getattr(ts.hmc_cfg, field) == getattr(js.hmc_cfg, field), field
    for a, b in ((ts.reflect_cfg, js.reflect_cfg), (ts.swap_cfg, js.swap_cfg)):
        assert (a.freq, a.n_moves, a.tol, a.maxiter) == (b.freq, b.n_moves, b.tol, b.maxiter)
    assert ts.reflect_cfg.n_moves == 0
    assert ts.mspec.onsite_corr == js.mspec.onsite_corr
    assert ts.mspec.intersite_corr == js.mspec.intersite_corr
    assert ts.read_phonon_config == js.read_phonon_config


@pytest.fixture(scope="module")
def square(tmp_path_factory):
    """The square example (disordered, counts cut) built by both packages,
    with 2 chains' fields, the measurement spec and both preconditioners."""
    cfg = _cut(_with_disorder(_example("ssh_hmc_square")), tmp_path_factory.mktemp("sq"))
    js = jconfig.build_setup(copy.deepcopy(cfg), "")
    ts = tconfig.build_setup(copy.deepcopy(cfg), "", "cpu", torch.float64)
    x = TS.tie_fields(ts.ops.spec, torch.as_tensor(
        0.4 * np.random.default_rng(7).standard_normal((C, ts.ops.Nph, ts.ops.Ltau)) + 0.2))
    return js, ts, x.numpy(), cfg


def _precond(tops, cfg):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    start = tuple(torch.as_tensor(np.array(jax.random.normal(k, (tops.Nsites, 1),
                                                             dtype=jnp.float64)))
                  for k in (k1, k2))
    return kpm.Preconditioner(
        setup=lambda params, x, start_=None: kpm.setup(tops, params, x, cfg, start),
        refresh=lambda st, params, x: kpm.refresh(tops, st, params, x),
        symmetric=lambda st, v: kpm.apply_symmetric(tops, st, v, cfg))


@pytest.fixture(scope="module")
def measured(square):
    js, ts, x, _ = square
    nv, tol = ts.mspec.nv, 1e-10
    jprec = jkpm.make_symmetric_precond(js.ops, js.kpm_cfg)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jstep = jax.jit(jm.make_measurement_step(js.ops, js.mspec,
                                             JSolverConfig(tol=tol, maxiter=2000), jprec))
    jres = [jstep(js.params, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    R = torch.as_tensor(np.stack([np.asarray(jax.random.normal(
        jax.random.split(k)[1], (nv, ts.ops.Nsites, ts.ops.Ltau), dtype=jnp.float64))
        for k in keys]))
    tstep = tm.make_measurement_step(ts.ops, ts.mspec, SolverConfig(tol=tol, maxiter=2000),
                                     _precond(ts.ops, ts.kpm_cfg))
    return jres, tstep(ts.params, torch.as_tensor(x), R=R)


def test_measurement_step_matches_jax(square, measured):
    _, ts, _, _ = square
    jres, (inc, stats, _) = measured
    assert set(inc["intersite"]) == {"el_ke", "x", "x2", "x4", "phonon_ke", "phonon_pe",
                                     "elph_energy", "sign_switch"}
    assert set(inc["onsite"]) == {"density", "double_occ", "mu"}
    assert set(inc["intersite_corr"]) == {"PhononGreens"}
    for c in range(C):
        jinc, jstats, _, _ = jres[c]
        assert set(inc) == set(jinc)
        for group in inc:
            assert set(inc[group]) == set(jinc[group]), group
            for k, v in inc[group].items():
                np.testing.assert_allclose(v[c].numpy(), np.asarray(jinc[group][k]),
                                           rtol=1e-10, atol=1e-10, err_msg=f"{group}/{k}")
        assert int(stats["iters"][c]) == int(jstats["iters"])
        assert int(stats["flag"][c]) == int(jstats["flag"]) == 0


def test_container_and_process_bin_match_jax(square, measured):
    js, ts, _, _ = square
    _, (inc, stats, snaps) = measured
    mean, _ = tm.mean_over_chains(inc, snaps, stats["flag"])
    zero = tm.zero_container(ts.ops, ts.mspec, torch.float64, "cpu")
    jzero = jm.zero_container(js.ops, js.mspec)
    for group in zero:
        assert list(zero[group]) == list(jzero[group]), group
        for k, z in zero[group].items():
            assert tuple(z.shape) == jzero[group][k].shape, (group, k)
    container = {g: {k: 3.0 * v for k, v in vals.items()} for g, vals in mean.items()}
    got = jax.tree.map(lambda t: t.numpy(), tm.process_bin(ts.ops, ts.mspec, container, 3))
    want = jm.process_bin(js.ops, js.mspec,
                          jax.tree.map(lambda t: jnp.asarray(t.numpy()), container), 3)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for k in flat_got:
        np.testing.assert_allclose(flat_got[k], np.asarray(flat_want[k]), rtol=1e-10,
                                   atol=1e-10, err_msg=str(k))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_output_files_match_jax(square, tmp_path):
    """write_bin, write_key_files, write_snapshot and write_summary of SSH
    bins write the JAX package's files, byte for byte."""
    js, ts, _, cfg = square
    js = dataclasses.replace(js, sim_params=dataclasses.replace(
        js.sim_params, datafolder=str(tmp_path / "jax")))
    ts = dataclasses.replace(ts, sim_params=dataclasses.replace(
        ts.sim_params, datafolder=str(tmp_path / "torch")))
    rng = np.random.default_rng(3)
    zero = tm.zero_container(ts.ops, ts.mspec, torch.float64, "cpu")
    bins = []
    for _ in range(2):
        cont = {g: {k: (rng.standard_normal(z.shape) + 1j * rng.standard_normal(z.shape)
                        if z.is_complex() else rng.standard_normal(z.shape))
                    for k, z in vals.items()} for g, vals in zero.items()}
        bins.append(jax.tree.map(np.asarray, jm.process_bin(
            js.ops, js.mspec, jax.tree.map(jnp.asarray, cont), 5)))
    jzero = jm.zero_container(js.ops, js.mspec)
    sim_stats = {"simulation_time": 12.5, "measurement_time": 3.25, "write_time": 0.5,
                 "iters": 17.125, "acceptance_rate": 0.875, "reflect_acceptance_rate": 0.0,
                 "swap_acceptance_rate": 0.25}
    mu_kw = dict(active=False, init_mu=0.0, target_N=16.0, N=16, beta=2.0, dtau=0.1,
                 forgetful_c=0.75, kappa_min=1.6)
    for mod, summ, setup, cont, tuner in ((jout, jsummary, js, jzero, JMuTuner(**mu_kw)),
                                          (tout, tsummary, ts, zero, MuTuner(**mu_kw))):
        folder = setup.sim_params.datafolder
        mod.init_measurement_folders(folder, cont, ("phonon_position",))
        mod.write_key_files(folder, setup.ops, setup.mspec, cont)
        for b, processed in enumerate(bins, start=1):
            mod.write_bin(folder, processed, b, setup.ops)
        mod.write_snapshot(folder, "phonon_position", np.linspace(0.0, 1.0, 32), 2)
        summ.write_summary(setup, sim_stats, tuner)
    names = _tree(tmp_path / "jax")
    assert names == _tree(tmp_path / "torch")
    assert any(n.startswith("PhononGreens_position_f") for n in names)
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "torch", names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    summary = (tmp_path / "torch" / "ssh_hmc_square_summary.out").read_text()
    assert "SSH Phonon ID = 2" in summary and "sign_switch" in summary


def test_phonon_and_matrix_files_match_jax(square, tmp_path):
    js, ts, x, _ = square
    jout.write_phonons(js.ops, x[0], str(tmp_path / "jx.out"))
    tout.write_phonons(ts.ops, torch.as_tensor(x[0]), str(tmp_path / "tx.out"))
    assert filecmp.cmp(tmp_path / "jx.out", tmp_path / "tx.out", shallow=False)
    np.testing.assert_allclose(tout.read_phonons(ts.ops, str(tmp_path / "tx.out")), x[0],
                               atol=1e-6)
    jout.write_K_matrix(js.ops, js.params, jnp.asarray(x[0]), str(tmp_path / "jK.out"), tau=3)
    tout.write_K_matrix(ts.ops, ts.params, torch.as_tensor(x[0]), str(tmp_path / "tK.out"),
                        tau=3)
    assert filecmp.cmp(tmp_path / "jK.out", tmp_path / "tK.out", shallow=False)
    jout.write_M_matrix(js.ops, js.params, jnp.asarray(x[0]), str(tmp_path / "jM.out"),
                        chunk=64)
    tout.write_M_matrix(ts.ops, ts.params, torch.as_tensor(x[0]), str(tmp_path / "tM.out"),
                        chunk=64)
    jM, tM = (np.loadtxt(tmp_path / f, skiprows=1) for f in ("jM.out", "tM.out"))
    np.testing.assert_array_equal(jM[:, :2], tM[:, :2])
    np.testing.assert_allclose(jM[:, 2:], tM[:, 2:], atol=2e-10)


def test_driver_runs_ssh_example(tmp_path, capsys):
    """``python -m elphdynamics_tpu_torch examples/ssh_hmc_square.toml
    --device cpu`` with its counts cut writes the output tree of the JAX
    package's driver on the same file: the SSH folders, the summary with
    the inter-site phonon statistics, a checkpoint that reloads."""
    paths = {}
    for pkg in ("jax", "torch"):
        cfg = _cut(_example("ssh_hmc_square"), tmp_path / pkg)
        (tmp_path / f"{pkg}_input").mkdir()
        paths[pkg] = tmp_path / f"{pkg}_input" / "ssh_hmc_square.toml"
        paths[pkg].write_text(dump_toml(cfg))
    assert cli.main([str(paths["torch"]), "1", "--device", "cpu", "--x64", "--chains", "2"]) == 0
    assert "swap_acceptance_rate" in capsys.readouterr().out
    jsimulate(str(paths["jax"]), run_id=1, n_chains=2)
    folder = tmp_path / "torch" / "ssh_hmc_square-1"
    names = _tree(folder)
    assert names == _tree(tmp_path / "jax" / "ssh_hmc_square-1")
    for b in (1, 2):
        for name in ("PhononGreens_position", "PhononGreens_momentum", "Greens_position",
                     "PairSusc_position"):
            data = np.loadtxt(folder / f"{name}_f" / f"{name}_{b:05d}.out", skiprows=1)
            assert data.size and np.isfinite(data).all(), name
        rows = (folder / "intersite_measurements_f" / f"intersite_measurements_{b:05d}.out"
                ).read_text().split("\n")
        assert sum(r.startswith("sign_switch ") for r in rows) == 2
    assert "PhononGreens_position_f/PhononGreens_position_key.out" in names
    summary = (folder / "ssh_hmc_square_summary.out").read_text()
    for section in ("INTER-SITE MEASUREMENTS", "SUSCEPTIBILITIES", "CORRELATIONS"):
        assert f"## {section} ##" in summary
    assert "sign_switch 1 = " in summary and "[ssh]" in summary and "SSH Phonon ID" in summary
    assert "Solver Failures" not in summary
    assert (folder / "final_phonon_config.out").read_text().startswith("type loc tau x\n")
    setup, params, x = load_model(str(folder), "cpu")
    assert tuple(x.shape) == (2, setup.ops.Nph, setup.ops.Ltau) and torch.isfinite(x).all()
    torch.testing.assert_close(TS.tie_fields(setup.ops.spec, x), x, rtol=0, atol=0)


def test_free_fermion_anchor():
    """α = 0: M does not depend on x, and G(τ) = Bᵗ·(I + B^{Lτ})⁻¹ with
    B = exp(−Δτ·K)·e^{Δτμ}. The SSH measurement stack (probes, batched
    solves with per-(chain, bond, τ) tables, pair convolutions, chain mean,
    bin normalisation) must reproduce it and the density within the probes'
    stochastic error."""
    L, beta, dtau, mu = 4, 2.0, 0.1, -0.4
    lat = Lattice.create(UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]]), L)
    hop = dict(t=1.0, alpha=0.0, omega=1.0, o1=0, o2=0)
    spec, params = TS.build_ssh(lat, beta, dtau, hoppings=[dict(hop, dL=(1, 0, 0), name="x"),
                                                           dict(hop, dL=(0, 1, 0), name="y")],
                                mu_assignments=[(mu, 0.0, None)], device="cpu")
    ops = make_model_ops(spec)
    N, Lt = spec.Nsites, spec.Ltau
    cb = np.full(spec.Nbonds, np.cosh(dtau))
    B = ckb.dense_matrix(spec.ckb, cb, np.sqrt(cb ** 2 - 1.0)) * np.exp(dtau * mu)
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

    mspec = tm.MeasurementSpec(nv=40, onsite_corr=(("Greens", True),))
    step = tm.make_measurement_step(ops, mspec, SolverConfig(tol=1e-8, maxiter=4000))
    gen = torch.Generator().manual_seed(0)
    x = torch.as_tensor(0.3 * np.random.default_rng(1).standard_normal((4, spec.Nph, Lt)))
    container, nsteps = None, 6
    for _ in range(nsteps):
        inc, stats, snaps = step(params, x, gen)
        assert int(stats["flag"].max()) == 0
        inc, _ = tm.mean_over_chains(inc, snaps, stats["flag"])
        container = inc if container is None else {
            g: {k: container[g][k] + v for k, v in vals.items()} for g, vals in inc.items()}
    res = tm.process_bin(ops, mspec, container, nsteps)
    got = res["onsite_corr"]["Greens"]["position"][0, :, :, 0, :Lt].real.numpy()
    # the Holstein anchor's bounds (4 chains × 6 steps × C(40,2) pairs; twice
    # the worst error over six generator seeds there)
    assert np.max(np.abs(got - exact)) < 0.03
    assert abs(float(res["global"]["density"]) - density_exact) < 0.02
    assert abs(density_exact - 1.0) > 0.05
    # the kinetic energy per bond: −t·Σ_σ⟨c†ᵢcⱼ + h.c.⟩ = 2t·(Gᵢⱼ + Gⱼᵢ) at τ = 0
    ke_exact = 2.0 * 2.0 * np.mean([Gt[0][j, i] for i, j in spec.ckb.neighbor_table.T])
    np.testing.assert_allclose(res["intersite"]["el_ke"].numpy(), ke_exact, atol=0.05)
