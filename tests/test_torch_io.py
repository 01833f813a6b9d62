"""Configuration, output files and checkpoints of the PyTorch port against
the JAX package.

* ``build_setup`` on each stock Holstein HMC example gives the JAX
  package's parameters (to 1e-12, through ``convert.params_from_jax``) and
  the same run, solver, preconditioner, sampler and measurement settings.
* On the same processed bins, the port's ``write_bin``, ``write_key_files``
  and ``write_summary`` write the same files, byte for byte, as the JAX
  package's.
* Checkpoints round-trip; a JAX checkpoint is refused; what the port does
  not run raises, naming its cause (near-null and 2MN under
  ``--site-devices``); the sections ported since (Langevin, GMRES, block
  CG, the KPM options, the bond-pair correlations, twisted boundaries and
  complex hopping, block CG on complex fields, the deep-β tools, and slice
  H2's layouts of ranks on gloo ranks) load and run; the CLI refuses a
  CUDA run without a card.
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

from elphdynamics_tpu.io import config as jconfig
from elphdynamics_tpu.io import output as jout
from elphdynamics_tpu.io import summary as jsummary
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.measure.mufinder import MuTuner as JMuTuner
from elphdynamics_tpu_torch import __main__ as cli
from elphdynamics_tpu_torch.convert import params_from_jax
from elphdynamics_tpu_torch.io import checkpoint as tckpt
from elphdynamics_tpu_torch.io import config as tconfig
from elphdynamics_tpu_torch.io import output as tout
from elphdynamics_tpu_torch.io import summary as tsummary
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.measure.mufinder import MuTuner
from elphdynamics_tpu_torch.simulation import check_parallel

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
STOCK = ["holstein_hmc_square", "holstein_hmc_single_site", "holstein_hmc_honeycomb",
         "holstein_hmc_triangular"]


def _stock(name, seed=11):
    cfg = jconfig.load_toml(os.path.join(EXAMPLES, f"{name}.toml"))
    cfg["simulation"]["random_seed"] = seed
    return cfg


def _with_disorder(cfg):
    """Disorder on every Holstein parameter, so the rng stream is used."""
    cfg = copy.deepcopy(cfg)
    h = cfg["holstein"]
    for t in h.get("t", []):
        t["stddev"] = 0.1
    for key in ("omega", "lambda", "mu"):
        for d in h[key]:
            d["stddev"] = 0.05
    return cfg


@pytest.mark.parametrize("disorder", [False, True], ids=["stock", "disordered"])
@pytest.mark.parametrize("name", STOCK)
def test_build_setup_matches_jax(name, disorder, tmp_path):
    cfg = _stock(name)
    if disorder:
        cfg = _with_disorder(cfg)
    js = jconfig.build_setup(copy.deepcopy(cfg), str(tmp_path))
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path), "cpu", torch.float64)
    want = params_from_jax({f.name: getattr(js.params, f.name)
                            for f in dataclasses.fields(ts.params)}, "cpu")
    for f in dataclasses.fields(ts.params):
        a, b = getattr(ts.params, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=f.name)
    assert dataclasses.asdict(ts.sim_params) == dataclasses.asdict(js.sim_params)
    np.testing.assert_allclose(ts.fa_mass, js.fa_mass, rtol=1e-14)
    for field in ("dt", "trajectory_time", "alpha", "Nb", "tol", "maxiter", "construct_guess",
                  "guess_order", "log_verbose", "integrator"):
        assert getattr(ts.hmc_cfg, field) == getattr(js.hmc_cfg, field), field
        assert getattr(ts.hmc_burnin_cfg, field) == getattr(js.hmc_burnin_cfg, field), field
    for field in ("tol", "maxiter", "kind"):
        assert getattr(ts.solver_cfg, field) == getattr(js.solver_cfg, field)
    for field in ("n_power", "buf", "c1", "c2", "max_order"):
        assert getattr(ts.kpm_cfg, field) == getattr(js.kpm_cfg, field)
    for a, b in ((ts.reflect_cfg, js.reflect_cfg), (ts.swap_cfg, js.swap_cfg)):
        assert (a.freq, a.n_moves, a.tol, a.maxiter) == (b.freq, b.n_moves, b.tol, b.maxiter)
    assert ts.mspec.nv == js.mspec.nv and ts.mspec.onsite_corr == js.mspec.onsite_corr
    assert ts.mspec.intersite_corr == js.mspec.intersite_corr == ()
    assert ts.ops.spec.bond_defs == js.ops.spec.bond_defs


def _processed_bins(js, ts, n_bins=2):
    """JAX-processed bins of random containers, as host numpy trees."""
    rng = np.random.default_rng(3)
    zero = tm.zero_container(ts.ops, ts.mspec, torch.float64, "cpu")
    out = []
    for _ in range(n_bins):
        cont = {g: {k: (rng.standard_normal(z.shape) + 1j * rng.standard_normal(z.shape)
                        if z.is_complex() else rng.standard_normal(z.shape))
                    for k, z in vals.items()} for g, vals in zero.items()}
        out.append(jax.tree.map(np.asarray, jm.process_bin(
            js.ops, js.mspec, jax.tree.map(jnp.asarray, cont), 5)))
    return zero, out


def test_output_files_match_jax(tmp_path):
    cfg = _with_disorder(_stock("holstein_hmc_honeycomb"))
    cfg["measurements"]["SpinSpin"]["time_dependent"] = False
    js = jconfig.build_setup(copy.deepcopy(cfg), str(tmp_path / "jax"))
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path / "torch"), "cpu", torch.float64)
    zero, bins = _processed_bins(js, ts)
    jzero = jm.zero_container(js.ops, js.mspec)
    sim_stats = {"simulation_time": 12.5, "measurement_time": 3.25, "write_time": 0.5,
                 "iters": 17.125, "acceptance_rate": 0.875, "reflect_acceptance_rate": 0.5,
                 "swap_acceptance_rate": 0.25, "solver_failures": 2}
    mu_kw = dict(active=True, init_mu=0.1, target_N=8.0, N=8, beta=2.0, dtau=0.1,
                 forgetful_c=0.75, kappa_min=0.8)
    tuners = [JMuTuner(**mu_kw), MuTuner(**mu_kw)]
    for tuner in tuners:
        for nm, n2 in ((7.5, 60.0), (8.25, 70.0), (8.0, 66.0)):
            tuner.update(nm, n2)
        tuner.estimate_mu()
    for (mod, setup, cont, tuner, folder) in (
            (jout, js, jzero, tuners[0], tmp_path / "jax"),
            (tout, ts, zero, tuners[1], tmp_path / "torch")):
        mod.init_measurement_folders(str(folder), cont, ("density",))
        mod.write_key_files(str(folder), setup.ops, setup.mspec, cont)
        for b, processed in enumerate(bins, start=1):
            mod.write_bin(str(folder), processed, b, setup.ops)
        mod.write_snapshot(str(folder), "density", np.linspace(0.0, 1.0, 8), 4)
    jsummary.write_summary(js, sim_stats, tuners[0])
    tsummary.write_summary(ts, sim_stats, tuners[1])

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = tree(tmp_path / "jax")
    assert names == tree(tmp_path / "torch")
    assert any(n.endswith("_key.out") for n in names) and "run_summary.out" not in names
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "torch", names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    assert len(match) == len(names) > 40


def test_phonon_and_M_matrix_files_match_jax(tmp_path):
    cfg = _stock("holstein_hmc_square")
    cfg["lattice"]["L"] = 2
    cfg["holstein"]["beta"] = 0.4
    js = jconfig.build_setup(copy.deepcopy(cfg), str(tmp_path))
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path), "cpu", torch.float64)
    x = 0.3 * np.random.default_rng(1).standard_normal((ts.ops.Nph, ts.ops.Ltau))
    jout.write_phonons(js.ops, x, str(tmp_path / "jx.out"))
    tout.write_phonons(ts.ops, torch.as_tensor(x), str(tmp_path / "tx.out"))
    assert filecmp.cmp(tmp_path / "jx.out", tmp_path / "tx.out", shallow=False)
    np.testing.assert_allclose(tout.read_phonons(ts.ops, str(tmp_path / "tx.out")), x, atol=1e-6)
    jout.write_M_matrix(js.ops, js.params, jnp.asarray(x), str(tmp_path / "jM.out"), chunk=7)
    tout.write_M_matrix(ts.ops, ts.params, torch.as_tensor(x), str(tmp_path / "tM.out"), chunk=7)
    jm_, tm_ = (np.loadtxt(tmp_path / f, skiprows=1) for f in ("jM.out", "tM.out"))
    np.testing.assert_array_equal(jm_[:, :2], tm_[:, :2])
    np.testing.assert_allclose(jm_[:, 2:], tm_[:, 2:], atol=2e-10)


def test_checkpoint_round_trip_and_refuses_jax(tmp_path):
    cfg = _stock("holstein_hmc_single_site")
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path), "cpu", torch.float64)
    cont = tm.zero_container(ts.ops, ts.mspec, torch.float64, "cpu")
    cont["onsite_corr"]["Greens"] += 1.5 - 0.5j
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, ts.ops.Nph, ts.ops.Ltau), generator=gen, dtype=torch.float64)
    tckpt.save_checkpoint(str(tmp_path), x=x, v=-x, generator_state=gen.get_state(),
                          params=ts.params, container=cont,
                          counters={"burnin_start": 3, "sim_start": 0},
                          sim_stats={"iters": 4.0}, mu_tuner_state={"mu": 0.0})
    assert tckpt.has_checkpoint(str(tmp_path))
    st = tckpt.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(st["x"], x.numpy())
    assert st["generator"].dtype == np.uint8
    restored = torch.Generator()
    restored.set_state(torch.as_tensor(st["generator"]))
    assert torch.equal(torch.rand(3, generator=restored), torch.rand(3, generator=gen))
    np.testing.assert_array_equal(st["container"]["onsite_corr"]["Greens"],
                                  cont["onsite_corr"]["Greens"].numpy())
    np.testing.assert_array_equal(st["params"]["mu"], ts.params.mu.numpy())
    assert st["counters"]["burnin_start"] == 3
    # a checkpoint of the JAX package (a PRNG key instead of a generator)
    np.savez(tmp_path / "checkpoint.npz", x=st["x"], v=st["v"], key=np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match="not interchangeable"):
        tckpt.load_checkpoint(str(tmp_path))


def _ssh(c, **extra):
    """The config with its [holstein] table replaced by the stock SSH
    example's [ssh] table (plus ``extra``)."""
    c.pop("holstein")
    c["ssh"] = {**jconfig.load_toml(os.path.join(EXAMPLES, "ssh_hmc_square.toml"))["ssh"], **extra}
    return c


def _twisted(c):
    """The config with its [holstein] table replaced by the stock twisted
    example's (twist = [π/4, π/8])."""
    c["holstein"] = jconfig.load_toml(os.path.join(EXAMPLES, "holstein_hmc_twisted.toml"))[
        "holstein"]
    return c


# (id, edit, what the message names[, (--devices, --site-devices)]): what
# the port refuses, a layout of ranks included: near-null and 2MN under
# site sharding, as the reference does not run them sharded (ROADMAP
# section 3).
UNPORTED = [
    ("slice H2-nearnull", lambda c: c["solver"].update(nearnull={"k": 4}),
     "nearnull.*refuses it too", (1, 2)),
    ("slice H2-2mn", lambda c: c["hmc"].update(integrator="2mn"), "2MN integrator", (1, 2)),
]


@pytest.mark.parametrize("edit,slice_,layout", [(u[1], u[2], u[3] if len(u) > 3 else (1, 1))
                                                for u in UNPORTED],
                         ids=[u[0] for u in UNPORTED])
def test_unported_sections_raise(edit, slice_, layout, tmp_path):
    cfg = _stock("holstein_hmc_square")
    edit(cfg)
    with pytest.raises(NotImplementedError, match=slice_):
        check_parallel(cfg, *layout)
        tconfig.build_setup(cfg, str(tmp_path), "cpu", torch.float64)


def _langevin(c):
    c.pop("hmc")
    c["langevin"] = dict(dt=1e-3, update_method=2, burnin_timesteps=1, simulation_timesteps=2,
                         meas_freq=1)
    return c


BOND_CORR = {k: {"measure": True, "time_dependent": True}
             for k in ("BondBond", "CurrentCurrent", "BondPairGreens")}
# what raised before it was ported: each now loads and runs to a summary;
# (id, edit[, (--devices, --site-devices)]), a layout running on gloo ranks
PORTED = [
    ("langevin", _langevin),
    ("gmres", lambda c: c["solver"].update(type="GMRES", restart=10)),
    ("block", lambda c: c["solver"].update(block=True)),
    ("stacked", lambda c: c["solver"]["preconditioner"].update(stacked=True, exact_lowfreq=2)),
    ("bond_correlations", lambda c: c["measurements"].update(BOND_CORR)),
    ("ssh_langevin", lambda c: _langevin(_ssh(c))),
    ("ssh_bond_correlations", lambda c: _ssh(c)["measurements"].update(BOND_CORR)),
    ("ssh_twist", lambda c: _ssh(c, twist=[0.3, 0.0])),
    ("twist", lambda c: c["holstein"].update(twist=[0.3, 0.0])),
    ("imag", lambda c: c["holstein"]["t"][0].update(imag=0.2)),
    ("twist_block", lambda c: _twisted(c)["solver"].update(block=True)),
    ("tempering", lambda c: c.update(tempering={"ladder": [1.0, 0.5]})),
    ("tune_dt", lambda c: c["hmc"].update(tune_dt=True, target_acceptance=0.7)),
    ("2mn", lambda c: c["hmc"].update(integrator="2mn")),
    ("deflation", lambda c: c["solver"].update(deflation={"k": 4})),
    ("nearnull", lambda c: c["solver"].update(nearnull={"k": 4})),
    ("slice H2-ssh", lambda c: _ssh(c), (1, 2)),
    ("slice H2-ssh_langevin", lambda c: _langevin(_ssh(c)), (1, 2)),
    ("slice H2-chain_x_site", lambda c: None, (2, 2)),
    ("slice H2-block", lambda c: c["solver"].update(block=True), (1, 2)),
    ("slice H2-deflation", lambda c: c["solver"].update(deflation={"k": 4}), (1, 2)),
    ("slice H2-tempering", lambda c: c.update(tempering={"ladder": [1.0, 0.5]}), (1, 2)),
]


@pytest.mark.parametrize("edit,layout", [(p[1], p[2] if len(p) > 2 else (1, 1))
                                         for p in PORTED], ids=[p[0] for p in PORTED])
def test_ported_sections_load_and_run(edit, layout, tmp_path):
    """The stock example with one ported section switched on and its counts
    cut runs on the CPU to a summary with finite bins and no solver
    failure; a layout of ranks runs on gloo ranks, one thread each."""
    from elphdynamics_tpu_torch.simulation import simulate

    cfg = _stock("holstein_hmc_square")
    cfg["hmc"].update(burnin_updates=1, simulation_updates=2, meas_freq=1, trajectory_time=0.1)
    cfg["hmc"].pop("reflection_update", None)
    cfg["simulation"].update(num_bins=2, filepath=str(tmp_path))
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"]["preconditioner"]["max_order"] = 8
    edit(cfg)
    setup = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path), "cpu", torch.float64)
    assert setup.dynamics_type == ("langevin" if "langevin" in cfg else "hmc")
    if layout == (1, 1):
        stats = simulate(cfg, run_id=1, n_chains=2, device="cpu", dtype=torch.float64)
    else:
        import torch_parallel_workers as W
        from elphdynamics_tpu_torch.parallel.multihost import launch

        check_parallel(cfg, *layout)
        # ranks on the CPU: the smallest run that still writes two bins
        if "holstein" in cfg:
            cfg["lattice"]["L"] = 2
        cfg.get("hmc", {}).update(burnin_updates=0, trajectory_time=0.05)
        cfg.get("langevin", {}).update(burnin_timesteps=0)
        cfg["measurements"]["num_random_vectors"] = 2
        path = tmp_path / "ported.toml"
        path.write_text(tout.dump_toml(cfg))
        stats = launch(W.simulate_worker, layout[0] * layout[1], "gloo", "cpu",
                       (str(path), 1, 2, *layout), timeout_s=240, threads=1,
                       store_dir=str(tmp_path))[0][0]
    assert stats.get("solver_failures", 0) == 0 and stats["iters"] > 0
    folder = tmp_path / f"{cfg['simulation']['foldername']}-1"
    assert (folder / f"{cfg['simulation']['foldername']}_summary.out").is_file()
    kinds = ["Greens"] + [k for k in BOND_CORR
                          if cfg["measurements"].get(k, {}).get("measure", False)]
    for kind in kinds:
        data = np.loadtxt(folder / f"{kind}_position_f" / f"{kind}_position_00002.out", skiprows=1)
        assert data.size and np.isfinite(data).all(), kind
    if "BondPairGreens" in kinds:
        assert (folder / "BondPairSusc_momentum_f" / "BondPairSusc_momentum_key.out").is_file()


def test_cli_deep_beta_example_with_profile(tmp_path):
    """``examples/holstein_hmc_deep_beta.toml`` cut in depth (L = 2, β = 2)
    runs through the CLI on the CPU, and ``--profile DIR`` writes the run's
    Chrome trace."""
    cfg = _stock("holstein_hmc_deep_beta")
    cfg["lattice"]["L"] = 2
    cfg["holstein"]["beta"] = 2.0
    cfg["hmc"].update(burnin_updates=2, simulation_updates=2, trajectory_time=0.2)
    cfg["simulation"].update(num_bins=2, filepath=str(tmp_path))
    cfg["measurements"]["num_random_vectors"] = 2
    path = tmp_path / "deep.toml"
    path.write_text(tout.dump_toml(cfg))
    prof = tmp_path / "trace"
    assert cli.main([str(path), "1", "--chains", "2", "--device", "cpu", "--x64",
                     "--profile", str(prof)]) == 0
    trace = prof / "trace.json"
    assert trace.is_file() and '"traceEvents"' in trace.read_text()[:4096]
    log = (tmp_path / "holstein_hmc_deep_beta-1" / "holstein_hmc_deep_beta.log").read_text()
    assert "tune_dt: frozen dt=" in log


def test_cli_refuses_cuda_without_a_card_and_multi_gpu(capsys, monkeypatch, tmp_path):
    """Without a card a CUDA run (one rank or several) exits with a message;
    more NCCL ranks than cards is refused before a rank starts; a
    ``--multihost`` process needs its launcher's environment; GMRES on the
    2-D layout (the reference solves sharded systems by CG only) is refused
    before a rank starts."""
    path = os.path.join(EXAMPLES, "holstein_hmc_square.toml")
    if not torch.cuda.is_available():
        assert cli.main([path]) != 0
        assert "no CUDA device" in capsys.readouterr().err
        assert cli.main([path, "--devices", "2"]) != 0
        assert "no CUDA device" in capsys.readouterr().err
    else:
        n = torch.cuda.device_count()
        assert cli.main([path, "--devices", str(n + 1)]) != 0
        assert "CUDA devices" in capsys.readouterr().err
    gmres = _stock("holstein_hmc_square")
    gmres["solver"].update(type="GMRES")
    (tmp_path / "gmres.toml").write_text(tout.dump_toml(gmres))
    with pytest.raises(NotImplementedError, match="BiCGStab / GMRES with --site-devices"):
        cli.main([str(tmp_path / "gmres.toml"), "--devices", "2", "--site-devices", "2",
                  "--device", "cpu"])
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="launcher"):
        cli.main([path, "--multihost", "--device", "cpu"])
