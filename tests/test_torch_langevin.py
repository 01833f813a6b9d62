"""Langevin dynamics of the PyTorch port against the JAX package, float64 on
the CPU.

* One Euler, Runge-Kutta and Heun step, Holstein (dense and fold branch)
  and SSH, 2 chains, with JAX's η and g fed to the port
  (``LangevinDraws``) and JAX's KPM start vectors: x to 1e-10, solver
  iterations and flags equal. The same step with BiCGStab through the left
  preconditioner.
* ``fermionic_force`` / ``total_force`` against the JAX functions, and the
  preconditioner cadence of the three schemes (full setups and refreshes
  per step).
* ``build_setup`` of the two stock Langevin examples, and a CLI run of
  each (counts cut, ``--device cpu``) whose output tree has the file names
  of the JAX package's driver on the same input.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics import force as jforce
from elphdynamics_tpu.dynamics.langevin import make_langevin_step as j_make_langevin_step
from elphdynamics_tpu.dynamics.solve import SolverConfig as JSolverConfig
from elphdynamics_tpu.io import config as jconfig
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models import ssh as JS
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_Q
from elphdynamics_tpu.simulation import simulate as jsimulate
from elphdynamics_tpu_torch import __main__ as cli
from elphdynamics_tpu_torch import bench
from elphdynamics_tpu_torch.dynamics import force as tforce
from elphdynamics_tpu_torch.dynamics import langevin as tl
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.io import config as tconfig
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.simulation import load_model

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
C = 2
UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
FA = [dict(omega_min=0.0, omega_max=10.0, mass=0.5)]
KPM = dict(max_order=8)
HOP = dict(t=1.0, t_std=0.1, alpha=0.3, alpha_std=0.05, omega=1.0, omega_std=0.1, o1=0, o2=0)


def _models(name):
    """(jops, jparams, tops, tparams) of a 4×4 model: Holstein on its dense
    or fold branch, or the SSH square lattice with x and y bonds."""
    if name == "ssh":
        kw = dict(hoppings=[dict(HOP, dL=(1, 0, 0), name="x"), dict(HOP, dL=(0, 1, 0), name="y")],
                  mu_assignments=[(-0.2, 0.1, None)])
        js, jp = JS.build_ssh(JLattice.create(JUnitCell.create(*UC), 4), 1.0, 0.1,
                              rng=np.random.default_rng(3), **kw)
        ts, tp = TS.build_ssh(Lattice.create(UnitCell.create(*UC), 4), 1.0, 0.1,
                              rng=np.random.default_rng(3), device="cpu", **kw)
    else:
        kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
                  omega=1.0, omega_std=0.1, lam=1.0, mu=0.0,
                  dense_threshold=2048 if name == "dense" else 0)
        js, jp = j_build_holstein(JLattice.create(JUnitCell.create(*UC), 4), 1.0, 0.1,
                                  rng=np.random.default_rng(5), **kw)
        ts, tp = build_holstein(Lattice.create(UnitCell.create(*UC), 4), 1.0, 0.1,
                                rng=np.random.default_rng(5), device="cpu", **kw)
    return j_make_model_ops(js), jp, make_model_ops(ts), tp


def _start(N):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    return tuple(torch.as_tensor(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64)))
                 for k in (k1, k2))


def _precond(tops, counts=None):
    """The port's full preconditioner started from the JAX package's power
    iteration vectors; ``counts`` tallies full setups and refreshes."""
    cfg, start = kpm.KPMConfig(**KPM), _start(tops.Nsites)
    base = kpm.make_precond(tops, cfg)

    def setup(params, x, start_=None):
        if counts is not None:
            counts["setup"] += 1
        return kpm.setup(tops, params, x, cfg, start)

    def refresh(st, params, x):
        if counts is not None:
            counts["refresh"] += 1
        return kpm.refresh(tops, st, params, x)

    return kpm.Preconditioner(setup=setup, refresh=refresh, symmetric=base.symmetric,
                              left=base.left, right=base.right)


def _jax_draws(keys, method, Nph, N, Lt):
    """The η and g that elphdynamics_tpu/dynamics/langevin.py draws from
    each chain's key: η from the first split, then one g per total_force."""
    eta, gs = [], [[] for _ in range(tl.n_forces(method))]
    for key in keys:
        key, kn = jax.random.split(key)
        eta.append(np.asarray(jax.random.normal(kn, (Nph, Lt), dtype=jnp.float64)))
        for g in gs:
            key, kg = jax.random.split(key)
            g.append(np.asarray(jax.random.normal(kg, (N, Lt), dtype=jnp.float64)))
    return tl.LangevinDraws(eta=torch.as_tensor(np.stack(eta)),
                            g=tuple(torch.as_tensor(np.stack(g)) for g in gs))


def _fields(tops, seed=11):
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((C, tops.Nph, 1)) + 0.1 * rng.standard_normal(
        (C, tops.Nph, tops.Ltau))
    return x if tops.is_holstein else TS.tie_fields(tops.spec, torch.as_tensor(x)).numpy()


@pytest.mark.parametrize("method", tl.METHODS)
@pytest.mark.parametrize("name", ["dense", "fold", "ssh"])
def test_langevin_step_matches_jax(name, method):
    jops, jp, tops, tp = _models(name)
    Q = build_Q(np.asarray(jp.omega), tops.dtau, tops.Ltau, FA)
    x0 = _fields(tops)
    scfg = dict(tol=1e-8, maxiter=1000)
    jstep = jax.jit(j_make_langevin_step(
        jops, Q, 0.01, method, JSolverConfig(**scfg),
        jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, jnp.asarray(x0[c]), keys[c]) for c in range(C)]

    tstep = tl.make_langevin_step(tops, Q, 0.01, method, SolverConfig(**scfg), _precond(tops))
    x1, stats = tstep(tp, torch.as_tensor(x0),
                      draws=_jax_draws(keys, method, tops.Nph, tops.Nsites, tops.Ltau))
    for c in range(C):
        jx, jstats, _ = runs[c]
        np.testing.assert_allclose(x1[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)
        assert int(stats.iters[c]) == int(jstats.iters)
        assert int(stats.flag[c]) == int(jstats.flag) == 0
    assert float((x1 - torch.as_tensor(x0)).abs().max()) > 1e-3
    if not tops.is_holstein:   # the noise is tied over aliased fields, x stays tied
        torch.testing.assert_close(TS.tie_fields(tops.spec, x1), x1, rtol=0, atol=0)


def test_langevin_step_bicgstab_matches_jax():
    """The force solve through M with the left preconditioner."""
    jops, jp, tops, tp = _models("dense")
    Q = build_Q(np.asarray(jp.omega), tops.dtau, tops.Ltau, FA)
    x0 = _fields(tops)
    scfg = dict(tol=1e-8, maxiter=1000, kind="bicgstab")
    jstep = jax.jit(j_make_langevin_step(jops, Q, 0.01, "rk", JSolverConfig(**scfg),
                                         jkpm.make_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    runs = [jstep(jp, jnp.asarray(x0[c]), keys[c]) for c in range(C)]
    tstep = tl.make_langevin_step(tops, Q, 0.01, "rk", SolverConfig(**scfg), _precond(tops))
    x1, stats = tstep(tp, torch.as_tensor(x0),
                      draws=_jax_draws(keys, "rk", tops.Nph, tops.Nsites, tops.Ltau))
    for c in range(C):
        np.testing.assert_allclose(x1[c].numpy(), np.asarray(runs[c][0]), rtol=0, atol=1e-10)
        assert int(stats.iters[c]) == int(runs[c][1].iters)
        assert int(stats.flag[c]) == 0


@pytest.mark.parametrize("name", ["dense", "ssh"])
def test_forces_match_jax(name):
    jops, jp, tops, tp = _models(name)
    x = _fields(tops, seed=12)
    g = np.random.default_rng(13).standard_normal((C, tops.Nsites, tops.Ltau))
    scfg = dict(tol=1e-10, maxiter=2000)
    tx, tg = torch.as_tensor(x), torch.as_tensor(g)
    got = tforce.fermionic_force(tops, tp, tx, tops.derived(tp, tx), tg, SolverConfig(**scfg))
    total = tforce.total_force(tops, tp, tx, tg, SolverConfig(**scfg), _precond(tops))
    for c in range(C):
        jx = jnp.asarray(x[c])
        want = jforce.fermionic_force(jops, jp, jx, jops.derived(jp, jx), jnp.asarray(g[c]),
                                      JSolverConfig(**scfg))
        np.testing.assert_allclose(got.dSdx[c].numpy(), np.asarray(want.dSdx), rtol=0, atol=1e-8)
        assert int(got.iters[c]) == int(want.iters) and int(got.flag[c]) == 0
        # the preconditioned total force: the same force to the solver's tolerance
        full = np.asarray(want.dSdx + jops.calc_dSbdx(jp, jx, True))
        np.testing.assert_allclose(total.dSdx[c].numpy(), full, rtol=0,
                                   atol=1e-7 * np.abs(full).max())
    assert int(total.iters.max()) < int(got.iters.min())   # the preconditioner helps


@pytest.mark.parametrize("method,setups,refreshes", [("euler", 1, 0), ("rk", 1, 1),
                                                      ("heun", 1, 1)])
def test_langevin_preconditioner_cadence(method, setups, refreshes):
    """Euler: a full setup for its one force. RK and Heun: one full setup
    per step, a refresh of it for each force (the first refresh is at the
    setup's own fields)."""
    _, jp, tops, tp = _models("dense")
    Q = build_Q(np.asarray(jp.omega), tops.dtau, tops.Ltau, FA)
    counts = {"setup": 0, "refresh": 0}
    step = tl.make_langevin_step(tops, Q, 0.01, method, SolverConfig(tol=1e-6, maxiter=500),
                                 _precond(tops, counts))
    x, stats = step(tp, torch.as_tensor(_fields(tops)), torch.Generator().manual_seed(0))
    assert counts["setup"] == setups
    assert counts["refresh"] == (2 if refreshes else 0)
    assert torch.isfinite(x).all() and int(stats.flag.max()) == 0


def test_langevin_draws_from_generator_and_refuses_bad_input():
    b = bench.build_langevin_step(4, 1.0, 0.1, 1e-3, C, "cpu", torch.float64, method="heun")
    out = [b.step(b.params, b.x, torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    d = tl.draw(b.ops, C, "heun", torch.float64, "cpu", torch.Generator().manual_seed(1))
    assert len(d.g) == 2 and tuple(d.eta.shape) == tuple(b.x.shape)
    assert torch.equal(b.step(b.params, b.x, draws=d)[0], out[0])
    with pytest.raises(ValueError, match="unknown Langevin method"):
        tl.make_langevin_step(b.ops, np.ones((b.ops.Nph, b.ops.Ltau)), 1e-3, "midpoint")
    with pytest.raises(ValueError, match="Nph, Ltau"):
        b.step(b.params, b.x[0])
    assert bench.LANGEVIN_64X64.n_chains == 16 and bench.SSH_LANGEVIN_64X64.n_chains == 8


# --- the driver ------------------------------------------------------------------

def _example(name, tmp_path, seed=11):
    """A stock Langevin example with its counts cut (and the KPM order
    capped, so the CPU runs it in seconds)."""
    cfg = copy.deepcopy(jconfig.load_toml(os.path.join(EXAMPLES, f"{name}.toml")))
    cfg["simulation"].update(random_seed=seed, num_bins=2, filepath=str(tmp_path))
    cfg["langevin"].update(burnin_timesteps=2, simulation_timesteps=4, meas_freq=1)
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"]["preconditioner"]["max_order"] = 8
    return cfg


@pytest.mark.parametrize("name", ["holstein_langevin_square", "ssh_langevin_square"])
def test_build_setup_langevin_matches_jax(name, tmp_path):
    cfg = jconfig.load_toml(os.path.join(EXAMPLES, f"{name}.toml"))
    cfg["simulation"]["random_seed"] = 11
    js = jconfig.build_setup(copy.deepcopy(cfg), str(tmp_path))
    ts = tconfig.build_setup(copy.deepcopy(cfg), str(tmp_path), "cpu", torch.float64)
    assert ts.dynamics_type == js.dynamics_type == "langevin"
    assert ts.hmc_cfg is None and ts.hmc_burnin_cfg is None
    assert (ts.langevin_dt, ts.langevin_method) == (js.langevin_dt, js.langevin_method)
    assert ts.langevin_method == "rk"
    np.testing.assert_array_equal(ts.fa_Q, js.fa_Q)
    sp, jsp = ts.sim_params, js.sim_params
    assert (sp.burnin, sp.nsteps, sp.meas_freq, sp.bin_size) == (
        jsp.burnin, jsp.nsteps, jsp.meas_freq, jsp.bin_size)
    assert (ts.solver_cfg.kind, ts.solver_cfg.restart, ts.solver_cfg.tol) == (
        js.solver_cfg.kind, js.solver_cfg.restart, js.solver_cfg.tol)
    assert ts.reflect_cfg.n_moves == ts.swap_cfg.n_moves == 0
    with pytest.raises(ValueError, match="exactly one of"):
        tconfig.build_setup({**cfg, "hmc": {}}, str(tmp_path), "cpu", torch.float64)
    bad = copy.deepcopy(cfg)
    bad["langevin"]["update_method"] = 4
    with pytest.raises(ValueError, match="update_method"):
        tconfig.build_setup(bad, str(tmp_path), "cpu", torch.float64)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", ["holstein_langevin_square", "ssh_langevin_square"])
def test_cli_runs_langevin_example(name, tmp_path, capsys):
    """``python -m elphdynamics_tpu_torch examples/<name>.toml --device cpu``
    with its counts cut: the output tree of the JAX package's driver on the
    same file, finite bins, every step accepted, a checkpoint that
    reloads."""
    paths = {}
    for pkg in ("jax", "torch"):
        (tmp_path / f"{pkg}_input").mkdir()
        paths[pkg] = tmp_path / f"{pkg}_input" / f"{name}.toml"
        paths[pkg].write_text(dump_toml(_example(name, tmp_path / pkg)))
    assert cli.main([str(paths["torch"]), "1", "--device", "cpu", "--x64", "--chains", "2"]) == 0
    assert "'acceptance_rate': 1.0" in capsys.readouterr().out
    jsimulate(str(paths["jax"]), run_id=1, n_chains=2)
    folder = tmp_path / "torch" / f"{name}-1"
    names = _tree(folder)
    assert names == _tree(tmp_path / "jax" / f"{name}-1")
    assert "hmc_sim_log.out" not in names
    for b in (1, 2):
        for sub in ("Greens_position", "Greens_momentum"):
            data = np.loadtxt(folder / f"{sub}_f" / f"{sub}_{b:05d}.out", skiprows=1)
            assert data.size and np.isfinite(data).all(), sub
    summary = (folder / f"{name}_summary.out").read_text()
    assert "[langevin]" in summary and "## SIMULATION INFO ##" in summary
    assert "Solver Failures" not in summary
    setup, params, x = load_model(str(folder), "cpu")
    assert setup.dynamics_type == "langevin"
    assert tuple(x.shape) == (2, setup.ops.Nph, setup.ops.Ltau) and torch.isfinite(x).all()
