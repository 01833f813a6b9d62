"""The segmented reflection, swap and measurement on the CPU
(``dynamics/graphs.py``).

On a CUDA field the one-rank reflection and swap updates and the
measurement step of a real field replay CUDA graphs of fixed segments (a
move's start, CG blocks, the verification, the next move's Metropolis test
and start, the last test; the probe start, CG blocks, the verification,
the estimators); on the CPU the same segment functions run uncaptured.
Here, in float64, 2 chains, Lτ = 10:

* the segmented calls equal the eager calls (asked for by name) bit for
  bit over two calls on the same draws, host reads included: reflection
  and swap on Holstein (dense and fold branch), swap on SSH (dense and fold
  Ā), with and without the KPM preconditioner, their tol² solves on the
  full operator and (a loose tol) on the in-loop one; the measurement on
  the same models with the on-site kinds, BondBond, CurrentCurrent,
  BondPairGreens, SSH's bond PhononGreens and the snapshots, time
  dependent and not, at ``loop_precision`` "high" and "highest";
* they match the JAX package's jitted reflection, swap and measurement
  step on JAX's draws (x to 1e-10, increments to 1e-9);
* the gate: ``eager=True`` and a site shard take the eager call; complex
  hopping, ``[solver] block``, the near-null and ``exact_lowfreq``
  preconditioners, BiCGStab and GMRES take the segmented one
  (``tests/test_torch_graph_complex.py`` holds the twisted cases,
  ``tests/test_torch_graph_aids.py`` the solver aids,
  ``tests/test_torch_graph_nonsym.py`` the nonsymmetric solves);
* a solve made to fail runs the verification and the eager retry;
* a stand-in capture: a second call makes no host-to-device copy;
* the stock Holstein and SSH HMC files and the twisted Holstein example
  through the driver write the same bins either way.
"""

import copy
import filecmp
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics import special_updates as jsu
from elphdynamics_tpu.dynamics.force import SolverConfig as JSolverConfig
from elphdynamics_tpu.io import config as jconfig
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu_torch import bench, simulation, solvers
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics import special_updates as tsu
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import kpm, nearnull
from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard, shard_model, shard_params
from test_torch_graph_update_ssh import HostUploads
from test_torch_langevin import EXAMPLES, KPM, _fields, _models, _start
from test_torch_measurements import NV, SPECS, TOL, _jax_probes, _special_draws
from test_torch_measurements import models  # noqa: F401  (the module fixture)
from test_torch_ssh import _swap_draws

torch.set_num_threads(1)

C = 2
MODELS = ["dense", "fold", "ssh", "ssh-fold"]
# (kind, model) of the special updates: SSH's reflection is a null move
SPECIAL = [("reflect", "dense"), ("reflect", "fold"), ("swap", "dense"), ("swap", "fold"),
           ("swap", "ssh"), ("swap", "ssh-fold")]
# the moves' tolerance: tol² 1e-10 runs the full operator in the loop, tol²
# 9e-6 ≥ 1e-6 the in-loop one ("cg_block_loop")
SPECIAL_TOLS = {"full": 1e-5, "loop": 3e-3}
N_MOVES = 3


@pytest.fixture
def branch_gate(monkeypatch):
    """Close the dense-Ā gate in both packages (Ā through the fold and the
    fused Chebyshev step: the twins of K1 and K2)."""
    def close():
        monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
        monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    return close


def _model(name, branch_gate):
    """The 4×4 model ``name`` (the fold names with the dense Ā off) and C
    chains of its fields."""
    if name.endswith("fold"):
        branch_gate()
    _, _, tops, tp = _models(name.split("-")[0])
    return tops, tp, torch.as_tensor(_fields(tops), device="cpu")


def _precond(tops, on=True):
    return kpm.make_precond(tops, kpm.KPMConfig(**KPM)) if on else None


def _call(fn, *args, **kw):
    solvers.host_reads = 0
    out = fn(*args, **kw)
    return out, solvers.host_reads


def _equal(a, b):
    """Nested tuples / dicts of tensors, equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for p, q in zip(a, b):
            _equal(p, q)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# --- the special updates against the eager ones

def _special_pair(kind, name, branch_gate, precond=True, eager=False, **cfg_kw):
    tops, tp, x = _model(name, branch_gate)
    make = tsu.make_reflection_update if kind == "reflect" else tsu.make_swap_update
    cfg = tsu.SpecialUpdateConfig(**{**dict(freq=1, n_moves=N_MOVES, maxiter=500), **cfg_kw})
    pre = _precond(tops, precond)
    seg, twin = make(tops, cfg, pre, eager=eager), make(tops, cfg, pre, eager=True)
    return tops, tp, x, seg, twin


def _two_calls(seg, twin, tp, x, seed=7):
    """Two calls each way from ``x`` on the same draws; the segmented
    results with their host reads."""
    xs = xe = x
    out = []
    for u in range(2):
        draws = twin.draw(tp, x, C, torch.Generator().manual_seed(seed + u))
        r_seg, r_eager = _call(seg, tp, xs, draws=draws), _call(twin, tp, xe, draws=draws)
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1]
        xs, xe = r_seg[0][0], r_eager[0][0]
        out.append(r_seg)
    return out


@pytest.mark.parametrize("tol", list(SPECIAL_TOLS))
@pytest.mark.parametrize("precond", [True, False], ids=["kpm", "plain"])
@pytest.mark.parametrize("kind,name", SPECIAL, ids=[f"{k}-{m}" for k, m in SPECIAL])
def test_segmented_special_update_equals_eager(kind, name, precond, tol, branch_gate):
    tops, tp, x, seg, twin = _special_pair(kind, name, branch_gate, precond,
                                           tol=SPECIAL_TOLS[tol])
    assert seg.segmented and not twin.segmented and seg.n_moves == N_MOVES
    runs = _two_calls(seg, twin, tp, x)
    moved = False
    for ((x1, rate), reads) in runs:
        assert reads > 0 and bool(((rate >= 0) & (rate <= 1)).all())
        moved = moved or not torch.equal(x1, x)
    assert moved    # some move was accepted
    ws = seg.workspace()
    assert ws is not None and ws.graphs is None and twin.workspace() is None
    assert seg.workspace().retries == 0
    if precond:
        assert (ws.kpm.expK is None) == name.endswith("fold")
        loop = graphs.CGSolve(tops, None, 1, 1.0, "high", "Lphi", True).kind(
            SPECIAL_TOLS[tol] ** 2)
        assert loop == ("cg_block_loop" if tol == "loop" else "cg_block")


def test_null_moves_take_no_workspace():
    """SSH's reflection and a call of no moves return x unchanged without
    a workspace."""
    _, _, tops, tp = _models("ssh")
    x = torch.as_tensor(_fields(tops))
    upd = tsu.make_reflection_update(tops, tsu.SpecialUpdateConfig(n_moves=3), _precond(tops))
    x1, rate = upd(tp, x, torch.Generator().manual_seed(0))
    assert x1 is x and not upd.segmented and upd.workspace() is None
    assert torch.equal(rate, torch.zeros(C, dtype=torch.float64))


# --- the measurement against the eager one

def _mspec(ssh: bool, td: bool):
    kinds = tm.ONSITE_CORR_KINDS[:4] if ssh else tm.ONSITE_CORR_KINDS
    inter = ("BondBond", "CurrentCurrent", "BondPairGreens") + (("PhononGreens",) if ssh else ())
    return tm.MeasurementSpec(nv=NV, onsite_corr=tuple((k, td) for k in kinds),
                              intersite_corr=tuple((k, td) for k in inter),
                              snapshots=("density", "double_occupancy", "phonon_position"))


def _measure_pair(name, branch_gate, precond=True, td=True, scfg_kw=None, eager=False):
    tops, tp, x = _model(name, branch_gate)
    scfg = SolverConfig(**{**dict(tol=1e-6, maxiter=500), **(scfg_kw or {})})
    pre = _precond(tops, precond)
    mspec = _mspec(not tops.is_holstein, td)
    seg = tm.make_measurement_step(tops, mspec, scfg, pre, eager=eager)
    twin = tm.make_measurement_step(tops, mspec, scfg, pre, eager=True)
    return tops, tp, x, seg, twin


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("td", [True, False], ids=["time_dependent", "equal_time"])
@pytest.mark.parametrize("precond", [True, False], ids=["kpm", "plain"])
@pytest.mark.parametrize("name", MODELS)
def test_segmented_measurement_equals_eager(name, precond, td, precision, branch_gate):
    tops, tp, x, seg, twin = _measure_pair(name, branch_gate, precond, td,
                                           dict(loop_precision=precision))
    assert seg.segmented and not twin.segmented
    xs = x
    for u in range(2):
        R = twin.draw(tp, xs, torch.Generator().manual_seed(3 + u))
        r_seg, r_eager = _call(seg, tp, xs, R=R), _call(twin, tp, xs, R=R)
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1] > 0
        inc, stats, snaps = r_seg[0]
        assert bool((stats["flag"] == 0).all()) and bool((stats["iters"] > 0).all())
        assert len(snaps) == 3 and "CurrentCurrent" in inc["intersite_corr"]
        xs = xs + 0.05
    ws = seg.workspace()
    assert ws is not None and ws.graphs is None and twin.workspace() is None
    # the probes come from the generator in the eager order
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    _equal(seg(tp, x, g1), twin(tp, x, g2))
    assert torch.equal(torch.randn(3, generator=g1), torch.randn(3, generator=g2))


# --- against the JAX package

def _jax_start_precond(tops, cfg_kw):
    """The port's KPM preconditioner started from the JAX package's power
    iteration vectors (a graphable one: its configuration and start kept)."""
    cfg, start = kpm.KPMConfig(**cfg_kw), _start(tops.Nsites)
    return replace(kpm.make_precond(tops, cfg), start=start,
                   setup=lambda params, x, start_=None: kpm.setup(
                       tops, params, x, cfg, start if start_ is None else start_))


@pytest.mark.parametrize("kind", ["reflect", "swap"])
def test_segmented_special_update_matches_jax(models, kind):  # noqa: F811
    """Holstein (the two-orbital lattice of ``test_torch_measurements``)."""
    jops, jp, jprec, tops, tp, _, x = models
    cfg = dict(freq=1, n_moves=N_MOVES, tol=1e-5, maxiter=2000)
    jmake = jsu.make_reflection_update if kind == "reflect" else jsu.make_swap_update
    jupd = jax.jit(jmake(jops, jsu.SpecialUpdateConfig(**cfg), jprec))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    jres = [jupd(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    per_chain = [_special_draws(kind, keys[c], N_MOVES, tops.Nsites, tops.Ltau, tops.Nph,
                                tops.spec.Nbonds) for c in range(C)]
    draws = tsu.SpecialDraws(*(torch.as_tensor(np.stack([d[k] for d in per_chain], axis=1))
                               for k in range(3)))
    tmake = tsu.make_reflection_update if kind == "reflect" else tsu.make_swap_update
    tupd = tmake(tops, tsu.SpecialUpdateConfig(**cfg), _jax_start_precond(tops, dict(max_order=8)))
    x_new, rate = tupd(tp, torch.as_tensor(x), draws=draws)
    assert tupd.segmented and tupd.workspace() is not None
    for c in range(C):
        jx, jrate, _ = jres[c]
        assert round(rate[c].item() * N_MOVES) == round(float(jrate) * N_MOVES)
        np.testing.assert_allclose(x_new[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)


def test_segmented_ssh_swap_matches_jax(branch_gate):
    """SSH (the 4×4 model of ``test_torch_langevin``) on its fold Ā."""
    branch_gate()
    jops, jp, tops, tp = _models("ssh")
    x = _fields(tops)
    cfg = dict(freq=1, n_moves=N_MOVES, tol=1e-5, maxiter=2000)
    jupd = jax.jit(jsu.make_swap_update(jops, jsu.SpecialUpdateConfig(**cfg),
                                        jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    jres = [jupd(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    per_chain = [_swap_draws(keys[c], N_MOVES, tops.Nph, tops.Nsites, tops.Ltau)
                 for c in range(C)]
    draws = tsu.SpecialDraws(*(torch.as_tensor(np.stack([d[k] for d in per_chain], axis=1))
                               for k in range(3)))
    tupd = tsu.make_swap_update(tops, tsu.SpecialUpdateConfig(**cfg),
                                _jax_start_precond(tops, KPM))
    x_new, rate = tupd(tp, torch.as_tensor(x), draws=draws)
    assert tupd.segmented and tupd.workspace().kpm.expK is None
    for c in range(C):
        jx, jrate, _ = jres[c]
        assert round(rate[c].item() * N_MOVES) == round(float(jrate) * N_MOVES)
        np.testing.assert_allclose(x_new[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)


@pytest.mark.parametrize("spec", list(SPECS))
def test_segmented_measurement_matches_jax(models, spec):  # noqa: F811
    jops, jp, jprec, tops, tp, _, x = models
    mspec = SPECS[spec]
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jstep = jax.jit(jm.make_measurement_step(jops, mspec, JSolverConfig(tol=TOL, maxiter=2000),
                                             jprec))
    jout = [jstep(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    tstep = tm.make_measurement_step(tops, mspec, SolverConfig(tol=TOL, maxiter=2000),
                                     _jax_start_precond(tops, dict(max_order=8)))
    R = torch.as_tensor(_jax_probes(keys, tops.Nsites, tops.Ltau))
    inc, stats, snaps = tstep(tp, torch.as_tensor(x), R=R)
    assert tstep.segmented and tstep.workspace() is not None
    for c in range(C):
        jinc, jstats, jsnaps, _ = jout[c]
        for group in inc:
            assert set(inc[group]) == set(jinc[group]), group
            for k, v in inc[group].items():
                np.testing.assert_allclose(v[c].numpy(), np.asarray(jinc[group][k]),
                                           rtol=1e-9, atol=1e-9, err_msg=f"{group}/{k}")
        assert int(stats["iters"][c]) == int(jstats["iters"])
        assert int(stats["flag"][c]) == int(jstats["flag"]) == 0
        for k, v in snaps.items():
            np.testing.assert_allclose(v[c].numpy(), np.asarray(jsnaps[k]), rtol=1e-9, atol=1e-9)


# --- the gate

GATE = ["complex", "block", "bicgstab", "gmres", "nearnull", "exact_lowfreq", "eager", "shard"]


def _gate_model(case):
    twist = bench.TWIST if case == "complex" else None
    b = bench.build_bench_step(4, 1.0, 0.1, 0.05, C, "cpu", torch.float64, twist=twist,
                               trajectory_time=0.1)
    ops, params, x = b.ops, b.params, b.state.x
    precond = kpm.make_precond(ops, kpm.KPMConfig(max_order=4))
    if case == "nearnull":
        precond = nearnull.make_nearnull_precond(ops, kpm.KPMConfig(max_order=4),
                                                 nearnull.NearNullConfig(k=4, c=2))
    elif case == "exact_lowfreq":
        precond = kpm.make_precond(ops, kpm.KPMConfig(max_order=4, exact_lowfreq=1))
    elif case == "shard":
        # one site rank holding every site: the sharded model, whose calls
        # need a process group (tests/test_torch_parallel_*.py run them)
        shard = SiteShard(ops.spec.ckb, ops.spec.wij_table, 1, 0)
        ops = make_model_ops(shard_model(ops.spec, params, shard)[0])
        params = shard_params(params, shard)
        precond = kpm.make_precond(ops, kpm.KPMConfig(max_order=4))
    return ops, params, x, precond


@pytest.mark.parametrize("case", GATE)
def test_gate_takes_the_eager_call(case):
    """Complex hopping, ``[solver] block``, the near-null and
    ``exact_lowfreq`` preconditioners, BiCGStab and GMRES take the
    segmented calls (a workspace, graphs on a card;
    ``tests/test_torch_graph_nonsym.py`` holds the nonsymmetric probe
    solves); ``eager=True`` is not segmented at all. Each call equals its
    eager twin. A site shard takes the segmented calls too (they need a
    process group: only the gate is read here, the calls are held to their
    eager forms in ``tests/test_torch_graph_sites.py``), except a gloo site
    group on a card, whose calls run eagerly. The moves always
    solve by CG, so the solver kind and ``block`` gate only the
    measurement."""
    ops, params, x, precond = _gate_model(case)
    kind = case if case in ("bicgstab", "gmres") else "cg"
    scfg = SolverConfig(tol=1e-6, maxiter=500, kind=kind, block=case == "block")
    mspec = tm.MeasurementSpec(nv=NV, onsite_corr=(("Greens", True),))
    eager = case == "eager"
    mstep = tm.make_measurement_step(ops, mspec, scfg, precond, eager=eager)
    mtwin = tm.make_measurement_step(ops, mspec, scfg, precond, eager=True)
    measure_segmented = case != "eager"
    assert mstep.segmented == measure_segmented
    cfg = tsu.SpecialUpdateConfig(freq=1, n_moves=2, maxiter=500)
    makers = (tsu.make_reflection_update, tsu.make_swap_update)
    moves_segmented = case in ("complex", "block", "bicgstab", "gmres", "nearnull",
                               "exact_lowfreq", "shard")
    if case == "shard":
        assert all(make(ops, cfg, precond).segmented for make in makers)
        # on a card the calls read the site group's backend: gloo runs eagerly
        for backend, on_card in (("gloo", False), ("nccl", True)):
            ops.shard.backend = lambda b=backend: b
            assert graphs.graphable(ops.shard, torch.device("cuda")) is on_card
        return
    R = mtwin.draw(params, x, torch.Generator().manual_seed(2))
    _equal(mstep(params, x, R=R), mtwin(params, x, R=R))
    assert (mstep.workspace() is not None) == measure_segmented
    for make in makers:
        upd = make(ops, cfg, precond, eager=eager)
        twin = make(ops, cfg, precond, eager=True)
        assert upd.segmented == moves_segmented
        draws = twin.draw(params, x, C, torch.Generator().manual_seed(4))
        _equal(upd(params, x, draws=draws), twin(params, x, draws=draws))
        assert (upd.workspace() is not None) == moves_segmented


# --- the verification's retry

@pytest.mark.parametrize("what", ["swap", "measurement"])
def test_failed_solve_runs_verification_and_retry(what, branch_gate):
    """maxiter 2: every solve fails its verification and is retried from
    zero, unpreconditioned (eagerly, between replays on the card); the
    results and host reads are the eager call's."""
    if what == "swap":
        tops, tp, x, seg, twin = _special_pair("swap", "dense", branch_gate, maxiter=2)
        draws = twin.draw(tp, x, C, torch.Generator().manual_seed(3))
        r_seg, r_eager = _call(seg, tp, x, draws=draws), _call(twin, tp, x, draws=draws)
        retries = N_MOVES
    else:
        tops, tp, x, seg, twin = _measure_pair("dense", branch_gate, scfg_kw=dict(maxiter=2))
        R = twin.draw(tp, x, torch.Generator().manual_seed(3))
        r_seg, r_eager = _call(seg, tp, x, R=R), _call(twin, tp, x, R=R)
        assert bool((r_seg[0][1]["iters"] > 2).all())   # the retry's iterations count
        retries = 1
    _equal(r_seg[0], r_eager[0])
    assert r_seg[1] == r_eager[1]
    assert seg.workspace().retries == retries


# --- a stand-in capture

class Uploads(HostUploads):
    """:class:`HostUploads` that also counts an element assignment from a
    Python number (``t[0] = 1.0``), which on a card copies the number from
    host memory."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__setitem__ and not torch.is_tensor(args[2]):
            self._count("__setitem__", type(args[2]).__name__)
        return super().__torch_function__(func, types, args, kwargs)


@pytest.mark.parametrize("what,name", [("reflect", "dense"), ("swap", "fold"),
                                       ("swap", "ssh-fold"), ("measurement", "fold"),
                                       ("measurement", "ssh")])
def test_stand_in_capture_uploads_nothing(what, name, branch_gate, monkeypatch):
    """The call is built and warmed up (its first call) under the mode,
    which then counts through a second call: every segment runs again, as
    a capture runs it, and makes no host-to-device copy."""
    mode = Uploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    with mode:
        if what == "measurement":
            tops, tp, x, seg, twin = _measure_pair(name, branch_gate)
            gen = torch.Generator().manual_seed(4)
            seg(tp, x, gen)
            R = twin.draw(tp, x, gen)
            mode.counting = True
            seg(tp, x, R=R)
        else:
            tops, tp, x, seg, twin = _special_pair(what, name, branch_gate)
            gen = torch.Generator().manual_seed(4)
            x, _ = seg(tp, x, gen)
            draws = twin.draw(tp, x, C, gen)
            mode.counting = True
            seg(tp, x, draws=draws)
        mode.counting = False
    assert mode.calls == []


# --- the driver

def _stock(name, tmp_path):
    """A stock HMC example with its counts cut (1 + 3 updates, a
    measurement per update, 3 bins, nᵥ 4, 10 leapfrog steps, KPM max_order
    8), so the CPU runs it in seconds."""
    cfg = copy.deepcopy(jconfig.load_toml(os.path.join(EXAMPLES, f"{name}.toml")))
    cfg["simulation"].update(random_seed=11, num_bins=3, filepath=str(tmp_path))
    cfg["hmc"].update(burnin_updates=1, simulation_updates=3, trajectory_time=0.1)
    cfg["measurements"]["num_random_vectors"] = 4
    cfg["solver"]["preconditioner"]["max_order"] = 8
    return cfg


@pytest.mark.parametrize("name", ["holstein_hmc_square", "ssh_hmc_square",
                                  "holstein_hmc_twisted"])
def test_driver_writes_the_same_bins(name, tmp_path, monkeypatch):
    """The stock HMC file, 2 chains: the driver through the segmented
    update, moves and measurement (their segments run) and through the eager
    ones write byte-identical bins; the run's statistics report each part's
    replays (0 on the CPU). The twisted Holstein example (no moves) runs
    its complex update and measurement segmented."""
    calls = {"n": 0}
    run = graphs.Workspace.run

    def counted(self, seg_name, fn):
        calls["n"] += 1
        return run(self, seg_name, fn)

    monkeypatch.setattr(graphs.Workspace, "run", counted)
    makers = {k: getattr(simulation, k) for k in
              ("make_hmc_step", "make_reflection_update", "make_swap_update",
               "make_measurement_step")}
    folders = {}
    for form in ("graphed", "eager"):
        if form == "eager":
            for k, real in makers.items():
                monkeypatch.setattr(simulation, k, lambda *a, _r=real, **kw: _r(
                    *a, **{**kw, "eager": True}))
        cfg = _stock(name, tmp_path / form)
        path = tmp_path / f"{form}.toml"
        path.write_text(dump_toml(copy.deepcopy(cfg)))
        calls["n"] = 0
        stats = simulation.simulate(str(path), run_id=1, n_chains=C, device="cpu",
                                    dtype=torch.float64)
        assert "solver_failures" not in stats
        assert stats["graph_replays"] == {"update": 0, "reflect": 0, "swap": 0,
                                          "measurement": 0}
        assert (calls["n"] > 0) == (form == "graphed")
        folders[form] = tmp_path / form / f"{name}-1"
    bins = sorted(os.path.relpath(os.path.join(d, f), folders["graphed"])
                  for d, _, fs in os.walk(folders["graphed"]) for f in fs
                  if d.endswith("_f"))
    assert len(bins) >= 15
    match, mismatch, errors = filecmp.cmpfiles(folders["graphed"], folders["eager"], bins,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(bins)
    assert filecmp.cmp(folders["graphed"] / "final_phonon_config.out",
                       folders["eager"] / "final_phonon_config.out", shallow=False)


def test_stock_example_builder():
    """``bench.build_hmc_example`` builds the stock file's driver step with
    every part segmented (its eager twin none), ``wide_hmc_config`` widens
    it as the card's 64×64 driver runs do."""
    path = os.path.join(EXAMPLES, "holstein_hmc_square.toml")
    cfg = jconfig.load_toml(path)
    cfg["hmc"]["trajectory_time"] = 0.05
    ex = bench.build_hmc_example(cfg, 1, "cpu", torch.float64)
    parts = (ex.step, ex.reflect, ex.swap, ex.measure)
    assert all(p.segmented for p in parts) and ex.reflect.n_moves == ex.swap.n_moves == 4
    e = ex.eager()
    assert not any(p.segmented for p in (e.step, e.reflect, e.swap, e.measure))
    assert e.precond is ex.precond and e.state is ex.state
    state, _ = ex.step(ex.params, ex.state, ex.generator)
    x, _ = ex.reflect(ex.params, state.x, ex.generator)
    x, _ = ex.swap(ex.params, x, ex.generator)
    inc, stats, _ = ex.measure(ex.params, x, ex.generator)
    assert int(stats["flag"].max()) == 0 and torch.isfinite(inc["global"]["density"]).all()
    wide = bench.wide_hmc_config(cfg)
    assert (wide["lattice"]["L"], wide["holstein"]["beta"], wide["hmc"]["dt"],
            wide["hmc"]["num_multitimesteps"], wide["measurements"]["num_random_vectors"]) == \
        (64, 4.0, 0.025, 4, 10) and cfg["lattice"]["L"] == 4
    with pytest.raises(ValueError, match="hmc"):
        bench.build_hmc_example(os.path.join(EXAMPLES, "holstein_langevin_square.toml"), 1,
                                "cpu")
