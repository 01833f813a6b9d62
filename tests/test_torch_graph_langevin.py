"""The graphed Langevin step's segments on the CPU (``dynamics/graphs.py``).

On a CUDA field the one-rank CG Langevin step of a real field replays CUDA
graphs of fixed segments (start, CG blocks, verification, for RK and Heun
a middle segment and a second solve, end); on the CPU the same segment
functions run uncaptured. Here, in float64, 2 chains, Lτ = 10:

* the segmented step equals the eager step (asked for by name) bit for bit
  over two steps on the same draws, host reads included: Euler, RK and Heun
  × Holstein (dense and fold branch) and SSH (dense and fold Ā), with and
  without the KPM preconditioner, at ``loop_precision`` "high" and
  "highest";
* it matches the JAX package's jitted step on JAX's draws (x to 1e-10,
  iterations and flags exact), one case per method;
* the gate: ``eager=True`` takes the eager step; complex hopping, the
  near-null and ``exact_lowfreq`` preconditioners, BiCGStab and GMRES take
  the graphed one (``tests/test_torch_graph_complex.py`` holds the twisted
  cases, ``tests/test_torch_graph_aids.py`` the solver aids,
  ``tests/test_torch_graph_nonsym.py`` the nonsymmetric solves);
* a solve made to fail runs the verification and the eager retry;
* a stand-in capture: a second step makes no host-to-device copy;
* changed parameters (the μ tuner) are copied into the workspace, a new
  exp(−Δτ·K) makes a new one;
* the Langevin TOML driver writes the same bins through either step.
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

from elphdynamics_tpu.dynamics.langevin import make_langevin_step as j_make_langevin_step
from elphdynamics_tpu.dynamics.solve import SolverConfig as JSolverConfig
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_Q
from elphdynamics_tpu_torch import bench, simulation, solvers
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics import langevin as tl
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.io.output import dump_toml
from elphdynamics_tpu_torch.ops import kpm, nearnull
from test_torch_graph_update_ssh import HostUploads
from test_torch_langevin import C, EXAMPLES, FA, KPM, _example, _fields, _jax_draws, _models, _start

torch.set_num_threads(1)

MODELS = ["dense", "fold", "ssh", "ssh-fold"]
DT = 0.01


@pytest.fixture
def branch_gate(monkeypatch):
    """Close the dense-Ā gate in both packages (Ā through the fold and the
    fused Chebyshev step: the twins of K1 and K2)."""
    def close():
        monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
        monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    return close


def _pair(name, method, precond=True, branch_gate=None, **scfg_kw):
    """The 4×4 model ``name`` (the fold names with the dense Ā off), its
    segmented Langevin step and the eager twin (one preconditioner, the
    port's fixed start vectors), and C chains of fields (made with a
    device, as a card's fields are: :class:`HostUploads` counts tensors
    made from host data without one)."""
    if name.endswith("fold"):
        branch_gate()
    _, jp, tops, tp = _models(name.split("-")[0])
    Q = build_Q(np.asarray(jp.omega), tops.dtau, tops.Ltau, FA)
    scfg = SolverConfig(**{**dict(tol=1e-6, maxiter=500), **scfg_kw})
    pre = kpm.make_precond(tops, kpm.KPMConfig(**KPM)) if precond else None
    seg = tl.make_langevin_step(tops, Q, DT, method, scfg, pre)
    eager = tl.make_langevin_step(tops, Q, DT, method, scfg, pre, eager=True)
    assert seg.segmented and not eager.segmented
    return tops, tp, seg, eager, torch.as_tensor(_fields(tops), device="cpu")


def _run(step, params, x, draws):
    solvers.host_reads = 0
    x1, stats = step(params, x, draws=draws)
    return x1, stats, solvers.host_reads


def _assert_same(a, b):
    (xa, sa, ra), (xb, sb, rb) = a, b
    assert torch.equal(xa, xb)
    assert torch.equal(sa.iters, sb.iters) and torch.equal(sa.flag, sb.flag)
    assert ra == rb


def _two_steps(seg, eager, tp, x, seed=7):
    """Two steps each way from ``x`` on the same draws; the segmented
    results."""
    xs = xe = x
    out = []
    for u in range(2):
        draws = eager.draw(tp, x, C, torch.Generator().manual_seed(seed + u))
        r_seg, r_eager = _run(seg, tp, xs, draws), _run(eager, tp, xe, draws)
        _assert_same(r_seg, r_eager)
        xs, xe = r_seg[0], r_eager[0]
        out.append(r_seg)
    return out


# --- the segmented step against the eager one

@pytest.mark.parametrize("precond", [True, False], ids=["kpm", "plain"])
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("method", tl.METHODS)
def test_segmented_step_equals_eager(method, name, precond, branch_gate):
    tops, tp, seg, eager, x = _pair(name, method, precond, branch_gate)
    runs = _two_steps(seg, eager, tp, x)
    for x1, stats, reads in runs:
        assert reads > 0 and bool((stats.flag == 0).all()) and bool((stats.iters > 0).all())
        assert float((x1 - x).abs().max()) > 1e-4
    ws = seg.workspace()
    assert ws is not None and ws.graphs is None and eager.workspace() is None
    if precond:
        assert (ws.kpm.expK is None) == name.endswith("fold")
    # one CG block graph serves both solves: "high" at tol 1e-6 steers with
    # the in-loop operator, the verification uses the full one
    assert seg.workspace().retries == 0


@pytest.mark.parametrize("method", tl.METHODS)
def test_segmented_step_equals_eager_highest(method, branch_gate):
    """``loop_precision`` "highest": every operator the full one."""
    tops, tp, seg, eager, x = _pair("dense", method, branch_gate=branch_gate,
                                    loop_precision="highest")
    _two_steps(seg, eager, tp, x)


# --- against the JAX package

@pytest.mark.parametrize("method,name", [("euler", "dense"), ("rk", "fold"), ("heun", "ssh")])
def test_segmented_step_matches_jax(method, name):
    jops, jp, tops, tp = _models(name)
    Q = build_Q(np.asarray(jp.omega), tops.dtau, tops.Ltau, FA)
    x0 = _fields(tops)
    scfg = dict(tol=1e-8, maxiter=1000)
    jstep = jax.jit(j_make_langevin_step(
        jops, Q, DT, method, JSolverConfig(**scfg),
        jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, jnp.asarray(x0[c]), keys[c]) for c in range(C)]
    # the port's KPM preconditioner started from the JAX package's vectors
    cfg, start = kpm.KPMConfig(**KPM), _start(tops.Nsites)
    pre = replace(kpm.make_precond(tops, cfg), start=start,
                  setup=lambda params, x, start_=None: kpm.setup(
                      tops, params, x, cfg, start if start_ is None else start_))
    step = tl.make_langevin_step(tops, Q, DT, method, SolverConfig(**scfg), pre)
    x1, stats = step(tp, torch.as_tensor(x0),
                     draws=_jax_draws(keys, method, tops.Nph, tops.Nsites, tops.Ltau))
    assert step.segmented and step.workspace() is not None
    for c in range(C):
        jx, jstats, _ = runs[c]
        np.testing.assert_allclose(x1[c].numpy(), np.asarray(jx), rtol=0, atol=1e-10)
        assert int(stats.iters[c]) == int(jstats.iters)
        assert int(stats.flag[c]) == int(jstats.flag) == 0


# --- the gate

@pytest.mark.parametrize("case", ["complex", "bicgstab", "gmres", "nearnull", "exact_lowfreq",
                                  "eager"])
def test_gate_takes_the_eager_step(case):
    """Complex hopping, the near-null and ``exact_lowfreq``
    preconditioners, BiCGStab and GMRES take the graphed step (a workspace,
    graphs on a card; ``tests/test_torch_graph_nonsym.py`` holds the
    nonsymmetric solves); ``eager=True`` is not segmented at all. Each step
    equals its eager twin."""
    twist = bench.TWIST if case == "complex" else None
    kind = case if case in ("bicgstab", "gmres") else "cg"
    b = bench.build_langevin_step(4, 1.0, 0.1, 1e-3, C, "cpu", torch.float64, method="rk",
                                  solver=SolverConfig(tol=1e-6, maxiter=500, kind=kind),
                                  twist=twist)
    precond = b.precond
    if case == "nearnull":
        precond = nearnull.make_nearnull_precond(b.ops, kpm.KPMConfig(max_order=4),
                                                 nearnull.NearNullConfig(k=4, c=2))
    elif case == "exact_lowfreq":
        precond = kpm.make_precond(b.ops, kpm.KPMConfig(max_order=4, exact_lowfreq=1))
    step = tl.make_langevin_step(b.ops, b.Q, b.dt, b.method, b.solver, precond,
                                 eager=case == "eager")
    graphed = case != "eager"
    assert step.segmented == graphed
    twin = tl.make_langevin_step(b.ops, b.Q, b.dt, b.method, b.solver, precond, eager=True)
    draws = twin.draw(b.params, b.x, C, torch.Generator().manual_seed(2))
    _assert_same(_run(step, b.params, b.x, draws), _run(twin, b.params, b.x, draws))
    assert (step.workspace() is not None) == graphed


def test_bench_eager_twin_and_stock_example():
    """``LangevinBench.eager`` is the eager twin of the bench step;
    ``bench.build_langevin_example`` builds the stock 4×4 file's step
    (RK, KPM max_order 64) segmented, and one step of it is finite."""
    b = bench.build_langevin_step(4, 1.0, 0.1, 1e-3, C, "cpu", torch.float64, method="heun")
    assert b.step.segmented and not b.eager().segmented
    draws = b.eager().draw(b.params, b.x, C, torch.Generator().manual_seed(4))
    _assert_same(_run(b.step, b.params, b.x, draws), _run(b.eager(), b.params, b.x, draws))
    s = bench.build_langevin_example(os.path.join(EXAMPLES, "holstein_langevin_square.toml"),
                                     1, "cpu", torch.float64)
    assert s.step.segmented and s.method == "rk" and s.precond.cfg.max_order == 64
    assert tuple(s.x.shape) == (1, 16, 20)
    x1, stats = s.step(s.params, s.x, s.generator)
    assert bool(torch.isfinite(x1).all()) and int(stats.flag.max()) == 0
    with pytest.raises(ValueError, match="langevin"):
        bench.build_langevin_example(os.path.join(EXAMPLES, "holstein_hmc_square.toml"), 1,
                                     "cpu")


# --- the verification's retry

@pytest.mark.parametrize("method", ["euler", "rk"])
def test_failed_solve_runs_verification_and_retry(method, branch_gate):
    """maxiter 2: every solve fails its verification and is retried from
    zero, unpreconditioned (eagerly, between replays on the card); x,
    iterations, flags and host reads are the eager step's."""
    tops, tp, seg, eager, x = _pair("dense", method, branch_gate=branch_gate, maxiter=2)
    draws = eager.draw(tp, x, C, torch.Generator().manual_seed(3))
    r_seg, r_eager = _run(seg, tp, x, draws), _run(eager, tp, x, draws)
    _assert_same(r_seg, r_eager)
    assert seg.workspace().retries == tl.n_forces(method)
    assert bool((r_seg[1].iters > 2).all())       # the retry's iterations are counted


# --- a stand-in capture

@pytest.mark.parametrize("method,name", [("euler", "dense"), ("rk", "fold"), ("heun", "ssh")])
def test_stand_in_capture_uploads_nothing(method, name, branch_gate, monkeypatch):
    """The step is built and warmed up (its first step) under the mode,
    which then counts through a second step: every segment runs again, as
    a capture runs it, and makes no host-to-device copy."""
    mode = HostUploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    with mode:
        tops, tp, seg, eager, x = _pair(name, method, branch_gate=branch_gate)
        gen = torch.Generator().manual_seed(4)
        x, _ = seg(tp, x, draws=eager.draw(tp, x, C, gen))
        draws = eager.draw(tp, x, C, gen)
        mode.counting = True
        seg(tp, x, draws=draws)
        mode.counting = False
    assert mode.calls == []


# --- the workspace across steps

def test_changed_parameters_equal_eager(branch_gate):
    """A moved μ (the driver's μ tuner) and ω are copied into the kept
    parameters in place; a new exp(−Δτ·K), which a graph holds in bf16,
    makes a new workspace."""
    tops, tp, seg, eager, x = _pair("dense", "rk", branch_gate=branch_gate)
    moved = replace(tp, mu=tp.mu + 0.05, omega=tp.omega * 0.95)
    xs = xe = x
    for u, params in enumerate((tp, moved, tp)):
        draws = eager.draw(params, x, C, torch.Generator().manual_seed(21 + u))
        r_seg, r_eager = _run(seg, params, xs, draws), _run(eager, params, xe, draws)
        _assert_same(r_seg, r_eager)
        xs, xe = r_seg[0], r_eager[0]
        if u == 0:
            ws = seg.workspace()
    assert seg.workspace() is ws and torch.equal(ws.params.mu, tp.mu)
    new_k = replace(tp, expK=tp.expK.clone(), expK_inv=tp.expK_inv.clone())
    draws = eager.draw(tp, x, C, torch.Generator().manual_seed(30))
    _assert_same(_run(seg, new_k, xs, draws), _run(eager, new_k, xe, draws))
    assert seg.workspace() is not ws


# --- the driver

def test_driver_writes_the_same_bins(tmp_path, monkeypatch):
    """``examples/holstein_langevin_square.toml`` with its counts cut
    (2 + 4 steps, a measurement per step, 2 bins, nᵥ 4, KPM max_order 8),
    2 chains: the driver through the graphed step and measurement (their
    segments run) and through the eager ones write byte-identical bins."""
    calls = {"n": 0}
    run = graphs.Workspace.run

    def counted(self, name, fn):
        calls["n"] += 1
        return run(self, name, fn)

    monkeypatch.setattr(graphs.Workspace, "run", counted)
    makers = {k: getattr(simulation, k) for k in ("make_langevin_step", "make_measurement_step")}
    folders = {}
    for form in ("graphed", "eager"):
        if form == "eager":
            # the measurement is graphed too: the eager run asks for both eager
            for k, real in makers.items():
                monkeypatch.setattr(simulation, k, lambda *a, _r=real, **kw: _r(
                    *a, **{**kw, "eager": True}))
        cfg = _example("holstein_langevin_square", tmp_path / form)
        path = tmp_path / f"{form}.toml"
        path.write_text(dump_toml(copy.deepcopy(cfg)))
        calls["n"] = 0
        stats = simulation.simulate(str(path), run_id=1, n_chains=C, device="cpu",
                                    dtype=torch.float64)
        assert stats["acceptance_rate"] == 1.0 and "solver_failures" not in stats
        assert (calls["n"] > 0) == (form == "graphed")
        folders[form] = tmp_path / form / "holstein_langevin_square-1"
    bins = sorted(os.path.relpath(os.path.join(d, f), folders["graphed"])
                  for d, _, fs in os.walk(folders["graphed"]) for f in fs
                  if d.endswith("_f"))
    assert len(bins) >= 10
    match, mismatch, errors = filecmp.cmpfiles(folders["graphed"], folders["eager"], bins,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(bins)
