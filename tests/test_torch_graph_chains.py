"""The graphed chain-batched calls on the CPU (``dynamics/graphs.py``):
chain ranks, parallel tempering and the 2MN integrator.

On a CUDA field these calls replay CUDA graphs of fixed segments; on the
CPU the same segment functions run uncaptured. Here, in float64 at 4×4
(Lτ = 10):

* the 2MN update's segments (the λ-kick and first half drift, the middle
  kick and second half drift, the closing λ-kick) equal the eager update
  bit for bit, host reads included, on Holstein's dense and fold branches
  and SSH's dense and fold Ā, with the dynamic step size and the verbose
  rows; they match the JAX package's 2MN update on its draws (x, v, ΔH to
  1e-10, equal decisions, flags and iterations);
* under a coupling ladder (per-chain λ, λ₂ or α, α₂) the graphed update
  equals the eager one, and the segmented exchange equals the eager one,
  both parities, 2 and 3 rungs, Holstein and SSH; against the JAX
  package's exchange on its draws: x and v exactly, the acceptance to
  1e-12;
* on 2 gloo chain ranks (``tests/torch_parallel_workers.py``) every call
  (leapfrog, 2MN and laddered updates, both exchanges, the RK Langevin
  step, the moves, the measurement with injected probes and of the
  gathered rung-0 chains) equals its eager form on the rank bit for bit,
  and the ranks' blocks equal the one-rank run; only the exchange has eager
  steps between its replays (its two gathers);
* a stand-in capture: a second 2MN update and a second chain-rank-free
  exchange make no host-to-device copy;
* the workspace takes ladder couplings and a chain block of them, and a
  changed μ, by copying into its kept parameters (one workspace, no new
  graphs); the moves under a ladder equal their eager form;
* the driver under ``[tempering]`` writes the same bins and final fields
  graphed and eager, on one rank and on 2 chain ranks, and a run
  interrupted after its first bin and resumed from the checkpoint ends
  where the uninterrupted run ends.
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

import torch_parallel_workers as W
from elphdynamics_tpu.dynamics import tempering as jtemp
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch import bench, simulation, solvers
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.tempering import (
    TemperingConfig, chain_params, ladder_params, make_exchange_step)
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.parallel.multihost import launch
from test_torch_graph_update_ssh import HostUploads
from test_torch_samplers import BASE, KPM, T, _check, _jax_draws, _model
from test_torch_tempering import MODELS as LADDER_MODELS
from test_torch_tempering import _driver_cfg, _fields
from test_torch_tempering import _jax_draws as _jax_exchange_draws

torch.set_num_threads(1)

C = 2


def _run(step, params, state, draws, *dt):
    """One update, its host reads counted."""
    solvers.host_reads = 0
    out, stats = step(params, state, *dt, draws=draws)
    return out, stats, solvers.host_reads


def _same_update(a, b):
    (sa, ta, ra), (sb, tb, rb) = a, b
    assert torch.equal(sa.x, sb.x) and torch.equal(sa.v, sb.v)
    for f in ("accepted", "iters", "flag", "delta_H", "H", "S", "K", "traj_H", "traj_S",
              "traj_K", "traj_iters"):
        u, w = getattr(ta, f), getattr(tb, f)
        assert (u is None and w is None) or torch.equal(u, w), f
    assert ra == rb


# --- 2MN

def _pair_2mn(model, **opts):
    """The port's segmented 2MN step of ``model`` (test_torch_samplers'
    tuple) and its eager twin, on one preconditioner configuration."""
    _, _, ts, tp, x0, v0 = model
    ops = make_model_ops(ts)
    mass = build_mass(tp.omega.numpy(), ts.dtau, ts.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = HMCConfig(**{**BASE, "dt": 0.1, "Nb": 2, "integrator": "2mn", **opts})
    dyn = cfg.tune_dt
    pre = kpm.make_symmetric_precond(ops, kpm.KPMConfig(**KPM))
    seg = make_hmc_step(ops, mass, cfg, pre, dynamic_dt=dyn)
    eager = make_hmc_step(ops, mass, cfg, kpm.make_symmetric_precond(ops, kpm.KPMConfig(**KPM)),
                          dynamic_dt=dyn, eager=True)
    assert seg.segmented and not eager.segmented
    return tp, seg, eager, HMCState(x=T(x0), v=T(v0)), mass


@pytest.mark.parametrize("name,opts", [
    ("holstein_dense", dict()), ("holstein_fold", dict(log_verbose=True)),
    ("ssh_dense", dict(tune_dt=True)), ("ssh_fold", dict(Nb=1))],
    ids=["holstein-dense", "holstein-fold-verbose", "ssh-dense-dynamic-dt", "ssh-fold-Nb1"])
def test_segmented_2mn_equals_eager(name, opts, monkeypatch):
    tp, seg, eager, state, _ = _pair_2mn(_model(name, monkeypatch), **opts)
    dt = (torch.tensor(0.08, dtype=torch.float64),) if opts.get("tune_dt") else ()
    s_seg = s_eager = state
    for u in range(2):
        draws = eager.draw(tp, state.x, C, torch.Generator().manual_seed(7 + u))
        r_seg, r_eager = _run(seg, tp, s_seg, draws, *dt), _run(eager, tp, s_eager, draws, *dt)
        _same_update(r_seg, r_eager)
        s_seg, s_eager = r_seg[0], r_eager[0]
        assert r_seg[2] > 0 and bool((r_seg[1].flag == 0).all())
    assert seg.workspace() is not None and seg.workspace().graphs is None
    if opts.get("log_verbose"):
        assert r_seg[1].traj_H.shape == (C, 2)


@pytest.mark.parametrize("name", ["holstein_fold", "ssh_dense"])
def test_segmented_2mn_matches_jax(name, monkeypatch):
    model = _model(name, monkeypatch)
    js, jp, ts, tp, x0, v0 = model
    cfg = dict(BASE, dt=0.1, Nb=2, integrator="2mn")
    jstep = jax.jit(j_make_hmc_step(j_make_model_ops(js), build_mass(
        tp.omega.numpy(), ts.dtau, ts.Ltau, [dict(omega_min=0.0, omega_max=10.0, mass=0.5)]),
        JHMCConfig(**cfg), jkpm.make_symmetric_precond(j_make_model_ops(js),
                                                       jkpm.KPMConfig(**KPM))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(C)]
    jstate = jax.tree.map(lambda *a: np.stack(a), *[r[0] for r in runs])
    jstats = jax.tree.map(lambda *a: np.stack(a), *[r[1] for r in runs])
    tp, seg, _, state, _ = _pair_2mn(model)
    tstate, tstats = seg(tp, state, draws=_jax_draws(keys, ts.Nph, ts.Nsites, ts.Ltau))
    _check(jstate, jstats, tstate, tstats)


# --- tempering

def _ladder_bench(model, ladder, n_chains, branch_gate=None, **kw):
    make = bench.build_ssh_step if model == "ssh" else bench.build_bench_step
    return make(4, 1.0, 0.1, 0.05, n_chains, "cpu", torch.float64, trajectory_time=0.15,
                ladder=ladder, **kw)


@pytest.mark.parametrize("model,fold", [("holstein", False), ("holstein", True),
                                        ("ssh", False), ("ssh", True)],
                         ids=["holstein-dense", "holstein-fold", "ssh-dense", "ssh-fold"])
def test_ladder_update_equals_eager(model, fold, monkeypatch):
    """Per-chain couplings through the graphed update: Holstein λ, λ₂ (on
    the fold branch the per-chain KPM diagonals), SSH α, α₂ (per-chain
    fold tables)."""
    if fold:
        monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    kw = dict(dense_threshold=0, pallas_threshold=0) if fold and model == "holstein" else {}
    b = _ladder_bench(model, (1.0, 0.85), 4, **kw)
    eager = b.eager()
    assert b.step.segmented and not eager.segmented
    lin = "lam" if model == "holstein" else "alpha"
    assert getattr(b.params, lin).shape[0] == 4
    s_seg = s_eager = b.state
    for u in range(2):
        draws = eager.draw(b.params, b.state.x, 4, torch.Generator().manual_seed(3 + u))
        r_seg = _run(b.step, b.params, s_seg, draws)
        r_eager = _run(eager, b.params, s_eager, draws)
        _same_update(r_seg, r_eager)
        s_seg, s_eager = r_seg[0], r_eager[0]


EXCHANGES = [("holstein", (1.0, 0.85), 4, 0), ("holstein", (1.0, 0.85), 4, 1),
             ("holstein", (1.0, 0.9, 0.75), 3, 1), ("ssh", (1.0, 0.9, 0.7), 3, 0),
             ("ssh", (1.0, 0.9, 0.7), 3, 1)]


@pytest.mark.parametrize("name,ladder,n,parity", EXCHANGES,
                         ids=[f"{c[0]}-K{len(c[1])}-C{c[2]}-p{c[3]}" for c in EXCHANGES])
def test_segmented_exchange_equals_eager_and_jax(name, ladder, n, parity):
    js, jp, ts, tp = LADDER_MODELS[name]()
    tops = make_model_ops(ts)
    x, v = _fields(ts, n, seed=n + parity)
    jcfg = jtemp.TemperingConfig(ladder=ladder, freq=1, tol=1e-8, maxiter=500)
    tcfg = TemperingConfig(ladder=ladder, freq=1, tol=1e-8, maxiter=500)
    keys = jax.random.split(jax.random.PRNGKey(40 + n), n)
    jex = jax.jit(jtemp.make_exchange_step(j_make_model_ops(js), jcfg, n),
                  static_argnames="parity")
    jx, jv, jacc, _, jflag, _ = jex(jtemp.ladder_params(jp, jcfg, n), jnp.asarray(x),
                                    jnp.asarray(v), keys, parity=parity)
    draws = _jax_exchange_draws(keys, ts.Nsites, ts.Ltau)
    params = ladder_params(tp, tcfg, n)
    outs = []
    for eager in (False, True):
        ex = make_exchange_step(tops, tcfg, n, kpm.make_precond(tops, kpm.KPMConfig(max_order=4)),
                                eager=eager)
        assert ex.segmented != eager
        solvers.host_reads = 0
        outs.append((ex(params, T(x), T(v), parity, draws=draws), solvers.host_reads))
    (seg, r_seg), (twin, r_twin) = outs
    assert all(torch.equal(a, b) for a, b in zip(seg, twin)) and r_seg == r_twin > 0
    np.testing.assert_array_equal(seg[0].numpy(), np.asarray(jx))
    np.testing.assert_array_equal(seg[1].numpy(), np.asarray(jv))
    np.testing.assert_allclose(float(seg[2]), float(jacc), rtol=0, atol=1e-12)
    assert int(seg[4]) == int(jflag) == 0


def test_workspace_takes_ladder_couplings_and_blocks():
    """The kept parameters take per-chain couplings ``[C, N]`` and a chain
    block of them (a view of the ladder leaves), and a new μ (the μ
    tuner's ``apply_mu``), by copying in: one workspace, no rebuild."""
    b = _ladder_bench("holstein", (1.0, 0.8), 4)
    ws = graphs.Workspace(torch.device("cpu"))
    block = chain_params(b.params, 2, 2)
    assert block.lam.shape == (2, b.ops.Nsites) and block.lam._base is not None
    assert ws.keep_params(block, graphs.REBUILD)
    kept = ws.params
    assert kept.lam is not block.lam and torch.equal(kept.lam, block.lam)
    moved = replace(b.params, mu=b.params.mu + 0.3)
    block2 = chain_params(moved, 2, 2)
    assert ws.keep_params(block2, graphs.REBUILD) and ws.params is kept
    assert torch.equal(kept.mu, moved.mu) and torch.equal(kept.lam, block2.lam)
    # a block of other chains is copied in too; a whole ladder is another shape
    assert ws.keep_params(chain_params(moved, 0, 2), graphs.REBUILD)
    assert torch.equal(kept.lam, moved.lam[:2])
    assert not ws.keep_params(moved, graphs.REBUILD)
    # a step's workspace (its graphs on a card) outlives new couplings and μ
    box, x = {}, b.state.x[2:]
    first = graphs.step_workspace(box, block, x)
    assert graphs.step_workspace(box, block2, x) is first and torch.equal(first.params.mu,
                                                                         moved.mu)


@pytest.mark.parametrize("kind", ["reflect", "swap"])
def test_ladder_moves_equal_eager(kind):
    """The reflection and swap under per-chain couplings: segmented and
    eager on the same draws, bit for bit."""
    from elphdynamics_tpu_torch.dynamics.special_updates import (
        SpecialUpdateConfig, make_reflection_update, make_swap_update)

    b = _ladder_bench("holstein", (1.0, 0.85), 4)
    make = make_reflection_update if kind == "reflect" else make_swap_update
    ucfg = SpecialUpdateConfig(n_moves=3, tol=1e-5, maxiter=500)
    pre = kpm.make_precond(b.ops, b.kpm_cfg)
    seg, eager = make(b.ops, ucfg, pre), make(b.ops, ucfg, pre, eager=True)
    assert seg.segmented and not eager.segmented
    x = b.state.x + 0.1
    for u in range(2):
        draws = eager.draw(b.params, x, 4, torch.Generator().manual_seed(11 + u))
        (xs, rs), (xe, re_) = seg(b.params, x, draws=draws), eager(b.params, x, draws=draws)
        assert torch.equal(xs, xe) and torch.equal(rs, re_)
        x = xs


# --- stand-in capture

@pytest.mark.parametrize("what", ["2mn", "exchange"])
def test_stand_in_capture_uploads_nothing(what, monkeypatch):
    """Built and warmed up (a first call) under the mode, which then counts
    through a second call: no host-to-device copy."""
    mode = HostUploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    with mode:
        if what == "2mn":
            tp, seg, eager, state, _ = _pair_2mn(_model("holstein_fold", monkeypatch))
            # the fields as a field of the device (they came from numpy)
            state = HMCState(*(torch.zeros(t.shape, dtype=t.dtype, device="cpu").copy_(t)
                               for t in (state.x, state.v)))
            gen = torch.Generator().manual_seed(4)
            state, _ = seg(tp, state, draws=eager.draw(tp, state.x, C, gen))
            draws = eager.draw(tp, state.x, C, gen)
            mode.counting = True
            seg(tp, state, draws=draws)
        else:
            b = _ladder_bench("holstein", (1.0, 0.85), 4)
            gen = torch.Generator().manual_seed(4)
            x, v, *_ = b.exchange(b.params, b.state.x, b.state.v, 0, gen)
            draws = b.exchange.draw(b.params, x, gen)
            mode.counting = True
            b.exchange(b.params, x, v, 1, draws=draws)
        mode.counting = False
    assert mode.calls == []


# --- chain ranks

def test_chain_ranks_equal_eager_and_one_rank(tmp_path):
    one = W.graph_chains_worker(torch.device("cpu"))
    ranks = launch(W.graph_chains_worker, 2, "gloo", "cpu", (), timeout_s=240, threads=1,
                   store_dir=str(tmp_path))
    for out in (one, *ranks):
        assert all(r["same"] for r in out.values()), {k for k, r in out.items() if not r["same"]}
        assert all(r["reads"] > 0 for r in out.values())
    # only the exchange steps out between replays: its two gathers, on chain ranks
    for k in one:
        assert one[k]["collectives"] == 0
        assert all(r[k]["collectives"] == (2 if k.startswith("exchange") else 0) for r in ranks)
    for k, res in one.items():
        for f, want in res.items():
            if f in ("same", "reads", "collectives"):
                continue
            blocked = (isinstance(want, np.ndarray) and want.ndim >= 1
                       and not k.startswith("measure"))
            got = np.concatenate([r[k][f] for r in ranks]) if blocked else ranks[0][k][f]
            np.testing.assert_array_equal(got, want, err_msg=f"{k}.{f}")
            if not blocked:
                np.testing.assert_array_equal(ranks[1][k][f], want, err_msg=f"{k}.{f}")


# --- the driver

def _tempering_cfg(tmp_path, updates, bins):
    cfg = _driver_cfg(tmp_path, [1.0, 0.8])
    cfg["hmc"].update(burnin_updates=1, simulation_updates=updates, trajectory_time=0.1)
    cfg["simulation"].update(num_bins=bins)
    return cfg


def _bins(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs if d.endswith("_f"))


def _driver(tmp_path, run_id, updates, bins, n_devices=1, eager=False, monkeypatch=None):
    cfg = _tempering_cfg(tmp_path, updates, bins)
    if eager:
        for k in ("make_hmc_step", "make_reflection_update", "make_swap_update",
                  "make_measurement_step", "make_exchange_step"):
            real = getattr(simulation, k)
            monkeypatch.setattr(simulation, k, lambda *a, _r=real, **kw: _r(
                *a, **{**kw, "eager": True}))
    if n_devices == 1:
        stats = simulation.simulate(copy.deepcopy(cfg), run_id=run_id, n_chains=4,
                                    device="cpu", dtype=torch.float64)
    else:
        stats = launch(W.simulate_worker, n_devices, "gloo", "cpu", (cfg, run_id, 4, n_devices),
                       timeout_s=240, threads=1, store_dir=str(tmp_path))[0][0]
    return stats, tmp_path / f"{cfg['simulation']['foldername']}-{run_id}"


def _same_run(a, b):
    bins = _bins(a)
    assert len(bins) >= 10 and bins == _bins(b)
    match, mismatch, errors = filecmp.cmpfiles(a, b, bins, shallow=False)
    assert mismatch == [] and errors == []
    assert filecmp.cmp(a / "final_phonon_config.out", b / "final_phonon_config.out",
                       shallow=False)
    with np.load(a / "checkpoint.npz") as za, np.load(b / "checkpoint.npz") as zb:
        np.testing.assert_array_equal(za["x"], zb["x"])
        np.testing.assert_array_equal(za["v"], zb["v"])


def test_tempering_driver_graphed_eager_resumed_and_on_chain_ranks(tmp_path, monkeypatch):
    """4 chains on the ladder (1.0, 0.8), an exchange after every update,
    1 + 4 updates, 2 bins: graphed (1) and eager (2) write the same files;
    2 chain ranks (3) too; a run of 1 + 2 updates (one bin), resumed from
    its checkpoint to 1 + 4 updates (4), ends where (1) ends."""
    graphed, f1 = _driver(tmp_path, 1, 4, 2)
    assert graphed["graph_replays"]["exchange"] == 0        # the CPU replays nothing
    assert 0.0 <= graphed["tempering_acceptance_rate"] <= 1.0
    _, f3 = _driver(tmp_path, 3, 4, 2, n_devices=2)
    _, f4 = _driver(tmp_path, 4, 2, 1)
    _, f4 = _driver(tmp_path, 4, 4, 2)
    assert "resumed from checkpoint: burnin_start=1 sim_start=2" in (
        f4 / f"{f4.name.rsplit('-', 1)[0]}.log").read_text()
    _, f2 = _driver(tmp_path, 2, 4, 2, eager=True, monkeypatch=monkeypatch)
    for other in (f2, f3, f4):
        _same_run(f1, other)
