"""The CG solver aids in the segmented sampler calls on the CPU
(``dynamics/graphs.py``): block CG, slow-mode deflation, the near-null
preconditioner and the KPM's exact low-frequency blocks.

On a CUDA field these calls replay CUDA graphs of fixed segments; on the
CPU the same segment functions run uncaptured. Here, in float64 at 4×4
(Lτ = 10), 2 chains:

* the segmented call equals the eager call (asked for by name) bit for bit
  over two calls on the same draws, host reads included: the HMC update
  with block CG (Holstein and SSH, real and twisted), with deflation (a
  real and a complex basis; the refreshed basis it returns too), with block
  CG and deflation (which takes CG); the update, Langevin step, moves,
  measurement and exchange under the near-null preconditioner and under
  ``exact_lowfreq`` on the dense Ā; the measurement with block probes (real
  and complex); the deep-β solves of ``bench.DeepBetaSolves``;
* the graphed update with block CG, deflation and the near-null
  preconditioner and the graphed measurement with block probes and the
  near-null preconditioner match the JAX package's jitted ones on its draws
  (the tolerances of ``tests/test_torch_block_complex.py``,
  ``tests/test_torch_deflation.py`` and ``tests/test_torch_measurements.py``,
  stated in each test);
* the update's gate: BiCGStab and GMRES take the segmented update (equal
  to the eager one; ``tests/test_torch_graph_nonsym.py`` holds them),
  ``eager=True`` and a site shard keep the eager update; block CG and CG
  solves replay graphs of their own names;
* ``maxiter = 2`` runs the block verification and its eager retry;
* a failed near-null factorisation raises ``torch.linalg.cholesky``'s error
  from the segmented call as from the eager one;
* a stand-in capture sees no host upload in a second call of each aid;
* on 2 gloo chain ranks the block-CG and the deflated update equal their
  eager forms and the one-rank run bit for bit.
"""

from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.dynamics.solve import SolverConfig as JSolverConfig
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.ops import deflation as jdefl
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops import nearnull as jnn
from elphdynamics_tpu.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch import bench, solvers
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics import langevin as tl
from elphdynamics_tpu_torch.dynamics import special_updates as tsu
from elphdynamics_tpu_torch.dynamics import tempering as tt
from elphdynamics_tpu_torch.dynamics.hmc import (
    HMCConfig, HMCDraws, HMCState, init_deflation, make_hmc_step)
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import deflation, kpm, nearnull
from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard, shard_model
from elphdynamics_tpu_torch.parallel.multihost import launch
from test_torch_block_complex import HMC as BLOCK_HMC
from test_torch_block_complex import KPM as BLOCK_KPM
from test_torch_block_complex import _T, _pf
from test_torch_block_complex import _jax_start as _jax_start_complex
from test_torch_block_complex import _model as _twisted_model
from test_torch_deflation import _holstein, _jax_draws, _port_state, _projector
from test_torch_graph_special_measure import Uploads
from test_torch_measurements import NV, SPECS, TOL, _jax_probes
from test_torch_measurements import models  # noqa: F401  (the module fixture)

torch.set_num_threads(1)

C = 2


def _call(fn, *args, **kw):
    solvers.host_reads = 0
    out = fn(*args, **kw)
    return out, solvers.host_reads


def _equal(a, b, path="") -> None:
    """Nested tuples / dicts / dataclasses of tensors, equal bit for bit."""
    if a is None:
        assert b is None, path
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (p, q) in enumerate(zip(a, b)):
            _equal(p, q, f"{path}[{i}]")
    else:
        for f in fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")


def _precond(ops, aid):
    """The preconditioner of ``aid``: near-null (k 4, c 2) over KPM, KPM with
    two exact low-frequency blocks, or plain KPM (max_order 4)."""
    kcfg = kpm.KPMConfig(max_order=4, exact_lowfreq=2 if aid == "lowfreq" else 0)
    if aid == "nearnull":
        return nearnull.make_nearnull_precond(ops, kcfg, nearnull.NearNullConfig(k=4, c=2))
    return kpm.make_precond(ops, kcfg)


def _bench(model="holstein", twisted=False, n_chains=C, **kw):
    make = bench.build_ssh_step if model == "ssh" else bench.build_bench_step
    return make(4, 1.0, 0.1, 0.05, n_chains, "cpu", torch.float64, trajectory_time=0.1,
                twist=bench.TWIST if twisted else None, **kw)


# --- the HMC update against the eager one

UPDATES = {
    "block-holstein": dict(block=True),
    "block-ssh": dict(model="ssh", block=True),
    "block-holstein-twisted": dict(twisted=True, block=True),
    "block-ssh-twisted": dict(model="ssh", twisted=True, block=True),
    "deflation-real": dict(deflate_k=4),
    "deflation-complex": dict(twisted=True, deflate_k=4),
    "block-deflation": dict(block=True, deflate_k=4),
    "nearnull": dict(aid="nearnull"),
    "lowfreq": dict(aid="lowfreq"),
}


def _update_pair(case, **cfg_kw):
    kw = dict(UPDATES[case])
    aid = kw.pop("aid", None)
    b = _bench(**kw)
    cfg = replace(b.hmc_cfg, **cfg_kw)
    seg = make_hmc_step(b.ops, b.mass, cfg, _precond(b.ops, aid))
    twin = make_hmc_step(b.ops, b.mass, cfg, _precond(b.ops, aid), eager=True)
    return b, seg, twin


@pytest.mark.parametrize("case", list(UPDATES))
def test_segmented_update_with_aid_equals_eager(case):
    b, seg, twin = _update_pair(case)
    assert seg.segmented and not twin.segmented
    s_seg = s_eager = b.state
    for u in range(2):
        draws = twin.draw(b.params, b.state.x, C, torch.Generator().manual_seed(5 + u))
        r_seg, r_eager = _call(seg, b.params, s_seg, draws=draws), _call(twin, b.params, s_eager,
                                                                          draws=draws)
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1] > 0
        (s_seg, stats), (s_eager, _) = r_seg[0], r_eager[0]
        assert bool((stats.flag == 0).all())
    ws = seg.workspace()
    assert ws.graphs is None and ws.retries == 0 and twin.workspace() is None
    block, deflating = b.hmc_cfg.block, b.hmc_cfg.deflate_k > 0
    # block CG on the tol¹ trajectory solves unless deflating; the tol²
    # endpoints always run CG
    assert ("bcg" in ws) == (block and not deflating) and "cg" in ws

    if deflating:
        assert s_seg.defl is not b.state.defl and s_seg.defl.W is not ws.defl.W
        assert s_seg.defl.W.is_complex() == ("complex" in case)
        assert not torch.equal(s_seg.defl.W, b.state.defl.W)    # refreshed, twice
    if case == "lowfreq":
        assert ws.kpm.G_low is not None and ws.kpm.G_low.shape[1] == 2
    if case == "nearnull":
        assert isinstance(ws.kpm, tuple) and ws.kpm[1].T.shape[1] == 4


def _assert_card_gate(shard) -> None:
    """On a card a site shard's calls read its group's backend: NCCL runs
    them segmented (captured), gloo eagerly; on the CPU both run
    segmented."""
    for backend, on_card in (("gloo", False), ("nccl", True)):
        shard.backend = lambda b=backend: b
        assert graphs.graphable(shard, torch.device("cuda")) is on_card
        assert graphs.graphable(shard, torch.device("cpu"))
    del shard.backend


@pytest.mark.parametrize("case", ["bicgstab", "gmres", "eager", "shard"])
def test_update_gate_keeps_the_eager_update(case):
    """With block CG and deflation set: BiCGStab and GMRES take the
    segmented update (their own solve, which ignores both, as the eager
    update does), equal to its eager twin bit for bit; ``eager=True`` keeps
    the eager update; a site shard takes the segmented one (its calls need
    a process group: only its gate is read here, the calls are held to
    their eager forms in ``tests/test_torch_graph_sites.py``), except a gloo
    site group on a card, whose calls run eagerly."""
    b = _bench(block=True, deflate_k=4)
    ops, params = b.ops, b.params
    nonsym = case in ("bicgstab", "gmres")
    cfg = replace(b.hmc_cfg, solver_kind=case if nonsym else "cg")
    if case == "shard":
        shard = SiteShard(ops.spec.ckb, ops.spec.wij_table, 1, 0)
        ops = make_model_ops(shard_model(ops.spec, params, shard)[0])
    step = make_hmc_step(ops, b.mass, cfg, kpm.make_precond(ops, b.kpm_cfg),
                         eager=case == "eager")
    assert step.segmented == (nonsym or case == "shard")
    if case == "shard":
        _assert_card_gate(ops.shard)
        return
    twin = make_hmc_step(ops, b.mass, cfg, kpm.make_precond(ops, b.kpm_cfg), eager=True)
    draws = twin.draw(params, b.state.x, C, torch.Generator().manual_seed(0))
    r_step, r_twin = _call(step, params, b.state, draws=draws), _call(twin, params, b.state,
                                                                        draws=draws)
    _equal(r_step[0], r_twin[0])
    assert r_step[1] == r_twin[1] > 0
    ws = step.workspace()
    assert (ws is not None) == nonsym
    if nonsym:
        assert ("bicg" if case == "bicgstab" else "gmres") in ws
        assert "cg" not in ws and "bcg" not in ws and "defl" in ws


def test_block_and_cg_solves_replay_graphs_of_their_own(monkeypatch):
    """A card captures one graph per segment name: the block solves' blocks
    and verification (``bcg_block``, ``bcg_verify``) must not share a name
    with the tol² endpoints' CG (``cg_block``, ``verify``), or a replay
    would verify the other kind's solution. Each name runs one solve
    kind's function."""
    runs = []
    run = graphs.Workspace.run

    def recorded(self, name, fn):
        runs.append((name, fn.__closure__[0].cell_contents if fn.__closure__ else None))
        return run(self, name, fn)

    monkeypatch.setattr(graphs.Workspace, "run", recorded)
    b, seg, _ = _update_pair("block-holstein")
    seg(b.params, b.state, torch.Generator().manual_seed(1))
    kinds = {}
    for name, owner in runs:
        if isinstance(owner, graphs.CGSolve):
            kinds.setdefault(name, set()).add(owner.name)
    assert {"verify", "bcg_verify"} <= set(kinds)
    assert all(owners == {"bcg" if name.startswith("bcg") else "cg"}
               for name, owners in kinds.items()), kinds


@pytest.mark.parametrize("case", ["block-holstein", "block-holstein-twisted"])
def test_failed_block_solve_runs_verification_and_retry(case):
    """maxiter 2: a block solve fails its verification and is retried from
    zero by plain CG (eagerly, between replays on a card); the update and
    its host reads are the eager update's."""
    b, seg, twin = _update_pair(case, maxiter=2)
    draws = twin.draw(b.params, b.state.x, C, torch.Generator().manual_seed(3))
    r_seg, r_eager = _call(seg, b.params, b.state, draws=draws), _call(twin, b.params, b.state,
                                                                        draws=draws)
    _equal(r_seg[0], r_eager[0])
    assert r_seg[1] == r_eager[1]
    # the start's tol² solve and the first block solve fail; a warm start
    # from a retried solution may pass later ones
    assert seg.workspace().retries >= 2


# --- the Langevin step, the moves, the measurement and the exchange under
# the near-null and exact_lowfreq preconditioners

PARTS = ["langevin", "reflect", "swap", "measurement", "exchange"]


def _part_pair(part, aid, block=False, twisted=False):
    """(segmented, eager, inputs) of one part: each call's arguments as
    (args, kwargs) on the same draws, two calls."""
    if part == "langevin":
        lb = bench.build_langevin_step(4, 1.0, 0.1, 1e-3, C, "cpu", torch.float64, method="rk")
        seg = tl.make_langevin_step(lb.ops, lb.Q, lb.dt, "rk", lb.solver, _precond(lb.ops, aid))
        twin = tl.make_langevin_step(lb.ops, lb.Q, lb.dt, "rk", lb.solver,
                                     _precond(lb.ops, aid), eager=True)
        calls = [((lb.params, lb.x), dict(draws=twin.draw(
            lb.params, lb.x, C, torch.Generator().manual_seed(7 + u)))) for u in range(2)]
        return seg, twin, calls
    if part == "exchange":
        b = _bench(n_chains=4, ladder=(1.0, 0.9))
        seg = tt.make_exchange_step(b.ops, b.tcfg, 4, _precond(b.ops, aid))
        twin = tt.make_exchange_step(b.ops, b.tcfg, 4, _precond(b.ops, aid), eager=True)
        x, v = b.state.x, b.ops.tie(torch.randn(b.state.x.shape, dtype=torch.float64,
                                                generator=torch.Generator().manual_seed(1)))
        calls = [((b.params, x, v, p), dict(draws=twin.draw(
            b.params, x, torch.Generator().manual_seed(9 + p)))) for p in (0, 1)]
        return seg, twin, calls
    b = _bench(twisted=twisted)
    x = b.state.x + 0.05
    if part == "measurement":
        scfg = SolverConfig(tol=1e-6, maxiter=500, block=block)
        mspec = tm.MeasurementSpec(nv=4, onsite_corr=(("Greens", True), ("DenDen", False)),
                                   intersite_corr=(("CurrentCurrent", True),),
                                   snapshots=("density",))
        seg = tm.make_measurement_step(b.ops, mspec, scfg, _precond(b.ops, aid))
        twin = tm.make_measurement_step(b.ops, mspec, scfg, _precond(b.ops, aid), eager=True)
        calls = [((b.params, x), dict(R=twin.draw(b.params, x,
                                                  torch.Generator().manual_seed(3 + u))))
                 for u in range(2)]
        return seg, twin, calls
    make = tsu.make_reflection_update if part == "reflect" else tsu.make_swap_update
    cfg = tsu.SpecialUpdateConfig(freq=1, n_moves=2, maxiter=500)
    seg, twin = make(b.ops, cfg, _precond(b.ops, aid)), make(b.ops, cfg, _precond(b.ops, aid),
                                                             eager=True)
    calls = [((b.params, x), dict(draws=twin.draw(b.params, x, C,
                                                  torch.Generator().manual_seed(4 + u))))
             for u in range(2)]
    return seg, twin, calls


@pytest.mark.parametrize("aid", ["nearnull", "lowfreq"])
@pytest.mark.parametrize("part", PARTS)
def test_segmented_part_under_preconditioner_equals_eager(part, aid):
    seg, twin, calls = _part_pair(part, aid)
    assert seg.segmented and not twin.segmented
    for args, kw in calls:
        r_seg, r_eager = _call(seg, *args, **kw), _call(twin, *args, **kw)
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1] > 0
    ws = seg.workspace()
    assert ws is not None and ws.graphs is None and twin.workspace() is None
    if aid == "lowfreq":
        assert ws.kpm.G_low is not None
    else:
        assert ws.kpm[1].info is not None and not bool(ws.kpm[1].info.any())


@pytest.mark.parametrize("twisted", [False, True], ids=["real", "complex"])
def test_segmented_block_measurement_equals_eager(twisted):
    """The probes' block CG (s = nᵥ, Hermitian under complex hopping) as
    the block segments, KPM-preconditioned."""
    seg, twin, calls = _part_pair("measurement", None, block=True, twisted=twisted)
    assert seg.segmented and not twin.segmented
    for args, kw in calls:
        r_seg, r_eager = _call(seg, *args, **kw), _call(twin, *args, **kw)
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1] > 0
        assert bool((r_seg[0][1]["flag"] == 0).all())
    ws = seg.workspace()
    assert "bcg" in ws and "cg" not in ws and ws.bcg.x.is_complex() == twisted
    assert ws.bcg.x.shape[1] == 4


def test_failed_block_probe_solve_runs_retry():
    """maxiter 2 on the block probe solve: its verification fails and the
    eager retry re-solves every probe by plain CG, as the eager call does."""
    b = _bench()
    x = b.state.x + 0.05
    mspec = tm.MeasurementSpec(nv=4, onsite_corr=(("Greens", True),))
    scfg = SolverConfig(tol=1e-6, maxiter=2, block=True)
    seg = tm.make_measurement_step(b.ops, mspec, scfg, _precond(b.ops, None))
    twin = tm.make_measurement_step(b.ops, mspec, scfg, _precond(b.ops, None), eager=True)
    R = twin.draw(b.params, x, torch.Generator().manual_seed(3))
    r_seg, r_eager = _call(seg, b.params, x, R=R), _call(twin, b.params, x, R=R)
    _equal(r_seg[0], r_eager[0])
    assert r_seg[1] == r_eager[1]
    assert seg.workspace().retries == 1 and bool((r_seg[0][1]["iters"] > 2).all())


def test_failed_nearnull_factorisation_raises_as_eager():
    """Zero test vectors make every chunk Gram zero: ``torch.linalg.cholesky``
    refuses it. The eager and the segmented update raise the same error."""
    b = _bench()
    kcfg, ncfg = kpm.KPMConfig(max_order=4), nearnull.NearNullConfig(k=4, c=2)
    zero = torch.zeros((4, b.ops.Nsites, b.ops.Ltau), dtype=torch.float64)
    errors = []
    for eager in (True, False):
        pre = nearnull.make_nearnull_precond(b.ops, kcfg, ncfg, test_vectors=zero)
        step = make_hmc_step(b.ops, b.mass, b.hmc_cfg, pre, eager=eager)
        with pytest.raises(torch.linalg.LinAlgError) as err:
            step(b.params, b.state, torch.Generator().manual_seed(0))
        errors.append(str(err.value))
    # the chunk Grams [C, Lτ/c, k, k]: torch.linalg.cholesky's own message
    with pytest.raises(torch.linalg.LinAlgError) as err:
        torch.linalg.cholesky(torch.zeros((C, 5, 4, 4), dtype=torch.float64))
    assert errors[0] == errors[1] == str(err.value)


# --- the deep-β solves

@pytest.mark.parametrize("kind", list(bench.SOLVE_KINDS))
def test_graphed_deep_beta_solve_equals_eager(kind, monkeypatch):
    small = replace(bench.DEEP_BETA_64X64, L=4, beta=1.6, n_chains=2,
                    deflation=deflation.DeflationConfig(k=8), nearnull=nearnull.NearNullConfig(k=4))
    d = bench.build_deep_beta_solves(small, "cpu", torch.float64, dense_threshold=0,
                                     pallas_threshold=0)
    runs = []
    monkeypatch.setattr(graphs.Workspace, "run",
                        lambda self, name, fn, _run=graphs.Workspace.run: (
                            runs.append(name), _run(self, name, fn))[1])
    for _ in range(2):
        solvers.host_reads = 0
        runs.clear()
        run = d.prepare(kind)
        got, reads = run(), solvers.host_reads
        # a card replays host reads + 1 graphs: setup, the blocks, the
        # verification, end
        assert len(runs) == reads + 1 and runs[0] == "setup" and runs[-1] == "end"
        solvers.host_reads = 0
        want = d.prepare(kind, eager=True)()
        _equal(got, want)
        assert reads == solvers.host_reads > 0 and int(got.flag.max()) == 0
    assert run.workspace.graphs is None and ("defl" in run.workspace) == (kind == "deflation")


# --- against the JAX package

def test_graphed_block_update_matches_jax():
    """The twisted Holstein chain of ``tests/test_torch_block_complex.py``
    (Hermitian block CG at s = 1) against the JAX package's jitted update
    with ``block``: x within 1e-8, ΔH within 1e-6, equal decisions (that
    file's tolerances)."""
    js, jp, jops, ts, tp, tops, x0 = _twisted_model("holstein")
    N, Lt, Nph = ts.Nsites, ts.Ltau, ts.Nph
    v0 = np.random.default_rng(12).standard_normal((C, Nph, Lt))
    mass = build_mass(np.asarray(jp.omega), 0.1, Lt, [dict(omega_min=0.0, omega_max=10.0,
                                                          mass=0.5)])
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(block=True, **BLOCK_HMC),
                                    jkpm.make_symmetric_precond(jops,
                                                                jkpm.KPMConfig(**BLOCK_KPM))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    jruns = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
             for c in range(C)]
    Rm, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        Rm.append(np.asarray(jax.random.normal(k_v, (Nph, Lt), dtype=jnp.float64)))
        Rpm.append(_pf(k_p, N, Lt))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    draws = HMCDraws(momentum=_T(np.stack(Rm)), pseudofermion=_T(np.stack(Rpm)),
                     uniform=_T(np.asarray(U)), kpm_start=_jax_start_complex(N))
    step = make_hmc_step(tops, mass, HMCConfig(block=True, **BLOCK_HMC),
                         kpm.make_symmetric_precond(tops, kpm.KPMConfig(**BLOCK_KPM)))
    st, stats = step(tp, HMCState(x=_T(x0), v=_T(v0)), draws=draws)
    assert step.segmented and "bcg" in step.workspace()
    for c, (jst, jstats, _) in enumerate(jruns):
        np.testing.assert_allclose(st.x[c].numpy(), np.asarray(jst.x), rtol=0, atol=1e-8)
        np.testing.assert_allclose(stats.delta_H[c].item(), float(jstats.delta_H), atol=1e-6)
        assert bool(stats.accepted[c]) == bool(jstats.accepted) and int(jstats.flag) == 0


def test_graphed_deflated_update_matches_jax():
    """``tests/test_torch_deflation.py``'s update through the graphed
    segments: x, v and ΔH within 1e-10 of the JAX package's, equal
    iterations and decisions, the refreshed basis's projector within
    1e-8."""
    js, jp, ts, tp = _holstein(False)
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    mass = build_mass(tp.omega.numpy(), ts.dtau, ts.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = dict(dt=0.1, trajectory_time=0.2, Nb=2, tol=1e-6, maxiter=500, construct_guess=True,
               guess_order=2, deflate_k=4, deflate_filter=4, deflate_power=3)
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((C, ts.Nsites, 1)) + 0.1 * rng.standard_normal(
        (C, ts.Nsites, ts.Ltau))
    v0 = rng.standard_normal(x0.shape)
    jdefls = [jdefl.init(jax.random.PRNGKey(40 + c), 4, ts.Nsites, ts.Ltau, dtype=jnp.float64)
              for c in range(C)]
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(max_order=4))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c]), defl=jdefls[c]),
                  keys[c]) for c in range(C)]
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg),
                          kpm.make_symmetric_precond(tops, kpm.KPMConfig(max_order=4)))
    tstate, tstats = tstep(tp, HMCState(x=torch.as_tensor(x0), v=torch.as_tensor(v0),
                                        defl=_port_state(jdefls)),
                           draws=_jax_draws(keys, ts.Nsites, ts.Ltau, False))
    assert tstep.segmented and "defl" in tstep.workspace()
    for c, (jstate, jstats, _) in enumerate(runs):
        np.testing.assert_allclose(float(tstats.delta_H[c]), float(jstats.delta_H), atol=1e-10)
        np.testing.assert_allclose(tstate.x[c].numpy(), np.asarray(jstate.x), atol=1e-10)
        np.testing.assert_allclose(tstate.v[c].numpy(), np.asarray(jstate.v), atol=1e-10)
        assert int(tstats.iters[c]) == int(jstats.iters)
        assert bool(tstats.accepted[c]) == bool(jstats.accepted) and int(jstats.flag) == 0
        np.testing.assert_allclose(_projector(tstate.defl.W[c].numpy()),
                                   _projector(jstate.defl.W), atol=1e-8)


def _jax_nearnull(jops, tops, k=4, c=2):
    """Both packages' near-null preconditioners on the same test vectors
    and KPM start (the JAX package's draws)."""
    jcfg = jnn.NearNullConfig(k=k, c=c)
    T0 = np.array(jax.random.normal(jax.random.PRNGKey(jcfg.seed),
                                    (k, tops.Nsites, tops.Ltau), dtype=jnp.float64))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    start = tuple(torch.as_tensor(np.array(jax.random.normal(kk, (tops.Nsites, 1),
                                                             dtype=jnp.float64)))
                  for kk in (k1, k2))
    tpre = nearnull.make_nearnull_precond(tops, kpm.KPMConfig(max_order=4),
                                          nearnull.NearNullConfig(k=k, c=c),
                                          test_vectors=torch.as_tensor(T0))
    tpre = replace(tpre, start=start)
    return jnn.make_nearnull_precond(jops, jkpm.KPMConfig(max_order=4), jcfg), tpre


def test_graphed_nearnull_update_matches_jax():
    """The deflation test's model and update with the near-null
    preconditioner (k 4, c 2) in both packages, the solve tolerance 1e-10:
    the JAX package inverts G by a Newton–Schulz sweep, the port by a
    Cholesky factorisation (``tests/test_torch_nearnull.py``: the
    corrections agree within 1e-6), so the solves agree to their
    tolerance, not bit for bit: x, v within 1e-8, ΔH within 1e-8, equal
    decisions, iterations within ±2 (that file's slack) per solve."""
    js, jp, ts, tp = _holstein(False)
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    mass = build_mass(tp.omega.numpy(), ts.dtau, ts.Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    cfg = dict(dt=0.1, trajectory_time=0.2, Nb=2, tol=1e-10, maxiter=500)
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((C, ts.Nsites, 1)) + 0.1 * rng.standard_normal(
        (C, ts.Nsites, ts.Ltau))
    v0 = rng.standard_normal(x0.shape)
    jpre, tpre = _jax_nearnull(jops, tops)
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg), jpre))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(C)]
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg), tpre)
    draws = _jax_draws(keys, ts.Nsites, ts.Ltau, False)
    tstate, tstats = tstep(tp, HMCState(x=torch.as_tensor(x0), v=torch.as_tensor(v0)),
                           draws=replace(draws, kpm_start=None))
    assert tstep.segmented and isinstance(tstep.workspace().kpm, tuple)
    for c, (jstate, jstats, _) in enumerate(runs):
        np.testing.assert_allclose(float(tstats.delta_H[c]), float(jstats.delta_H), atol=1e-8)
        np.testing.assert_allclose(tstate.x[c].numpy(), np.asarray(jstate.x), atol=1e-8)
        np.testing.assert_allclose(tstate.v[c].numpy(), np.asarray(jstate.v), atol=1e-8)
        assert abs(int(tstats.iters[c]) - int(jstats.iters)) <= 2
        assert bool(tstats.accepted[c]) == bool(jstats.accepted) and int(jstats.flag) == 0


@pytest.mark.parametrize("aid", ["block", "nearnull"])
def test_graphed_measurement_with_aid_matches_jax(models, aid):  # noqa: F811
    """``tests/test_torch_measurements.py``'s two-orbital lattice and
    probes at tol 1e-10 with block probes (KPM) or the near-null
    preconditioner, in both packages: every increment within rtol = atol =
    1e-9 (that file's tolerance), flags 0."""
    jops, jp, jprec, tops, tp, tprec, x = models
    mspec = SPECS[list(SPECS)[0]]
    block = aid == "block"
    if aid == "nearnull":
        jprec, tprec = _jax_nearnull(jops, tops, k=2, c=2)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jstep = jax.jit(jm.make_measurement_step(
        jops, mspec, JSolverConfig(tol=TOL, maxiter=2000, block=block), jprec))
    jout = [jstep(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    tstep = tm.make_measurement_step(tops, mspec, SolverConfig(tol=TOL, maxiter=2000,
                                                               block=block), tprec)
    R = torch.as_tensor(_jax_probes(keys, tops.Nsites, tops.Ltau))
    inc, stats, snaps = tstep(tp, torch.as_tensor(x), R=R)
    assert tstep.segmented and ("bcg" in tstep.workspace()) == block
    assert R.shape[1] == NV
    for c in range(C):
        jinc, jstats, jsnaps, _ = jout[c]
        assert int(stats["flag"][c]) == int(jstats["flag"]) == 0
        for group in inc:
            for k, v in inc[group].items():
                np.testing.assert_allclose(v[c].numpy(), np.asarray(jinc[group][k]),
                                           rtol=1e-9, atol=1e-9, err_msg=f"{group}/{k}")


# --- a stand-in capture

CAPTURES = {
    "block": ("measurement", dict(block=True)),
    "deflation": ("update", dict(case="deflation-real")),
    "nearnull": ("update", dict(case="nearnull")),
    "lowfreq": ("update", dict(case="lowfreq")),
}


@pytest.mark.parametrize("aid", list(CAPTURES))
def test_stand_in_capture_uploads_nothing(aid, monkeypatch):
    """The call is built and warmed up (its first call) under the mode,
    which then counts through a second call: every segment runs again, as
    a capture runs it, and makes no host-to-device copy (nor an element
    assignment from a Python number)."""
    mode = Uploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    what, kw = CAPTURES[aid]
    with mode:
        if what == "measurement":
            seg, twin, calls = _part_pair("measurement", None, **kw)
            seg(*calls[0][0], **calls[0][1])
            mode.counting = True
            seg(*calls[1][0], **calls[1][1])
        else:
            b, seg, twin = _update_pair(kw["case"])
            gen = torch.Generator().manual_seed(4)
            state, _ = seg(b.params, b.state, gen)
            draws = twin.draw(b.params, state.x, C, gen)
            mode.counting = True
            seg(b.params, state, draws=draws)
        mode.counting = False
    assert mode.calls == []


# --- chain ranks

def test_chain_ranks_with_block_and_deflation_equal_one_rank(tmp_path):
    """On 2 gloo chain ranks the block-CG update and the deflated update
    (``torch_parallel_workers.graph_aids_worker``) equal their eager forms
    on the rank bit for bit, host reads included, and the ranks' blocks of
    x, v, ΔH, iterations and the refreshed basis equal the one-rank run."""
    one = W.graph_aids_worker(torch.device("cpu"))
    ranks = launch(W.graph_aids_worker, 2, "gloo", "cpu", (), timeout_s=240, threads=1,
                   store_dir=str(tmp_path))
    for out in (one, *ranks):
        assert all(r["same"] for r in out.values()), {k for k, r in out.items() if not r["same"]}
        assert all(r["reads"] > 0 and r["segmented"] for r in out.values())
    for k, res in one.items():
        for f, want in res.items():
            if f in ("same", "reads", "segmented"):
                continue
            got = np.concatenate([r[k][f] for r in ranks])
            np.testing.assert_array_equal(got, want, err_msg=f"{k}.{f}")


def test_deflation_basis_keeps_the_callers_tensors():
    """The graphed update reads the caller's basis and returns a new one:
    the tensors handed in are left as they were."""
    b, seg, _ = _update_pair("deflation-real")
    before = {f.name: getattr(b.state.defl, f.name).clone() for f in fields(b.state.defl)}
    state = b.state
    for u in range(2):
        state, _ = seg(b.params, state, torch.Generator().manual_seed(u))
    for f in fields(b.state.defl):
        assert torch.equal(getattr(b.state.defl, f.name), before[f.name])
    assert state.defl.chol.dtype == torch.float64 and b.state.defl.chol.dtype == torch.float32
    assert init_deflation(b.ops, b.hmc_cfg, C, device="cpu").W.shape == state.defl.W.shape
