"""The graphed update's segments on the CPU (``dynamics/graphs.py``).

On a CUDA field the one-rank Holstein leapfrog CG update replays CUDA
graphs of fixed segments; on the CPU the same segment functions run
uncaptured. Here, in float64:

* the block form of ``solvers.cg`` (``cg_init`` then ``cg_block``) equals
  the loop it replaced (kept below as the reference) bit for bit, with a
  ``maxiter`` that is not a multiple of ``CG_SYNC_EVERY``, a system that
  hits the κ bound and ``active0``;
* the segmented update equals the eager update (asked for by name) bit for
  bit on the same injected draws, dense branch at ``loop_precision``
  "highest" and "high", fold branch with the dense Ā off (the twins of K1
  and K2), with the dynamic step size and the verbose energies, at 4×4 and
  8×8, with equal host reads;
* it matches the JAX package's update on JAX's draws (x to 1e-10, equal
  decisions, flags and iterations);
* a solve made to fail runs through the verification and the retry with
  the eager path's flags;
* the kernels' launch counts under a stand-in capture: counted once per
  replay, not at capture;
* the workspace keeps its tensors and copies changed parameters in.
"""

import contextlib
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.lattice import Lattice as JLattice
from elphdynamics_tpu.lattice import UnitCell as JUnitCell
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.models.holstein import build_holstein as j_build_holstein
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.bench import build_bench_step
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.hmc import (
    HMCConfig, HMCDraws, HMCState, make_hmc_step)
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import ckb_cuda, kpm
from elphdynamics_tpu_torch.ops.fourier_accel import build_mass
from elphdynamics_tpu_torch.utils import capture

torch.set_num_threads(1)


# --- the CG loop as it was before its block form (the reference)

def cg_loop(apply_A, b, x0=None, *, apply_P=None, tol=1e-5, maxiter=1000, kappa_max=1e12,
            active0=None):
    if x0 is None:
        x0 = torch.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)
    dot = solvers._dot
    normb = torch.sqrt(dot(b, b))
    safe_normb = solvers._positive(normb)
    r = b - apply_A(x0)
    z = P(r)
    rdotz, rr0 = dot(r, z), dot(r, r)
    eps0 = torch.sqrt(rr0) / safe_normb
    batch = b.shape[:-2]
    active = torch.ones(batch, dtype=torch.bool)
    if active0 is not None:
        active = active & active0
    active = active & (eps0 >= tol)
    conv = eps0 < tol
    x, p = x0, z
    kmin = torch.zeros_like(normb)
    iters = torch.zeros(batch, dtype=torch.int32)
    for j in range(maxiter):
        if j % solvers.CG_SYNC_EVERY == 0 and not bool(active.any()):
            break
        Ap = apply_A(p)
        alpha = rdotz / solvers._nonzero(dot(p, Ap))
        x_new = x + solvers._bc(alpha, x) * p
        r_new = r - solvers._bc(alpha, r) * Ap
        z_new = P(r_new)
        rr, rdotz_new = dot(r_new, r_new), dot(r_new, z_new)
        eps = torch.sqrt(rr) / safe_normb
        kmin_new = solvers._kappa_bound(kmin, eps0, eps, j)
        done = (eps < tol) | (kmin_new > kappa_max)
        beta = rdotz_new / solvers._nonzero(rdotz)
        p_new = z_new + solvers._bc(beta, p) * p
        m = solvers._bc(active, x)
        x = torch.where(m, x_new, x)
        r = torch.where(m, r_new, r)
        p = torch.where(m, p_new, p)
        rdotz = torch.where(active, rdotz_new, rdotz)
        kmin = torch.where(active, kmin_new, kmin)
        iters = iters + active.to(torch.int32)
        conv = conv | (active & (eps < tol))
        active = active & ~done
    return x, iters, conv


def _spd_system(B=5, N=6, L=3, seed=0):
    """``B`` SPD systems on ``[N, L]`` fields (condition numbers up to
    ~1e3) and a Jacobi preconditioner."""
    rng = np.random.default_rng(seed)
    n = N * L
    A = []
    for k in range(B):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A.append(q @ np.diag(np.logspace(0, 1 + k % 3, n)) @ q.T)
    A = torch.as_tensor(np.stack(A))
    d = torch.diagonal(A, dim1=-2, dim2=-1).reshape(B, N, L)

    def apply_A(v):
        return torch.matmul(A, v.reshape(B, n, 1)).reshape(v.shape)

    b = torch.as_tensor(rng.standard_normal((B, N, L)))
    return apply_A, (lambda v: v / d), b


@pytest.mark.parametrize("case", ["maxiter_7", "maxiter_6_unpreconditioned", "kappa_bound",
                                  "active0_x0"])
def test_cg_block_form_equals_loop(case):
    apply_A, P, b = _spd_system()
    kw = dict(apply_P=P, tol=1e-10, maxiter=60)
    x0 = None
    if case == "maxiter_7":
        kw["maxiter"] = 7
    elif case == "maxiter_6_unpreconditioned":
        kw.update(maxiter=6, apply_P=None)
    elif case == "kappa_bound":
        kw["kappa_max"] = 30.0
    else:
        kw["active0"] = torch.tensor([True, False, True, True, False])
        x0 = 0.1 * torch.ones_like(b)
    x_ref, it_ref, conv_ref = cg_loop(apply_A, b, x0, **kw)
    res = solvers.cg(apply_A, b, x0, **kw)
    assert torch.equal(res.x, x_ref) and torch.equal(res.iters, it_ref)
    assert torch.equal(res.converged, conv_ref)
    if case == "maxiter_7":
        assert int(it_ref.max()) == 7 and not bool(conv_ref.all())
    if case == "kappa_bound":   # some system stopped on the bound, not converged
        assert bool((~conv_ref & (it_ref < kw["maxiter"])).any())
    if case == "active0_x0":
        assert torch.equal(it_ref[~kw["active0"]], torch.zeros(2, dtype=torch.int32))
    # the block form driven by hand, the iteration index on the device
    st = solvers.cg_init(apply_A, b, x0, apply_P=kw["apply_P"], tol=kw["tol"],
                         active0=kw.get("active0")).clone()
    for _ in range(math.ceil(kw["maxiter"] / solvers.CG_SYNC_EVERY)):
        solvers.cg_block(apply_A, st, apply_P=kw["apply_P"], tol=torch.tensor(kw["tol"],
                         dtype=torch.float64), maxiter=kw["maxiter"],
                         kappa_max=kw.get("kappa_max", 1e12))
    assert torch.equal(st.x, x_ref) and torch.equal(st.iters, it_ref)
    assert torch.equal(st.conv, conv_ref)


# --- the segmented update against the eager one

@contextlib.contextmanager
def _dense_abar(on: bool):
    keep = kpm._DENSE_ABAR_MAX_SITES
    if not on:
        kpm._DENSE_ABAR_MAX_SITES = 0
    try:
        yield
    finally:
        kpm._DENSE_ABAR_MAX_SITES = keep


def _pair(L, branch, **cfg_kw):
    """A 2-chain float64 bench model at β = 1 (Lτ = 10), its segmented step
    and its eager twin (the same model and preconditioner)."""
    kw = dict(dense_threshold=0, pallas_threshold=0) if branch == "fold" else {}
    b = build_bench_step(L, 1.0, 0.1, 0.05, 2, "cpu", torch.float64, trajectory_time=0.2,
                         **kw)
    cfg = replace(b.hmc_cfg, **cfg_kw)
    pre = kpm.make_precond(b.ops, b.kpm_cfg)
    dyn = cfg.tune_dt
    seg = make_hmc_step(b.ops, b.mass, cfg, pre, dynamic_dt=dyn)
    eager = make_hmc_step(b.ops, b.mass, cfg, pre, dynamic_dt=dyn, eager=True)
    assert seg.segmented and not eager.segmented
    return b, seg, eager


def _run(step, b, state, draws, dt=None):
    solvers.host_reads = 0
    args = (dt,) if dt is not None else ()
    out, stats = step(b.params, state, *args, draws=draws)
    return out, stats, solvers.host_reads


def _assert_same(a, b):
    sa, ta, ra = a
    sb, tb, rb = b
    assert torch.equal(sa.x, sb.x) and torch.equal(sa.v, sb.v)
    for f in ("accepted", "iters", "flag", "delta_H", "H", "S", "K", "traj_H", "traj_S",
              "traj_K", "traj_iters"):
        u, w = getattr(ta, f), getattr(tb, f)
        assert (u is None and w is None) or torch.equal(u, w), f
    assert ra == rb


@pytest.mark.parametrize("L,branch,opts", [
    (4, "dense", dict(loop_precision="highest")),
    (4, "dense", dict(loop_precision="high", log_verbose=True)),
    (8, "dense", dict(loop_precision="high")),
    (4, "fold", dict()),
    (8, "fold", dict(tune_dt=True)),
], ids=["4x4-dense-highest", "4x4-dense-high-verbose", "8x8-dense-high", "4x4-fold",
        "8x8-fold-dynamic-dt"])
def test_segmented_update_equals_eager(L, branch, opts):
    with _dense_abar(branch == "dense"):
        b, seg, eager = _pair(L, branch, **opts)
        assert b.ops.spec.dense_ckb == (branch == "dense")
        dt = torch.tensor(0.04, dtype=torch.float64) if opts.get("tune_dt") else None
        s_seg = s_eager = b.state
        for u in range(2):
            draws = eager.draw(b.params, b.state.x, 2, torch.Generator().manual_seed(7 + u))
            r_seg = _run(seg, b, s_seg, draws, dt)
            r_eager = _run(eager, b, s_eager, draws, dt)
            _assert_same(r_seg, r_eager)
            s_seg, s_eager = r_seg[0], r_eager[0]
            assert r_seg[2] > 0 and bool(r_seg[1].accepted.any())
        ws = seg.workspace()
        assert ws is not None and ws.graphs is None and eager.workspace() is None
        if branch == "fold":
            assert ws.kpm.expK is None     # Ā through the twins of K1 and K2


def test_failed_solve_runs_verification_and_retry():
    """maxiter 2: the tol² solves fail their verification and are retried
    from zero (eagerly, between replays on the card); the flags,
    iterations, host reads and x are the eager path's."""
    b, seg, eager = _pair(4, "dense", maxiter=2)
    draws = eager.draw(b.params, b.state.x, 2, torch.Generator().manual_seed(3))
    r_seg, r_eager = _run(seg, b, b.state, draws), _run(eager, b, b.state, draws)
    _assert_same(r_seg, r_eager)
    assert seg.workspace().retries >= 2


# --- against the JAX package

T_ASSIGN = [(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))]
CFG = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-5, maxiter=500,
           construct_guess=True, guess_order=3)


@pytest.mark.parametrize("dense_threshold", [2048, 0], ids=["dense", "fold"])
def test_segmented_update_matches_jax(dense_threshold):
    L, beta, dtau, C = 4, 1.0, 0.1, 2
    kw = dict(t_assignments=T_ASSIGN, omega=1.0, lam=1.0, mu=0.0,
              dense_threshold=dense_threshold)
    jspec, jparams = j_build_holstein(
        JLattice.create(JUnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]]), L),
        beta, dtau, rng=np.random.default_rng(5), **kw)
    tspec, tparams = build_holstein(
        Lattice.create(UnitCell.create(2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]]), L),
        beta, dtau, rng=np.random.default_rng(5), device="cpu", **kw)
    N, Lt = jspec.Nsites, jspec.Ltau
    mass = build_mass(np.asarray(jparams.omega), dtau, Lt,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    rng = np.random.default_rng(13)
    x0 = 0.5 * rng.standard_normal((C, N, 1)) + 0.1 * rng.standard_normal((C, N, Lt))
    v0 = rng.standard_normal((C, N, Lt))
    jops = j_make_model_ops(jspec)
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**CFG),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(max_order=4))))
    keys = jax.random.split(jax.random.PRNGKey(8), C)
    runs = [jstep(jparams, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(C)]
    jx = np.stack([np.asarray(r[0].x) for r in runs])
    jstats = {f: np.stack([np.asarray(getattr(r[1], f)) for r in runs])
              for f in ("accepted", "iters", "flag", "delta_H")}
    # the draws of elphdynamics_tpu/dynamics/hmc.py:_step, made by JAX on the host
    R, Rpm, U = [], [], []
    for key in keys:
        _, k_v, k_p, k_acc = jax.random.split(key, 4)
        R.append(np.asarray(jax.random.normal(k_v, (N, Lt), dtype=jnp.float64)))
        Rpm.append(np.asarray(jax.random.normal(k_p, (2, N, Lt), dtype=jnp.float64)))
        U.append(float(jax.random.uniform(k_acc, (), dtype=jnp.float64)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    start = tuple(torch.as_tensor(np.array(jax.random.normal(k, (N, 1), dtype=jnp.float64)))
                  for k in (k1, k2))
    draws = HMCDraws(momentum=torch.as_tensor(np.stack(R)),
                     pseudofermion=torch.as_tensor(np.stack(Rpm)),
                     uniform=torch.as_tensor(np.asarray(U)), kpm_start=start)

    tops = make_model_ops(tspec)
    step = make_hmc_step(tops, mass, HMCConfig(**CFG),
                         kpm.make_symmetric_precond(tops, kpm.KPMConfig(max_order=4)))
    out, stats = step(tparams, HMCState(x=torch.as_tensor(x0), v=torch.as_tensor(v0)),
                      draws=draws)
    assert step.segmented and step.workspace() is not None
    np.testing.assert_allclose(out.x.numpy(), jx, rtol=0, atol=1e-10)
    for f in ("accepted", "iters", "flag"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), jstats[f])
    np.testing.assert_allclose(stats.delta_H.numpy(), jstats["delta_H"], rtol=0, atol=1e-9)


# --- bookkeeping

def test_launch_counts_under_a_stand_in_capture():
    """A graph's capture counts nothing; each replay counts its launches,
    by form and by shape."""
    ckb_cuda.reset_counts()
    v = torch.zeros((16, 2, 64, 10))
    shared, chain = torch.zeros(8), torch.zeros((16, 8))
    ckb_cuda._count("fold", shared, v[:, 0])             # a launch before the capture
    with capture.recording() as rec:
        for _ in range(3):
            ckb_cuda._count("fold", shared, v)
        ckb_cuda._count("fused", chain, v)
        assert ckb_cuda.launches == 1 and ckb_cuda.fused_launches == 0
    assert (ckb_cuda.launches, ckb_cuda.fused_launches) == (1, 0)
    assert ckb_cuda.launch_shapes == {("fold/shared", (16, 64, 10), torch.float32): 1}
    assert (rec.per_replay("fold/shared"), rec.per_replay("fused/chain")) == (3, 1)
    for _ in range(2):
        rec.replayed()
    assert (ckb_cuda.launches, ckb_cuda.fused_launches) == (7, 2)
    assert ckb_cuda.table_launches["fold/shared"] == 7
    assert ckb_cuda.table_launches["fused/chain"] == 2
    assert ckb_cuda.launch_shapes == {("fold/shared", (16, 64, 10), torch.float32): 1,
                                      ("fold/shared", (16, 2, 64, 10), torch.float32): 6,
                                      ("fused/chain", (16, 2, 64, 10), torch.float32): 2}
    ckb_cuda.reset_counts()


def test_workspace_keeps_tensors_and_parameters():
    ws = graphs.Workspace(torch.device("cpu"))
    a = ws.put("a", torch.ones(3))
    assert ws.put("a", torch.full((3,), 2.0)) is a and torch.equal(a, torch.full((3,), 2.0))
    b = build_bench_step(4, 1.0, 0.1, 0.05, 2, "cpu", torch.float64, trajectory_time=0.2)
    assert ws.keep_params(b.params)
    kept = ws.params
    assert kept.mu is not b.params.mu and torch.equal(kept.mu, b.params.mu)
    moved = replace(b.params, mu=b.params.mu + 0.25)
    assert ws.keep_params(moved, ("expK",)) and ws.params is kept
    assert torch.equal(kept.mu, moved.mu)
    assert not ws.keep_params(replace(moved, expK=moved.expK.clone()), ("expK",))
    assert not ws.keep_params(replace(moved, lam=moved.lam[None].expand(2, -1)), ())
