"""BiCGStab and GMRES in the segmented sampler calls on the CPU
(``dynamics/graphs.NonsymSolve``).

On a CUDA field the HMC update, the Langevin step and the measurement with
``[solver] type`` BiCGStab or GMRES replay CUDA graphs of fixed segments
(BiCGStab's blocks of ``CG_SYNC_EVERY`` iterations; GMRES's cycle start,
blocks of Arnoldi steps and cycle closes; each stage's verification); on
the CPU the same segment functions run uncaptured. Here, in float64:

* ``solvers.bicgstab`` and ``solvers.gmres``, built from their pieces,
  equal the loops they replaced (kept below as the reference) bit for bit:
  a breakdown (b = 0), a ``maxiter`` that is not a multiple of
  ``CG_SYNC_EVERY``, systems frozen mid-cycle, a cycle closed after every
  reachable number of Arnoldi steps, both GMRES sides;
* the segmented calls equal the eager calls (asked for by name) bit for
  bit over two calls on the same draws, with equal host reads and host
  reads + 1 segments run: the HMC update (4×4 Holstein dense, 8×8 Holstein
  on the fold branch with the dense Ā off, 4×4 SSH with the fold Ā;
  leapfrog and 2MN; twisted Holstein), the Langevin step (RK, Euler, Heun)
  and the measurement (real and twisted);
* ``maxiter = 2`` runs the verifications and the eager retries;
* a stand-in capture sees no host upload in a second call;
* the graphed calls match the JAX package's jitted update, Langevin step
  and measurement on its draws, at the tolerances of
  ``tests/test_torch_solver_kinds.py`` (BiCGStab: iterations exact, x to
  1e-10; GMRES, whose classical Gram-Schmidt applied twice may take one
  iteration more or less than the reference's modified Gram-Schmidt: the
  solve-level slack of ``test_solve_minv_kinds_match_jax`` and
  ``test_solve_oinv_kinds_match_jax``);
* on 2 gloo chain ranks a GMRES update replays the one-rank segments and
  takes one rank's decisions.
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
from elphdynamics_tpu.dynamics.langevin import make_langevin_step as j_make_langevin_step
from elphdynamics_tpu.dynamics.solve import SolverConfig as JSolverConfig
from elphdynamics_tpu.measure import measurements as jm
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu.ops.fourier_accel import build_Q
from elphdynamics_tpu_torch import bench, solvers
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics import langevin as tl
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.parallel.multihost import launch
from test_torch_graph_special_measure import Uploads
from test_torch_langevin import FA, _fields, _jax_draws, _models
from test_torch_langevin import _precond as _langevin_precond
from test_torch_measurements import NV, SPECS, TOL, _jax_probes
from test_torch_measurements import models  # noqa: F401  (the module fixture)
from test_torch_solver_kinds import HMC_CFG, N_CHAINS, _hmc_draws
from test_torch_solver_kinds import (
    BETA, DTAU, L, UC, JLattice, JUnitCell, TLattice, TUnitCell, build_mass, j_build_holstein,
    j_make_model_ops, t_build_holstein, t_make_model_ops)

torch.set_num_threads(1)

C = 2
KINDS = ["bicgstab", "gmres"]


# --- the loops as they were before their pieces (the reference)

def bicgstab_loop(apply_A, b, x0=None, *, apply_P=None, tol=1e-5, maxiter=1000):
    if x0 is None:
        x0 = torch.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)
    bc, nz, dot = solvers._bc, solvers._nonzero, solvers._dot_hot
    safe_normb = solvers._positive(solvers._norm(b))
    r = b - apply_A(x0)
    rt = r
    eps0 = solvers._norm(r) / safe_normb
    x = x0
    pvec, v = torch.zeros_like(b), torch.zeros_like(b)
    rho_old, omega = torch.ones_like(eps0), torch.ones_like(eps0)
    alpha = torch.zeros_like(eps0)
    iters = torch.zeros(b.shape[:-2], dtype=torch.int32)
    active, conv = eps0 >= tol, eps0 < tol
    for j in range(maxiter):
        if j % solvers.CG_SYNC_EVERY == 0 and not bool(active.any()):
            break
        rho = dot(rt, r)
        breakdown = rho == 0
        beta = (rho / nz(rho_old)) * (alpha / nz(omega))
        p_new = r + bc(beta, r) * (pvec - bc(omega, v) * v)
        phat = P(p_new)
        v_new = apply_A(phat)
        alpha_new = rho / nz(dot(rt, v_new))
        s = r - bc(alpha_new, r) * v_new
        early = solvers._norm_hot(s) / safe_normb < tol
        shat = P(s)
        t = apply_A(shat)
        omega_new = dot(t, s) / nz(dot(t, t))
        x_early = x + bc(alpha_new, x) * phat
        x_full = x_early + bc(omega_new, x) * shat
        r_new = s - bc(omega_new, r) * t
        eps = solvers._norm_hot(r_new) / safe_normb
        done = early | (eps < tol) | breakdown | (omega_new == 0)
        m = bc(active, x)
        x = torch.where(m, torch.where(bc(early, x), x_early, x_full), x)
        r = torch.where(m, r_new, r)
        pvec = torch.where(m, p_new, pvec)
        v = torch.where(m, v_new, v)
        rho_old = torch.where(active, rho, rho_old)
        alpha = torch.where(active, alpha_new, alpha)
        omega = torch.where(active, omega_new, omega)
        iters = iters + active.to(torch.int32)
        conv = conv | (active & (early | (eps < tol)))
        active = active & ~done
    return x, iters, conv


def gmres_loop(apply_A, b, x0=None, *, apply_P=None, tol=1e-5, maxiter=1000, restart=20,
               side="right"):
    if x0 is None:
        x0 = torch.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)
    right = apply_P is not None and side == "right"
    bc, pos = solvers._bc, solvers._positive
    m = restart
    batch, f64 = tuple(b.shape[:-2]), torch.float64
    normb = pos(solvers._norm(b if right else P(b)))
    x = x0
    iters = torch.zeros(batch, dtype=torch.int32)
    done_all = torch.zeros(batch, dtype=torch.bool)
    V = b.new_empty((m + 1,) + tuple(b.shape))

    def project(w, n):
        h = solvers.fdot(V[:n], w[None], dim=(-2, -1))
        return h, w - (V[:n] * h[..., None, None].to(b.dtype)).sum(dim=0)

    for _ in range(max(1, -(-maxiter // m))):
        if bool(done_all.all()):
            break
        r = (b - apply_A(x)) if right else P(b - apply_A(x))
        beta = solvers._norm_hot(r)
        V[0] = r / bc(pos(beta), r)
        H = torch.zeros(batch + (m + 1, m), dtype=f64)
        Qr = torch.eye(m + 1, dtype=f64).expand(batch + (m + 1, m + 1)).contiguous()
        done = done_all | (beta / normb < tol)
        n = 0
        for i in range(m):
            if i % solvers.CG_SYNC_EVERY == 0 and bool(done.all()):
                break
            w = apply_A(P(V[i])) if right else P(apply_A(V[i]))
            h, w = project(w, i + 1)
            h2, w = project(w, i + 1)
            hip = solvers._norm_hot(w)
            V[i + 1] = torch.where(bc(done, w), torch.zeros_like(w), w / bc(pos(hip), w))
            col = torch.zeros(batch + (m + 1,), dtype=f64)
            col[..., :i + 1] = torch.movedim(h + h2, 0, -1)
            col[..., i + 1] = hip
            col = torch.matmul(Qr, col[..., None])[..., 0]
            a, c = col[..., i], col[..., i + 1]
            denom = torch.sqrt(a * a + c * c)
            ci = torch.where(denom > 0, a / pos(denom), torch.ones_like(a))
            si = torch.where(denom > 0, c / pos(denom), torch.zeros_like(a))
            col[..., i] = ci * a + si * c
            col[..., i + 1] = 0.0
            fr = done[..., None]
            qi, qi1 = Qr[..., i, :], Qr[..., i + 1, :]
            new_qi = torch.where(fr, qi, ci[..., None] * qi + si[..., None] * qi1)
            new_qi1 = torch.where(fr, qi1, ci[..., None] * qi1 - si[..., None] * qi)
            Qr[..., i, :] = new_qi
            Qr[..., i + 1, :] = new_qi1
            H[..., :, i] = torch.where(fr, torch.zeros_like(col), col)
            eps = (beta * Qr[..., i + 1, 0]).abs() / normb
            iters = iters + (~done).to(torch.int32)
            done = done | (eps < tol)
            n = i + 1
        svec = beta[..., None] * Qr[..., :m, 0]
        y = torch.zeros(batch + (m,), dtype=f64)
        for k in range(n - 1, -1, -1):
            hkk = H[..., k, k]
            val = (svec[..., k] - (H[..., k, :] * y).sum(dim=-1)) / solvers._nonzero(hkk)
            y[..., k] = torch.where(hkk != 0, val, torch.zeros_like(val))
        if n:
            dx = (V[:n] * torch.movedim(y[..., :n], -1, 0)[..., None, None].to(b.dtype)).sum(0)
            if right:
                dx = P(dx)
            x = torch.where(bc(done_all, x), x, x + dx)
        done_all = done
    err = solvers._norm(apply_A(x) - b) / pos(solvers._norm(b))
    return x, iters, err < np.sqrt(tol)


def _dense(As):
    """``apply_A`` of dense matrices ``As`` ``[n, n]`` or ``[B, n, n]`` on
    ``[B, n, K]`` fields, and a Jacobi preconditioner."""
    A = torch.as_tensor(As)
    d = torch.diagonal(A, dim1=-2, dim2=-1)[..., None]
    return (lambda v: torch.matmul(A, v)), (lambda v: v / d)


def _same(got: solvers.CGResult, want) -> None:
    x, iters, conv = want
    assert torch.equal(got.x, x) and torch.equal(got.iters, iters)
    assert torch.equal(got.converged, conv)


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("maxiter", [7, 200])
def test_bicgstab_blocks_equal_loop(precond, maxiter):
    """Three systems, the first with b = 0 (ρ = 0 at once: a breakdown),
    on a ``maxiter`` that is and one that is not reached."""
    rng = np.random.default_rng(2)
    n = 24
    A = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = torch.as_tensor(rng.standard_normal((3, n, 2)))
    b[0] = 0.0
    apply_A, jacobi = _dense(A)
    kw = dict(apply_P=jacobi if precond else None, tol=1e-10, maxiter=maxiter)
    got = solvers.bicgstab(apply_A, b, **kw)
    _same(got, bicgstab_loop(apply_A, b, **kw))
    assert int(got.iters[0]) == 0 and torch.isfinite(got.x).all()
    assert (int(got.iters.max()) == maxiter) == (maxiter == 7)


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("precond", [False, True], ids=["plain", "jacobi"])
def test_gmres_pieces_equal_loop(side, precond):
    """An easy, a hard and an exact (x0 solves it) system in one batch, so
    that systems freeze mid-cycle, at restart lengths that are and are not
    multiples of ``CG_SYNC_EVERY``, and a start ``x0``."""
    rng = np.random.default_rng(4)
    n = 16
    easy = np.eye(n) + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n)
    hard = np.eye(n) + 0.45 * rng.standard_normal((n, n)) / np.sqrt(n)
    As = np.stack([easy, hard, 2.0 * np.eye(n)])
    apply_A, jacobi = _dense(As)
    b = torch.as_tensor(rng.standard_normal((3, n, 2)))
    x0 = torch.as_tensor(rng.standard_normal((3, n, 2)))
    x0[2] = b[2] / 2.0
    for restart in (5, 6, 8, 20):
        for tol, start in ((1e-10, None), (1e-6, x0)):
            kw = dict(apply_P=jacobi if precond else None, tol=tol, maxiter=60,
                      restart=restart, side=side)
            _same(solvers.gmres(apply_A, b, start, **kw), gmres_loop(apply_A, b, start, **kw))


def test_gmres_closes_after_every_reachable_step_count(monkeypatch):
    """A diagonal system with k distinct eigenvalues converges in k Arnoldi
    steps, so the host read after the block holding step k stops the cycle:
    over k = 1 … 22 (and b = 0, no step at all) the cycles close after 0,
    4, …, 16 steps (the multiples of ``CG_SYNC_EVERY`` below the restart
    length 20) and after 20 (the last block), each run equal to the old
    loop bit for bit."""
    closes = set()
    close = solvers.gmres_cycle_close
    monkeypatch.setattr(solvers, "gmres_cycle_close",
                        lambda st, n, **kw: (closes.add(n), close(st, n, **kw))[1])
    rng = np.random.default_rng(9)
    n = 24
    for k in range(0, 23):
        ev = np.linspace(1.0, 3.0, max(k, 1))[np.arange(n) % max(k, 1)]
        apply_A, _ = _dense(np.diag(ev))
        b = torch.as_tensor(rng.standard_normal((1, n, 1))) * (k > 0)
        kw = dict(tol=1e-12, maxiter=100, restart=20)
        _same(solvers.gmres(apply_A, b, **kw), gmres_loop(apply_A, b, **kw))
    assert closes == {0, 4, 8, 12, 16, 20}


# --- the segmented calls against the eager ones

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


@pytest.fixture
def segments_run(monkeypatch):
    """The names of the segments a call runs (``Workspace.run``), in order."""
    runs = []
    run = graphs.Workspace.run
    monkeypatch.setattr(graphs.Workspace, "run",
                        lambda self, name, fn: (runs.append(name), run(self, name, fn))[1])
    return runs


def _call(fn, runs, *args, **kw):
    """(result, host reads, segments run) of one call."""
    solvers.host_reads = 0
    runs.clear()
    out = fn(*args, **kw)
    return out, solvers.host_reads, list(runs)


# names of the CG solves' graphs, which a nonsymmetric solve must not reuse
CG_NAMES = {"cg_block", "cg_block_loop", "verify", "bcg_block", "bcg_block_loop",
            "bcg_verify"}


def _check_names(names, kind, stages) -> None:
    solve_names = {n for n in names if n.startswith(("bicg_", "gmres_", "nonsym_"))}
    assert not set(names) & CG_NAMES
    assert {f"nonsym_verify_{s}" for s in stages} <= solve_names
    assert ("nonsym_next" in solve_names) == (len(stages) == 2)
    prefix = "bicg_block_" if kind == "bicgstab" else "gmres_cycle_"
    assert {prefix + s for s in stages} <= solve_names


@pytest.fixture
def dense_abar(monkeypatch):
    """Close the dense-Ā gate: Ā through the twins of K1 and K2."""
    def close(on: bool):
        if on:
            monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    return close


# (model, L, options): Holstein dense at 4×4, the fold branch at 8×8 (the
# dense Ā off), SSH with the fold Ā, 2MN, complex hopping
UPDATES = {
    "holstein-bicgstab": ("holstein", 4, dict(solver="bicgstab")),
    "holstein-gmres": ("holstein", 4, dict(solver="gmres", restart=6)),
    "fold-8x8-bicgstab": ("fold", 8, dict(solver="bicgstab")),
    "fold-8x8-gmres": ("fold", 8, dict(solver="gmres")),
    "ssh-fold-gmres": ("ssh", 4, dict(solver="gmres", restart=10)),
    "ssh-fold-bicgstab": ("ssh", 4, dict(solver="bicgstab")),
    "2mn-gmres": ("holstein", 4, dict(solver="gmres", integrator="2mn")),
    "twisted-bicgstab": ("holstein", 4, dict(solver="bicgstab", twist=bench.TWIST)),
    "twisted-gmres": ("holstein", 4, dict(solver="gmres", restart=8, twist=bench.TWIST)),
}


def _update_pair(case, dense_abar, **cfg_kw):
    model, size, kw = UPDATES[case]
    dense_abar(model in ("fold", "ssh"))
    make = bench.build_ssh_step if model == "ssh" else bench.build_bench_step
    extra = dict(dense_threshold=0, pallas_threshold=0) if model == "fold" else {}
    b = make(size, 1.0, 0.1, 0.05, C, "cpu", torch.float64, trajectory_time=0.1, **kw, **extra)
    cfg = replace(b.hmc_cfg, **cfg_kw)
    seg = make_hmc_step(b.ops, b.mass, cfg, b.precond())
    twin = make_hmc_step(b.ops, b.mass, cfg, b.precond(), eager=True)
    return b, seg, twin


@pytest.mark.parametrize("case", list(UPDATES))
def test_segmented_update_equals_eager(case, dense_abar, segments_run):
    b, seg, twin = _update_pair(case, dense_abar)
    kind = b.hmc_cfg.solver_kind
    assert seg.segmented and not twin.segmented and kind in KINDS
    s_seg = s_eager = b.state
    for u in range(2):
        draws = twin.draw(b.params, b.state.x, C, torch.Generator().manual_seed(5 + u))
        (s_seg, stats), reads, names = _call(seg, segments_run, b.params, s_seg, draws=draws)
        (s_eager, stats_e), reads_e, _ = _call(twin, segments_run, b.params, s_eager,
                                               draws=draws)
        _equal((s_seg, stats), (s_eager, stats_e))
        # a card replays host reads + 1 graphs
        assert reads == reads_e > 0 and len(names) == reads + 1
        assert bool((stats.flag == 0).all())
        _check_names(names, kind, ("T", "M"))
    ws = seg.workspace()
    assert ws.graphs is None and ws.retries == 0 and twin.workspace() is None
    st = ws.bicg if kind == "bicgstab" else ws.gmres
    assert "cg" not in ws and "bcg" not in ws
    assert st.x.is_complex() == ("twisted" in case) and st.x.shape[1] == (1 if "twisted" in case
                                                                           else 2)
    # the fold branch and SSH's fold Ā: Ā through the twins of K1 and K2
    assert (ws.kpm.expK is None) == (UPDATES[case][0] in ("fold", "ssh"))


LANGEVIN = [("bicgstab", "rk"), ("gmres", "rk"), ("gmres", "euler"), ("bicgstab", "heun")]


def _langevin_pair(kind, method, maxiter=500, restart=6):
    lb = bench.build_langevin_step(4, 1.0, 0.1, 1e-3, C, "cpu", torch.float64, method=method,
                                   solver=SolverConfig(tol=1e-6, maxiter=maxiter, kind=kind,
                                                       restart=restart))
    return lb, lb.step, lb.eager()


@pytest.mark.parametrize("kind,method", LANGEVIN)
def test_segmented_langevin_step_equals_eager(kind, method, segments_run):
    lb, seg, twin = _langevin_pair(kind, method)
    assert seg.segmented and not twin.segmented
    x_seg = x_eager = lb.x
    for u in range(2):
        draws = twin.draw(lb.params, lb.x, C, torch.Generator().manual_seed(7 + u))
        r_seg, reads, names = _call(seg, segments_run, lb.params, x_seg, draws=draws)
        r_eager, reads_e, _ = _call(twin, segments_run, lb.params, x_eager, draws=draws)
        _equal(r_seg, r_eager)
        assert reads == reads_e > 0 and len(names) == reads + 1
        assert bool((r_seg[1].flag == 0).all())
        _check_names(names, kind, ("M",))
        x_seg, x_eager = r_seg[0], r_eager[0]
    assert twin.workspace() is None and seg.workspace().graphs is None


def _measure_pair(kind, twisted=False, maxiter=500, restart=6):
    b = bench.build_bench_step(4, 1.0, 0.1, 0.05, C, "cpu", torch.float64, trajectory_time=0.1,
                               twist=bench.TWIST if twisted else None)
    x = b.state.x + 0.05
    scfg = SolverConfig(tol=1e-6, maxiter=maxiter, kind=kind, restart=restart)
    mspec = tm.MeasurementSpec(nv=4, onsite_corr=(("Greens", True), ("DenDen", False)),
                               intersite_corr=(("CurrentCurrent", True),),
                               snapshots=("density",))
    seg = tm.make_measurement_step(b.ops, mspec, scfg, b.precond())
    twin = tm.make_measurement_step(b.ops, mspec, scfg, b.precond(), eager=True)
    return b, x, seg, twin


@pytest.mark.parametrize("kind,twisted", [("bicgstab", False), ("gmres", False),
                                          ("gmres", True)],
                         ids=["bicgstab", "gmres", "gmres-twisted"])
def test_segmented_measurement_equals_eager(kind, twisted, segments_run):
    b, x, seg, twin = _measure_pair(kind, twisted)
    assert seg.segmented and not twin.segmented
    for u in range(2):
        R = twin.draw(b.params, x, torch.Generator().manual_seed(3 + u))
        r_seg, reads, names = _call(seg, segments_run, b.params, x, R=R)
        r_eager, reads_e, _ = _call(twin, segments_run, b.params, x, R=R)
        _equal(r_seg, r_eager)
        assert reads == reads_e > 0 and len(names) == reads + 1
        assert bool((r_seg[1]["flag"] == 0).all())
        _check_names(names, kind, ("M",))
    ws = seg.workspace()
    st = ws.bicg if kind == "bicgstab" else ws.gmres
    assert st.x.shape[1] == 4 and st.x.is_complex() == twisted and "b" not in ws


# --- the verification's retry

def test_failed_update_solves_run_retry(dense_abar):
    """maxiter 2 with restart 2: every stage of every solve fails its
    verification and is retried from zero, unpreconditioned (eagerly,
    between replays on a card); the update and its host reads are the
    eager update's."""
    for case in ("holstein-gmres", "holstein-bicgstab"):
        b, seg, twin = _update_pair(case, dense_abar, maxiter=2, restart=2)
        draws = twin.draw(b.params, b.state.x, C, torch.Generator().manual_seed(3))
        solvers.host_reads = 0
        r_seg = seg(b.params, b.state, draws=draws), solvers.host_reads
        solvers.host_reads = 0
        r_eager = twin(b.params, b.state, draws=draws), solvers.host_reads
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1]
        ws = seg.workspace()
        # each stage of the tol² start solve and the first trajectory solve
        assert ws.retries >= 4 and ws.retry_reads > 0


@pytest.mark.parametrize("what", ["langevin", "measurement"])
def test_failed_probe_and_force_solves_run_retry(what, segments_run):
    """maxiter 2 (GMRES: restart 2, so one cycle of 2 steps) in the
    Langevin force solves and the probe solves: the verification fails, the
    eager retry re-solves; results and host reads are the eager call's."""
    if what == "langevin":
        lb, seg, twin = _langevin_pair("gmres", "rk", maxiter=2, restart=2)
        draws = twin.draw(lb.params, lb.x, C, torch.Generator().manual_seed(3))
        args, kw = (lb.params, lb.x), dict(draws=draws)
    else:
        b, x, seg, twin = _measure_pair("bicgstab", maxiter=2)
        args, kw = (b.params, x), dict(R=twin.draw(b.params, x, torch.Generator().manual_seed(3)))
    r_seg, reads, _ = _call(seg, segments_run, *args, **kw)
    r_eager, reads_e, _ = _call(twin, segments_run, *args, **kw)
    _equal(r_seg, r_eager)
    ws = seg.workspace()
    assert reads == reads_e and ws.retries >= 1 and ws.retry_reads > 0


# --- a stand-in capture

CAPTURES = ["update-gmres", "update-bicgstab", "langevin-gmres", "measurement-gmres"]


@pytest.mark.parametrize("case", CAPTURES)
def test_stand_in_capture_uploads_nothing(case, dense_abar, monkeypatch):
    """The call is built and warmed up (its first call) under the mode,
    which then counts through a second call: every segment runs again, as
    a capture runs it, and makes no host-to-device copy (nor an element
    assignment from a Python number)."""
    mode = Uploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    what, kind = case.split("-")
    with mode:
        if what == "update":
            b, seg, twin = _update_pair(f"holstein-{kind}", dense_abar)
            gen = torch.Generator().manual_seed(4)
            state, _ = seg(b.params, b.state, gen)
            draws = twin.draw(b.params, state.x, C, gen)
            mode.counting = True
            seg(b.params, state, draws=draws)
        elif what == "langevin":
            lb, seg, twin = _langevin_pair(kind, "rk")
            gen = torch.Generator().manual_seed(4)
            x, _ = seg(lb.params, lb.x, gen)
            draws = twin.draw(lb.params, x, C, gen)
            mode.counting = True
            seg(lb.params, x, draws=draws)
        else:
            b, x, seg, twin = _measure_pair(kind)
            gen = torch.Generator().manual_seed(4)
            seg(b.params, x, gen)
            R = twin.draw(b.params, x, gen)
            mode.counting = True
            seg(b.params, x, R=R)
        mode.counting = False
    assert mode.calls == []


# --- against the JAX package

def _kinds_models():
    """``tests/test_torch_solver_kinds.py``'s HMC model in both packages."""
    kw = dict(t_assignments=[(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))],
              omega=1.0, lam=1.0, mu=0.0)
    jspec, jparams = j_build_holstein(JLattice.create(JUnitCell.create(*UC), L), BETA, DTAU,
                                      rng=np.random.default_rng(5), **kw)
    tspec, tparams = t_build_holstein(TLattice.create(TUnitCell.create(*UC), L), BETA, DTAU,
                                      rng=np.random.default_rng(5), device="cpu", **kw)
    return jspec, jparams, tspec, tparams


@pytest.mark.parametrize("kind", KINDS)
def test_graphed_update_matches_jax(kind):
    """``test_hmc_update_solver_kinds_match_jax``'s update (tol 1e-5, the
    tol² endpoints, KPM max_order 16) through the graphed segments against
    the JAX package's jitted update on its draws. BiCGStab: that test's
    tolerances (equal iterations and decisions, x and v to 1e-10, ΔH to
    1e-9). GMRES: decisions equal, mean iterations per solve within 2 (two
    solves in sequence, ``test_solve_oinv_kinds_match_jax``'s slack), x and v
    within 1e-7 of their largest magnitude."""
    jspec, jparams, tspec, tparams = _kinds_models()
    N, Ltau = jspec.Nsites, jspec.Ltau
    mass = build_mass(np.asarray(jparams.omega), DTAU, Ltau,
                      [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    rng = np.random.default_rng(11)
    x0 = 0.5 * rng.standard_normal((N_CHAINS, N, 1)) + 0.1 * rng.standard_normal(
        (N_CHAINS, N, Ltau))
    v0 = rng.standard_normal((N_CHAINS, N, Ltau))
    cfg = {**HMC_CFG, "solver_kind": kind}
    jops = j_make_model_ops(jspec)
    jit_step = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**cfg),
                                       jkpm.make_precond(jops, jkpm.KPMConfig(max_order=16))))
    keys = jax.random.split(jax.random.PRNGKey(3), N_CHAINS)
    runs = [jit_step(jparams, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(N_CHAINS)]
    jstate = jax.tree.map(lambda *a: np.stack(a), *[r[0] for r in runs])
    jstats = jax.tree.map(lambda *a: np.stack(a), *[r[1] for r in runs])
    tops = t_make_model_ops(tspec)
    tstep = make_hmc_step(tops, mass, HMCConfig(**cfg),
                          kpm.make_precond(tops, kpm.KPMConfig(max_order=16)))
    tstate, tstats = tstep(tparams, HMCState(x=torch.as_tensor(x0), v=torch.as_tensor(v0)),
                           draws=_hmc_draws(keys, N, Ltau))
    assert tstep.segmented and ("bicg" if kind == "bicgstab" else "gmres") in tstep.workspace()
    assert np.all(np.asarray(jstats.flag) == 0)
    np.testing.assert_array_equal(tstats.flag.numpy(), np.asarray(jstats.flag))
    np.testing.assert_array_equal(tstats.accepted.numpy(), np.asarray(jstats.accepted))
    if kind == "bicgstab":
        np.testing.assert_array_equal(tstats.iters.numpy(), np.asarray(jstats.iters))
        atol = dict(x=1e-10, dH=1e-9)
    else:
        assert np.all(np.abs(tstats.iters.numpy() - np.asarray(jstats.iters)) <= 2)
        atol = dict(x=1e-7 * np.abs(np.asarray(jstate.x)).max(), dH=1e-6)
    np.testing.assert_allclose(tstats.delta_H.numpy(), np.asarray(jstats.delta_H), rtol=0,
                               atol=atol["dH"])
    for got, want in ((tstate.x, jstate.x), (tstate.v, jstate.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol["x"] * max(1.0, np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("kind", KINDS)
def test_graphed_langevin_step_matches_jax(kind):
    """``test_langevin_step_bicgstab_matches_jax``'s RK step (tol 1e-8)
    through the graphed segments: BiCGStab x to 1e-10 and equal iterations;
    GMRES x within 1e-8 of its largest magnitude
    (``test_solve_minv_kinds_match_jax``) and iterations within 1."""
    jops, jp, tops, tp = _models("dense")
    Q = build_Q(np.asarray(jp.omega), tops.dtau, tops.Ltau, FA)
    x0 = _fields(tops)
    scfg = dict(tol=1e-8, maxiter=1000, kind=kind, restart=20)
    jstep = jax.jit(j_make_langevin_step(jops, Q, 0.01, "rk", JSolverConfig(**scfg),
                                         jkpm.make_precond(jops, jkpm.KPMConfig(max_order=8))))
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    runs = [jstep(jp, jnp.asarray(x0[c]), keys[c]) for c in range(C)]
    tstep = tl.make_langevin_step(tops, Q, 0.01, "rk", SolverConfig(**scfg),
                                  _langevin_precond(tops))
    x1, stats = tstep(tp, torch.as_tensor(x0),
                      draws=_jax_draws(keys, "rk", tops.Nph, tops.Nsites, tops.Ltau))
    assert tstep.segmented and tstep.workspace() is not None
    for c in range(C):
        want = np.asarray(runs[c][0])
        if kind == "bicgstab":
            np.testing.assert_allclose(x1[c].numpy(), want, rtol=0, atol=1e-10)
            assert int(stats.iters[c]) == int(runs[c][1].iters)
        else:
            np.testing.assert_allclose(x1[c].numpy(), want, rtol=0,
                                       atol=1e-8 * np.abs(want).max())
            assert abs(int(stats.iters[c]) - int(runs[c][1].iters)) <= 1
        assert int(stats.flag[c]) == int(runs[c][1].flag) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_graphed_measurement_matches_jax(models, kind):  # noqa: F811
    """``tests/test_torch_measurements.py``'s two-orbital lattice and probes
    at tol 1e-10 with the full KPM preconditioner (its left apply) in both
    packages: every increment and snapshot within rtol = atol = 1e-9 (that
    file's tolerance), iterations equal (BiCGStab) or within 1 (GMRES), flags
    0."""
    jops, jp, _, tops, tp, _, x = models
    mspec = SPECS[list(SPECS)[0]]
    cfg = kpm.KPMConfig(max_order=8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1234))
    start = tuple(torch.as_tensor(np.array(jax.random.normal(k, (tops.Nsites, 1),
                                                             dtype=jnp.float64)))
                  for k in (k1, k2))
    tprec = replace(kpm.make_precond(tops, cfg), start=start)
    jprec = jkpm.make_precond(jops, jkpm.KPMConfig(max_order=8))
    scfg = dict(tol=TOL, maxiter=2000, kind=kind, restart=20)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jstep = jax.jit(jm.make_measurement_step(jops, mspec, JSolverConfig(**scfg), jprec))
    jout = [jstep(jp, jnp.asarray(x[c]), keys[c]) for c in range(C)]
    tstep = tm.make_measurement_step(tops, mspec, SolverConfig(**scfg), tprec)
    R = torch.as_tensor(_jax_probes(keys, tops.Nsites, tops.Ltau))
    inc, stats, snaps = tstep(tp, torch.as_tensor(x), R=R)
    assert tstep.segmented and R.shape[1] == NV
    slack = 0 if kind == "bicgstab" else 1
    for c in range(C):
        jinc, jstats, jsnaps, _ = jout[c]
        assert int(stats["flag"][c]) == int(jstats["flag"]) == 0
        assert abs(int(stats["iters"][c]) - int(jstats["iters"])) <= slack
        for group in inc:
            for k, v in inc[group].items():
                np.testing.assert_allclose(v[c].numpy(), np.asarray(jinc[group][k]),
                                           rtol=1e-9, atol=1e-9, err_msg=f"{group}/{k}")
        for k, v in snaps.items():
            np.testing.assert_allclose(v[c].numpy(), np.asarray(jsnaps[k]), rtol=1e-9, atol=1e-9)


# --- the bench configurations and chain ranks

def test_bench_configurations_take_the_solver():
    """``GMRES_64X64`` and ``BICGSTAB_64X64`` are ``KERNEL_64X64`` with that
    solver kind, ``GMRES_LANGEVIN_64X64`` ``LANGEVIN_64X64`` by GMRES; cut
    to 4×4 on the CPU each builds a segmented step of that kind with the
    JAX package's settings (tol 1e-5, maxiter 500, restart 20)."""
    pairs = ((bench.GMRES_64X64, bench.KERNEL_64X64, "gmres"),
             (bench.BICGSTAB_64X64, bench.KERNEL_64X64, "bicgstab"),
             (bench.GMRES_LANGEVIN_64X64, bench.LANGEVIN_64X64, "gmres"))
    for cfg, base, kind in pairs:
        assert replace(cfg, name=base.name, solver="cg") == base and cfg.solver == kind
        b = bench.build(replace(cfg, L=4, beta=1.0, n_chains=2), "cpu", torch.float64)
        if cfg.sampler == "langevin":
            scfg = b.solver
        else:
            scfg = b.hmc_cfg
            scfg = SolverConfig(tol=scfg.tol, maxiter=scfg.maxiter, kind=scfg.solver_kind,
                                restart=scfg.restart)
        assert (scfg.kind, scfg.tol, scfg.maxiter, scfg.restart) == (kind, 1e-5, 500, 20)
        assert b.step.segmented and not b.eager().segmented


def test_chain_ranks_gmres_update_equals_one_rank(tmp_path):
    """On 2 gloo chain ranks the GMRES update
    (``torch_parallel_workers.graph_nonsym_worker``) equals its eager form
    on the rank bit for bit, host reads included, replays the one-rank
    segments, and the ranks' blocks of decisions, x, v, ΔH and iterations
    equal the one-rank run's."""
    one = W.graph_nonsym_worker(torch.device("cpu"))
    ranks = launch(W.graph_nonsym_worker, 2, "gloo", "cpu", (), timeout_s=240, threads=1,
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
