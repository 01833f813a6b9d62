"""The graphed calls under complex hopping (twisted boundaries) on the CPU
(``dynamics/graphs.py``).

On a CUDA field the one-rank CG calls of a twisted model replay CUDA graphs
of the same segments as a real field's: the leapfrog HMC update, the
Langevin step (Euler, RK, Heun), the reflection and swap moves and the
measurement, their fermion fields complex (the packed pseudofermions
``[C, 1, N, Lτ]``, the circular complex force probes and measurement
probes), x, v and the forces real. On the CPU the same segment functions
run uncaptured. Here, in float64, 2 chains, Lτ = 10, on the twisted 4×4
Holstein model (dense branch; fold branch with the dense Ā off) and the
twisted SSH chain (dense and fold Ā) of ``tests/test_torch_complex_hopping.py``:

* every graphed call equals its eager twin (asked for by name) bit for bit
  over two calls on the same draws, host reads included;
* the graphed update matches the JAX package's jitted ``make_hmc_step`` on
  JAX's draws with the dense Ā off in both packages (x to 1e-10, equal
  decisions, flags and iterations); the other twisted cases against JAX
  are ``tests/test_torch_complex_hopping.py``'s, which now run graphed;
* a solve made to fail runs the verification and the eager retry;
* a stand-in capture: a second call makes no host-to-device copy;
* a real workspace never serves a complex call, nor the reverse;
* the τ↔ω phase Θ is uploaded once per (Lτ, device, dtype) with its
  values unchanged, and a first upload during a capture raises;
* the measurement's estimators run on blocks of chains with the results
  of one block of all chains, the blocks sized by a byte budget.
"""

import numpy as np
import pytest
import torch

from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics import langevin as tl
from elphdynamics_tpu_torch.dynamics import special_updates as tsu
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.measure import measurements as tm
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import kpm, timefreqfft
from elphdynamics_tpu_torch.ops.fourier_accel import build_mass, build_Q
from elphdynamics_tpu_torch.utils.dtypes import complex_of, params_are_complex
from test_torch_complex_hopping import _holstein, _ssh, twisted_update_against_jax
from test_torch_graph_special_measure import Uploads, _call, _equal
from test_torch_graph_update import _assert_same

torch.set_num_threads(1)

C = 2
# the twisted Holstein model on its dense and fold branches (the fold one
# with the dense Ā off too) and the twisted SSH chain with a dense and a
# fold Ā
MODELS = ["dense", "fold", "ssh", "ssh-fold"]
FA = [dict(omega_min=0.0, omega_max=10.0, mass=0.5)]
HMC = dict(dt=0.05, trajectory_time=0.2, Nb=2, tol=1e-7, maxiter=500, construct_guess=True,
           guess_order=3)
N_MOVES = 3


@pytest.fixture
def abar_gate(monkeypatch):
    """Close the dense-Ā gate in both packages (Ā through the fold: the
    twin of K1's complex mode)."""
    def close():
        monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
        monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    return close


def _model(name, abar_gate):
    """The twisted model ``name`` (ops, params) and C chains of its real
    fields ``[C, Nph, Lτ]`` (SSH's tied), made with a device, as a card's
    fields are (:class:`Uploads` counts tensors made from host data without
    one)."""
    if name in ("fold", "ssh-fold"):
        abar_gate()
    rng = np.random.default_rng(11)
    if name.startswith("ssh"):
        js, _, ts, tp, xs = _ssh(Ltau=10, alpha=0.3, alpha2=0.0)
        x = np.stack([xs, xs + 0.1 * rng.standard_normal(xs.shape)])
        x = TS.tie_fields(ts, torch.as_tensor(x, device="cpu"))
    else:
        _, _, ts, tp = _holstein(L=4, beta=1.0, dense_threshold=2048 if name == "dense" else 0)
        x = torch.as_tensor(0.5 * rng.standard_normal((C, ts.Nph, 1))
                            + 0.1 * rng.standard_normal((C, ts.Nph, ts.Ltau)), device="cpu")
    assert params_are_complex(tp)
    return make_model_ops(ts), tp, x


def _precond(ops, on=True):
    return kpm.make_precond(ops, kpm.KPMConfig(max_order=4)) if on else None


def _mass(ops, tp):
    return build_mass(tp.omega.numpy(), ops.dtau, ops.Ltau, FA)


# --- the HMC update

def _update_pair(name, abar_gate, **cfg_kw):
    ops, tp, x = _model(name, abar_gate)
    cfg = HMCConfig(**{**HMC, **cfg_kw})
    pre = _precond(ops)
    seg = make_hmc_step(ops, _mass(ops, tp), cfg, pre)
    eager = make_hmc_step(ops, _mass(ops, tp), cfg, pre, eager=True)
    assert seg.segmented and not eager.segmented
    v = torch.as_tensor(np.random.default_rng(13).standard_normal(tuple(x.shape)), device="cpu")
    if not ops.is_holstein:
        v = TS.tie_fields(ops.spec, v)
    return ops, tp, seg, eager, HMCState(x=x, v=v)


def _two_updates(seg, eager, tp, state, seed=7):
    """Two updates each way from ``state`` on the same draws; each update's
    graphed result with its host reads."""
    ss = se = state
    out = []
    for u in range(2):
        draws = eager.draw(tp, state.x, C, torch.Generator().manual_seed(seed + u))
        assert draws.pseudofermion.is_complex() and draws.pseudofermion.shape[1] == 1
        (sg, tg), rg = _call(seg, tp, ss, draws=draws)
        (s_e, te), re_ = _call(eager, tp, se, draws=draws)
        _assert_same((sg, tg, rg), (s_e, te, re_))
        assert rg > 0
        ss, se = sg, s_e
        out.append((sg, tg))
    return out


@pytest.mark.parametrize("name,opts", [*[(m, {}) for m in MODELS],
                                       ("dense", dict(log_verbose=True)),
                                       ("ssh", dict(tol=1e-5))],
                         ids=[*MODELS, "dense-verbose", "ssh-loop-tol"])
def test_segmented_twisted_update_equals_eager(name, opts, abar_gate):
    ops, tp, seg, eager, state = _update_pair(name, abar_gate, **opts)
    runs = _two_updates(seg, eager, tp, state)
    assert any(bool(t.accepted.any()) for _, t in runs)
    for st, stats in runs:
        assert not st.x.is_complex() and bool((stats.flag == 0).all())
    ws = seg.workspace()
    assert ws is not None and ws.graphs is None and eager.workspace() is None
    # the fermion side of the workspace is the packed complex field, the
    # warm-start history too; the KPM state is the complex one
    assert ws.Lphi.is_complex() and tuple(ws.Lphi.shape) == (C, 1, ops.Nsites, ops.Ltau)
    assert ws.hist0.is_complex() and ws.cg.iters.shape[1] == 1
    assert kpm._state_is_complex(ws.kpm) and ws.kpm.coeff.shape[-1] == ops.Ltau
    assert (ws.kpm.expK is None) == name.endswith("fold")
    assert ws.retries == 0


@pytest.mark.parametrize("name", ["fold", "ssh"])
def test_segmented_twisted_update_matches_jax(name, abar_gate):
    """The dense Ā off in both packages (``tests/test_torch_complex_hopping.py``
    runs the dense-Ā cases): x and v to 1e-10, equal decisions, flags and
    iterations."""
    abar_gate()
    tstep, st, stats, runs = twisted_update_against_jax(name)
    ws = tstep.workspace()
    assert tstep.segmented and ws is not None and ws.kpm.expK is None
    for c, (jst, jstats, _) in enumerate(runs):
        np.testing.assert_allclose(st.x[c].numpy(), np.asarray(jst.x), rtol=0, atol=1e-10)
        np.testing.assert_allclose(st.v[c].numpy(), np.asarray(jst.v), rtol=0, atol=1e-10)
        assert bool(stats.accepted[c]) == bool(jstats.accepted)
        assert int(stats.iters[c]) == int(jstats.iters)
        assert int(stats.flag[c]) == int(jstats.flag) == 0


# --- the Langevin step

def _langevin_pair(name, method, abar_gate, precond=True, **scfg_kw):
    ops, tp, x = _model(name, abar_gate)
    Q = build_Q(tp.omega.numpy(), ops.dtau, ops.Ltau, FA)
    scfg = SolverConfig(**{**dict(tol=1e-6, maxiter=500), **scfg_kw})
    pre = _precond(ops, precond)
    seg = tl.make_langevin_step(ops, Q, 0.01, method, scfg, pre)
    eager = tl.make_langevin_step(ops, Q, 0.01, method, scfg, pre, eager=True)
    assert seg.segmented and not eager.segmented
    return ops, tp, seg, eager, x


@pytest.mark.parametrize("precond", [True, False], ids=["kpm", "plain"])
@pytest.mark.parametrize("name", ["dense", "fold", "ssh-fold"])
@pytest.mark.parametrize("method", tl.METHODS)
def test_segmented_twisted_langevin_equals_eager(method, name, precond, abar_gate):
    ops, tp, seg, eager, x = _langevin_pair(name, method, abar_gate, precond)
    xs = xe = x
    for u in range(2):
        draws = eager.draw(tp, x, C, torch.Generator().manual_seed(5 + u))
        assert all(g.is_complex() for g in draws.g)
        rg, rdg = _call(seg, tp, xs, draws=draws)
        re_, rde = _call(eager, tp, xe, draws=draws)
        _equal(rg[0], re_[0])
        _equal((rg[1].iters, rg[1].flag), (re_[1].iters, re_[1].flag))
        assert rdg == rde > 0 and bool((rg[1].flag == 0).all())
        assert not rg[0].is_complex() and float((rg[0] - xs).abs().max()) > 1e-4
        xs, xe = rg[0], re_[0]
    ws = seg.workspace()
    assert ws is not None and ws.b.is_complex() and eager.workspace() is None


# --- the moves

SPECIAL = [("reflect", "dense"), ("reflect", "fold"), ("swap", "dense"), ("swap", "fold"),
           ("swap", "ssh"), ("swap", "ssh-fold")]


def _special_pair(kind, name, abar_gate, **cfg_kw):
    ops, tp, x = _model(name, abar_gate)
    make = tsu.make_reflection_update if kind == "reflect" else tsu.make_swap_update
    cfg = tsu.SpecialUpdateConfig(**{**dict(freq=1, n_moves=N_MOVES, maxiter=500), **cfg_kw})
    pre = _precond(ops)
    seg, twin = make(ops, cfg, pre), make(ops, cfg, pre, eager=True)
    assert seg.segmented and not twin.segmented and seg.n_moves == N_MOVES
    return ops, tp, x, seg, twin


@pytest.mark.parametrize("kind,name", SPECIAL, ids=[f"{k}-{m}" for k, m in SPECIAL])
def test_segmented_twisted_move_equals_eager(kind, name, abar_gate):
    """Reflection (Holstein; SSH's is a null move) and swap: x and the
    acceptance bit for bit, equal host reads, over two calls."""
    ops, tp, x, seg, twin = _special_pair(kind, name, abar_gate)
    xs = xe = x
    moved = False
    for u in range(2):
        draws = twin.draw(tp, x, C, torch.Generator().manual_seed(7 + u))
        assert draws.pseudofermion.is_complex() and draws.pseudofermion.shape[2] == 1
        r_seg, r_eager = _call(seg, tp, xs, draws=draws), _call(twin, tp, xe, draws=draws)
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1] > 0
        moved = moved or not torch.equal(r_seg[0][0], xs)
        xs, xe = r_seg[0][0], r_eager[0][0]
    assert moved
    ws = seg.workspace()
    assert ws is not None and ws.R.is_complex() and ws.retries == 0


# --- the measurement

def _mspec(ssh: bool):
    onsite = ("Greens", "DenDen", "SpinSpin", "PairGreens") + (() if ssh else ("PhononGreens",))
    inter = ("BondBond", "CurrentCurrent", "BondPairGreens") + (("PhononGreens",) if ssh else ())
    return tm.MeasurementSpec(nv=4, onsite_corr=tuple((k, True) for k in onsite),
                              intersite_corr=tuple((k, True) for k in inter),
                              snapshots=("density", "double_occupancy", "phonon_position"))


def _measure_pair(name, abar_gate, chain_block=None, **scfg_kw):
    ops, tp, x = _model(name, abar_gate)
    scfg = SolverConfig(**{**dict(tol=1e-6, maxiter=500), **scfg_kw})
    pre = _precond(ops)
    mspec = _mspec(not ops.is_holstein)
    seg = tm.make_measurement_step(ops, mspec, scfg, pre, chain_block=chain_block)
    twin = tm.make_measurement_step(ops, mspec, scfg, pre, eager=True, chain_block=chain_block)
    assert seg.segmented and not twin.segmented
    return ops, tp, x, seg, twin


@pytest.mark.parametrize("name", MODELS)
def test_segmented_twisted_measurement_equals_eager(name, abar_gate):
    """Every on-site kind, BondBond, CurrentCurrent (conj(t) placements),
    BondPairGreens (the spin-↓ factor conjugated), the bond-phonon
    PhononGreens (SSH) and the snapshots, time dependent: bit for bit, with
    equal host reads, over two calls; the probes come from the generator
    in the eager order."""
    ops, tp, x, seg, twin = _measure_pair(name, abar_gate)
    xs = x
    for u in range(2):
        R = twin.draw(tp, xs, torch.Generator().manual_seed(3 + u))
        assert R.is_complex()
        r_seg, r_eager = _call(seg, tp, xs, R=R), _call(twin, tp, xs, R=R)
        _equal(r_seg[0], r_eager[0])
        assert r_seg[1] == r_eager[1] > 0
        inc, stats, snaps = r_seg[0]
        assert bool((stats["flag"] == 0).all()) and len(snaps) == 3
        assert "SpinSpin" in inc["onsite_corr"] and "CurrentCurrent" in inc["intersite_corr"]
        xs = xs + 0.05
    ws = seg.workspace()
    assert ws is not None and ws.R.is_complex() and twin.workspace() is None
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    _equal(seg(tp, x, g1), twin(tp, x, g2))
    assert torch.equal(torch.randn(3, generator=g1), torch.randn(3, generator=g2))


# --- the verification's retry

@pytest.mark.parametrize("what", ["update", "measurement"])
def test_twisted_failed_solve_runs_verification_and_retry(what, abar_gate):
    """maxiter 2: every solve fails its verification and is retried from
    zero, unpreconditioned (eagerly, between replays on the card); the
    results and host reads are the eager call's."""
    if what == "update":
        ops, tp, seg, eager, state = _update_pair("dense", abar_gate, maxiter=2)
        draws = eager.draw(tp, state.x, C, torch.Generator().manual_seed(3))
        (sg, tg), rg = _call(seg, tp, state, draws=draws)
        (s_e, te), re_ = _call(eager, tp, state, draws=draws)
        _assert_same((sg, tg, rg), (s_e, te, re_))
        # a solve warm-started from a retried solution may pass in 2
        assert seg.workspace().retries > 0
    else:
        ops, tp, x, seg, twin = _measure_pair("fold", abar_gate, maxiter=2)
        R = twin.draw(tp, x, torch.Generator().manual_seed(3))
        (rg_out, rg), (re_out, re_) = _call(seg, tp, x, R=R), _call(twin, tp, x, R=R)
        _equal(rg_out, re_out)
        assert rg == re_
        assert bool((rg_out[1]["iters"] > 2).all()) and seg.workspace().retries == 1


# --- a stand-in capture

CAPTURE = [("update", "dense"), ("update", "fold"), ("update", "ssh-fold"),
           ("euler", "dense"), ("rk", "fold"), ("heun", "ssh-fold"),
           ("reflect", "fold"), ("swap", "ssh"), ("measurement", "dense"),
           ("measurement", "ssh-fold")]


@pytest.mark.parametrize("what,name", CAPTURE, ids=[f"{w}-{m}" for w, m in CAPTURE])
def test_twisted_stand_in_capture_uploads_nothing(what, name, abar_gate, monkeypatch):
    """The call is built and warmed up (its first call) under the mode,
    which then counts through a second call: every segment runs again, as
    a capture runs it, and makes no host-to-device copy (the complex KPM
    pipeline's Θ included)."""
    mode = Uploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    with mode:
        gen = torch.Generator().manual_seed(4)
        if what == "update":
            ops, tp, seg, eager, state = _update_pair(name, abar_gate)
            state, _ = seg(tp, state, draws=eager.draw(tp, state.x, C, gen))
            draws = eager.draw(tp, state.x, C, gen)
            mode.counting = True
            seg(tp, state, draws=draws)
        elif what in tl.METHODS:
            ops, tp, seg, eager, x = _langevin_pair(name, what, abar_gate)
            x, _ = seg(tp, x, draws=eager.draw(tp, x, C, gen))
            draws = eager.draw(tp, x, C, gen)
            mode.counting = True
            seg(tp, x, draws=draws)
        elif what == "measurement":
            ops, tp, x, seg, twin = _measure_pair(name, abar_gate)
            seg(tp, x, gen)
            R = twin.draw(tp, x, gen)
            mode.counting = True
            seg(tp, x, R=R)
        else:
            ops, tp, x, seg, twin = _special_pair(what, name, abar_gate)
            x, _ = seg(tp, x, gen)
            draws = twin.draw(tp, x, C, gen)
            mode.counting = True
            seg(tp, x, draws=draws)
        mode.counting = False
    assert mode.calls == []


# --- the workspace's key

def test_real_and_complex_workspaces_are_apart(abar_gate):
    """One step called with real, then twisted, then real parameters of the
    same lattice (fields of one dtype and shape): each change of the
    hopping's type makes a new workspace, and each call equals its eager
    twin."""
    ops, tp, seg, eager, state = _update_pair("dense", abar_gate)
    _, _, ts_real, tp_real = _holstein(L=4, beta=1.0, dense_threshold=2048, twist=None)
    assert not params_are_complex(tp_real)
    box = {}
    seen = []
    for params in (tp, tp_real, tp, tp):
        ws = graphs.step_workspace(box, params, state.x)
        seen.append(ws)
        assert ws.key[-1] == (complex_of(state.x.dtype) if params is tp else torch.float64)
    assert seen[0] is not seen[1] and seen[1] is not seen[2] and seen[2] is seen[3]
    real_ops = make_model_ops(ts_real)
    real_seg = make_hmc_step(real_ops, _mass(real_ops, tp_real), HMCConfig(**HMC),
                             _precond(real_ops))
    real_eager = make_hmc_step(real_ops, _mass(real_ops, tp_real), HMCConfig(**HMC),
                               _precond(real_ops), eager=True)
    for step, twin, params in ((seg, eager, tp), (real_seg, real_eager, tp_real)):
        draws = twin.draw(params, state.x, C, torch.Generator().manual_seed(1))
        (sg, tg), rg = _call(step, params, state, draws=draws)
        (s_e, te), re_ = _call(twin, params, state, draws=draws)
        _assert_same((sg, tg, rg), (s_e, te, re_))
        assert step.workspace().Lphi.is_complex() == params_are_complex(params)


# --- the τ↔ω phase

def test_theta_is_uploaded_once_with_its_values(monkeypatch):
    """Θ is made once per (Lτ, device, dtype) and kept; its values are
    ``theta(Lτ)`` in the field's complex type, and the maps give what the
    per-call upload gave, bit for bit. A first upload during a CUDA graph
    capture raises (the check runs before any device is touched)."""
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        first = timefreqfft.theta_on(14, "cpu", dtype)
        assert timefreqfft.theta_on(14, torch.device("cpu"), dtype) is first
        want = torch.as_tensor(timefreqfft.theta(14), dtype=complex_of(dtype))
        assert first.dtype == complex_of(dtype) and torch.equal(first, want)
        v = torch.as_tensor(rng.standard_normal((3, 5, 14))).to(dtype)
        w = timefreqfft.tau_to_omega(v)
        assert torch.equal(w, torch.fft.fft(want * v, dim=-1))
        assert torch.equal(timefreqfft.omega_to_tau(w, real=False),
                           torch.conj(want) * torch.fft.ifft(w, dim=-1))
    assert timefreqfft.theta_on(14, "cpu", torch.float32) is \
        timefreqfft.theta_on(14, "cpu", torch.complex64)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        timefreqfft.theta_on(15, "cuda", torch.float32)
    assert timefreqfft.theta_on(14, "cpu", torch.float32) is not None   # the CPU never captures


# --- the measurement's chain blocks

@pytest.mark.parametrize("name", ["dense", "ssh"])
def test_measurement_analyzes_chains_in_blocks(name, abar_gate, monkeypatch):
    """The estimators run on blocks of chains (``chain_block``; their
    memory grows with the chains: a batch of all of them did not fit on the
    card at ``--chains 0``), the blocks' results joined along the chain
    axis: 3 chains in blocks of 2 give what one block of 3 gives (bit for
    bit on the CPU), the segmented measurement what the eager one gives."""
    ops, tp, x, seg, twin = _measure_pair(name, abar_gate, chain_block=2)
    *_, whole_step = _measure_pair(name, abar_gate)
    x = torch.cat([x, x[:1] + 0.1])
    R = twin.draw(tp, x, torch.Generator().manual_seed(3))
    sizes = []
    pair_sums = tm.G.pair_tensor_sums

    def recorded(lattice, R_, MinvR, pairs=None):
        sizes.append(R_.shape[0])
        return pair_sums(lattice, R_, MinvR, pairs)

    monkeypatch.setattr(tm.G, "pair_tensor_sums", recorded)
    whole = whole_step(tp, x, R=R)
    (blocked, r_e), (graphed, r_g) = _call(twin, tp, x, R=R), _call(seg, tp, x, R=R)
    assert sizes == [3, 2, 1, 2, 1] and r_e == r_g > 0
    _equal(graphed, blocked)
    _equal(blocked, whole)


@pytest.mark.parametrize("chains, nv, n_sites, ltau, dtype, block", [
    (64, 10, 4096, 40, torch.float32, 8),      # SSH 64×64 at --chains 0: 8 blocks
    (32, 10, 4096, 40, torch.float32, 8),      # Holstein 64×64 at --chains 0
    (16, 10, 4096, 40, torch.float32, 8),
    (8, 10, 4096, 40, torch.float32, 8),       # one block
    (32, 10, 4096, 40, torch.float64, 4),      # twice the bytes per chain
    (4096, 10, 16, 20, torch.float32, 4096),   # stock 4×4 at --chains 0: one pass
    (2048, 10, 16, 40, torch.float32, 2048),   # stock twisted 4×4
    (512, 20, 64, 160, torch.float32, 32),     # stock deep-β 8×8: 16 blocks
    (9, 10, 4096, 40, torch.float32, 5),       # equal blocks: 5 + 4, not 8 + 1
    (3, 1, 4096, 40, torch.float32, 3),        # one probe: no pair
])
def test_analyze_chains_keeps_the_byte_budget(chains, nv, n_sites, ltau, dtype, block):
    """The estimators' chains per pass keep one pair-summed tensor per probe
    pair within ``ANALYZE_BYTES``, in equal blocks: the 64×64 batches of
    ``--chains 0`` run in blocks of 8 chains, the small lattices' thousands
    of chains in one pass or a few."""
    got = tm.analyze_chains(chains, nv, n_sites, ltau, dtype)
    assert got == block
    pairs = max(nv * (nv - 1) // 2, 1)
    per_chain = pairs * 2 * n_sites * ltau * (16 if dtype == torch.float64 else 8)
    most = max(1, tm.ANALYZE_BYTES // per_chain)   # the chains the budget holds
    assert got <= most and -(-chains // got) == -(-chains // most)
