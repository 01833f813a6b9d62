"""The graphed SSH update's segments on the CPU (``dynamics/graphs.py``).

On a CUDA field the one-rank SSH leapfrog CG update of a real field
replays CUDA graphs of fixed segments, as the Holstein one does; on the
CPU the same segment functions run uncaptured. Here, in float64, on both
SSH models of ``tests/test_torch_ssh.py`` (4×4, and 3×3 with aliased
phonons), each on the dense-Ā and the fold branch:

* the segmented update equals the eager update (asked for by name) bit for
  bit over two updates on the same draws, host reads included, also with
  the verbose energies, the dynamic step size and parameters changed
  between updates;
* it matches the JAX package's jitted SSH step on JAX's draws (x and v to
  1e-10, ΔH to 1e-9, H to 1e-12 relative, equal decisions, flags and
  iterations);
* a stand-in capture: after the warm-up update, a second update makes no
  tensor from host data and moves no host tensor onto a field (on a card
  each would be a host-to-device copy, which a CUDA graph cannot hold);
* the workspace keeps ``SSHDerived`` and the KPM state at fixed addresses;
* ``bench.SSH_8X8`` builds on the CPU and is segmented.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from elphdynamics_tpu.dynamics.hmc import HMCConfig as JHMCConfig
from elphdynamics_tpu.dynamics.hmc import HMCState as JHMCState
from elphdynamics_tpu.dynamics.hmc import make_hmc_step as j_make_hmc_step
from elphdynamics_tpu.models.adapter import make_model_ops as j_make_model_ops
from elphdynamics_tpu.ops import kpm as jkpm
from elphdynamics_tpu_torch import bench, solvers
from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCState, make_hmc_step
from elphdynamics_tpu_torch.models import ssh as TS
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.ops import kpm
from test_torch_graph_update import _assert_same
from test_torch_ssh import C, HMC_KW, KPM_KW, MODELS, T, _build, _jax_draws, _mass

torch.set_num_threads(1)

CASES = [(m, b) for m in MODELS for b in ("dense", "fold")]
IDS = [f"{m}-{b}" for m, b in CASES]


@pytest.fixture
def branch_gate(monkeypatch):
    """Close the dense-Ā gate in both packages for the fold branch (per-chain
    tables for Ā, the fused Chebyshev step)."""
    def close(branch):
        if branch == "fold":
            monkeypatch.setattr(jkpm, "_DENSE_ABAR_MAX_SITES", 0)
            monkeypatch.setattr(kpm, "_DENSE_ABAR_MAX_SITES", 0)
    return close


def _fields(ts):
    rng = np.random.default_rng(5)
    x = TS.tie_fields(ts, T(0.3 * rng.standard_normal((C, ts.Nph, ts.Ltau)) + 0.1))
    v = TS.tie_fields(ts, T(np.random.default_rng(13).standard_normal(tuple(x.shape))))
    return HMCState(x=x, v=v)


def _pair(name, **cfg_kw):
    """The model ``name`` at Lτ = 10, its segmented step and the eager twin
    (one preconditioner), and a tied starting state of C chains."""
    L, hoppings = MODELS[name]
    _, _, ts, tp = _build(L, hoppings)
    ops = make_model_ops(ts)
    cfg = HMCConfig(**{**HMC_KW, **cfg_kw})
    pre = kpm.make_precond(ops, kpm.KPMConfig(**KPM_KW))
    dyn = cfg.tune_dt
    seg = make_hmc_step(ops, _mass(ts, tp), cfg, pre, dynamic_dt=dyn)
    eager = make_hmc_step(ops, _mass(ts, tp), cfg, pre, dynamic_dt=dyn, eager=True)
    assert seg.segmented and not eager.segmented
    return ts, tp, seg, eager, _fields(ts)


def _run(step, params, state, draws, dt=None):
    solvers.host_reads = 0
    args = (dt,) if dt is not None else ()
    out, stats = step(params, state, *args, draws=draws)
    return out, stats, solvers.host_reads


# --- the segmented update against the eager one

@pytest.mark.parametrize("name,branch,opts", [
    *[(m, b, {}) for m, b in CASES],
    ("4x4", "dense", dict(log_verbose=True)),
    ("3x3_alias", "fold", dict(tune_dt=True)),
], ids=[*IDS, "4x4-dense-verbose", "3x3_alias-fold-dynamic-dt"])
def test_segmented_update_equals_eager(name, branch, opts, branch_gate):
    branch_gate(branch)
    ts, tp, seg, eager, state = _pair(name, **opts)
    dt = torch.tensor(0.04, dtype=torch.float64) if opts.get("tune_dt") else None
    s_seg = s_eager = state
    for u in range(2):
        draws = eager.draw(tp, state.x, C, torch.Generator().manual_seed(7 + u))
        r_seg = _run(seg, tp, s_seg, draws, dt)
        r_eager = _run(eager, tp, s_eager, draws, dt)
        _assert_same(r_seg, r_eager)
        s_seg, s_eager = r_seg[0], r_eager[0]
        assert r_seg[2] > 0 and bool((r_seg[1].flag == 0).all())
    ws = seg.workspace()
    assert ws is not None and ws.graphs is None and eager.workspace() is None
    assert (ws.kpm.expK is None) == (branch == "fold")
    if opts.get("log_verbose"):
        assert r_seg[1].traj_H.shape == (C, HMCConfig(**HMC_KW).Nt)


def test_changed_parameters_equal_eager():
    """New parameter tensors between updates (α, μ and ω moved) are copied
    into the workspace's kept parameters: no graph holds a value derived
    from SSH's parameters, so nothing goes stale."""
    ts, tp, seg, eager, state = _pair("4x4")
    moved = replace(tp, alpha=tp.alpha * 1.1, mu=tp.mu + 0.05, omega=tp.omega * 0.95)
    s_seg = s_eager = state
    for u, params in enumerate((tp, moved, tp)):
        draws = eager.draw(params, state.x, C, torch.Generator().manual_seed(21 + u))
        r_seg = _run(seg, params, s_seg, draws)
        r_eager = _run(eager, params, s_eager, draws)
        _assert_same(r_seg, r_eager)
        s_seg, s_eager = r_seg[0], r_eager[0]
        if u == 0:
            ws = seg.workspace()
    assert seg.workspace() is ws and torch.equal(ws.params.alpha, tp.alpha)


# --- against the JAX package

@pytest.mark.parametrize("name,branch", CASES, ids=IDS)
def test_segmented_update_matches_jax(name, branch, branch_gate):
    branch_gate(branch)
    L, hoppings = MODELS[name]
    js, jp, ts, tp = _build(L, hoppings)
    state = _fields(ts)
    x0, v0 = state.x.numpy(), state.v.numpy()
    jops, tops = j_make_model_ops(js), make_model_ops(ts)
    mass = _mass(ts, tp)
    jstep = jax.jit(j_make_hmc_step(jops, mass, JHMCConfig(**HMC_KW),
                                    jkpm.make_symmetric_precond(jops, jkpm.KPMConfig(**KPM_KW))))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    runs = [jstep(jp, JHMCState(x=jnp.asarray(x0[c]), v=jnp.asarray(v0[c])), keys[c])
            for c in range(C)]
    jstate = jax.tree.map(lambda *a: np.stack(a), *[r[0] for r in runs])
    jstats = jax.tree.map(lambda *a: np.stack(a), *[r[1] for r in runs])
    step = make_hmc_step(tops, mass, HMCConfig(**HMC_KW),
                         kpm.make_symmetric_precond(tops, kpm.KPMConfig(**KPM_KW)))
    out, stats = step(tp, state, draws=_jax_draws(keys, ts.Nph, ts.Nsites, ts.Ltau))
    assert step.segmented and step.workspace() is not None
    assert (step.workspace().kpm.expK is None) == (branch == "fold")
    np.testing.assert_allclose(out.x.numpy(), jstate.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.v.numpy(), jstate.v, rtol=0, atol=1e-10)
    np.testing.assert_allclose(stats.delta_H.numpy(), jstats.delta_H, rtol=0, atol=1e-9)
    np.testing.assert_allclose(stats.H.numpy(), jstats.H, rtol=1e-12)
    for f in ("accepted", "iters", "flag"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), getattr(jstats, f))


# --- a stand-in capture

class HostUploads(TorchFunctionMode):
    """Counts, while ``counting``, the calls that on a card would copy host
    memory to the device. A host tensor is one made from host data without
    a ``device`` (``torch.as_tensor``, ``torch.tensor``, ``torch.from_numpy``;
    a tensor made with a ``device`` lives on the field's device), or
    computed from host tensors alone. Counted: making a tensor from host
    data (a host tensor, or an upload where a ``device`` is given), moving
    a host tensor (``Tensor.to`` a device or a tensor, ``Tensor.copy_``
    from it, ``torch.as_tensor`` of it with a device) and any other call
    that mixes a host tensor with the field's. ``torch.from_numpy``, which
    the mode does not see, is counted through :meth:`from_numpy`."""

    MAKERS = (torch.as_tensor, torch.tensor)

    def __init__(self):
        super().__init__()
        self.host = {}     # id -> host tensor (kept alive, so that ids stay unique)
        self.counting = False
        self.calls = []

    def _count(self, name, what):
        if self.counting:
            self.calls.append((name, what))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        if func in self.MAKERS and not torch.is_tensor(args[0]):
            self._count(name, type(args[0]).__name__)
            if kwargs.get("device", args[2] if len(args) > 2 else None) is None:
                self.host[id(out)] = out
            return out
        leaves = pytree.tree_leaves((args, kwargs))
        tensors = [a for a in leaves if torch.is_tensor(a)]
        n_host = sum(id(t) in self.host for t in tensors)
        if n_host == 0:
            return out
        moved = (func is torch.Tensor.copy_ or func in self.MAKERS
                 or (func is torch.Tensor.to
                     and any(isinstance(a, (torch.device, str)) for a in leaves)))
        if moved or n_host < len(tensors):
            self._count(name, "host tensor")
        else:
            for t in pytree.tree_leaves(out):
                if torch.is_tensor(t):
                    self.host[id(t)] = t
        return out

    def from_numpy(self, real):
        def counted(a):
            out = real(a)
            self._count("from_numpy", type(a).__name__)
            self.host[id(out)] = out
            return out
        return counted


@pytest.mark.parametrize("name,branch", CASES, ids=IDS)
def test_stand_in_capture_uploads_nothing(name, branch, branch_gate, monkeypatch):
    """The step is built and warmed up (its first update) under the mode,
    which then counts through a second update: every segment runs again,
    as a capture runs it, and makes no host-to-device copy."""
    branch_gate(branch)
    mode = HostUploads()
    monkeypatch.setattr(torch, "from_numpy", mode.from_numpy(torch.from_numpy))
    with mode:
        ts, tp, seg, eager, state = _pair(name)
        gen = torch.Generator().manual_seed(4)
        state, _ = seg(tp, state, draws=eager.draw(tp, state.x, C, gen))
        draws = eager.draw(tp, state.x, C, gen)
        mode.counting = True
        seg(tp, state, draws=draws)
        mode.counting = False
    assert mode.calls == []
    # the mode sees what it is meant to see
    with mode:
        host = torch.as_tensor(np.arange(3.0))[:, None].double()
        mode.counting = True
        host.to(torch.zeros(3))
        torch.zeros(3, 1).copy_(host)
        torch.zeros(3, 1) * host
        torch.from_numpy(np.arange(3.0))
        torch.tensor(1.0)
    assert [c[0] for c in mode.calls] == ["to", "copy_", "mul", "from_numpy", "tensor"]


# --- the workspace

def test_workspace_puts_a_namedtuple_in_place():
    ws = graphs.Workspace(torch.device("cpu"))
    first = TS.SSHDerived(cosh=torch.ones(2, 3), sinh=torch.zeros(2, 3))
    kept = ws.put("env", first)
    assert isinstance(kept, TS.SSHDerived) and kept.cosh is not first.cosh
    again = ws.put("env", TS.SSHDerived(cosh=torch.full((2, 3), 2.0), sinh=torch.ones(2, 3)))
    assert again is kept and torch.equal(kept.cosh, torch.full((2, 3), 2.0))
    assert torch.equal(kept.sinh, torch.ones(2, 3))


@pytest.mark.parametrize("branch", ["dense", "fold"])
def test_workspace_keeps_addresses_across_updates(branch, branch_gate):
    """``SSHDerived`` and the per-chain KPM tables (τ-means, and on the dense
    branch the re-densified Ā) keep their tensors from one update to the
    next; their values are those of the update's last field."""
    branch_gate(branch)
    ts, tp, seg, eager, state = _pair("4x4")
    addresses = []
    for u in range(2):
        state, _ = seg(tp, state, draws=eager.draw(tp, state.x, C,
                                                   torch.Generator().manual_seed(u)))
        ws = seg.workspace()
        kept = [ws.env.cosh, ws.env.sinh, ws.kpm.expnV_bar, ws.kpm.cosh_bar, ws.kpm.sinh_bar]
        if branch == "dense":
            kept += [ws.kpm.expK, ws.kpm.expK_inv]
        addresses.append([t.data_ptr() for t in kept])
        want = TS.ckb_coeffs(ts, tp, ws.x)
        assert torch.equal(ws.env.cosh, want.cosh) and torch.equal(ws.env.sinh, want.sinh)
        assert torch.equal(ws.kpm.cosh_bar, want.cosh.mean(dim=-1))
    assert addresses[0] == addresses[1]


# --- the bench configuration

def test_bench_ssh_8x8_builds_segmented():
    """``bench.SSH_8X8`` (the JAX package's ``scripts/bench_ssh.py``) at 2
    chains on the CPU, the trajectory cut to 2 steps: segmented, the dense
    per-chain Ā, one finite update with no solver failure."""
    cfg = replace(bench.SSH_8X8, n_chains=2)
    assert (bench.SSH_8X8.L, bench.SSH_8X8.n_chains, bench.SSH_8X8.dt) == (8, 64, 0.05)
    b = bench.build(cfg, "cpu", torch.float64, trajectory_time=0.1)
    assert b.step.segmented and b.kpm_cfg.max_order == 8 and b.hmc_cfg.Nb == 4
    state, stats = b.step(b.params, b.state, b.generator)
    ws = b.step.workspace()
    assert isinstance(ws.env, TS.SSHDerived)
    assert tuple(ws.kpm.expK.shape) == (2, 64, 64)
    assert bool(torch.isfinite(state.x).all()) and bool((stats.flag == 0).all())
