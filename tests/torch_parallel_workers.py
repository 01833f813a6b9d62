"""Rank functions of the PyTorch port's multi-rank tests
(``tests/test_torch_parallel_*.py``).

``elphdynamics_tpu_torch.parallel.multihost.launch`` spawns each rank and
pickles its function by import path, so the functions live here, in a
module that imports torch and the port only (a spawned rank does not
import JAX). Every function takes the rank's device first and returns
numpy arrays or numbers; a sharded field comes back as the rank's block,
and the test assembles the blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics.hmc import HMCConfig, HMCDraws, HMCState, make_hmc_step
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_oinv
from elphdynamics_tpu_torch.lattice import Lattice, UnitCell
from elphdynamics_tpu_torch.models.adapter import make_model_ops
from elphdynamics_tpu_torch.models.holstein import build_holstein
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.ops.checkerboard import build_checkerboard_spec
from elphdynamics_tpu_torch.parallel import multihost
from elphdynamics_tpu_torch.parallel.lattice_shard import SiteShard, shard_holstein, shard_ssh

UC = (2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
T_ASSIGN = [(1.0, 0.1, 0, 0, (1, 0, 0)), (1.0, 0.1, 0, 0, (0, 1, 0))]
WIJ = [(0.3, 0.05, 1, 0, 0, (1, 0, 0)), (0.2, 0.0, -1, 0, 0, (0, 1, 0))]


def holstein_kw(case: str) -> dict:
    """Model arguments shared by both packages: ``plain``, ``wij``
    (dispersion and an anharmonic term) or ``twist`` (complex hopping)."""
    kw = dict(t_assignments=T_ASSIGN, omega=1.0, omega_std=0.1, lam=1.0, lam_std=0.1, mu=-0.1)
    if case == "wij":
        kw.update(wij_assignments=WIJ, omega4=0.05)
    if case == "twist":
        kw.update(twist=(0.3, 0.0))
    return kw


def build(L: int, beta: float, dtau: float, case: str, seed: int = 5, device="cpu", **extra):
    """The port's Holstein model (float64), on the CPU unless ``device``
    says otherwise."""
    return build_holstein(Lattice.create(UnitCell.create(*UC), L), beta, dtau,
                          rng=np.random.default_rng(seed), device=device,
                          **holstein_kw(case), **extra)


def _shard(spec, params):
    """This rank's (shard, local ops, local params) of a model."""
    shard = SiteShard(spec.ckb, spec.wij_table, multihost.world(), multihost.rank())
    lspec, lparams = shard_holstein(spec, params, shard)
    return shard, make_model_ops(lspec), lparams


def _np(t):
    return t.detach().cpu().numpy()


FOLDS = (("mul", False, 1.0), ("transpose", True, 1.0), ("inverse", True, -1.0),
         ("inverse_transpose", False, -1.0))


def fold_worker(device, cases):
    """The halo fold of each ``(neighbor table, nsites, cosh, sinh, v)`` of
    ``cases`` in the four directions on this rank's block:
    ``{(case, direction): block}``, and per case the shard's (messages,
    bytes, folds)."""
    out = {}
    for i, (table, nsites, c, s, v) in enumerate(cases):
        spec = build_checkerboard_spec(nsites, table)
        shard = SiteShard(spec, np.zeros((2, 0), dtype=np.int64), multihost.world(),
                          multihost.rank())
        c, s, v = (torch.as_tensor(a, device=device) for a in (c, s, v))
        for name, rev, sign in FOLDS:
            out[(i, name)] = _np(shard.fold(c, s, shard.local(v), reverse=rev, sign=sign))
        out[(i, "halo")] = (shard.halo_msgs, shard.halo_bytes, shard.folds)
    return out


def solve_worker(device, L: int, cases, n_chains: int):
    """:func:`solve_case` for each model case."""
    return {case: solve_case(L, case, n_chains) for case in cases}


def solve_case(L: int, case: str, n_chains: int):
    """Sharded operators, bosonic action, KPM bounds and the checked CG
    against the one-rank port on the same inputs: the largest differences
    and both iteration counts."""
    spec, params = build(L, 1.0, 0.1, case, dense_threshold=0)
    ops = make_model_ops(spec)
    shard, lops, lp = _shard(spec, params)
    g = torch.Generator().manual_seed(1)
    x = 0.3 * torch.randn((n_chains, spec.Nsites, spec.Ltau), generator=g, dtype=torch.float64)
    rhs = torch.randn((n_chains, 2, spec.Nsites, spec.Ltau), generator=g, dtype=torch.float64)
    if params.cosht.is_complex():
        rhs = rhs.to(params.cosht.dtype)
    loc = shard.local
    d, ld = ops.derived(params, x), lops.derived(lp, loc(x))
    diffs = {
        "mulM": (loc(ops.mulM(params, d[:, None], rhs)) - lops.mulM(lp, ld[:, None], loc(rhs))),
        "mulMT": (loc(ops.mulMT(params, d[:, None], rhs)) - lops.mulMT(lp, ld[:, None], loc(rhs))),
        "muldMdx": (loc(ops.muldMdx(params, d[:, None], x[:, None], rhs, rhs))
                    - lops.muldMdx(lp, ld[:, None], loc(x)[:, None], loc(rhs), loc(rhs))),
        "Sb": ops.calc_Sb(params, x) - lops.calc_Sb(lp, loc(x)),
        "dSbdx": loc(ops.calc_dSbdx(params, x, True)) - lops.calc_dSbdx(lp, loc(x), True),
    }
    kcfg = kpm.KPMConfig(max_order=4)
    pre, lpre = kpm.make_symmetric_precond(ops, kcfg), kpm.make_symmetric_precond(lops, kcfg)
    st, lst = pre.setup(params, x), lpre.setup(lp, loc(x))
    diffs["lam_avg"] = st.lam_avg - lst.lam_avg
    diffs["lam_mag"] = st.lam_mag - lst.lam_mag
    scfg = SolverConfig(tol=1e-8, maxiter=500)
    full = solve_oinv(ops, params, d[:, None], rhs, scfg, resolve_precond(pre, params, x))
    part = solve_oinv(lops, lp, ld[:, None], loc(rhs), scfg, resolve_precond(lpre, lp, loc(x)))
    diffs["cg_x"] = loc(full.x) - part.x
    out = {k: float(v.abs().max()) for k, v in diffs.items()}
    out["iters"] = (_np(full.iters).tolist(), _np(part.iters).tolist())
    out["flags"] = (_np(full.flag).tolist(), _np(part.flag).tolist())
    out["allreduces"] = shard.allreduces
    return out


def _local_draws(draws: dict, shard) -> HMCDraws:
    """Numpy whole-model draws as the rank's HMCDraws."""
    T = torch.as_tensor
    return HMCDraws(momentum=shard.local(T(draws["momentum"])),
                    pseudofermion=shard.local(T(draws["pseudofermion"])),
                    uniform=T(draws["uniform"]),
                    kpm_start=tuple(shard.local(T(v)) for v in draws["kpm_start"]))


def _defl_state(defl):
    """Numpy (W, chol, pvec, lam_max) as a deflation state, or None."""
    from elphdynamics_tpu_torch.ops.deflation import DeflationState

    return None if defl is None else DeflationState(*(torch.as_tensor(a) for a in defl))


def hmc_worker(device, L: int, beta: float, case: str, cfg: dict, kpm_kw: dict, mass, x0, v0,
               draws: dict, dt=None, defl=None, form: str = "segmented"):
    """One sharded HMC update with the given whole-model draws (and whole
    deflation basis ``defl``, cut to the block), in ``form`` (``segmented``,
    the graphed update's segments; ``eager``), and the same update of the
    one-rank port (rank 0): the sharded x and v blocks, both runs'
    statistics and the one-rank fields."""
    from elphdynamics_tpu_torch.ops import deflation

    spec, params = build(L, beta, 0.1, case)
    ops = make_model_ops(spec)
    shard, lops, lp = _shard(spec, params)
    hcfg = HMCConfig(**cfg)
    dyn = dt is not None
    step = make_hmc_step(lops, mass, hcfg, kpm.make_symmetric_precond(lops, kpm.KPMConfig(**kpm_kw)),
                         dynamic_dt=dyn, eager=form == "eager")
    x0, v0 = torch.as_tensor(x0), torch.as_tensor(v0)
    args = (torch.tensor(dt, dtype=torch.float64),) if dyn else ()
    d0 = _defl_state(defl)
    st, stats = step(lp, HMCState(x=shard.local(x0), v=shard.local(v0),
                                  defl=None if d0 is None else deflation.cut(d0, shard.local)),
                     *args, draws=_local_draws(draws, shard))

    def stat_dict(s):
        return {k: _np(getattr(s, k)) for k in ("accepted", "iters", "flag", "delta_H", "H")}

    out = dict(x=_np(st.x), v=_np(st.v), stats=stat_dict(stats),
               halo=(shard.halo_msgs, shard.halo_bytes, shard.folds, shard.allreduces),
               W=None if st.defl is None else _np(st.defl.W))
    if multihost.rank() == 0:
        one = make_hmc_step(ops, mass, hcfg, kpm.make_symmetric_precond(ops, kpm.KPMConfig(**kpm_kw)),
                            dynamic_dt=dyn)
        T = torch.as_tensor
        st1, stats1 = one(params, HMCState(x=x0, v=v0, defl=d0), *args, draws=HMCDraws(
            momentum=T(draws["momentum"]), pseudofermion=T(draws["pseudofermion"]),
            uniform=T(draws["uniform"]), kpm_start=tuple(T(v) for v in draws["kpm_start"])))
        out.update(one_x=_np(st1.x), one_v=_np(st1.v), one_stats=stat_dict(stats1))
    return out


def sampler_worker(device, L: int, case: str, n_chains: int):
    """Reflection, swap, the three Langevin schemes and a Green's-function
    sample, sharded and on one rank from equal generators: per sampler the
    largest difference and whether the decisions and iterations agree."""
    from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step
    from elphdynamics_tpu_torch.dynamics.special_updates import (
        SpecialUpdateConfig, make_reflection_update, make_swap_update)
    from elphdynamics_tpu_torch.measure.greens import sample_greens
    from elphdynamics_tpu_torch.ops.fourier_accel import build_Q

    spec, params = build(L, 1.0, 0.1, case)
    ops = make_model_ops(spec)
    shard, lops, lp = _shard(spec, params)
    kcfg = kpm.KPMConfig(max_order=4)
    pre, lpre = kpm.make_precond(ops, kcfg), kpm.make_precond(lops, kcfg)
    g = torch.Generator().manual_seed(2)
    x = 0.4 * torch.randn((n_chains, spec.Nsites, spec.Ltau), generator=g, dtype=torch.float64)
    out = {}

    def gens():
        return torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)

    ucfg = SpecialUpdateConfig(n_moves=3, tol=1e-5, maxiter=500)
    for name, make in (("reflection", make_reflection_update), ("swap", make_swap_update)):
        g1, g2 = gens()
        x1, r1 = make(ops, ucfg, pre)(params, x, g1)
        x2, r2 = make(lops, ucfg, lpre)(lp, shard.local(x), g2)
        out[name] = (float((shard.local(x1) - x2).abs().max()), _np(r1).tolist(), _np(r2).tolist())
    Q = build_Q(_np(params.omega), spec.dtau, spec.Ltau,
                [dict(omega_min=0.0, omega_max=10.0, mass=0.5)])
    scfg = SolverConfig(tol=1e-8, maxiter=500)
    for method in ("euler", "rk", "heun"):
        g1, g2 = gens()
        x1, s1 = make_langevin_step(ops, Q, 1e-3, method, scfg, pre)(params, x, g1)
        x2, s2 = make_langevin_step(lops, Q, 1e-3, method, scfg, lpre)(lp, shard.local(x), g2)
        out[method] = (float((shard.local(x1) - x2).abs().max()),
                       _np(s1.iters).tolist(), _np(s2.iters).tolist())
    g1, g2 = gens()
    gd1 = sample_greens(ops, params, x, 4, scfg, pre, g1)
    gd2 = sample_greens(lops, lp, shard.local(x), 4, scfg, lpre, g2)
    MinvR = shard.gather(gd2.MinvR)
    out["greens"] = (float((gd1.MinvR - MinvR).abs().max()),
                     float((gd1.R - shard.gather(gd2.R)).abs().max()),
                     _np(gd1.iters).tolist(), _np(gd2.iters).tolist())
    return out


def simulate_worker(device, config: str, run_id: int, n_chains: int, n_devices: int = 1,
                    site_devices: int = 1):
    """One rank of a driver run on the CPU in float64: its statistics and
    the processed bins it wrote, as float64 arrays (rank 0 writes them; the
    text files round to 8 digits)."""
    from elphdynamics_tpu_torch import simulation

    bins = []
    write_bin = simulation.out_io.write_bin

    def recording_write_bin(datafolder, processed, bin_index, ops):
        bins.append(processed)
        return write_bin(datafolder, processed, bin_index, ops)

    simulation.out_io.write_bin = recording_write_bin
    try:
        stats = simulation.simulate(config, run_id=run_id, n_chains=n_chains, device=device,
                                    dtype=torch.float64, n_devices=n_devices,
                                    site_devices=site_devices)
    finally:
        simulation.out_io.write_bin = write_bin
    return stats, bins


def collectives_worker(device):
    """Every collective of ``parallel.multihost`` and ``parallel.comm`` on
    rank-stamped tensors."""
    from elphdynamics_tpu_torch.parallel.comm import allreduce_sum, halo_exchange

    r, D = multihost.rank(), multihost.world()
    x = torch.full((2, 3), float(r))
    from_prev, from_next = halo_exchange(torch.full((1, 2), 10.0 * r), torch.full((3,), -1.0 * r),
                                         (r + 1) % D, (r - 1) % D)
    none = halo_exchange(None, None, (r + 1) % D, (r - 1) % D)
    return dict(fetch=multihost.fetch(x), tree=multihost.fetch_tree({"a": {"b": x[0]}}),
                int=multihost.bcast_int(7 + r), str=multihost.bcast_str(f"rank {r}"),
                sum=_np(allreduce_sum(torch.tensor([1.0, r]))),
                # a complex128 stack, as block CG's Grams on complex fields
                csum=_np(allreduce_sum(torch.tensor(
                    [[1 + 2j, 1j * r], [0.1 * (r + 1), 0.3j / (r + 1)]], dtype=torch.complex128))),
                from_prev=_np(from_prev),
                from_next=_np(from_next), none=none, primary=multihost.is_primary())


# --- SSH under site sharding (tests/test_torch_parallel_ssh.py) --------------

SSH_HOP = dict(t=1.0, t_std=0.1, alpha=0.3, alpha_std=0.05, alpha2=0.1, alpha2_std=0.02,
               omega=1.0, omega_std=0.1, omega4=0.05, o1=0, o2=0)
SSH_HOPPINGS = [dict(SSH_HOP, dL=(1, 0, 0), name="x"), dict(SSH_HOP, dL=(0, 1, 0), name="y")]
SSH_MU = [(-0.2, 0.1, None)]


def build_ssh_model(L: int, beta: float, dtau: float, twist=None, seed: int = 3,
                    device="cpu"):
    """The port's SSH model shared with the tests (x and y bonds with
    disorder on every parameter) in float64, on the CPU unless ``device``
    says otherwise."""
    from elphdynamics_tpu_torch.models.ssh import build_ssh

    return build_ssh(Lattice.create(UnitCell.create(*UC), L), beta, dtau,
                     hoppings=SSH_HOPPINGS, mu_assignments=SSH_MU, twist=twist,
                     rng=np.random.default_rng(seed), device=device)


def _fixed_precond(ops, cfg, start):
    """The CG preconditioner started from the given (whole-lattice) power
    iteration vectors, cut to the rank's block on a shard."""
    if ops.shard is not None:
        start = tuple(ops.shard.local(v) for v in start)
    return kpm.Preconditioner(
        setup=lambda params, x, start_=None: kpm.setup(ops, params, x, cfg, start),
        refresh=lambda st, params, x: kpm.refresh(ops, st, params, x),
        symmetric=lambda st, v: kpm.apply_symmetric(ops, st, v, cfg))


def ssh_worker(device, L: int, beta: float, runs: dict, form: str = "segmented"):
    """SSH's samplers on this rank's block of sites, in ``form``
    (``segmented``: the graphed calls' segments, the probe solves of
    ``measurements.make_probe_solve``; ``eager``: the eager calls and
    ``greens.sample_greens``), and (rank 0) on one rank, from the given
    whole-model inputs and draws: per run the sharded result (x whole on
    every rank; probe solutions as the block), the one-rank result, and the
    shard's counters. ``runs`` maps a name to (kind, twist, inputs): kind
    ``hmc``, ``langevin_rk``, ``swap`` or ``greens``."""
    from elphdynamics_tpu_torch.dynamics.langevin import LangevinDraws, make_langevin_step
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.dynamics.special_updates import (
        SpecialDraws, SpecialUpdateConfig, make_swap_update)
    from elphdynamics_tpu_torch.measure.greens import sample_greens
    from elphdynamics_tpu_torch.measure.measurements import make_probe_solve

    T = torch.as_tensor
    out = {}
    for name, (kind, twist, inp) in runs.items():
        spec, params = build_ssh_model(L, beta, 0.1, twist)
        shard = SiteShard(spec.ckb, np.zeros((2, 0), np.int64), multihost.world(),
                          multihost.rank())
        lspec, lp = shard_ssh(spec, params, shard)
        ops, lops = make_model_ops(spec), make_model_ops(lspec)
        kcfg = kpm.KPMConfig(**inp["kpm"])
        start = tuple(T(v) for v in inp["kpm_start"])
        res = {}
        for tag, o, p in (("sharded", lops, lp), ("one", ops, params)):
            if tag == "one" and multihost.rank() != 0:
                continue
            pre = _fixed_precond(o, kcfg, start)
            cut = (lambda t: o.shard.local(T(t))) if o.shard is not None else T
            eager = tag == "sharded" and form == "eager"
            if kind == "hmc":
                step = make_hmc_step(o, inp["mass"], HMCConfig(**inp["cfg"]), pre, eager=eager)
                st, stats = step(p, HMCState(x=T(inp["x0"]), v=T(inp["v0"])), draws=HMCDraws(
                    momentum=T(inp["momentum"]), pseudofermion=cut(inp["pseudofermion"]),
                    uniform=T(inp["uniform"])))
                res[tag] = dict(x=_np(st.x), v=_np(st.v), accepted=_np(stats.accepted),
                                iters=_np(stats.iters), flag=_np(stats.flag),
                                delta_H=_np(stats.delta_H))
            elif kind == "langevin_rk":
                step = make_langevin_step(o, inp["Q"], inp["dt"], "rk",
                                          SolverConfig(**inp["scfg"]), pre, eager=eager)
                x1, stats = step(p, T(inp["x0"]), draws=LangevinDraws(
                    eta=T(inp["eta"]), g=tuple(cut(g) for g in inp["g"])))
                res[tag] = dict(x=_np(x1), iters=_np(stats.iters), flag=_np(stats.flag))
            elif kind == "swap":
                upd = make_swap_update(o, SpecialUpdateConfig(**inp["cfg"]), pre, eager=eager)
                x1, rate = upd(p, T(inp["x0"]), draws=SpecialDraws(
                    picks=T(inp["picks"]), pseudofermion=cut(inp["pseudofermion"]),
                    uniform=T(inp["uniform"])))
                res[tag] = dict(x=_np(x1), rate=_np(rate))
            else:
                nv, scfg = inp["R"].shape[1], SolverConfig(**inp["scfg"])
                sample = (make_probe_solve(o, nv, scfg, pre) if tag == "sharded" and not eager
                          else lambda p_, x_, R: sample_greens(o, p_, x_, nv, scfg, pre, R=R))
                gd = sample(p, T(inp["x0"]), R=cut(inp["R"]))
                res[tag] = dict(MinvR=_np(gd.MinvR), iters=_np(gd.iters), flag=_np(gd.flag))
        res["counts"] = (shard.halo_msgs, shard.folds, shard.allreduces, shard.allreduce_bytes)
        out[name] = res
    return out


# --- block CG, deflation and tempering across ranks ---------------------------

def block_worker(device, L: int, x, B, R, tol: float, start):
    """Block CG on a site-sharded Holstein model (the ``plain`` case), with
    the symmetric KPM preconditioner (power-iteration ``start``): on
    MᵀM·X = B (``B`` ``[C, s, N, Lτ]``), and the nᵥ probe solves of a
    Green's-function sample with ``[solver] block`` (probes ``R``). The
    rank's blocks of the solutions, the iterations and flags, and (rank 0)
    the one-rank port's."""
    from elphdynamics_tpu_torch import solvers
    from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
    from elphdynamics_tpu_torch.measure.greens import sample_greens

    spec, params = build(L, 1.0, 0.1, "plain")
    ops = make_model_ops(spec)
    shard, lops, lp = _shard(spec, params)
    T = torch.as_tensor
    scfg = SolverConfig(tol=tol, maxiter=500, block=True)
    kcfg = kpm.KPMConfig(max_order=4)
    out = {}
    for tag, o, p, cut, red in (("sharded", lops, lp, shard.local, shard.sum),
                                ("one", ops, params, lambda t: t, None)):
        if tag == "one" and multihost.rank() != 0:
            continue
        xx = cut(T(x))
        d = o.derived(p, xx)[:, None]
        pre = _fixed_precond(o, kcfg, tuple(T(v) for v in start))
        res = solvers.block_cg(lambda v: o.mulMTM(p, d, v), cut(T(B)), tol=tol, maxiter=500,
                               apply_P=resolve_precond(pre, p, xx).symmetric, reduce=red)
        gd = sample_greens(o, p, xx, R.shape[1], scfg, pre, R=cut(T(R)))
        out[tag] = dict(X=_np(res.x), iters=_np(res.iters), MinvR=_np(gd.MinvR),
                        giters=_np(gd.iters), gflag=_np(gd.flag))
    out["allreduces"] = shard.allreduces
    return out


def aids_worker(device, block_args: tuple, hmc_runs: dict):
    """:func:`hmc_worker` with each of ``hmc_runs`` (name -> arguments after
    the device) and :func:`block_worker` with ``block_args`` (under
    ``"block_cg"``), in one launch."""
    out = {name: hmc_worker(device, *args) for name, args in hmc_runs.items()}
    out["block_cg"] = block_worker(device, *block_args)
    return out


def exchange_worker(device, n_devices: int, site_devices: int, model: str, ladder, x,
                    generator_seed: int):
    """Two tempering exchanges (both pair parities) on this rank's block of
    chains and sites, the draws from a generator every rank seeds alike:
    per exchange the rank's block of x and v, the acceptance and flag. The
    model is the ``plain`` Holstein case or the shared SSH one; ``x``
    whole ``[C, Nph, Lτ]``."""
    from elphdynamics_tpu_torch.dynamics.tempering import (
        TemperingConfig, chain_params, ladder_params, make_exchange_step)
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock
    from elphdynamics_tpu_torch.parallel.lattice_shard import shard_model, shard_params

    C = x.shape[0]
    spec, params = (build(4, 1.0, 0.1, "plain") if model == "holstein"
                    else build_ssh_model(4, 1.0, 0.1))
    tcfg = TemperingConfig(ladder=tuple(ladder), freq=1, tol=1e-9, maxiter=500)
    params = ladder_params(params, tcfg, C)
    site_group, chain_group = multihost.layout_groups(n_devices, site_devices)
    block, d = divmod(multihost.rank(), site_devices)
    ops, x = make_model_ops(spec), torch.as_tensor(x)
    cb = ChainBlock.of(C, n_devices, block, chain_group) if n_devices > 1 else None
    if site_devices > 1:
        shard = SiteShard(spec.ckb, getattr(spec, "wij_table", None),
                          site_devices, d, site_group, base=block * site_devices)
        ops = make_model_ops(shard_model(spec, params, shard)[0])
        params = shard_params(params, shard)
        if ops.is_holstein:
            x = shard.local(x)
    if cb is not None:
        params = chain_params(params, cb.lo, cb.n)
        x = cb.local(x)
    exchange = make_exchange_step(ops, tcfg, C, kpm.make_precond(ops, kpm.KPMConfig(max_order=4)),
                                  chains=cb)
    g = torch.Generator().manual_seed(generator_seed)
    v, out = torch.zeros_like(x), []
    for parity in (0, 1):
        x, v, rate, iters, flag = exchange(params, x, v, parity, g)
        out.append(dict(x=_np(x), rate=float(rate), flag=int(flag), iters=float(iters)))
    return out


# --- block CG on complex fields across ranks (slice F4) -----------------------

def twisted_block_worker(device, model: str, n_chain: int, n_site: int):
    """On a twisted 4×4 model (``holstein`` or ``ssh``, float64, 4 chains)
    on this rank's part of an ``n_chain`` × ``n_site`` layout: one HMC
    update whose trajectory solves run Hermitian block CG (s = 1: the two
    spins are one complex entry) and the nᵥ = 4 probe solves of a
    Green's-function sample by block CG (tol 1e-10), from generators and
    probes every rank makes alike; rank 0 also runs both on one rank. Per
    run the rank's blocks (Holstein's x and the probe solutions cut to its
    sites, SSH's bond field whole), the statistics, and the number of
    ``block_cg`` calls."""
    from dataclasses import replace

    from elphdynamics_tpu_torch import bench, solvers
    from elphdynamics_tpu_torch.measure.greens import sample_greens
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock
    from elphdynamics_tpu_torch.utils.dtypes import trace_noise

    make = bench.build_ssh_step if model == "ssh" else bench.build_bench_step
    b = make(4, 1.0, 0.1, 0.05, 4, "cpu", torch.float64, trajectory_time=0.2, twist=(0.3, 0.1))
    b = replace(b, hmc_cfg=replace(b.hmc_cfg, block=True))
    site_group, chain_group = multihost.layout_groups(n_chain, n_site)
    blk, d = divmod(multihost.rank(), n_site)
    spec = b.ops.spec
    shard = (SiteShard(spec.ckb, getattr(spec, "wij_table", None), n_site, d, site_group,
                       base=blk * n_site) if n_site > 1 else None)
    cb = ChainBlock.of(4, n_chain, blk, chain_group) if n_chain > 1 else None
    R = trace_noise((4, 4, spec.Nsites, spec.Ltau), torch.complex128, "cpu",
                    torch.Generator().manual_seed(5))
    parts = {"sharded": (bench.shard_bench_step(b, shard, cb), shard, cb)}
    if multihost.rank() == 0:
        parts["one"] = (bench.shard_bench_step(b), None, None)
    block_cg, calls = solvers.block_cg, []

    def counted(*a, **kw):
        calls.append(1)
        return block_cg(*a, **kw)

    solvers.block_cg = counted
    out = {}
    try:
        for tag, (lb, sh, ch) in parts.items():
            calls.clear()
            st, stats = lb.step(lb.params, lb.state, torch.Generator().manual_seed(3))
            r = R if sh is None else sh.local(R)
            r = r if ch is None else ch.local(r)
            gd = sample_greens(lb.ops, lb.params, st.x, 4,
                               SolverConfig(tol=1e-10, maxiter=500, block=True),
                               kpm.make_precond(lb.ops, b.kpm_cfg), R=r)
            out[tag] = dict(x=_np(st.x), accepted=_np(stats.accepted), iters=_np(stats.iters),
                            flag=_np(stats.flag), MinvR=_np(gd.MinvR), giters=_np(gd.iters),
                            gflag=_np(gd.flag), block_calls=len(calls))
    finally:
        solvers.block_cg = block_cg
    return out


def layout_whole(ranks: list, run: str, field: str, n_chain: int, n_site: int,
                 site_axis: bool) -> np.ndarray:
    """The whole array from the ranks' blocks of a 2-D layout (rank r holds
    chain block r // n_site and site block r % n_site): site blocks
    concatenated along axis −2 within a chain block (when ``site_axis``),
    chain blocks along axis 0."""
    rows = []
    for b in range(n_chain):
        parts = [ranks[b * n_site + s][run][field] for s in range(n_site)]
        rows.append(np.concatenate(parts, axis=-2) if site_axis else parts[0])
    return np.concatenate(rows, axis=0)


# --- the graphed chain-batched calls (dynamics/graphs.py) on chain ranks ----

def _same(a, b) -> bool:
    """Two results (tensors, or tuples / dicts / dataclasses of them) equal
    bit for bit."""
    import dataclasses

    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(p, q) for p, q in zip(a, b))
    return a == b


def graph_chains_worker(device, n_chains: int = 4):
    """On this rank's block of ``n_chains`` chains (every chain on one
    rank), from generators every rank seeds alike, each call in its
    segmented form and in its eager form (asked for by name) on the same
    draws: two leapfrog updates, two 2MN updates, two updates and an
    exchange of each parity under a 2-rung ladder (4×4 Holstein, Lτ = 10),
    an RK Langevin step, the reflection and swap moves, the measurement
    with injected probes and the measurement of the gathered rung-0 chains.
    Per call: whether the two forms agree bit for bit (host reads
    included), the segmented form's results on the rank's block, its host
    reads and the eager steps between its replays."""
    from elphdynamics_tpu_torch import bench, solvers
    from elphdynamics_tpu_torch.dynamics import graphs
    from elphdynamics_tpu_torch.dynamics.special_updates import (
        SpecialUpdateConfig, make_reflection_update, make_swap_update)
    from elphdynamics_tpu_torch.dynamics.tempering import rung_params
    from elphdynamics_tpu_torch.measure import measurements as M
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock
    from elphdynamics_tpu_torch.utils.dtypes import trace_noise

    world = multihost.world()
    cb = ChainBlock.of(n_chains, world, multihost.rank()) if world > 1 else None

    def local(t):
        return t if cb is None else cb.local(t)

    def gather(t):
        return t if cb is None else cb.gather(t)

    def on_block(f, draws_dim: int = 0):
        """``f(params, state, *args, generator)`` on this rank's chains, the
        whole batch's draws cut to them."""
        if cb is None:
            return lambda p, s, *a, g: f(p, s, *a, g)
        run = cb.wrap(f, draws_dim)
        return lambda p, s, *a, g: run(p, s, *a, generator=g)

    out = {}

    def both(name, seg, eager, *args):
        """``seg(*args, g=gen)`` and ``eager(*args, g=gen)`` from equal
        generators, their host reads and eager steps counted; the
        segmented form's result."""
        res = []
        for f in (seg, eager):
            solvers.host_reads = graphs.collectives = 0
            r = f(*args, g=torch.Generator().manual_seed(31))
            res.append((r, solvers.host_reads, graphs.collectives))
        out[name] = dict(same=_same(res[0][0], res[1][0]) and res[0][1] == res[1][1],
                         reads=res[0][1], collectives=res[0][2])
        return res[0][0]

    for label, integrator, ladder in (("leapfrog", "leapfrog", None), ("2mn", "2mn", None),
                                      ("tempering", "leapfrog", (1.0, 0.9))):
        b = bench.build_bench_step(4, 1.0, 0.1, 0.05, n_chains, "cpu", torch.float64,
                                   trajectory_time=0.15, integrator=integrator, ladder=ladder)
        lb = bench.shard_bench_step(b, chains=cb) if cb is not None else b
        eager = lb.eager()
        assert lb.step.segmented and not eager.segmented
        step = (lambda p, s, g: lb.step(p, s, g)) if cb is None else (
            lambda p, s, g: lb.step(p, s, generator=g))
        state = lb.state
        for u in range(2):
            state, stats = both(f"{label}_update{u}", step, on_block(eager), lb.params, state)
            out[f"{label}_update{u}"].update(x=_np(state.x), v=_np(state.v),
                                             accepted=_np(stats.accepted),
                                             iters=_np(stats.iters), dH=_np(stats.delta_H))
        if ladder is not None:
            ex, ex_eager = lb.exchange, lb.eager_exchange()
            assert ex.segmented and not ex_eager.segmented
            x, v = state.x, state.v
            for parity in (0, 1):
                x, v, rate, iters, flag = both(
                    f"exchange_p{parity}", lambda p, x_, v_, g: ex(p, x_, v_, parity, g),
                    lambda p, x_, v_, g: ex_eager(p, x_, v_, parity, g), lb.params, x, v)
                out[f"exchange_p{parity}"].update(x=_np(x), v=_np(v), rate=float(rate),
                                                  iters=float(iters), flag=int(flag))
            rung0 = (rung_params(b.params), gather(x)[:n_chains // len(ladder)])

    lang = bench.build_langevin_step(4, 1.0, 0.1, 1e-3, n_chains, "cpu", torch.float64,
                                     method="rk")
    x, stats = both("langevin", on_block(lang.step), on_block(lang.eager()), lang.params,
                    local(lang.x))
    out["langevin"].update(x=_np(x), iters=_np(stats.iters))

    b = bench.build_bench_step(4, 1.0, 0.1, 0.05, n_chains, "cpu", torch.float64,
                               trajectory_time=0.15)
    pre = bench.kpm.make_precond(b.ops, b.kpm_cfg)
    x = local(b.state.x) + 0.1
    ucfg = SpecialUpdateConfig(n_moves=3, tol=1e-5, maxiter=500)
    for name, make in (("reflect", make_reflection_update), ("swap", make_swap_update)):
        xm, rate = both(name, on_block(make(b.ops, ucfg, pre), 1),
                        on_block(make(b.ops, ucfg, pre, eager=True), 1), b.params, x)
        out[name].update(x=_np(xm), rate=_np(rate))
    mspec = M.MeasurementSpec(nv=2, onsite_corr=(("Greens", True), ("DenDen", False)),
                              snapshots=("density",))
    scfg = bench.SolverConfig(tol=1e-6, maxiter=500)
    mstep = M.make_measurement_step(b.ops, mspec, scfg, pre)
    mtwin = M.make_measurement_step(b.ops, mspec, scfg, pre, eager=True)
    R = trace_noise((n_chains, mspec.nv, b.ops.Nsites, b.ops.Ltau), x.dtype, x.device,
                    torch.Generator().manual_seed(5))
    inc, mstats, _ = both("measure_probes", lambda p, x_, g: mstep(p, x_, R=local(R)),
                          lambda p, x_, g: mtwin(p, x_, R=local(R)), b.params, x)
    out["measure_probes"].update(greens=_np(gather(inc["onsite_corr"]["Greens"])),
                                 flag=_np(gather(mstats["flag"])))
    # under tempering every rank measures the gathered rung-0 chains
    inc, mstats, _ = both("measure_rung0", lambda p, x_, g: mstep(p, x_, g),
                          lambda p, x_, g: mtwin(p, x_, g), *rung0)
    out["measure_rung0"].update(greens=_np(inc["onsite_corr"]["Greens"]),
                                flag=_np(mstats["flag"]))
    return out


def graph_aids_worker(device, n_chains: int = 4):
    """On this rank's block of ``n_chains`` chains (every chain on one
    rank), from generators every rank seeds alike, two updates with block
    CG and two with a deflation basis (4×4 Holstein, Lτ = 10, float64), each
    in its segmented form and in its eager form (asked for by name) on the
    same draws (:func:`_segmented_against_eager`)."""
    return _segmented_against_eager(
        (("block", dict(block=True)), ("deflation", dict(deflate_k=4))), n_chains)


def graph_nonsym_worker(device, n_chains: int = 4):
    """:func:`graph_aids_worker` for two GMRES updates (restart 20, the
    bench configurations' settings)."""
    return _segmented_against_eager((("gmres", dict(solver="gmres")),), n_chains)


def _segmented_against_eager(cases, n_chains: int):
    """For each ``(label, options)`` of ``cases`` (:func:`bench.build_bench_step`
    options), two updates on this rank's block of chains in the segmented
    and in the eager form on the same draws. Per update: whether the two
    forms agree bit for bit (host reads included), whether the step is
    segmented, its host reads and the segmented form's results on the
    rank's block (x, v, ΔH, iterations, decisions, the refreshed basis)."""
    from elphdynamics_tpu_torch import bench, solvers
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock

    world = multihost.world()
    cb = ChainBlock.of(n_chains, world, multihost.rank()) if world > 1 else None
    out = {}
    for label, aid in cases:
        b = bench.build_bench_step(4, 1.0, 0.1, 0.05, n_chains, "cpu", torch.float64,
                                   trajectory_time=0.1, **aid)
        lb = bench.shard_bench_step(b, chains=cb) if cb is not None else b
        eager = lb.eager()
        run_eager = eager if cb is None else cb.wrap(eager)
        state_seg = state_eager = lb.state
        for u in range(2):
            res = []
            for f, state in ((lb.step, state_seg), (run_eager, state_eager)):
                solvers.host_reads = 0
                g = torch.Generator().manual_seed(41 + u)
                r = f(lb.params, state, g) if cb is None else f(lb.params, state, generator=g)
                res.append((r, solvers.host_reads))
            (state_seg, stats), reads = res[0]
            state_eager = res[1][0][0]
            row = dict(same=_same(res[0][0], res[1][0]) and reads == res[1][1],
                       segmented=bool(lb.step.segmented and not eager.segmented), reads=reads,
                       x=_np(state_seg.x), v=_np(state_seg.v), dH=_np(stats.delta_H),
                       iters=_np(stats.iters), accepted=_np(stats.accepted))
            if state_seg.defl is not None:
                row["W"] = _np(state_seg.defl.W)
            out[f"{label}_update{u}"] = row
    return out


def wij_force_worker(device, seed: int):
    """The ωᵢⱼ force (``calc_dSbdx`` of the dispersive ``wij`` model, 4×4,
    float64) on this rank's block of sites: the fixed-order sum, and the
    two ``index_add`` calls it replaced (:meth:`SiteShard.wij_dsb` before
    the change) on the same inputs."""
    from elphdynamics_tpu_torch.models.holstein import calc_dSbdx

    spec, params = build(4, 1.0, 0.1, "wij")
    shard, lops, lp = _shard(spec, params)
    x = torch.randn((3, spec.Nsites, spec.Ltau), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed))
    xl = shard.local(x)
    new = calc_dSbdx(lops.spec, lp, xl)
    # the old form: the force without ωᵢⱼ, then one index_add per side
    om2, om4 = (lp.omega ** 2)[:, None], lp.omega4[:, None]
    lap = torch.roll(xl, 1, dims=-1) + torch.roll(xl, -1, dims=-1) - 2.0 * xl
    old = spec.dtau * (om2 * xl + 4.0 * om4 * xl ** 3) - lap / spec.dtau
    for side, (rows, m, kk, sgn, pair) in enumerate(
            shard._wij_sides(lp.wij, spec.wij_sign, xl)):
        g = spec.dtau * (lp.wij ** 2)[kk][:, None] * pair
        if side == 1:
            g = sgn * g
        old = old.index_add(-2, rows, torch.where(m, g, torch.zeros_like(g)))
    return _np(new), _np(old)


# --- the graphed site-sharded calls (dynamics/graphs.py) on site ranks --------

# the calls of each model case of :func:`graph_sites_worker`
SITE_CALLS = {
    "holstein": ("update", "update_dt", "update_block", "update_deflated", "langevin_euler",
                 "langevin_rk", "reflect", "swap", "probes", "probes_block"),
    "wij": ("update", "langevin_rk", "swap"),
    "ssh": ("update", "langevin_euler", "langevin_rk", "swap", "probes"),
    "twist": ("update", "langevin_rk", "probes_block"),
    "ssh_twist": ("update",),
    "ladder": ("update", "exchange"),
}
SITE_TWIST = (0.3, 0.0)


def graph_sites_worker(device, n_chain: int, cases, n_chains: int = 2):
    """On this rank of the ``n_chain`` × (world / ``n_chain``) layout (rank
    r is chain block r // n_site and site block r % n_site), the calls of
    each case of :data:`SITE_CALLS` (4×4, Lτ = 10, float64, ``n_chains``
    chains in all): Holstein ``plain`` (``holstein``), with ωᵢⱼ dispersion
    (``wij``), SSH, both under complex hopping (``twist``, ``ssh_twist``)
    and a 2-rung Holstein ladder (``ladder``: its update and the exchange
    of both parities). Each call runs in its segmented form and in its
    eager form (asked for by name) on the same draws (the whole batch's,
    cut to the rank's chains and sites): the leapfrog update (Holstein's
    twice, the second from the first's state), the dt tuner's update, the
    block-CG and deflated updates, the Langevin step, the moves and the
    measurement's probe solves (CG, block CG); the updates other than the
    leapfrog one take one trajectory step. On a card a first call's
    counters also hold its warm-up and are not compared. Per call: whether the two forms agree bit
    for bit (results, host reads and the shard's counters), the segmented
    form's host reads, graph replays, counters and results (x the rank's
    block; SSH's bond field whole), and on a card the eager retries' host
    reads and the eager steps between replays (replays = host reads −
    retry reads + 1 + those steps)."""
    from elphdynamics_tpu_torch import bench, solvers
    from elphdynamics_tpu_torch.dynamics import graphs
    from elphdynamics_tpu_torch.dynamics import hmc as H
    from elphdynamics_tpu_torch.dynamics.langevin import make_langevin_step
    from elphdynamics_tpu_torch.dynamics.special_updates import (
        SpecialUpdateConfig, make_reflection_update, make_swap_update)
    from elphdynamics_tpu_torch.measure.measurements import make_probe_solve
    from elphdynamics_tpu_torch.ops import deflation
    from elphdynamics_tpu_torch.ops.fourier_accel import build_mass, build_Q
    from elphdynamics_tpu_torch.parallel.chains import ChainBlock
    from elphdynamics_tpu_torch.parallel.lattice_shard import COUNTERS, shard_model
    from elphdynamics_tpu_torch.utils.dtypes import field_dtype, trace_noise

    device = torch.device(device)
    n_site = multihost.world() // n_chain
    site_group, chain_group = multihost.layout_groups(n_chain, n_site)
    block, d = divmod(multihost.rank(), n_site)
    cb = ChainBlock.of(n_chains, n_chain, block, chain_group) if n_chain > 1 else None
    out = {}

    def shard_of(spec):
        return SiteShard(spec.ckb, getattr(spec, "wij_table", None), n_site, d, site_group,
                         base=block * n_site)

    def chains(t, dim: int = 0):
        return t if cb is None else cb.local(t, dim)

    def graph_counts(f):
        """(replays, the host reads of eager retries) of ``f``'s graphs."""
        ws = f.workspace() if hasattr(f, "workspace") else None
        if ws is None or ws.graphs is None:
            return 0, 0
        return ws.graphs.replays, ws.retry_reads

    def both(name, shard, seg, eager, calls):
        """``calls(f)`` of the segmented form ``seg`` and of ``eager``."""
        # a first call on a card also counts its warm-up (every segment once,
        # eagerly): its counters are compared from the second call on
        ws = seg.workspace()
        warm_up = ws is None and device.type == "cuda"
        res = []
        for f in (seg, eager):
            solvers.host_reads = graphs.collectives = 0
            shard.reset_counts()
            before = graph_counts(f)
            r = calls(f)
            after = graph_counts(f)
            res.append((r, solvers.host_reads, {k: getattr(shard, k) for k in COUNTERS},
                        after[0] - before[0], after[1] - before[1], graphs.collectives))
        out[name] = dict(same=(_same(res[0][0], res[1][0]) and res[0][1] == res[1][1]
                               and (warm_up or res[0][2] == res[1][2])),
                         reads=res[0][1], counts=res[0][2], replays=res[0][3],
                         retry_reads=res[0][4], collectives=res[0][5],
                         segmented=bool(seg.segmented and not eager.segmented
                                        and graphs.graphable(shard, device)))
        return res[0][0]

    def rows(x, shard, holstein):
        """x as the rank holds it (Holstein's sites cut, SSH's bonds whole)."""
        return shard.local(x) if holstein else x

    for case in cases:
        calls = SITE_CALLS[case]
        gen = torch.Generator(device=device)
        if case == "ladder":
            b = bench.build_bench_step(4, 1.0, 0.1, 0.05, n_chains, device, torch.float64,
                                       trajectory_time=0.1, ladder=(1.0, 0.9))
            shard = shard_of(b.ops.spec)
            lb = bench.shard_bench_step(b, shard, cb)
            step = H.make_hmc_step(lb.ops, lb.mass, lb.hmc_cfg, lb.precond())
            eager = lb.eager()
            draws = chains(eager.draw(lb.params, lb.state.x, n_chains, gen.manual_seed(7)))
            st, stats = both(f"{case}_update", shard, step, eager,
                             lambda f: f(lb.params, lb.state, draws=draws))
            out[f"{case}_update"].update(x=_np(st.x), accepted=_np(stats.accepted))
            ex, ex_eager = lb.exchange, lb.eager_exchange()
            x, v = st.x, st.v
            for parity in (0, 1):
                dr = ex.draw(lb.params, x, gen.manual_seed(11 + parity))
                x, v, rate, iters, flag = both(
                    f"{case}_exchange{parity}", shard, ex, ex_eager,
                    lambda f: f(lb.params, x, v, parity, draws=dr))
                out[f"{case}_exchange{parity}"].update(x=_np(x), rate=float(rate),
                                                       flag=int(flag))
            continue
        holstein = not case.startswith("ssh")
        twist = SITE_TWIST if "twist" in case else None
        if holstein:
            spec, params = build(4, 1.0, 0.1, {"holstein": "plain"}.get(case, case),
                                 device=device)
        else:
            spec, params = build_ssh_model(4, 1.0, 0.1, twist, device=device)
        shard = shard_of(spec)
        lspec, lp = shard_model(spec, params, shard)
        ops = make_model_ops(lspec)
        N, Nph, Lt = spec.Nsites, params.omega.shape[-1], spec.Ltau
        rng = np.random.default_rng(13)
        x0 = torch.as_tensor(0.5 * rng.standard_normal((n_chains, Nph, 1))
                             + 0.1 * rng.standard_normal((n_chains, Nph, Lt)), device=device)
        x = chains(rows(x0, shard, holstein))
        omega = params.omega.double().cpu().numpy()
        blocks = [dict(omega_min=0.0, omega_max=10.0, mass=0.5)]
        pre = kpm.make_precond(ops, kpm.KPMConfig(max_order=4))
        fdt = field_dtype(lp, x.dtype)
        for call in calls:
            name = f"{case}_{call}"
            if call.startswith("update"):
                cfg = HMCConfig(dt=0.05, trajectory_time=0.1 if call == "update" else 0.05,
                                Nb=2 if case == "wij" else 1,
                                tol=1e-6, maxiter=500, construct_guess=True, guess_order=2,
                                block=call == "update_block",
                                deflate_k=4 if call == "update_deflated" else 0)
                dyn = call == "update_dt"
                mass = build_mass(omega, spec.dtau, Lt, blocks)
                step = H.make_hmc_step(ops, mass, cfg, pre, dynamic_dt=dyn)
                eager = H.make_hmc_step(ops, mass, cfg, pre, dynamic_dt=dyn, eager=True)
                defl = None
                if cfg.deflate_k:
                    whole = H.init_deflation(make_model_ops(spec), cfg, n_chains,
                                             torch.Generator(device=device).manual_seed(3),
                                             params=params, device=device)
                    defl = chains(deflation.cut(whole, shard.local))
                state = HMCState(x=x, v=torch.zeros_like(x), defl=defl)
                args = (torch.tensor(0.04, dtype=torch.float64, device=device),) if dyn else ()
                for u in range(2 if name == "holstein_update" else 1):
                    dr = chains(eager.draw(lp, x, n_chains, gen.manual_seed(21 + u)))
                    state, stats = both(f"{name}{u}", shard, step, eager,
                                        lambda f: f(lp, state, *args, draws=dr))
                    out[f"{name}{u}"].update(x=_np(state.x), v=_np(state.v),
                                             accepted=_np(stats.accepted),
                                             iters=_np(stats.iters), dH=_np(stats.delta_H))
            elif call.startswith("langevin"):
                Q = build_Q(omega, spec.dtau, Lt, blocks)
                scfg = SolverConfig(tol=1e-6, maxiter=500)
                method = call.split("_")[1]
                step = make_langevin_step(ops, Q, 1e-3, method, scfg, pre)
                eager = make_langevin_step(ops, Q, 1e-3, method, scfg, pre, eager=True)
                dr = chains(eager.draw(lp, x, n_chains, gen.manual_seed(31)))
                x1, stats = both(name, shard, step, eager, lambda f: f(lp, x, draws=dr))
                out[name].update(x=_np(x1), iters=_np(stats.iters))
            elif call in ("reflect", "swap"):
                make = make_reflection_update if call == "reflect" else make_swap_update
                ucfg = SpecialUpdateConfig(n_moves=2, tol=1e-4, maxiter=500)
                upd, eager = make(ops, ucfg, pre), make(ops, ucfg, pre, eager=True)
                dr = chains(eager.draw(lp, x, n_chains, gen.manual_seed(41)), 1)
                xm, rate = both(name, shard, upd, eager, lambda f: f(lp, x + 0.1, draws=dr))
                out[name].update(x=_np(xm), rate=_np(rate))
            else:
                scfg = SolverConfig(tol=1e-8, maxiter=500, block=call == "probes_block")
                solve = make_probe_solve(ops, 2, scfg, pre)
                eager = make_probe_solve(ops, 2, scfg, pre, eager=True)
                R = chains(shard.local(trace_noise((n_chains, 2, N, Lt), fdt, device,
                                                   gen.manual_seed(51))))
                gd = both(name, shard, solve, eager, lambda f: f(lp, x, R=R))
                out[name].update(MinvR=_np(gd.MinvR), iters=_np(gd.iters), flag=_np(gd.flag))
    return out


def halo_worker(device):
    """The halo rows of every boundary-crossing group of the 4×4 Holstein
    model's checkerboard on this rank's block of sites, real and complex,
    from ``comm.halo_exchange``: whether each equals the rows the
    neighbour sent (rebuilt here from the neighbour's plan and seed), bit
    for bit, and the number of exchanges compared."""
    from elphdynamics_tpu_torch.parallel import comm

    spec, _ = build(4, 1.0, 0.1, "plain")
    D, rank = multihost.world(), multihost.rank()
    shards = [SiteShard(spec.ckb, None, D, d) for d in range(D)]
    shard, p = shards[rank], shards[rank].plan

    def fields(d):
        """Rank ``d``'s real and complex blocks and its send tables."""
        g = torch.Generator().manual_seed(d)
        return ([torch.randn((2, 3, shards[d].B, 5), generator=g, dtype=dtype)
                 for dtype in (torch.float64, torch.complex128)], shards[d]._dev_tables(device))

    (mine, tabs) = fields(rank)
    prev, nxt = fields(shard.prev_rank), fields(shard.next_rank)
    same, n = True, 0
    for i, v in enumerate(mine):
        for k in range(p.ngroups):
            sn = v.index_select(-2, tabs["send_next"][k]) if p.hp[k] else None
            sp = v.index_select(-2, tabs["send_prev"][k]) if p.hn[k] else None
            from_prev, from_next = comm.halo_exchange(sn, sp, shard.next_rank, shard.prev_rank)
            if sn is not None:
                want = prev[0][i].index_select(-2, prev[1]["send_next"][k])
                same = same and torch.equal(from_prev, want)
            if sp is not None:
                want = nxt[0][i].index_select(-2, nxt[1]["send_prev"][k])
                same = same and torch.equal(from_next, want)
            n += sn is not None or sp is not None
    return same, n
