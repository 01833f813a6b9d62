"""Parallel tempering over a coupling ladder (beyond the reference).

Counterpart of ``elphdynamics_tpu/dynamics/tempering.py``. K replicas run at
scaled electron-phonon couplings (rung r: λ·ladder[r] and λ₂·ladder[r]² for
Holstein, α and α₂ likewise for SSH; rung 0 is the physical coupling), and
an exchange proposes swapping whole configurations between adjacent rungs.
The exchange is a Metropolis test on the joint (x, v, φ) chain: φ is
refreshed exactly (φ = Λ⁻¹MᵀR, so S₀ = Σ|R|²/2 + Sb needs no solve), one
batched tol solve over all C chains evaluates each chain's action at its
partner's (x, φ), and

    P(swap) = min(1, exp(−[S_a(x_b) + S_b(x_a) − S_a(x_a) − S_b(x_b)])),

with one uniform per pair and both partners' solves unflagged. x and v are
gathered by the partner index (φ is refreshed by the next update anyway).

Chain layout: C = K·M chains; rung r owns chains [r·M, (r+1)·M), and lane m
of rung r only exchanges with lane m of rungs r ± 1, pairs (2i+parity,
2i+parity+1) alternating with the attempt's parity.

In the port the couplings alone become per-chain ``[C, ...]`` leaves (the
models broadcast them against the chain axis); every other parameter stays
shared. Random numbers come from a generator or an injected
:class:`ExchangeDraws`.

Across chain ranks (:class:`..parallel.chains.ChainBlock`) neighbouring
rungs sit on different ranks, and the exchange still takes the one-rank
run's decisions: every rank draws the whole batch's numbers from the same
generator, evaluates its own chains' actions (each at its partner's x and
φ, received with one gather of x, v and φ over the chain group), the
``[C]`` action differences and flags are gathered, every rank decides every
pair from the same values, and each keeps its block of the permuted x and
v. On a site-sharded model (the 2-D layout) the cross solve runs on the
rank's block of sites, its actions summed over the site group.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_oinv
from elphdynamics_tpu_torch.dynamics.special_updates import _refresh_phi
from elphdynamics_tpu_torch.models.adapter import ModelOps, global_sites, local_sites, site_sum
from elphdynamics_tpu_torch.utils.dtypes import fdot, field_dtype, pseudofermion_noise


@dataclass(frozen=True)
class TemperingConfig:
    ladder: tuple = (1.0,)   # coupling multipliers; ladder[0] must be 1.0
    freq: int = 5            # attempt an exchange every `freq` sampler updates
    tol: float = 1e-5
    maxiter: int = 1000


@dataclass(frozen=True)
class ExchangeDraws:
    """The random numbers of one exchange on C chains."""

    pseudofermion: torch.Tensor   # [C, 2, N, Lτ] ([C, 1, N, Lτ] complex) φ-refresh normals
    uniform: torch.Tensor         # [C] on [0, 1); a pair uses its lower member's


def check_ladder(tcfg: TemperingConfig, n_chains: int) -> None:
    """Refuse a ladder that does not divide the chains or does not start at
    the physical coupling."""
    K = len(tcfg.ladder)
    if n_chains % K:
        raise ValueError(f"--chains ({n_chains}) must be divisible by the tempering ladder "
                         f"size ({K})")
    if abs(float(tcfg.ladder[0]) - 1.0) > 1e-12:
        raise ValueError("[tempering] ladder[0] must be 1.0 (the physical coupling; "
                         "measurements bin rung 0 only)")


def _coupling_names(params) -> tuple[str, str]:
    return ("lam", "lam2") if hasattr(params, "lam") else ("alpha", "alpha2")


def ladder_params(params, tcfg: TemperingConfig, n_chains: int):
    """``params`` with per-chain couplings ``[C, ...]``: chains of rung r
    scale the linear coupling by ladder[r] and the quadratic one by
    ladder[r]²."""
    check_ladder(tcfg, n_chains)
    lin, quad = _coupling_names(params)
    base = getattr(params, lin)
    mult = torch.as_tensor(np.repeat(np.asarray(tcfg.ladder, np.float64),
                                     n_chains // len(tcfg.ladder)),
                           device=base.device).to(base.dtype)[:, None]
    return replace(params, **{lin: mult * base, quad: mult * mult * getattr(params, quad)})


def chain_params(params, lo: int, n: int):
    """``params`` for chains ``[lo, lo + n)``: per-chain couplings cut to
    that block (``params`` themselves when the couplings are shared)."""
    lin, quad = _coupling_names(params)
    if getattr(params, lin).ndim == 1:
        return params
    return replace(params, **{k: getattr(params, k).narrow(0, lo, n) for k in (lin, quad)})


def rung_params(params):
    """Shared-coupling parameters at the physical couplings: those of chain
    0, a rung-0 chain (``params`` themselves when the couplings are
    shared)."""
    lin, quad = _coupling_names(params)
    if getattr(params, lin).ndim == 1:
        return params
    return replace(params, **{lin: getattr(params, lin)[0], quad: getattr(params, quad)[0]})


def target_mask(tcfg: TemperingConfig, n_chains: int) -> np.ndarray:
    """Boolean ``[C]``: the chains at the physical coupling (rung 0)."""
    m = np.zeros(n_chains, dtype=bool)
    m[:n_chains // len(tcfg.ladder)] = True
    return m


def make_exchange_step(ops: ModelOps, tcfg: TemperingConfig, n_chains: int, precond=None,
                       chains=None, eager: bool = False):
    """Build ``exchange(params, x, v, parity, generator=None, draws=None) ->
    (x, v, acc_rate, iters, flag)`` for ladder ``params`` (per-chain
    couplings, :func:`ladder_params`) and fields ``[C, Nph, Lτ]``;
    ``parity`` ∈ {0, 1} chooses the rung pairs. ``acc_rate`` is the accepted
    share of the complete pairs, ``iters`` the chains' mean solve
    iterations, ``flag`` the largest solver flag (0-dim tensors).

    With ``chains`` (this rank's :class:`..parallel.chains.ChainBlock` of
    the ``n_chains``) ``params`` hold its block's couplings
    (:func:`chain_params`), ``x`` and ``v`` its block, and the results are
    its block of the exchanged fields; the draws stay the whole batch's.

    The exchange (it solves by CG, with any preconditioner; on a site
    shard too, its site group's all-reduces and halo exchanges inside the
    segments) is a fixed sequence of
    segments over one workspace (:mod:`.graphs`), replayed as CUDA graphs on
    a CUDA field and called directly on the CPU, each doing the eager
    exchange's arithmetic in its order: ``first`` (φ and S₀), ``cross``
    (the partners' Λφ, the derived state and full KPM setup at their x, the
    tol solve's start from zero), the solve's CG blocks and verification,
    ``actions`` (S_cross − S₀, iterations, flags) and ``decide`` (the
    Metropolis test, the permuted block of x and v, the accepted share). On
    chain ranks the gathers of x, v and φ and of the ``[C]`` values run
    eagerly between replays (:meth:`.graphs.Workspace.collective`); on one
    rank there are none, and ``first`` + ``cross`` and ``actions`` +
    ``decide`` are one segment each. The pair parity is no graph's: both
    parities' partner tables sit on the device and the attempt's is copied
    into a fixed slot, so one graph set serves both. A site shard's group
    under gloo on a card runs the eager exchange (:func:`.graphs.graphable`
    reads the group's backend). ``eager`` asks for the eager exchange;
    ``exchange.segmented`` and ``exchange.workspace()`` as for the HMC
    update."""
    K = len(tcfg.ladder)
    M = n_chains // K
    scfg = SolverConfig(tol=tcfg.tol, maxiter=tcfg.maxiter)
    lo, n = (chains.lo, chains.n) if chains is not None else (0, n_chains)

    def gather(t):
        """Every chain's ``t`` from the chain ranks' blocks."""
        return t if chains is None else chains.gather(t)

    def partners(parity: int, device):
        chain = torch.arange(n_chains, device=device)
        rung = chain // M
        rel = rung - parity
        lower = (rel % 2 == 0) & (rel >= 0) & (rung + 1 < K)
        upper = (rel % 2 == 1) & (rung - 1 >= 0) & (rel - 1 >= 0)
        return torch.where(lower, chain + M, torch.where(upper, chain - M, chain)), lower

    def draw(params, x, generator=None) -> ExchangeDraws:
        """The draws of one exchange of every chain (a site-sharded model
        draws every site's and keeps its block)."""
        return ExchangeDraws(
            pseudofermion=local_sites(ops, pseudofermion_noise(
                (n_chains, global_sites(ops), ops.Ltau), field_dtype(params, x.dtype),
                x.device, generator)),
            uniform=torch.rand((n_chains,), generator=generator, dtype=torch.float64,
                               device=x.device))

    def cross_action(params, xp, Lphi, z):
        """Each chain's action at its partner's field from the solve's z."""
        return (site_sum(ops, fdot(Lphi, z, dim=(1, -2, -1))) / 2
                + ops.calc_Sb(params, xp, False))

    def decide(partner, lower, half, iters, flag, u, x_all, v_all):
        """The Metropolis test of every pair on the gathered ``[C]`` values,
        this rank's block of the permuted fields and the accepted share."""
        dS = half + half[partner]                 # the same on both members
        chain = torch.arange(n_chains, device=half.device)
        paired = partner != chain
        u = u.to(dtype=dS.dtype)
        u_pair = torch.where(lower, u, u[partner])
        accept = paired & (flag == 0) & (flag[partner] == 0) & (u_pair < torch.exp(-dS))
        sel = torch.where(accept, partner, chain)
        n_pairs = torch.clamp((paired & lower).sum(), min=1)
        acc_rate = (accept & lower).sum().to(torch.float64) / n_pairs
        keep = sel[lo:lo + n]
        return (x_all[keep], v_all[keep], acc_rate, iters.to(torch.float64).mean(),
                flag.max())

    def eager_exchange(params, x, v, parity: int, draws: ExchangeDraws):
        phi, S0 = _refresh_phi(ops, params, x, draws.pseudofermion[lo:lo + n].to(x.device))
        partner, lower = partners(parity, x.device)
        x_all, v_all, phi_all = gather(x), gather(v), gather(phi)

        # one batched cross solve: each of this rank's chains' action at its
        # partner's (x, φ); the pseudofermion travels with its configuration
        mine = partner[lo:lo + n]
        xp, phip = x_all[mine], phi_all[mine]
        Lphi = (ops.mulLambda(ops.calc_Lambda(params, xp)[:, None], phip)
                if ops.calc_Lambda is not None else phip)
        sol = solve_oinv(ops, params, ops.stack(ops.derived(params, xp)), Lphi, scfg,
                         resolve_precond(precond, params, xp))
        S_cross = cross_action(params, xp, Lphi, sol.x)
        ns = sol.iters.shape[1]
        half, iters, flag = (gather(t) for t in (S_cross - S0,
                                                 (sol.iters.sum(dim=1) + ns - 1) // ns,
                                                 sol.flag.amax(dim=1)))
        return decide(partner, lower, half, iters, flag,
                      draws.uniform.to(device=x.device), x_all, v_all)

    # --- the segmented exchange (see the docstring)
    segmented = not eager
    box: dict = {}
    tables: dict = {}
    cg = graphs.CGSolve(ops, precond, scfg.maxiter, scfg.kappa_max, scfg.loop_precision,
                        rhs="Lphi", stacked=True)

    def pair_tables(device):
        """Both parities' partner and lower-member tables, on the device."""
        return graphs.made_once(tables, device, lambda: tuple(
            torch.stack(t) for t in zip(*(partners(q, device) for q in (0, 1)))),
            "the exchange's pair tables")

    def fields(ws):
        """Every chain's x, v and φ: the gathered copies on chain ranks, the
        rank's own on one rank."""
        if chains is None:
            return ws.x, ws.v, ws.phi
        return ws.x_all, ws.v_all, ws.phi_all

    def seg_first(ws):
        """φ and S₀ at the rank's x (:func:`_refresh_phi`)."""
        phi, S0 = _refresh_phi(ops, ws.params, ws.x, ws.R)
        ws.put("phi", phi)
        ws.put("S0", S0)

    def gather_fields(ws):
        for name in ("x", "v", "phi"):
            ws.put(f"{name}_all", gather(getattr(ws, name)))

    def seg_cross(ws):
        """The partners' x and Λφ, the derived state and the full KPM setup
        at their x, and the tol solve's start from zero."""
        p = ws.params
        x_all, _, phi_all = fields(ws)
        mine = ws.partner[lo:lo + n]
        xp = ws.put("xp", x_all[mine])
        phip = phi_all[mine]
        ws.put("env", ops.derived(p, xp))
        ws.put("Lphi", ops.mulLambda(ops.calc_Lambda(p, xp)[:, None], phip)
               if ops.calc_Lambda is not None else phip)
        if precond is not None:
            ws.load("kpm", precond.setup(p, xp, ws.kpm_start))
        cg.start(ws, scfg.tol)

    def seg_actions(ws):
        """S_cross − S₀, the mean iterations and the largest flag per chain."""
        ns = ws.cg.iters.shape[1]
        ws.put("half", cross_action(ws.params, ws.xp, ws.Lphi, ws.cg.x) - ws.S0)
        ws.put("iters", (ws.cg.iters.sum(dim=1) + ns - 1) // ns)
        ws.put("flag", ws.verdict.flag.amax(dim=1))

    def gather_values(ws):
        for name in ("half", "iters", "flag"):
            ws.put(f"{name}_all", gather(getattr(ws, name)))

    def seg_decide(ws):
        x_all, v_all, _ = fields(ws)
        vals = ((ws.half, ws.iters, ws.flag) if chains is None
                else (ws.half_all, ws.iters_all, ws.flag_all))
        for name, val in zip(("out_x", "out_v", "rate", "mean_iters", "max_flag"),
                             decide(ws.partner, ws.lower, *vals, ws.u, x_all, v_all)):
            ws.put(name, val)

    def segments(ws):
        """Every segment once (and the gathers between them on chain ranks),
        in the order of an exchange whose solve stops after one CG block
        (the warm-up and the capture order)."""
        if chains is None:
            return [("start", lambda: (seg_first(ws), seg_cross(ws))),
                    *cg.segments(ws, scfg.tol),
                    ("end", lambda: (seg_actions(ws), seg_decide(ws)))]
        return [("first", lambda: seg_first(ws)), graphs.between(lambda: gather_fields(ws)),
                ("cross", lambda: seg_cross(ws)), *cg.segments(ws, scfg.tol),
                ("actions", lambda: seg_actions(ws)), graphs.between(lambda: gather_values(ws)),
                ("decide", lambda: seg_decide(ws))]

    def segmented_exchange(params, x, v, parity: int, draws: ExchangeDraws):
        ws = graphs.step_workspace(box, params, x)
        dev = x.device
        partner, lower = pair_tables(dev)
        ws.put("partner", partner[parity])
        ws.put("lower", lower[parity])
        ws.put("x", x)
        ws.put("v", v)
        ws.put("R", draws.pseudofermion[lo:lo + n].to(dev))
        ws.put("u", draws.uniform.to(device=dev))
        if precond is not None:
            ws.put_start(precond.start)
        ws.capture_once(lambda: segments(ws))
        if chains is None:
            ws.run("start", lambda: (seg_first(ws), seg_cross(ws)))
            cg.solve(ws, scfg.tol)
            ws.run("end", lambda: (seg_actions(ws), seg_decide(ws)))
        else:
            ws.run("first", lambda: seg_first(ws))
            ws.collective(lambda: gather_fields(ws))
            ws.run("cross", lambda: seg_cross(ws))
            cg.solve(ws, scfg.tol)
            ws.run("actions", lambda: seg_actions(ws))
            ws.collective(lambda: gather_values(ws))
            ws.run("decide", lambda: seg_decide(ws))
        return (ws.out_x.clone(), ws.out_v.clone(), ws.rate.clone(), ws.mean_iters.clone(),
                ws.max_flag.clone())

    def exchange(params, x, v, parity: int, generator: torch.Generator | None = None,
                 draws: ExchangeDraws | None = None):
        if x.shape[0] != n:
            raise ValueError(f"x holds {x.shape[0]} chains, the exchange {n}")
        if draws is None:
            draws = draw(params, x, generator)
        if segmented and graphs.graphable(ops.shard, x.device):
            return segmented_exchange(params, x, v, parity, draws)
        return eager_exchange(params, x, v, parity, draws)

    exchange.draw = draw
    exchange.n_chains, exchange.chains = n_chains, chains
    exchange.segmented = segmented
    exchange.workspace = lambda: box.get("ws")
    return exchange
