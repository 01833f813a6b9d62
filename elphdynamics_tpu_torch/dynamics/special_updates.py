"""Global Monte Carlo moves: reflection and swap.

Counterpart of ``elphdynamics_tpu/dynamics/special_updates.py``:

* reflection: x_i(τ) → −x_i(τ) on a whole site worldline (Holstein; a null
  move for SSH);
* swap: exchange the worldlines of the two sites of a random bond
  (Holstein), or of two random phonons (SSH).

Each proposal is an exact Metropolis test: the pseudofermions are drawn
afresh at the current configuration (so S₀ = Σ±|R±|²/2 + Sb exactly), the
move is applied, the new action is evaluated with tol² solves, and the
move is accepted or rejected. The moves of one call run in sequence, each
on all chains at once (one batched solve per move). As in the JAX package
these tol² solves are always batched CG with the symmetric preconditioner,
whatever solver kind and ``block`` setting the sampler runs with, and are
never warm-started.

Random draws are explicit, as in :mod:`.hmc`: an update takes optional
:class:`SpecialDraws`; without them it draws from its ``generator``.

On a site-sharded model the picks are global sites and bonds: the rank
that holds a site flips it, and a swapped row reaches the other rank by
an all-reduce; the actions are summed over the ranks.

On one rank or a chain rank's block, with shared or per-chain (tempering
ladder) couplings, with a real field or under complex hopping (the packed
complex pseudofermions ``[n_moves, C, 1, N, Lτ]``), and with any
preconditioner (KPM, with or without the exact low-frequency blocks, or
the near-null one), a call is a fixed sequence of segments over one workspace (:mod:`.graphs`), as the HMC
update is: ``first`` (move 0's
start: φ and S₀ at x, the proposal, the derived state, Λφ and the full
KPM setup at the proposed field, the tol² solve's start from zero), the
solve's CG blocks and verification (:class:`.graphs.CGSolve`), ``next``
(move m's Metropolis test and masked commit, then move m+1's start) and
``last`` (the last move's test and the acceptance rate). Move m's picks,
pseudofermions and uniform are copied into fixed workspace slots before
the replay that reads them, so no graph holds a move index. On a CUDA
field each segment is captured once as a CUDA graph and replayed, the host
keeping the eager call's reads (CG's ``any(active)`` before a block, the
verification's ``any(bad)``); on the CPU the segments run directly, doing
the eager call's arithmetic in its order. A site shard's call is
segmented too, its site group's all-reduces (the actions, the swapped
rows of :meth:`..parallel.lattice_shard.SiteShard.row`) and halo
exchanges inside the segments (captured on NCCL ranks, one card each); a
site group under gloo on a card runs the eager call
(:func:`.graphs.graphable` reads the group's backend), as does a caller
that asks for it by name (``eager=True``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_oinv
from elphdynamics_tpu_torch.models.adapter import (
    ModelOps, global_phonons, global_sites, local_sites, site_sum)
from elphdynamics_tpu_torch.utils.dtypes import fdot, field_dtype, pseudofermion_noise


@dataclass(frozen=True)
class SpecialUpdateConfig:
    freq: int = 1       # apply every `freq` sampler updates (0 = never)
    n_moves: int = 0    # sites (reflection) or bonds (swap) per call
    tol: float = 1e-5
    maxiter: int = 1000


@dataclass(frozen=True)
class SpecialDraws:
    """The random numbers of one call of ``n_moves`` moves on C chains."""

    # [n_moves, C] site (reflection) or checkerboard bond (Holstein swap);
    # [n_moves, C, 2] two distinct phonons (SSH swap)
    picks: torch.Tensor
    # [n_moves, C, 2, N, Lτ] unit normals; under complex hopping the two
    # spins packed as [n_moves, C, 1, N, Lτ] R↑ + i·R↓
    pseudofermion: torch.Tensor
    uniform: torch.Tensor        # [n_moves, C] uniforms on [0, 1) (float64)


def _eval_S(ops: ModelOps, params, x, phi, tol: float, maxiter: int, precond=None):
    """S = Sb + Σ± (Λφ±)ᵀ(MᵀM)⁻¹(Λφ±)/2 per chain (Λ = 1 for SSH), and the
    solve's flag."""
    derived = ops.derived(params, x)
    Lphi = (ops.mulLambda(ops.calc_Lambda(params, x)[:, None], phi)
            if ops.calc_Lambda is not None else phi)
    pa = resolve_precond(precond, params, x)
    sol = solve_oinv(ops, params, ops.stack(derived), Lphi,
                     SolverConfig(tol=tol, maxiter=maxiter), pa)
    S = site_sum(ops, fdot(Lphi, sol.x, dim=(1, -2, -1))) / 2 + ops.calc_Sb(params, x, False)
    return S, sol.flag.amax(dim=1)


def _refresh_phi(ops: ModelOps, params, x, R):
    """φ± = Λ⁻¹·Mᵀ·R± (Mᵀ·R± for SSH) and the exact action
    S₀ = Σ±|R±|²/2 + Sb."""
    derived = ops.derived(params, x)
    MtR = ops.mulMT(params, ops.stack(derived), R)
    phi = (ops.mulLambdaInv(ops.calc_Lambda(params, x)[:, None], MtR)
           if ops.calc_Lambda is not None else MtR)
    S0 = site_sum(ops, fdot(R, R, dim=(1, -2, -1))) / 2 + ops.calc_Sb(params, x, False)
    return phi, S0


def _make_update(ops: ModelOps, cfg: SpecialUpdateConfig, n_moves: int, draw_picks,
                 propose, precond, eager: bool = False):
    """The Metropolis loop shared by the moves: ``draw_picks(shape,
    generator, device)`` draws the ``[n_moves, C]`` picks, ``propose(x,
    picks)`` returns the moved fields for one chain vector of picks. The
    update's ``draw(params, x, n_chains, generator)`` makes the draws of
    one call (on a site-sharded model every site's pseudofermions, cut to
    the rank's block). ``eager`` asks for the eager call where the
    segmented one (module docstring) would run; ``update.segmented`` says
    whether the configuration takes it (on a site shard where
    :func:`.graphs.graphable` lets the call's device), and
    ``update.workspace()`` is its :class:`.graphs.Workspace` (None before
    the first segmented call)."""
    tol2 = cfg.tol ** 2

    def draw(params, x, n_chains: int, generator=None) -> SpecialDraws:
        C = n_chains
        return SpecialDraws(
            picks=draw_picks((n_moves, C), generator, x.device),
            pseudofermion=torch.stack([
                local_sites(ops, pseudofermion_noise((C, global_sites(ops), ops.Ltau),
                                                     field_dtype(params, x.dtype), x.device,
                                                     generator))
                for _ in range(n_moves)]),
            uniform=torch.rand((n_moves, C), generator=generator, dtype=torch.float64,
                               device=x.device))

    def eager_update(params, x, draws: SpecialDraws):
        accepted = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for m in range(n_moves):
            phi, S0 = _refresh_phi(ops, params, x, draws.pseudofermion[m].to(x.device))
            x_new = propose(x, draws.picks[m].to(x.device))
            S1, flag = _eval_S(ops, params, x_new, phi, tol2, cfg.maxiter, precond)
            P = torch.clamp(torch.exp(-(S1 - S0)), max=1.0)
            acc = (draws.uniform[m].to(P) < P) & (flag == 0)
            x = torch.where(acc[:, None, None], x_new, x)
            accepted = accepted + acc.to(torch.int64)
        return x, accepted.to(torch.float64) / max(n_moves, 1)

    # --- the segmented call: the eager call's arithmetic in its order, over
    # one workspace (dynamics/graphs.py)
    segmented = not eager and n_moves > 0
    box: dict = {}
    # the eager call's solve: CG at tol², kappa_max and loop_precision at
    # SolverConfig's defaults, preconditioned by the symmetric apply
    scfg = SolverConfig(tol=tol2, maxiter=cfg.maxiter)
    cg = graphs.CGSolve(ops, precond, scfg.maxiter, scfg.kappa_max, scfg.loop_precision,
                        rhs="Lphi", stacked=True)

    def move_start(ws):
        """φ and S₀ at ws.x from the move's pseudofermions (:func:`_refresh_phi`),
        the proposal at the move's picks, then the derived state, Λφ and the
        full KPM setup at the proposed field and the tol² solve's start from
        zero (:func:`_eval_S`)."""
        p = ws.params
        phi, S0 = _refresh_phi(ops, p, ws.x, ws.R)
        ws.put("S0", S0)
        x_new = ws.put("x_new", propose(ws.x, ws.pick))
        ws.put("env", ops.derived(p, x_new))
        ws.put("Lphi", ops.mulLambda(ops.calc_Lambda(p, x_new)[:, None], phi)
               if ops.calc_Lambda is not None else phi)
        if precond is not None:
            ws.load("kpm", precond.setup(p, x_new, ws.kpm_start))
        cg.start(ws, tol2)

    def move_end(ws):
        """S₁ from the finished solve, the Metropolis test against the move's
        uniform and the masked commit."""
        S1 = (site_sum(ops, fdot(ws.Lphi, ws.cg.x, dim=(1, -2, -1))) / 2
              + ops.calc_Sb(ws.params, ws.x_new, False))
        flag = ws.verdict.flag.amax(dim=1)
        P = torch.clamp(torch.exp(-(S1 - ws.S0)), max=1.0)
        acc = (ws.u.to(P) < P) & (flag == 0)
        ws.put("x", torch.where(acc[:, None, None], ws.x_new, ws.x))
        ws.put("accepted", ws.accepted + acc.to(torch.int64))

    def seg_next(ws):
        move_end(ws)
        move_start(ws)

    def seg_last(ws):
        move_end(ws)
        ws.put("rate", ws.accepted.to(torch.float64) / n_moves)

    def segments(ws):
        """Every segment once, in the order of a call whose solves each stop
        after one CG block (the warm-up and the capture order)."""
        seq = [("first", lambda: move_start(ws)), *cg.segments(ws, tol2)]
        if n_moves > 1:
            seq.append(("next", lambda: seg_next(ws)))
        return seq + [("last", lambda: seg_last(ws))]

    def segmented_update(params, x, draws: SpecialDraws):
        ws = graphs.step_workspace(box, params, x)
        dev = x.device

        def load(start: int | None, end: int | None):
            """The slots of move ``start``'s start (pseudofermions, picks)
            and of move ``end``'s test (uniform)."""
            if start is not None:
                ws.put("R", draws.pseudofermion[start].to(dev))
                ws.put("pick", draws.picks[start].to(dev))
            if end is not None:
                ws.put("u", draws.uniform[end].to(dev))

        def begin():
            ws.put("x", x)
            ws.put("accepted", torch.zeros(x.shape[0], dtype=torch.int64, device=dev))

        begin()
        load(0, 0)
        if precond is not None:
            ws.put_start(precond.start)
        if ws.graphs is not None and not ws.graphs.graphs:
            ws.capture_once(lambda: segments(ws))
            begin()     # the warm-up ran a move on the slots
        ws.run("first", lambda: move_start(ws))
        for m in range(n_moves):
            cg.solve(ws, tol2)
            if m + 1 < n_moves:
                load(m + 1, m)
                ws.run("next", lambda: seg_next(ws))
            else:
                load(None, m)
                ws.run("last", lambda: seg_last(ws))
        return ws.x.clone(), ws.rate.clone()

    def update(params, x, generator: torch.Generator | None = None,
               draws: SpecialDraws | None = None):
        C = x.shape[0]
        if n_moves == 0:
            return x, torch.zeros(C, dtype=torch.float64, device=x.device)
        if draws is None:
            draws = draw(params, x, C, generator)
        if segmented and graphs.graphable(ops.shard, x.device):
            return segmented_update(params, x, draws)
        return eager_update(params, x, draws)

    update.draw = draw
    update.n_moves = n_moves
    update.segmented = segmented
    update.workspace = lambda: box.get("ws")
    return update


def _uniform_picks(n: int):
    def draw_picks(shape, generator, device):
        return torch.randint(0, n, shape, generator=generator, device=device)
    return draw_picks


def make_reflection_update(ops: ModelOps, cfg: SpecialUpdateConfig, precond=None,
                           eager: bool = False):
    """Reflection x → −x on ``n_moves`` random sites per call (Holstein; for
    SSH a null move that accepts nothing). Returns ``update(params, x,
    generator=None, draws=None) -> (x, acceptance [C])``."""
    if not ops.is_holstein:
        return _make_update(ops, cfg, 0, None, None, precond, eager)
    N = global_phonons(ops)

    def propose(x, sites):
        rows = torch.arange(x.shape[0], device=x.device)
        x_new = x.clone()
        if ops.shard is None:
            x_new[rows, sites] = -x[rows, sites]
        else:
            # the rank that holds the site flips it
            has, r = ops.shard.owns(sites)
            x_new[rows, r] = torch.where(has[:, None], -x[rows, r], x[rows, r])
        return x_new

    return _make_update(ops, cfg, min(cfg.n_moves, N), _uniform_picks(N), propose, precond,
                        eager)


def _swap_rows(x, i, j):
    """``x`` with rows ``i`` and ``j`` (one per chain) exchanged."""
    rows = torch.arange(x.shape[0], device=x.device)
    x_new = x.clone()
    x_new[rows, i] = x[rows, j]
    x_new[rows, j] = x[rows, i]
    return x_new


def make_swap_update(ops: ModelOps, cfg: SpecialUpdateConfig, precond=None,
                     eager: bool = False):
    """Swap ``n_moves`` times per call: the worldlines of the two sites of a
    random bond (Holstein, bonds in checkerboard order), or of two distinct
    random phonons (SSH)."""
    if not ops.is_holstein:
        Nph = ops.Nph

        def draw_pair(shape, generator, device):
            i = torch.randint(0, Nph, shape, generator=generator, device=device)
            j = torch.randint(0, Nph - 1, shape, generator=generator, device=device)
            return torch.stack([i, torch.where(j >= i, j + 1, j)], dim=-1)

        return _make_update(ops, cfg, cfg.n_moves if Nph >= 2 else 0, draw_pair,
                            lambda x, ij: _swap_rows(x, ij[:, 0], ij[:, 1]), precond, eager)
    n_moves = cfg.n_moves if ops.spec.Nbonds > 0 else 0
    tables: dict = {}

    def propose(x, bonds):
        table = graphs.made_once(tables, x.device, lambda: torch.as_tensor(
            ops.spec.ckb.neighbor_table, device=x.device), "the swap's bond table")
        ends = table[:, bonds]
        if ops.shard is None:
            return _swap_rows(x, ends[0], ends[1])
        # site-sharded: each endpoint's row reaches every rank (one
        # all-reduce each), and its owner writes the other's
        i, j = ends[0], ends[1]
        row_i, row_j = ops.shard.row(x, i), ops.shard.row(x, j)
        rows = torch.arange(x.shape[0], device=x.device)
        x_new = x.clone()
        for site, val in ((i, row_j), (j, row_i)):
            has, r = ops.shard.owns(site)
            x_new[rows, r] = torch.where(has[:, None], val, x_new[rows, r])
        return x_new

    return _make_update(ops, cfg, n_moves, _uniform_picks(ops.spec.Nbonds), propose, precond,
                        eager)
