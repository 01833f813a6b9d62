"""Model-level linear-solve dispatch: z = (MᵀM)⁻¹·rhs for the HMC forces
and actions, x = M⁻¹·rhs for the Langevin force and the Green's-function
probes.

Counterpart of ``elphdynamics_tpu/dynamics/solve.py``. With CG, systems are
solved through the SPD operator MᵀM with the symmetric KPM preconditioner
(optionally block CG over an axis of systems that share the operator); with
BiCGStab or GMRES they are solved through M and Mᵀ directly with the left
and right KPM preconditioners, and (MᵀM)⁻¹ becomes two solves in sequence.
Every path ends in a residual verification and an unpreconditioned retry.
CG solves of MᵀM can start from a deflated guess (``deflate``,
:mod:`..ops.deflation`).

Fields carry an explicit leading chain axis, so the systems of one chain
that share its operator are ``rhs[c]``: block CG needs ``rhs`` of at least
four axes ``[C, s, N, Lτ]`` (the JAX package, which maps over chains, asks
for three). Under complex hopping block CG is Hermitian block CG
(:func:`..solvers.block_cg`) on M†M; every call site below runs it
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.models.adapter import ModelOps
from elphdynamics_tpu_torch.utils.dtypes import fdot

# the values of ``[solver] loop_precision``, the JAX package's: None and
# "highest" run every operator at full precision, "high" and "default" the
# in-loop MᵀM cheaper where the model has a cheaper form
# (models/holstein.BF16_PASSES)
LOOP_PRECISIONS = (None, "highest", "high", "default")


@dataclass(frozen=True)
class SolverConfig:
    """Linear-solver settings."""

    tol: float = 1e-5
    maxiter: int = 1000
    kappa_max: float = 1e12
    kind: str = "cg"      # "cg" | "bicgstab" | "gmres"
    restart: int = 20     # GMRES restart length
    # block CG over the systems of one chain that share its operator (the nᵥ
    # probes of a measurement, the two spins of a trajectory solve)
    block: bool = False
    # the split precision policy of the JAX package (_cg_operators): the
    # in-loop MᵀM of CG at this precision, the verification, the retry and
    # every solve with tol < 1e-6 at full precision. Only the dense Holstein
    # operator of a real float32 CUDA field has a cheaper form ("high": three
    # bf16 products accumulated in float32; models/holstein.py); elsewhere
    # every value runs the full operator
    loop_precision: str | None = "high"

    def __post_init__(self):
        if self.kind not in ("cg", "bicgstab", "gmres"):
            raise ValueError(f"unknown solver kind {self.kind!r} (cg, bicgstab or gmres)")
        if self.loop_precision not in LOOP_PRECISIONS:
            raise ValueError(f"unknown loop_precision {self.loop_precision!r} "
                             f"(expected one of {LOOP_PRECISIONS})")


# the refusal of BiCGStab / GMRES under site sharding, and why (ROADMAP §3)
SITE_NONSYM = ("BiCGStab / GMRES with --site-devices: the JAX package's sharded samplers "
               "read only [solver] block and solve by CG whatever type is set, so there is "
               "no sharded BiCGStab / GMRES to match (ROADMAP section 3, found in the "
               "reference)")


def site_reduce(ops: ModelOps, kind: str = "cg"):
    """The all-reduce of a site-sharded model's dots and Grams over its site
    group (None on one rank). Site sharding runs CG and block CG; BiCGStab
    and GMRES there raise (:data:`SITE_NONSYM`)."""
    if ops.shard is None:
        return None
    if kind != "cg":
        raise NotImplementedError(SITE_NONSYM)
    return ops.shard.sum


@dataclass(frozen=True)
class PrecondApplies:
    symmetric: object          # (v) -> v   ≈ (MᵀM)⁻¹
    left: object = None        # (v) -> v   ≈ M⁻¹
    right: object = None       # (v) -> v   ≈ M⁻ᵀ


def precond_state(precond, params, x, prev=None, start=None):
    """Full preconditioner setup (``prev=None``) or the cheap refresh of
    ``prev``. ``start`` overrides the power-iteration start vectors."""
    if precond is None:
        return None
    if prev is not None:
        return precond.refresh(prev, params, x)
    return precond.setup(params, x, start)


def precond_applies(precond, st) -> PrecondApplies | None:
    """Bind a preconditioner state into the apply closures."""
    if precond is None:
        return None
    return PrecondApplies(
        symmetric=lambda v: precond.symmetric(st, v),
        left=(lambda v: precond.left(st, v)) if precond.left is not None else None,
        right=(lambda v: precond.right(st, v)) if precond.right is not None else None)


def resolve_precond(precond, params, x, prev_state=None) -> PrecondApplies | None:
    """Set up (or refresh, given ``prev_state``) and bind the applies."""
    if precond is None:
        return None
    return precond_applies(precond, precond_state(precond, params, x, prev_state))


def _cg_operators(ops: ModelOps, params, derived, scfg: SolverConfig):
    """(in-loop, verification) MᵀM operators of the CG paths: ``(full,
    None)`` for ``loop_precision`` None or "highest" and for tol < 1e-6 (the
    tol² endpoint solves iterate to the float32 floor, which a cheaper
    operator would raise), else ``(cheaper, full)``: the cheaper operator
    steers the iteration, the residual verification and the retry use the
    full one."""
    full = lambda v: ops.mulMTM(params, derived, v)
    prec = scfg.loop_precision
    if prec is None or prec == "highest" or scfg.tol < 1e-6:
        return full, None
    return (lambda v: ops.mulMTM(params, derived, v, precision=prec)), full


def nonsym_retry(apply_A, b, x, iters, v: solvers.Verdict, base, tol, maxiter: int
                 ) -> solvers.SolveResult:
    """The retry of the BiCGStab and GMRES paths after
    :func:`..solvers.cg_verify` flagged a system (``v``): every system
    iterated again by ``base`` unpreconditioned with 10× the iteration
    budget, from zero where flagged and from ``x`` elsewhere; only the
    flagged systems keep its result and its iterations, and one stays
    flagged if the retry leaves it above √tol. ``tol`` is a number or a
    0-dim float64 tensor."""
    badf = v.bad[..., None, None]
    x_start = torch.where(badf, torch.zeros_like(x), x)
    res2 = base(apply_A, b, x0=x_start, apply_P=None, tol=tol, maxiter=10 * maxiter)
    x = torch.where(badf, res2.x, x)
    d = apply_A(x) - b
    err2 = torch.sqrt(fdot(d, d, dim=(-2, -1))) / v.safe_normb
    zero = torch.zeros_like(v.flag)
    flag = torch.where(v.bad & (err2 > solvers._sqrt_tol(tol)), v.flag, zero)
    iters = iters + torch.where(v.bad, res2.iters, zero)
    return solvers.SolveResult(x=x, iters=iters, residual=err2, flag=flag)


def _checked_nonsym(apply_A, b, base, apply_P, scfg: SolverConfig):
    """Residual verification (:func:`..solvers.cg_verify`) and
    unpreconditioned retry (:func:`nonsym_retry`) for the BiCGStab and GMRES
    paths. The retry runs only when a preconditioned system failed (one
    host read)."""
    res1 = base(apply_A, b, apply_P=apply_P, tol=scfg.tol, maxiter=scfg.maxiter)
    v = solvers.cg_verify(apply_A, b, res1.x, res1.iters, scfg.tol, scfg.maxiter)
    if apply_P is None or not solvers.host_any(v.bad):
        return solvers.SolveResult(x=res1.x, iters=res1.iters, residual=v.residual, flag=v.flag)
    return nonsym_retry(apply_A, b, res1.x, res1.iters, v, base, scfg.tol, scfg.maxiter)


def base_solver(scfg: SolverConfig):
    """The BiCGStab or GMRES solve of ``scfg.kind`` that the residual
    verification follows, called as ``base(apply_A, b, x0=None, *, apply_P,
    tol, maxiter)``: GMRES's loop without its own residual check
    (``converged`` there: the systems its Givens estimate stopped)."""
    if scfg.kind == "bicgstab":
        return solvers.bicgstab

    def gmres_batched(apply_A, b, x0=None, *, apply_P=None, tol, maxiter):
        st = solvers.gmres_iterate(apply_A, b, x0, apply_P=apply_P, tol=tol, maxiter=maxiter,
                                   restart=scfg.restart)
        return solvers.CGResult(x=st.x, iters=st.iters, converged=st.done_all)

    return gmres_batched


def solve_minv(ops: ModelOps, params, derived, rhs, scfg: SolverConfig,
               pa: PrecondApplies | None, block: bool = False):
    """x = M⁻¹·rhs for every leading index of ``rhs``: CG on MᵀM·x = Mᵀ·rhs
    with the symmetric preconditioner, or BiCGStab / GMRES on M with the left
    one.

    ``block=True`` (CG with ``scfg.block`` only) solves ``rhs``
    ``[C, s, N, Lτ]`` by block CG over the ``s`` axis: valid only when those
    systems share the operator (the nᵥ probes of one configuration), never
    for the chain axis. Complex probes (complex hopping) run Hermitian block
    CG with s = nᵥ."""
    use_block = block and scfg.block and rhs.ndim >= 4
    reduce = site_reduce(ops, scfg.kind)
    if scfg.kind == "cg":
        b = ops.mulMT(params, derived, rhs)
        hot, chk = _cg_operators(ops, params, derived, scfg)
        kw = dict(apply_P=pa.symmetric if pa else None, tol=scfg.tol, maxiter=scfg.maxiter,
                  kappa_max=scfg.kappa_max, apply_A_check=chk)
        if use_block:
            return solvers.block_solve_checked(hot, b, reduce=reduce, **kw)
        return solvers.solve_checked(hot, b, reduce=reduce, **kw)
    return _checked_nonsym(lambda v: ops.mulM(params, derived, v), rhs, base_solver(scfg),
                           pa.left if pa else None, scfg)


def solve_oinv(ops: ModelOps, params, derived, rhs, scfg: SolverConfig,
               pa: PrecondApplies | None, x0=None, deflate=None):
    """z = (MᵀM)⁻¹·rhs for every leading index of ``rhs``; ``x0`` warm
    starts the CG, ``deflate`` (a per-chain
    :class:`..ops.deflation.DeflationState`) init-projects its slow modes
    out (CG only; the other kinds ignore it, as in the JAX package).

    With ``scfg.block`` the spin-stacked systems ``[C, 2, N, Lτ]`` (one
    operator per chain; the spins differ only in φ) run through block CG,
    unless deflating. Gated to tol ≥ 1e-6: at the tol² endpoint tolerance
    the shared Gram solves sit on the float32 noise floor, so those stay on
    batched CG. Under complex hopping the two spins are one complex stack
    entry ``[C, 1, N, Lτ]``, so the block is s = 1: Hermitian block CG at
    s = 1 is CG in exact arithmetic (its iterates differ from CG's by
    rounding). BiCGStab / GMRES solve Mᵀ·y = rhs with the right
    preconditioner, then M·z = y with the left one."""
    use_block = scfg.block and deflate is None and rhs.ndim >= 4 and scfg.tol >= 1e-6
    reduce = site_reduce(ops, scfg.kind)
    if scfg.kind == "cg":
        hot, chk = _cg_operators(ops, params, derived, scfg)
        kw = dict(apply_P=pa.symmetric if pa else None, tol=scfg.tol, maxiter=scfg.maxiter,
                  kappa_max=scfg.kappa_max, apply_A_check=chk)
        if use_block:
            return solvers.block_solve_checked(hot, rhs, X0=x0, reduce=reduce, **kw)
        return solvers.solve_checked(hot, rhs, x0=x0, deflate=deflate, reduce=reduce, **kw)
    base = base_solver(scfg)
    res1 = _checked_nonsym(lambda v: ops.mulMT(params, derived, v), rhs, base,
                           pa.right if pa else None, scfg)
    res2 = _checked_nonsym(lambda v: ops.mulM(params, derived, v), res1.x, base,
                           pa.left if pa else None, scfg)
    return solvers.SolveResult(x=res2.x, iters=res1.iters + res2.iters,
                               residual=res2.residual,
                               flag=torch.maximum(res1.flag, res2.flag))
