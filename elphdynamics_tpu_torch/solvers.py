"""Batched iterative solvers with masked per-system convergence.

Counterpart of ``elphdynamics_tpu/solvers.py``: ``cg``, ``cg_split``,
``block_cg``, ``bicgstab``, ``gmres`` and the residual-verified wrappers
``solve_checked`` / ``block_solve_checked``. Fields are ``[..., N, Lτ]``;
every leading index is an independent system (for :func:`block_cg` the
axis before the field axes is the block of right-hand sides that share one
operator). All systems iterate together and stop individually through
masks: an iteration changes nothing for a system that has converged, hit
the κ bound or broken down, so extra iterations are harmless.

The JAX loops are ``lax.while_loop`` programs whose condition reads
``any(active)`` on the device. Here that flag is read on the host only
once every ``CG_SYNC_EVERY`` iterations (GMRES: at that cadence inside a
restart cycle and once per cycle), and the retry ladders run only when a
verification failed — one host sync per solve for them. :func:`cg` is a
start (:func:`cg_init`) and blocks of ``CG_SYNC_EVERY`` iterations
(:func:`cg_block`) over a :class:`CGState` updated in place, :func:`block_cg`
likewise (:func:`block_cg_init`, :func:`block_cg_block`, a
:class:`BlockCGState`), :func:`bicgstab` likewise (:func:`bicgstab_init`,
:func:`bicgstab_block`, a :class:`BiCGStabState`), :func:`gmres` a start
(:func:`gmres_init`) and per restart cycle :func:`gmres_cycle_start`,
blocks of Arnoldi steps (:func:`gmres_arnoldi_block`) and
:func:`gmres_cycle_close` over a :class:`GMRESState`, and the verification
is :func:`cg_verify` then, rarely, :func:`cg_retry`: fixed shapes that a
CUDA graph captures (``dynamics/graphs.py``). Every host read goes through
:func:`host_any`, which counts it.

Dot products, norms and Gram matrices accumulate in float64
(:mod:`elphdynamics_tpu_torch.utils.dtypes`); scalars are cast back to the
field dtype before they touch a field. The block updates of
:func:`block_cg` are matmuls in the field dtype. They must not run in TF32
(a low-precision block update breaks block CG's A-conjugacy): callers leave
``torch.backends.cuda.matmul.allow_tf32`` off, which is PyTorch's default.

Complex fields (complex hopping) run through ``cg``, ``cg_split``,
``bicgstab`` and ``gmres`` unchanged: the dot products are the real
Hermitian product Re(a†b), so the solvers work on the real ℝ²ⁿ embedding.
On a ℂ-linear Hermitian operator (M†M and the complex KPM polynomial) that
is complex CG: r†z and p†Ap are real there, so α and β are the same.
``block_cg`` is Hermitian block CG on them: complex Grams U†W and complex
s×s solves (see its docstring); its norms, κ bound and verification stay on
Re(a†b).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable

import torch

from elphdynamics_tpu_torch.ops import deflation
from elphdynamics_tpu_torch.utils import spans
from elphdynamics_tpu_torch.utils.dtypes import fdot, fdot_fast

# iterations between host reads of any(active); masked iterations past
# convergence are no-ops, so this only trades wasted work for fewer syncs
CG_SYNC_EVERY = 4


def _dot(a, b):
    return fdot(a, b, dim=(-2, -1))


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _dot_hot(a, b):
    return fdot_fast(a, b, dim=(-2, -1))


def _dots(pairs, reduce=None, dot=_dot_hot):
    """The per-system dots of each ``(a, b)`` of ``pairs``. ``reduce`` (a
    site-sharded solve: the site ranks' sum) turns the rank's partial dots
    into the global ones, all of ``pairs`` in one all-reduce."""
    ds = [dot(a, b) for a, b in pairs]
    if reduce is None:
        return ds
    return list(reduce(torch.stack(ds)).unbind(0))


def _norm_hot(a):
    return torch.sqrt(_dot_hot(a, a))


def _bc(s, like):
    """Broadcast a batch-shaped scalar against a field; non-bool scalars are
    cast to the field dtype."""
    s = s[..., None, None]
    return s if s.dtype == torch.bool else s.to(like.dtype)


def _nonzero(a):
    return torch.where(a != 0, a, torch.ones_like(a))


def _positive(a):
    return torch.where(a > 0, a, torch.ones_like(a))


def _kappa_bound(kmin, eps0, eps, j):
    """The running condition-number lower bound (2(j+1)/log(2ε₀/ε))² with
    the signed log of the reference formula; only ε ≈ 2ε₀ is guarded. ``j``
    is the iteration index, a number or a 0-dim float64 tensor (a captured
    CG block reads it from the device)."""
    logr = torch.log(2.0 * eps0 / torch.where(eps > 0, eps, torch.full_like(eps, 1e-300)))
    logr = torch.where(logr.abs() > 1e-12, logr, torch.full_like(logr, 1e-12))
    return torch.maximum(kmin, (2.0 * (j + 1) / logr) ** 2)


# host reads of the solvers' loop flags (CG's and BiCGStab's ``any(active)``,
# GMRES's ``any(~done)`` and ``any(~done_all)``) and of the verification's
# ``any(bad)`` since import (or since a caller last set it to 0): the same
# count on the eager update and on the graphed one, which replays the same
# loops
host_reads = 0


def host_any(flags: torch.Tensor) -> bool:
    """``any(flags)`` read on the host (the span ``host_read``: on a card,
    the wait for the work before it)."""
    global host_reads
    host_reads += 1
    with spans.span("host_read"):
        return bool(flags.any())


@dataclass(frozen=True)
class CGResult:
    x: torch.Tensor
    iters: torch.Tensor      # per-system iteration count (int32)
    converged: torch.Tensor  # per-system bool


class _InPlace:
    """``clone`` and ``load_`` of a dataclass of tensors that a solver
    block updates in place."""

    def clone(self):
        return type(self)(*(getattr(self, f.name).clone() for f in fields(self)))

    def load_(self, other) -> None:
        """Copy ``other``'s values into this state's tensors."""
        for f in fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))


@dataclass
class CGState(_InPlace):
    """Masked batched CG between two blocks of :func:`cg_block`: the
    iterate, residual and direction, the per-system ``rdotz``, κ bound,
    start residual ε₀, safe |b|, iteration count, convergence and activity
    masks, and the iteration index ``j`` (a 0-dim float64 tensor). A block
    updates every field in place, so a captured block reads and writes the
    same memory on every replay."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rdotz: torch.Tensor
    kmin: torch.Tensor
    eps0: torch.Tensor
    safe_normb: torch.Tensor
    iters: torch.Tensor
    conv: torch.Tensor
    active: torch.Tensor
    j: torch.Tensor


def cg_init(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
            apply_P: Callable | None = None, tol=1e-5, active0: torch.Tensor | None = None,
            deflate=None, reduce: Callable | None = None) -> CGState:
    """The start of :func:`cg`: r = b − A·x0 (after the deflated start),
    z = P(r), the start residual and the masks. ``tol`` is a number or a
    0-dim float64 tensor. The state's ``x`` and ``p`` may be ``x0`` and
    ``r`` themselves: clone it (:meth:`CGState.clone`) or load it into
    another state before a block runs on it."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)

    normb = torch.sqrt(_dots([(b, b)], reduce, _dot)[0])
    safe_normb = _positive(normb)
    r = b - apply_A(x0)
    if deflate is not None:
        # two passes, one step of iterative refinement: a float32 WᵀAW
        # factor limits one projection to ~1e-4·|b| in the slow modes
        for _ in range(2):
            x0 = deflation.project(deflate, r, x0, reduce)
            r = b - apply_A(x0)
    z = P(r)
    rdotz, rr0 = _dots([(r, z), (r, r)], reduce, _dot)
    eps0 = torch.sqrt(rr0) / safe_normb

    batch = b.shape[:-2]
    active = torch.ones(batch, dtype=torch.bool, device=b.device)
    if active0 is not None:
        active = active & active0
    active = active & (eps0 >= tol)
    return CGState(x=x0, r=r, p=z, rdotz=rdotz, kmin=torch.zeros_like(normb), eps0=eps0,
                   safe_normb=safe_normb,
                   iters=torch.zeros(batch, dtype=torch.int32, device=b.device),
                   conv=eps0 < tol, active=active,
                   j=torch.zeros((), dtype=torch.float64, device=b.device))


def cg_block(apply_A: Callable, st: CGState, *, apply_P: Callable | None = None, tol=1e-5,
             maxiter: int = 1000, kappa_max: float = 1e12,
             reduce: Callable | None = None) -> None:
    """``CG_SYNC_EVERY`` masked iterations of :func:`cg` on ``st``, in
    place. An iteration changes a system only while it is active and
    ``j < maxiter``, so a block that runs past ``maxiter`` stops where the
    loop does. ``tol`` as in :func:`cg_init`."""
    P = apply_P if apply_P is not None else (lambda v: v)
    for _ in range(CG_SYNC_EVERY):
        act = st.active & (st.j < maxiter)
        Ap = apply_A(st.p)
        pAp, = _dots([(st.p, Ap)], reduce)
        alpha = st.rdotz / _nonzero(pAp)
        x_new = st.x + _bc(alpha, st.x) * st.p
        r_new = st.r - _bc(alpha, st.r) * Ap
        z_new = P(r_new)
        rr, rdotz_new = _dots([(r_new, r_new), (r_new, z_new)], reduce)
        eps = torch.sqrt(rr) / st.safe_normb
        kmin_new = _kappa_bound(st.kmin, st.eps0, eps, st.j)
        done = (eps < tol) | (kmin_new > kappa_max)
        beta = rdotz_new / _nonzero(st.rdotz)
        p_new = z_new + _bc(beta, st.p) * st.p

        m = _bc(act, st.x)
        torch.where(m, x_new, st.x, out=st.x)
        torch.where(m, r_new, st.r, out=st.r)
        torch.where(m, p_new, st.p, out=st.p)
        torch.where(act, rdotz_new, st.rdotz, out=st.rdotz)
        torch.where(act, kmin_new, st.kmin, out=st.kmin)
        st.iters += act.to(torch.int32)
        st.conv |= act & (eps < tol)
        st.active &= ~(act & done)
        st.j += 1


def cg(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       apply_P: Callable | None = None, tol: float = 1e-5, maxiter: int = 1000,
       kappa_max: float = 1e12, active0: torch.Tensor | None = None,
       deflate=None, reduce: Callable | None = None) -> CGResult:
    """Preconditioned CG for SPD ``A`` (``apply_P`` applies P⁻¹). A system
    stops when ``|r|/|b| < tol`` or when the running condition-number lower
    bound ``(2j/log(2ε₀/ε))²`` exceeds ``kappa_max``; ``active0`` masks out
    systems that should not be solved at all. ``deflate`` (a
    :class:`..ops.deflation.DeflationState`, chain axis leading as in ``b``)
    projects the slow modes out of the start before the first iteration.

    ``reduce`` makes the dots global on a site-sharded solve (each rank
    holds a block of sites): two all-reduces per iteration, pᵀAp and then
    |r|² with rᵀz. Every stopping decision then comes from the same bits on
    every rank, so the ranks iterate in step.

    The loop is :func:`cg_init` and then blocks of :func:`cg_block`, with
    ``any(active)`` read on the host before each block."""
    st = cg_init(apply_A, b, x0, apply_P=apply_P, tol=tol, active0=active0, deflate=deflate,
                 reduce=reduce)
    st.x, st.p = st.x.clone(), st.p.clone()
    j = 0
    while j < maxiter and host_any(st.active):
        cg_block(apply_A, st, apply_P=apply_P, tol=tol, maxiter=maxiter, kappa_max=kappa_max,
                 reduce=reduce)
        j += CG_SYNC_EVERY
    return CGResult(x=st.x, iters=st.iters, converged=st.conv)


@dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor
    iters: torch.Tensor
    residual: torch.Tensor
    flag: torch.Tensor  # 0 ok / 1 hit maxiter / 2 false convergence


def solve_checked(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
                  apply_P: Callable | None = None, tol: float = 1e-5,
                  maxiter: int = 1000, kappa_max: float = 1e12,
                  apply_A_check: Callable | None = None, deflate=None,
                  reduce: Callable | None = None) -> SolveResult:
    """CG with residual verification and retry: systems whose true residual
    ``|A·x−b|/|b|`` exceeds √tol are flagged (1 = hit maxiter, 2 = false
    convergence) and re-solved from zero, unpreconditioned, with 10× the
    iteration budget. ``apply_A_check`` (default ``apply_A``) is the operator
    of the verification and the retry; ``deflate`` goes to the first
    :func:`cg` only (the retry starts from zero, undeflated). ``reduce``
    as in :func:`cg`, for the verification too."""
    A_chk = apply_A_check if apply_A_check is not None else apply_A
    res1 = cg(apply_A, b, x0=x0, apply_P=apply_P, tol=tol, maxiter=maxiter,
              kappa_max=kappa_max, deflate=deflate, reduce=reduce)
    return _verify_and_retry(A_chk, b, res1, tol, maxiter, kappa_max,
                             retry=apply_P is not None, reduce=reduce)


def _norms(a, b, reduce):
    """(|a|, |b|) per system, the two dots in one reduction."""
    return [torch.sqrt(d) for d in _dots([(a, a), (b, b)], reduce, _dot)]


def _sqrt_tol(tol):
    """√tol, correctly rounded for a number and for a float64 tensor alike."""
    return torch.sqrt(tol) if torch.is_tensor(tol) else math.sqrt(tol)


@dataclass(frozen=True)
class Verdict:
    """:func:`cg_verify`'s result: the relative true residual, the systems
    above √tol, their flags and the safe |b|."""

    residual: torch.Tensor
    bad: torch.Tensor
    flag: torch.Tensor
    safe_normb: torch.Tensor


def cg_verify(A_chk, b, x, iters, tol, maxiter: int, reduce: Callable | None = None) -> Verdict:
    """Verify a CG solution against ``A_chk``: flag the systems whose
    ``|A·x−b|/|b|`` exceeds √tol (1 = hit ``maxiter``, 2 = false
    convergence). ``tol`` is a number or a 0-dim float64 tensor (√tol is
    correctly rounded either way)."""
    res_norm, normb = _norms(A_chk(x) - b, b, reduce)
    safe_normb = _positive(normb)
    err = res_norm / safe_normb
    bad = err > _sqrt_tol(tol)
    one, two, zero = (torch.full_like(iters, k) for k in (1, 2, 0))
    flag = torch.where(bad, torch.where(iters >= maxiter, one, two), zero)
    return Verdict(residual=err, bad=bad, flag=flag, safe_normb=safe_normb)


def cg_retry(A_chk, b, x, iters, v: Verdict, tol, maxiter: int, kappa_max: float,
             reduce: Callable | None = None) -> SolveResult:
    """Re-solve the systems :func:`cg_verify` flagged from zero by plain
    masked CG with 10× the iteration budget; the others keep ``x``. A
    system stays flagged if the retry leaves it above √tol."""
    x_start = torch.where(_bc(v.bad, x), torch.zeros_like(x), x)
    res2 = cg(A_chk, b, x0=x_start, tol=tol, maxiter=10 * maxiter,
              kappa_max=kappa_max, active0=v.bad, reduce=reduce)
    x = torch.where(_bc(v.bad, x), res2.x, x)
    err2 = _norms(A_chk(x) - b, b, reduce)[0] / v.safe_normb
    still_bad = v.bad & (err2 > _sqrt_tol(tol))
    flag = torch.where(still_bad, v.flag, torch.zeros_like(v.flag))
    return SolveResult(x=x, iters=iters + res2.iters, residual=err2, flag=flag)


def _verify_and_retry(A_chk, b, res1: CGResult, tol: float, maxiter: int, kappa_max: float,
                      retry: bool = True, reduce: Callable | None = None) -> SolveResult:
    """The ladder shared by :func:`solve_checked` and
    :func:`block_solve_checked`: verify ``res1`` against ``A_chk``, flag the
    systems above √tol and re-solve them from zero by plain masked CG. The
    retry runs only when a system failed (one host read)."""
    v = cg_verify(A_chk, b, res1.x, res1.iters, tol, maxiter, reduce)
    if not retry or not host_any(v.bad):
        return SolveResult(x=res1.x, iters=res1.iters, residual=v.residual, flag=v.flag)
    return cg_retry(A_chk, b, res1.x, res1.iters, v, tol, maxiter, kappa_max, reduce)


def cg_split(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
             apply_Linv: Callable, apply_LTinv: Callable, tol: float = 1e-5,
             maxiter: int = 1000, kappa_max: float = 1e12) -> CGResult:
    """CG with a split preconditioner L/Lᵀ: iterates the transformed system
    ``[L⁻¹·A·L⁻ᵀ]·u = L⁻¹·b`` with u = Lᵀ·x carried implicitly. The residual
    criterion is ``|L⁻ᵀL⁻¹(A·x−b)| / |L⁻ᵀL⁻¹b|``; masks and the κ bound as in
    :func:`cg`."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    r = apply_Linv(b - apply_A(x0))
    p = apply_LTinv(r)
    safe_normLb = _positive(_norm(apply_LTinv(apply_Linv(b))))
    eps0 = _norm(p) / safe_normLb
    rdotr = _dot(r, r)
    active = eps0 >= tol
    conv = eps0 < tol
    x = x0
    kmin = torch.zeros_like(eps0)
    iters = torch.zeros(b.shape[:-2], dtype=torch.int32, device=b.device)

    for j in range(maxiter):
        if j % CG_SYNC_EVERY == 0 and not bool(active.any()):
            break
        Ap = apply_A(p)
        alpha = rdotr / _nonzero(_dot_hot(p, Ap))
        x_new = x + _bc(alpha, x) * p
        r_new = r - _bc(alpha, r) * apply_Linv(Ap)
        rdotr_new = _dot_hot(r_new, r_new)
        beta = rdotr_new / _nonzero(rdotr)
        p_new = apply_LTinv(r_new) + _bc(beta, p) * p
        eps = _norm_hot(p_new) / safe_normLb
        kmin_new = _kappa_bound(kmin, eps0, eps, j)
        done = (eps < tol) | (kmin_new > kappa_max)

        m = _bc(active, x)
        x = torch.where(m, x_new, x)
        r = torch.where(m, r_new, r)
        p = torch.where(m, p_new, p)
        rdotr = torch.where(active, rdotr_new, rdotr)
        kmin = torch.where(active, kmin_new, kmin)
        iters = iters + active.to(torch.int32)
        conv = conv | (active & (eps < tol))
        active = active & ~done
    return CGResult(x=x, iters=iters, converged=conv)


def _colsolve(G: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Batched s×s solve G⁻¹·C with the diagonal scaling
    D⁻½·(D⁻½GD⁻½)⁻¹·D⁻½ folded in (a unit diagonal conditions the Gram
    matrix as a per-iteration column normalisation would). s = 2 uses the
    closed-form inverse; larger blocks one batched LU without the error
    check's host read (``torch.linalg.solve_ex``). A complex ``G`` is
    Hermitian: its diagonal is real, and the closed form, which keeps the
    two off-diagonal entries apart, is the inverse of any 2×2 matrix."""
    dg = torch.diagonal(G, dim1=-2, dim2=-1).real
    sc = 1.0 / torch.sqrt(_positive(dg))
    Gh = G * sc[..., :, None] * sc[..., None, :]
    Ch = sc[..., :, None] * C
    if G.shape[-1] == 2:
        a, b, b2, c = Gh[..., 0, 0], Gh[..., 0, 1], Gh[..., 1, 0], Gh[..., 1, 1]
        det = _nonzero(a * c - b * b2)[..., None]
        Y = torch.stack([(c[..., None] * Ch[..., 0, :] - b[..., None] * Ch[..., 1, :]) / det,
                         (a[..., None] * Ch[..., 1, :] - b2[..., None] * Ch[..., 0, :]) / det],
                        dim=-2)
    else:
        Y = torch.linalg.solve_ex(Gh, Ch).result
    return sc[..., :, None] * Y


@dataclass
class BlockCGState(_InPlace):
    """Block CG between two blocks of :func:`block_cg_block`: the iterate,
    residual and search blocks ``[..., s, N, Lτ]``, the per-column safe |b|,
    start residual ε₀ and κ bound, the iteration count, convergence and
    activity masks, and the iteration index ``j`` (a 0-dim float64 tensor).
    A block updates every field in place, as :class:`CGState`'s does."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    safe_normb: torch.Tensor
    eps0: torch.Tensor
    kmin: torch.Tensor
    iters: torch.Tensor
    conv: torch.Tensor
    active: torch.Tensor
    j: torch.Tensor


class _BlockOps:
    """The Grams, norms and block combinations of block CG on right-hand
    sides shaped like ``B`` ``[..., s, N, Lτ]``."""

    def __init__(self, B: torch.Tensor, reduce: Callable | None):
        if B.ndim < 3:
            raise ValueError("block_cg needs [..., s, N, Ltau] right-hand sides")
        self.flat = B.shape[:-2] + (B.shape[-2] * B.shape[-1],)
        self.wide = torch.complex128 if B.is_complex() else torch.float64
        self.reduce = reduce

    def gram(self, U, W):
        """[..., a, b] = Σ conj(U[..., a])·W[..., b] over the field (U†W),
        in float64 or complex128 (the rank's partial on a site shard). The
        JAX package leaves out the conjugate, which is no inner product on
        complex fields."""
        return torch.matmul(U.reshape(self.flat).to(self.wide).conj(),
                            W.reshape(self.flat).to(self.wide).mT)

    def grams(self, *pairs):
        """The Grams of ``pairs``, made global in one all-reduce."""
        gs = [self.gram(U, W) for U, W in pairs]
        return gs if self.reduce is None else list(self.reduce(torch.stack(gs)).unbind(0))

    def norms(self, a, dot=_dot):
        return torch.sqrt(_dots([(a, a)], self.reduce, dot)[0])

    def combine(self, U, coef):
        """Σₐ U[..., a]·coef[..., a, b] as a [..., b] block (no conjugate)."""
        return torch.matmul(coef.to(U.dtype).mT, U.reshape(self.flat)).reshape(U.shape)


def block_cg_init(apply_A: Callable, B: torch.Tensor, X0: torch.Tensor | None = None, *,
                  apply_P: Callable | None = None, tol=1e-5,
                  active0: torch.Tensor | None = None,
                  reduce: Callable | None = None) -> BlockCGState:
    """The start of :func:`block_cg`: R = B − A·X0, Z = P(R), the per-column
    start residual and masks, and the first search block (Z with the
    inactive columns zeroed, each column normalised). ``tol`` is a number or
    a 0-dim float64 tensor. The state's ``x`` may be ``X0`` itself: clone
    it or load it into another state before a block runs on it."""
    bo = _BlockOps(B, reduce)
    if X0 is None:
        X0 = torch.zeros_like(B)
    P = apply_P if apply_P is not None else (lambda v: v)
    R = B - apply_A(X0)
    Z = P(R)
    normb, normr = (torch.sqrt(d) for d in _dots([(B, B), (R, R)], reduce, _dot))
    safe_normb = _positive(normb)               # [..., s]
    eps0 = normr / safe_normb

    batch = B.shape[:-2]
    active = torch.ones(batch, dtype=torch.bool, device=B.device)
    if active0 is not None:
        active = active & active0
    active = active & (eps0 >= tol)

    Pd = Z * _bc(active, Z)
    Pd = Pd / _bc(_positive(bo.norms(Pd, _dot_hot)), Pd)
    return BlockCGState(x=X0, r=R, p=Pd, safe_normb=safe_normb, eps0=eps0,
                        kmin=torch.zeros_like(eps0),
                        iters=torch.zeros(batch, dtype=torch.int32, device=B.device),
                        conv=eps0 < tol, active=active,
                        j=torch.zeros((), dtype=torch.float64, device=B.device))


def block_cg_block(apply_A: Callable, st: BlockCGState, *, apply_P: Callable | None = None,
                   tol=1e-5, maxiter: int = 1000, kappa_max: float = 1e12,
                   reduce: Callable | None = None) -> None:
    """``CG_SYNC_EVERY`` masked iterations of :func:`block_cg` on ``st``,
    in place, with no host read. An iteration changes a column only while
    it is active and ``j < maxiter``. ``tol`` as in :func:`block_cg_init`."""
    bo = _BlockOps(st.x, reduce)
    P = apply_P if apply_P is not None else (lambda v: v)
    s = st.x.shape[-3]
    eye = torch.eye(s, dtype=bo.wide, device=st.x.device)
    for _ in range(CG_SYNC_EVERY):
        act = st.active & (st.j < maxiter)
        Pd = st.p * _bc(act, st.p)
        Q = apply_A(Pd)
        G, PR = bo.grams((Pd, Q), (Pd, st.r))
        # frozen slots: a unit diagonal keeps the batched LU non-singular
        G = G + eye * (~act).to(bo.wide)[..., None, :]
        alpha = _colsolve(G, PR) * act[..., None, :].to(bo.wide)
        X_new = st.x + bo.combine(Pd, alpha)
        R_new = st.r - bo.combine(Q, alpha)
        eps = bo.norms(R_new, _dot_hot) / st.safe_normb
        kmin_new = _kappa_bound(st.kmin, st.eps0, eps, st.j)
        done = (eps < tol) | (kmin_new > kappa_max)
        Z_new = P(R_new) * _bc(act & ~done, R_new)
        beta = _colsolve(G, -bo.grams((Q, Z_new))[0])
        Pd_new = Z_new + bo.combine(Pd, beta)

        m = _bc(act, st.x)
        torch.where(m, X_new, st.x, out=st.x)
        torch.where(m, R_new, st.r, out=st.r)
        torch.where(m, Pd_new, torch.zeros_like(Pd_new), out=st.p)
        torch.where(act, kmin_new, st.kmin, out=st.kmin)
        st.iters += act.to(torch.int32)
        st.conv |= act & (eps < tol)
        st.active &= ~(act & done)
        st.j += 1


def block_cg(apply_A: Callable, B: torch.Tensor, X0: torch.Tensor | None = None, *,
             apply_P: Callable | None = None, tol: float = 1e-5, maxiter: int = 1000,
             kappa_max: float = 1e12, active0: torch.Tensor | None = None,
             reduce: Callable | None = None) -> CGResult:
    """Breakdown-guarded block CG: ``A·X = B`` for ``s`` right-hand sides
    ``[..., s, N, Lτ]`` that share the operator, the search block spanning
    all residuals (O'Leary 1980). Leading axes before ``s`` are independent
    blocks (chains).

    * converged columns freeze: they are zeroed out of the direction block
      and the Gram matrix gets a unit diagonal in their slot;
    * the Gram solves are scaled to a unit diagonal (:func:`_colsolve`);
    * α and β come from the explicit Gram solves ``(P†AP)α = P†R`` and
      ``(P†AP)β = −Q†Z``, not from the ρ recursion;
    * the Gram matrices accumulate in float64 (complex128 for complex
      fields), the block updates are field dtype matmuls (TF32 matmuls must
      be off, as they are by default).

    Complex fields (a ℂ-linear Hermitian positive definite ``A`` and ``P``:
    M†M and the complex KPM polynomial) run Hermitian block CG: the Grams
    are U†W and α, β complex s×s solves, so the search spans the complex
    span of the s directions, 2s real directions per iteration for one
    application of ``A`` to the block. The other choice, the real embedding
    with Re(U†W), searches s real directions for the same matvecs: it
    deflates half as much. At s = 1 (the spin-packed trajectory solve of
    complex hopping) this is CG in exact arithmetic.

    ``reduce`` (a site-sharded solve: the site group's sum) makes the Grams
    and norms global, one all-reduce per set: the start's norms, then per
    iteration the pair PᵀAP, PᵀR, the residual norms and QᵀZ. Every rank of
    the group then takes the same decisions and iterates in step.

    The loop is :func:`block_cg_init` and then blocks of
    :func:`block_cg_block`, with ``any(active)`` read on the host before
    each block, as :func:`cg` runs."""
    st = block_cg_init(apply_A, B, X0, apply_P=apply_P, tol=tol, active0=active0,
                       reduce=reduce)
    st.x = st.x.clone()
    j = 0
    while j < maxiter and host_any(st.active):
        block_cg_block(apply_A, st, apply_P=apply_P, tol=tol, maxiter=maxiter,
                       kappa_max=kappa_max, reduce=reduce)
        j += CG_SYNC_EVERY
    return CGResult(x=st.x, iters=st.iters, converged=st.conv)


def block_solve_checked(apply_A: Callable, B: torch.Tensor, X0: torch.Tensor | None = None, *,
                        apply_P: Callable | None = None, tol: float = 1e-5,
                        maxiter: int = 1000, kappa_max: float = 1e12,
                        apply_A_check: Callable | None = None,
                        reduce: Callable | None = None) -> SolveResult:
    """:func:`block_cg` with the residual verification and retry ladder of
    :func:`solve_checked`; failed columns are re-solved by plain
    unpreconditioned masked CG. ``reduce`` as in :func:`block_cg`."""
    A_chk = apply_A_check if apply_A_check is not None else apply_A
    res1 = block_cg(apply_A, B, X0=X0, apply_P=apply_P, tol=tol, maxiter=maxiter,
                    kappa_max=kappa_max, reduce=reduce)
    return _verify_and_retry(A_chk, B, res1, tol, maxiter, kappa_max, reduce=reduce)


@dataclass
class BiCGStabState(_InPlace):
    """Masked batched BiCGStab between two blocks of :func:`bicgstab_block`:
    the iterate, residual, shadow residual r̃, search direction and A·p̂, the
    per-system ρ of the last iteration, α, ω, safe |b|, iteration count,
    convergence and activity masks, and the iteration index ``j`` (a 0-dim
    float64 tensor). A block updates every field in place, as
    :class:`CGState`'s does."""

    x: torch.Tensor
    r: torch.Tensor
    rt: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    rho_old: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    safe_normb: torch.Tensor
    iters: torch.Tensor
    conv: torch.Tensor
    active: torch.Tensor
    j: torch.Tensor


def bicgstab_init(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
                  tol=1e-5) -> BiCGStabState:
    """The start of :func:`bicgstab`: r = r̃ = b − A·x0, the start residual
    and the masks. ``tol`` is a number or a 0-dim float64 tensor. The
    state's ``x`` may be ``x0``, and ``r`` and ``rt`` are one tensor: clone
    it (:meth:`BiCGStabState.clone`) or load it into another state before a
    block runs on it."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    safe_normb = _positive(_norm(b))
    r = b - apply_A(x0)
    eps0 = _norm(r) / safe_normb
    batch = b.shape[:-2]
    return BiCGStabState(x=x0, r=r, rt=r, p=torch.zeros_like(b), v=torch.zeros_like(b),
                         rho_old=torch.ones_like(eps0), alpha=torch.zeros_like(eps0),
                         omega=torch.ones_like(eps0), safe_normb=safe_normb,
                         iters=torch.zeros(batch, dtype=torch.int32, device=b.device),
                         conv=eps0 < tol, active=eps0 >= tol,
                         j=torch.zeros((), dtype=torch.float64, device=b.device))


def bicgstab_block(apply_A: Callable, st: BiCGStabState, *, apply_P: Callable | None = None,
                   tol=1e-5, maxiter: int = 1000) -> None:
    """``CG_SYNC_EVERY`` masked iterations of :func:`bicgstab` on ``st``, in
    place, with no host read. An iteration changes a system only while it
    is active and ``j < maxiter``. ``tol`` as in :func:`bicgstab_init`."""
    P = apply_P if apply_P is not None else (lambda v: v)
    for _ in range(CG_SYNC_EVERY):
        act = st.active & (st.j < maxiter)
        rho = _dot_hot(st.rt, st.r)
        breakdown = rho == 0
        beta = (rho / _nonzero(st.rho_old)) * (st.alpha / _nonzero(st.omega))
        p_new = st.r + _bc(beta, st.r) * (st.p - _bc(st.omega, st.v) * st.v)
        phat = P(p_new)
        v_new = apply_A(phat)
        alpha_new = rho / _nonzero(_dot_hot(st.rt, v_new))
        s = st.r - _bc(alpha_new, st.r) * v_new
        early = _norm_hot(s) / st.safe_normb < tol
        shat = P(s)
        t = apply_A(shat)
        omega_new = _dot_hot(t, s) / _nonzero(_dot_hot(t, t))
        x_early = st.x + _bc(alpha_new, st.x) * phat
        x_full = x_early + _bc(omega_new, st.x) * shat
        r_new = s - _bc(omega_new, st.r) * t
        eps = _norm_hot(r_new) / st.safe_normb
        done = early | (eps < tol) | breakdown | (omega_new == 0)

        m = _bc(act, st.x)
        torch.where(m, torch.where(_bc(early, st.x), x_early, x_full), st.x, out=st.x)
        torch.where(m, r_new, st.r, out=st.r)
        torch.where(m, p_new, st.p, out=st.p)
        torch.where(m, v_new, st.v, out=st.v)
        torch.where(act, rho, st.rho_old, out=st.rho_old)
        torch.where(act, alpha_new, st.alpha, out=st.alpha)
        torch.where(act, omega_new, st.omega, out=st.omega)
        st.iters += act.to(torch.int32)
        st.conv |= act & (early | (eps < tol))
        st.active &= ~(act & done)
        st.j += 1


def bicgstab(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
             apply_P: Callable | None = None, tol=1e-5, maxiter: int = 1000) -> CGResult:
    """Preconditioned BiCGStab for a non-symmetric ``A``, batched with masked
    convergence. A breakdown (ρ = 0 or ω = 0) stops that system through the
    masks; no host branch looks at it.

    The loop is :func:`bicgstab_init` and then blocks of
    :func:`bicgstab_block`, with ``any(active)`` read on the host before
    each block, as :func:`cg` runs. ``tol`` as in :func:`bicgstab_init`."""
    st = bicgstab_init(apply_A, b, x0, tol=tol).clone()
    j = 0
    while j < maxiter and host_any(st.active):
        bicgstab_block(apply_A, st, apply_P=apply_P, tol=tol, maxiter=maxiter)
        j += CG_SYNC_EVERY
    return CGResult(x=st.x, iters=st.iters, converged=st.conv)


@dataclass
class GMRESState(_InPlace):
    """Restarted GMRES on right-hand sides ``[..., N, Lτ]`` with restart
    length m, between two of its pieces (:func:`gmres_init`,
    :func:`gmres_cycle_start`, :func:`gmres_arnoldi_block`,
    :func:`gmres_cycle_close`), each of which updates it in place: the
    iterate, the Krylov basis ``V`` ``[m+1, ..., N, Lτ]`` (one buffer for the
    whole solve) and its rows widened to float64 (complex128 for a complex
    field) ``W`` for the projections' dots, which write their products into
    ``prod`` and the scaled rows into ``rows`` (``[m, ..., N, Lτ]`` each, so
    that no step allocates in proportion to the basis), the Hessenberg
    columns ``H`` ``[..., m+1, m]``, the accumulated Givens rotations ``Qr``
    ``[..., m+1, m+1]``, an Arnoldi step's column ``col`` ``[..., m+1]`` and
    the back-substitution's ``y`` ``[..., m]`` (all float64), the cycle's
    start residual β, the preconditioned |b|, the masks of the systems done
    in this cycle and in earlier ones, and the iteration count."""

    x: torch.Tensor
    V: torch.Tensor
    W: torch.Tensor
    prod: torch.Tensor
    rows: torch.Tensor
    H: torch.Tensor
    Qr: torch.Tensor
    col: torch.Tensor
    y: torch.Tensor
    beta: torch.Tensor
    normb: torch.Tensor
    done: torch.Tensor
    done_all: torch.Tensor
    iters: torch.Tensor


def gmres_state(b: torch.Tensor, restart: int) -> GMRESState:
    """The buffers of a GMRES solve of right-hand sides like ``b`` with
    restart length ``restart``. The basis and the projections' buffers are
    left uninitialised: a cycle reads only the rows it wrote."""
    batch, dev, f64 = tuple(b.shape[:-2]), b.device, torch.float64
    m = restart
    wide = torch.complex128 if b.is_complex() else f64

    def zeros(shape, dtype=f64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return GMRESState(x=torch.zeros_like(b), V=b.new_empty((m + 1,) + tuple(b.shape)),
                      W=b.new_empty((m + 1,) + tuple(b.shape), dtype=wide),
                      prod=b.new_empty((m,) + tuple(b.shape), dtype=f64),
                      rows=b.new_empty((m,) + tuple(b.shape)),
                      H=zeros(batch + (m + 1, m)), Qr=zeros(batch + (m + 1, m + 1)),
                      col=zeros(batch + (m + 1,)), y=zeros(batch + (m,)), beta=zeros(batch),
                      normb=zeros(batch), done=zeros(batch, torch.bool),
                      done_all=zeros(batch, torch.bool), iters=zeros(batch, torch.int32))


def _gmres_P(apply_P, side: str):
    """(P, right): the preconditioner's apply (the identity for None) and
    whether it is applied on the right."""
    P = apply_P if apply_P is not None else (lambda v: v)
    return P, apply_P is not None and side == "right"


def gmres_init(st: GMRESState, b: torch.Tensor, x0: torch.Tensor | None = None, *,
               apply_P: Callable | None = None, side: str = "right") -> None:
    """The start of :func:`gmres` on ``st``, in place: |b| (|P·b| with left
    preconditioning), x = ``x0`` (zero for None), no iteration and no
    system done."""
    P, right = _gmres_P(apply_P, side)
    st.normb.copy_(_positive(_norm(b if right else P(b))))
    if x0 is None:
        st.x.zero_()
    else:
        st.x.copy_(x0)
    st.iters.zero_()
    st.done_all.zero_()


def gmres_cycle_start(apply_A: Callable, b: torch.Tensor, st: GMRESState, *,
                      apply_P: Callable | None = None, tol=1e-5, side: str = "right") -> None:
    """The start of a restart cycle, in place: the residual, β and the first
    basis row, H and the rotations reset, the systems already below ``tol``
    done. ``tol`` is a number or a 0-dim float64 tensor."""
    P, right = _gmres_P(apply_P, side)
    r = (b - apply_A(st.x)) if right else P(b - apply_A(st.x))
    st.beta.copy_(_norm_hot(r))
    st.V[0].copy_(r / _bc(_positive(st.beta), r))
    st.W[0].copy_(st.V[0])
    st.H.zero_()
    st.Qr.zero_()
    torch.diagonal(st.Qr, dim1=-2, dim2=-1).fill_(1.0)
    st.done.copy_(st.done_all | (st.beta / st.normb < tol))


def _project(st: GMRESState, w, n):
    """Coefficients of ``w`` on the first ``n`` basis rows, and ``w`` with
    them removed: :func:`..utils.dtypes.fdot` of the rows and ``w`` (the
    widened rows ``st.W`` times ``w`` widened, summed over the field), the
    products written into ``st.prod`` and the scaled rows into
    ``st.rows``."""
    W, prod = st.W[:n], st.prod[:n]
    wide = w.to(W.dtype)[None]
    dims = (-2, -1)
    if W.is_complex():
        # Re(a†b) = Re(a)·Re(b) + Im(a)·Im(b), as fdot sums it
        h = torch.mul(W.real, wide.real, out=prod).sum(dim=dims)
        h = h + torch.mul(W.imag, wide.imag, out=prod).sum(dim=dims)
    else:
        h = torch.mul(W, wide, out=prod).sum(dim=dims)                # [n, ...]
    rows = torch.mul(st.V[:n], h[..., None, None].to(w.dtype), out=st.rows[:n])
    return h, w - rows.sum(dim=0)


def gmres_arnoldi_block(apply_A: Callable, st: GMRESState, i0: int, *,
                        apply_P: Callable | None = None, tol=1e-5, side: str = "right") -> None:
    """The Arnoldi steps ``i0`` … ``i0 + CG_SYNC_EVERY − 1`` (up to the
    restart length) of a cycle, in place, each on the fixed slices
    ``V[:i+1]``: the new basis row, the Hessenberg column rotated by the
    accumulated rotations and a new rotation, the residual estimate. A
    system done in this cycle freezes (zero basis rows and columns, its
    rotations stop) and stops counting iterations. ``tol`` as in
    :func:`gmres_cycle_start`."""
    P, right = _gmres_P(apply_P, side)
    m = st.H.shape[-1]
    for i in range(i0, min(i0 + CG_SYNC_EVERY, m)):
        done = st.done
        w = apply_A(P(st.V[i])) if right else P(apply_A(st.V[i]))
        h, w = _project(st, w, i + 1)
        h2, w = _project(st, w, i + 1)
        hip = _norm_hot(w)
        st.V[i + 1].copy_(torch.where(_bc(done, w), torch.zeros_like(w),
                                      w / _bc(_positive(hip), w)))
        st.W[i + 1].copy_(st.V[i + 1])
        st.col.zero_()
        st.col[..., :i + 1] = torch.movedim(h + h2, 0, -1)
        st.col[..., i + 1] = hip
        col = torch.matmul(st.Qr, st.col[..., None])[..., 0]
        # the new rotation zeroes col[i+1]
        a, c = col[..., i], col[..., i + 1]
        denom = torch.sqrt(a * a + c * c)
        ci = torch.where(denom > 0, a / _positive(denom), torch.ones_like(a))
        si = torch.where(denom > 0, c / _positive(denom), torch.zeros_like(a))
        col[..., i] = ci * a + si * c
        col[..., i + 1].zero_()
        fr = done[..., None]
        qi, qi1 = st.Qr[..., i, :], st.Qr[..., i + 1, :]
        new_qi = torch.where(fr, qi, ci[..., None] * qi + si[..., None] * qi1)
        new_qi1 = torch.where(fr, qi1, ci[..., None] * qi1 - si[..., None] * qi)
        st.Qr[..., i, :] = new_qi
        st.Qr[..., i + 1, :] = new_qi1
        st.H[..., :, i] = torch.where(fr, torch.zeros_like(col), col)
        eps = (st.beta * st.Qr[..., i + 1, 0]).abs() / st.normb
        st.iters += (~done).to(torch.int32)
        st.done |= eps < tol


def gmres_cycle_close(st: GMRESState, n: int, *, apply_P: Callable | None = None,
                      side: str = "right") -> None:
    """The end of a cycle that ran ``n`` Arnoldi steps, in place: the
    back-substitution y = H[:n, :n]⁻¹·s[:n] (a zero diagonal is a frozen or
    unreached column and stays out of the correction), the update of the
    systems not done before the cycle, and the cycle's done mask kept."""
    P, right = _gmres_P(apply_P, side)
    m = st.H.shape[-1]
    svec = st.beta[..., None] * st.Qr[..., :m, 0]
    st.y.zero_()
    for k in range(n - 1, -1, -1):
        hkk = st.H[..., k, k]
        val = (svec[..., k] - (st.H[..., k, :] * st.y).sum(dim=-1)) / _nonzero(hkk)
        st.y[..., k] = torch.where(hkk != 0, val, torch.zeros_like(val))
    if n:
        dt = st.V.dtype
        dx = (st.V[:n] * torch.movedim(st.y[..., :n], -1, 0)[..., None, None].to(dt)).sum(dim=0)
        if right:
            dx = P(dx)
        torch.where(_bc(st.done_all, st.x), st.x, st.x + dx, out=st.x)
    st.done_all.copy_(st.done)


def gmres_cycles(maxiter: int, restart: int) -> int:
    """The restart cycles of :func:`gmres` within ``maxiter`` iterations."""
    return max(1, -(-maxiter // restart))


def gmres_iterate(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
                  apply_P: Callable | None = None, tol=1e-5, maxiter: int = 1000,
                  restart: int = 20, side: str = "right") -> GMRESState:
    """The loop of :func:`gmres`, its final state returned: for a caller
    that verifies x itself (``dynamics/solve.py``), as the JAX package's
    compiled solves leave out :func:`gmres`'s unused residual check."""
    m = restart
    kw = dict(apply_P=apply_P, side=side)
    st = gmres_state(b, m)
    gmres_init(st, b, x0, **kw)
    for _ in range(gmres_cycles(maxiter, m)):
        if not host_any(~st.done_all):
            break
        gmres_cycle_start(apply_A, b, st, tol=tol, **kw)
        n = 0
        for i0 in range(0, m, CG_SYNC_EVERY):
            if not host_any(~st.done):
                break
            gmres_arnoldi_block(apply_A, st, i0, tol=tol, **kw)
            n = min(i0 + CG_SYNC_EVERY, m)
        gmres_cycle_close(st, n, **kw)
    return st


def gmres(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
          apply_P: Callable | None = None, tol=1e-5, maxiter: int = 1000,
          restart: int = 20, side: str = "right") -> CGResult:
    """Preconditioned restarted GMRES, batched over the leading axes of ``b``.

    All systems share one restart-cycle loop: the Krylov basis ``V`` is
    ``[m+1, ..., N, Lτ]`` (one buffer for the whole solve), the Hessenberg
    and rotation state is per system (``[..., m+1, m]``, float64). A system
    that converges inside a cycle freezes: its basis rows are zero, its
    Hessenberg columns are zero and its rotations stop, so floor-level
    Arnoldi columns never reach the back-substitution. Converged systems
    stop counting iterations and take no update at later restarts.

    Orthogonalisation is classical Gram-Schmidt applied twice, each pass one
    batched product against the whole basis (the JAX package's modified
    Gram-Schmidt is a loop over basis rows). The Givens rotations are kept
    as their accumulated product ``Qr`` ``[..., m+1, m+1]``: a new Hessenberg
    column is rotated by one batched product, and the residual estimate is
    ``β·Qr[:, 0]``.

    ``side`` selects right (default) or left preconditioning. Right solves
    (A·P)u = b with x = P·u, whose Givens estimate is the true residual;
    left tracks ‖P(b−Ax)‖.

    The loop (:func:`gmres_iterate`) is :func:`gmres_init` and, per restart
    cycle, :func:`gmres_cycle_start`, blocks of ``CG_SYNC_EVERY`` Arnoldi
    steps (:func:`gmres_arnoldi_block`) and :func:`gmres_cycle_close` over a
    :class:`GMRESState`. Host reads (:func:`host_any`): ``any(~done)``
    before each block (leaving a cycle early changes nothing: frozen
    systems contribute zero columns) and ``any(~done_all)`` before each
    cycle. ``converged`` is the true relative residual |A·x − b|/|b| below
    √tol. ``tol`` is a number or a 0-dim float64 tensor."""
    st = gmres_iterate(apply_A, b, x0, apply_P=apply_P, tol=tol, maxiter=maxiter,
                       restart=restart, side=side)
    err = _norm(apply_A(st.x) - b) / _positive(_norm(b))
    return CGResult(x=st.x, iters=st.iters, converged=err < _sqrt_tol(tol))
