"""Batched conjugate gradient with masked per-system convergence.

Counterpart of the CG part of ``elphdynamics_tpu/solvers.py`` (``cg`` and
``solve_checked``). Fields are ``[..., N, Lτ]``; every leading index is an
independent system. All systems iterate together and stop individually
through masks: an iteration changes nothing for a system that has
converged or hit the κ bound, so extra iterations are harmless.

The JAX loop is a ``lax.while_loop`` whose condition reads ``any(active)``
on the device. Here that flag is read on the host only once every
``CG_SYNC_EVERY`` iterations, and the retry ladder of :func:`solve_checked`
runs only when a verification failed — one host sync per solve for it.

Dot products and norms accumulate in float64
(:mod:`elphdynamics_tpu_torch.utils.dtypes`); scalars are cast back to the
field dtype before they touch a field.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

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


def _norm_hot(a):
    return torch.sqrt(_dot_hot(a, a))


def _bc(s, like):
    """Broadcast a batch-shaped scalar against a field; non-bool scalars are
    cast to the field dtype."""
    s = s[..., None, None]
    return s if s.dtype == torch.bool else s.to(like.dtype)


def _nonzero(a):
    return torch.where(a != 0, a, torch.ones_like(a))


@dataclass(frozen=True)
class CGResult:
    x: torch.Tensor
    iters: torch.Tensor      # per-system iteration count (int32)
    converged: torch.Tensor  # per-system bool


def cg(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       apply_P: Callable | None = None, tol: float = 1e-5, maxiter: int = 1000,
       kappa_max: float = 1e12, active0: torch.Tensor | None = None) -> CGResult:
    """Preconditioned CG for SPD ``A`` (``apply_P`` applies P⁻¹). A system
    stops when ``|r|/|b| < tol`` or when the running condition-number lower
    bound ``(2j/log(2ε₀/ε))²`` exceeds ``kappa_max``; ``active0`` masks out
    systems that should not be solved at all."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    P = apply_P if apply_P is not None else (lambda v: v)

    normb = _norm(b)
    safe_normb = torch.where(normb > 0, normb, torch.ones_like(normb))
    r = b - apply_A(x0)
    z = P(r)
    rdotz = _dot(r, z)
    eps0 = _norm(r) / safe_normb

    batch = b.shape[:-2]
    active = torch.ones(batch, dtype=torch.bool, device=b.device)
    if active0 is not None:
        active = active & active0
    active = active & (eps0 >= tol)
    conv = eps0 < tol
    x, p = x0, z
    kmin = torch.zeros_like(normb)
    iters = torch.zeros(batch, dtype=torch.int32, device=b.device)

    for j in range(maxiter):
        if j % CG_SYNC_EVERY == 0 and not bool(active.any()):
            break
        Ap = apply_A(p)
        pAp = _dot_hot(p, Ap)
        alpha = rdotz / _nonzero(pAp)
        x_new = x + _bc(alpha, x) * p
        r_new = r - _bc(alpha, r) * Ap
        eps = _norm_hot(r_new) / safe_normb
        # the signed log of the reference formula; only ε ≈ 2ε₀ is guarded
        logr = torch.log(2.0 * eps0 / torch.where(eps > 0, eps, torch.full_like(eps, 1e-300)))
        logr = torch.where(logr.abs() > 1e-12, logr, torch.full_like(logr, 1e-12))
        kmin_new = torch.maximum(kmin, (2.0 * (j + 1) / logr) ** 2)
        done = (eps < tol) | (kmin_new > kappa_max)
        z_new = P(r_new)
        rdotz_new = _dot_hot(r_new, z_new)
        beta = rdotz_new / _nonzero(rdotz)
        p_new = z_new + _bc(beta, p) * p

        m = _bc(active, x)
        x = torch.where(m, x_new, x)
        r = torch.where(m, r_new, r)
        p = torch.where(m, p_new, p)
        rdotz = torch.where(active, rdotz_new, rdotz)
        kmin = torch.where(active, kmin_new, kmin)
        iters = iters + active.to(torch.int32)
        conv = conv | (active & (eps < tol))
        active = active & ~done
    return CGResult(x=x, iters=iters, converged=conv)


@dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor
    iters: torch.Tensor
    residual: torch.Tensor
    flag: torch.Tensor  # 0 ok / 1 hit maxiter / 2 false convergence


def solve_checked(apply_A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
                  apply_P: Callable | None = None, tol: float = 1e-5,
                  maxiter: int = 1000, kappa_max: float = 1e12,
                  apply_A_check: Callable | None = None) -> SolveResult:
    """CG with residual verification and retry: systems whose true residual
    ``|A·x−b|/|b|`` exceeds √tol are flagged (1 = hit maxiter, 2 = false
    convergence) and re-solved from zero, unpreconditioned, with 10× the
    iteration budget. ``apply_A_check`` (default ``apply_A``) is the operator
    of the verification and the retry."""
    A_chk = apply_A_check if apply_A_check is not None else apply_A
    res1 = cg(apply_A, b, x0=x0, apply_P=apply_P, tol=tol, maxiter=maxiter,
              kappa_max=kappa_max)
    normb = _norm(b)
    safe_normb = torch.where(normb > 0, normb, torch.ones_like(normb))
    err = _norm(A_chk(res1.x) - b) / safe_normb
    sq = math.sqrt(tol)
    bad = err > sq
    one, two, zero = (torch.full_like(res1.iters, k) for k in (1, 2, 0))
    flag = torch.where(bad, torch.where(res1.iters >= maxiter, one, two), zero)

    if apply_P is None or not bool(bad.any()):
        return SolveResult(x=res1.x, iters=res1.iters, residual=err, flag=flag)

    x_start = torch.where(_bc(bad, res1.x), torch.zeros_like(res1.x), res1.x)
    res2 = cg(A_chk, b, x0=x_start, tol=tol, maxiter=10 * maxiter,
              kappa_max=kappa_max, active0=bad)
    x = torch.where(_bc(bad, res1.x), res2.x, res1.x)
    err2 = _norm(A_chk(x) - b) / safe_normb
    still_bad = bad & (err2 > sq)
    flag = torch.where(still_bad, flag, zero)
    return SolveResult(x=x, iters=res1.iters + res2.iters, residual=err2, flag=flag)
