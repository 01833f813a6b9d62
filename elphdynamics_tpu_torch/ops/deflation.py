"""Incremental slow-mode deflation for the deep-β solves.

Counterpart of ``elphdynamics_tpu/ops/deflation.py`` (beyond the reference;
off unless ``[solver.deflation] k > 0``). A basis ``W`` of ``k``
orthonormal fields per chain is improved once per HMC update by a
degree-``filter_degree`` Chebyshev band-stop filter ``W ← T_d(ℓ(P⁻¹A))·W``
on ``[cutoff·λmax, 1.02·λmax]`` (λmax of P⁻¹A from a power iteration
warm-started from the previous update's vector), re-orthonormalised by QR,
and the Cholesky factor of ``WᵀAW`` is stored. Every CG solve of the update
then corrects its start by the A-orthogonal projection onto span(W)
(:func:`project`, applied twice by ``solvers.cg``): zero extra operator
applications in the loop. The projection can only shrink the A-norm error,
so a basis that has not converged helps less and never breaks a solve.

The state carries a leading chain axis: ``W`` ``[C, k, N, Lτ]``, ``chol``
``[C, k, k]``, ``pvec`` ``[C, N, Lτ]``, ``lam_max`` ``[C]``. The operators
passed to :func:`refresh` act on ``[C, ..., N, Lτ]`` fields (every model
operator and preconditioner apply of the port does). As in the JAX
package the basis is float32 (complex64 under complex hopping, where every
Gram and projection takes the Hermitian product) whatever the field dtype;
the filter's products run in the field dtype and are rounded back to it.

Under site sharding (``reduce``, the site group's sum) the basis and the
power-iteration vector hold the rank's block of sites ``[C, k, B, Lτ]``:
the basis is drawn for the whole lattice and cut (:func:`cut`), the norms,
the ``WᵀAW`` Gram and the projection's ``W†r`` are all-reduced, and the QR
becomes CholeskyQR2 with float64 Grams all-reduced (the JAX package's
``_orthonormalize_psum``). Only span(W) enters the projector, and the span
does not depend on how the sites are cut, so the sharded and one-rank
projectors agree to rounding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from elphdynamics_tpu_torch.utils.device import require_device
from elphdynamics_tpu_torch.utils.dtypes import fdot, real_of
from elphdynamics_tpu_torch.utils.linalg import cholesky_solve


@dataclass(frozen=True)
class DeflationConfig:
    """``[solver.deflation]`` settings."""

    k: int = 32              # basis size
    filter_degree: int = 8   # Chebyshev filter degree per refresh
    power_iters: int = 4     # λmax(P⁻¹A) power-iteration steps per refresh
    cutoff: float = 1 / 16   # band-stop lower edge as a fraction of λmax


@dataclass(frozen=True)
class DeflationState:
    W: torch.Tensor        # [C, k, N, Lτ] orthonormal basis per chain
    chol: torch.Tensor     # [C, k, k] lower Cholesky factor of WᵀAW (refresh-point A)
    pvec: torch.Tensor     # [C, N, Lτ] power-iteration vector of λmax(P⁻¹A)
    lam_max: torch.Tensor  # [C] current λmax estimate


def init(n_chains: int, k: int, Nsites: int, Ltau: int, dtype: torch.dtype = torch.float32,
         device="cuda", generator: torch.Generator | None = None) -> DeflationState:
    """A random orthonormal basis per chain (useful after a few refreshes);
    a complex ``dtype`` draws a circularly complex basis."""
    device = require_device(device)
    rdt = real_of(dtype)

    def normal(shape):
        if not dtype.is_complex:
            return torch.randn(shape, generator=generator, dtype=rdt, device=device)
        g = torch.randn((2,) + shape, generator=generator, dtype=rdt, device=device)
        return torch.complex(g[0], g[1])

    C = n_chains
    W = _orthonormalize(normal((C, k, Nsites, Ltau)))
    pvec = normal((C, Nsites, Ltau))
    pvec = (pvec / torch.sqrt(fdot(pvec, pvec))[:, None, None]).to(dtype)
    eye = torch.eye(k, dtype=dtype, device=device).expand(C, k, k).contiguous()
    return DeflationState(W=W, chol=eye, pvec=pvec,
                          lam_max=torch.ones(C, dtype=rdt, device=device))


def cut(st: DeflationState, local) -> DeflationState:
    """``st`` with ``local`` (a whole ``[C, ..., N, Lτ]`` field → the rank's
    block of sites) applied to the basis and the power-iteration vector."""
    return DeflationState(W=local(st.W), chol=st.chol, pvec=local(st.pvec),
                          lam_max=st.lam_max)


def _orthonormalize(W: torch.Tensor, reduce: Callable | None = None) -> torch.Tensor:
    """QR over each chain's flattened field axes: ``[C, k, N, Lτ]`` with
    orthonormal rows (columns of a degenerate basis become zero). Only
    span(W) enters the projector, so no Rayleigh-Ritz step is needed. With
    ``reduce`` (the rank's block of sites) CholeskyQR2 instead:
    :func:`_orthonormalize_sharded`."""
    if reduce is not None:
        return _orthonormalize_sharded(W, reduce)
    C, k = W.shape[:2]
    Q, R = torch.linalg.qr(W.reshape(C, k, -1).mT)          # Q: [C, N·Lτ, k]
    d = torch.diagonal(R, dim1=-2, dim2=-1).abs()
    Q = torch.where(d[:, None, :] > 1e-30, Q, torch.zeros_like(Q))
    return Q.mT.reshape(W.shape).to(W.dtype)


def _orthonormalize_sharded(W: torch.Tensor, reduce: Callable) -> torch.Tensor:
    """CholeskyQR2 over the site-sharded flattened field axes of the rank's
    ``[C, k, B, Lτ]`` block: twice, the row Gram W·W† in float64 summed over
    the ranks, its Cholesky factor L (with refresh's jitter, so rows the
    filter made nearly parallel stay factorizable) and W ← L⁻¹·W. A chain
    whose factorisation fails gets a zero basis, as a degenerate column
    gets a zero in the one-rank QR."""
    C, k = W.shape[:2]
    Wf = W.reshape(C, k, -1).to(torch.complex128 if W.is_complex() else torch.float64)
    eye = torch.eye(k, dtype=Wf.dtype, device=W.device)
    for _ in range(2):
        G = reduce(torch.matmul(Wf, Wf.mH))
        jitter = 1e-6 * (torch.diagonal(G, dim1=-2, dim2=-1).real.sum(-1) / k) + 1e-30
        L, info = torch.linalg.cholesky_ex(G + jitter[:, None, None] * eye)
        bad = (info != 0) | torch.isnan(L).flatten(1).any(dim=1)
        L = torch.where(bad[:, None, None], eye, L)
        Wf = torch.linalg.solve_triangular(L, Wf, upper=False)
        Wf = torch.where(bad[:, None, None], torch.zeros_like(Wf), Wf)
    return Wf.reshape(W.shape).to(W.dtype)


def _chain(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain scalar ``[C]`` against a ``[C, ...]`` field."""
    return s.reshape(s.shape + (1,) * (like.ndim - 1))


def refresh(st: DeflationState, apply_A: Callable, apply_P: Callable,
            cfg: DeflationConfig, reduce: Callable | None = None) -> DeflationState:
    """One basis improvement at the current operator: ``power_iters``
    single-field and ``filter_degree`` ``[C, k]``-batched applies of P⁻¹A,
    a batched QR and a k×k Cholesky factor per chain. ``apply_A`` /
    ``apply_P`` take ``[C, ..., N, Lτ]`` fields and return them in the
    field dtype. ``reduce``: the site group's sum of a site-sharded state
    (norms and Grams all-reduced, CholeskyQR2)."""
    vdt, wdt = st.pvec.dtype, st.W.dtype
    edt = real_of(wdt)           # the band edges stay real

    def PA(v):
        return apply_P(apply_A(v))

    def total(t):
        return t if reduce is None else reduce(t)

    v = st.pvec[:, None]
    lam = None
    for _ in range(cfg.power_iters):
        w = PA(v)
        lam = torch.sqrt(total(fdot(w, w)))                   # [C, 1]
        v = (w / torch.clamp(lam, min=1e-30).to(real_of(w.dtype))[..., None, None]).to(vdt)
    pvec = v[:, 0]
    lam_max = (st.lam_max if lam is None else
               torch.clamp(lam[:, 0], min=1e-30).to(st.lam_max.dtype))

    # Chebyshev band-stop filter: ℓ maps [a, b] onto [−1, 1]; |T_d| ≤ 1 in
    # the band and grows like cosh(d·acosh(ℓ(0))) below it, so the slow tail
    # gains ~50× on the bulk per refresh at d = 8
    b_edge = (1.02 * lam_max).to(edt)
    a_edge = (cfg.cutoff * lam_max).to(edt)
    center = _chain((b_edge + a_edge) / 2, st.W)
    half = _chain(torch.clamp((b_edge - a_edge) / 2, min=1e-30).to(edt), st.W)

    def ell(V):   # (c·V − P⁻¹A·V)/e (the sign flip is harmless)
        return ((center * V - PA(V)) / half).to(wdt)

    W0 = st.W
    W1 = ell(W0)
    for _ in range(max(cfg.filter_degree - 1, 0)):
        W0, W1 = W1, (2.0 * ell(W1) - W0).to(wdt)
    W = _orthonormalize(W1, reduce)

    # the projector's normal matrix C_ij = w_i†·A·w_j as one batched matmul
    AW = apply_A(W)
    C, k = W.shape[:2]
    G = total(torch.matmul(W.reshape(C, k, -1).conj().to(AW.dtype), AW.reshape(C, k, -1).mT))
    G = 0.5 * (G + G.mH)
    jitter = 1e-6 * (torch.diagonal(G, dim1=-2, dim2=-1).real.sum(-1) / k) + 1e-30
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    chol, info = torch.linalg.cholesky_ex(G + jitter[:, None, None] * eye)
    # a failed factorisation neutralises that chain's correction (W·0 = 0)
    bad = (info != 0) | torch.isnan(chol).flatten(1).any(dim=1)
    chol = torch.where(bad[:, None, None], eye, chol)
    W = torch.where(_chain(bad, W), torch.zeros_like(W), W)
    return DeflationState(W=W, chol=chol, pvec=pvec, lam_max=lam_max)


def project(st: DeflationState, r0: torch.Tensor, x0: torch.Tensor,
            reduce: Callable | None = None) -> torch.Tensor:
    """The start ``x0`` corrected by the A-orthogonal projection of the error
    onto span(W), through the refresh-point ``WᵀAW`` factor:
    ``x0 + W·(WᵀAW)⁻¹·W†·r0`` with ``r0 = b − A·x0`` ``[C, ..., N, Lτ]``.
    The caller recomputes the exact residual afterwards (A drifts from the
    refresh point along a trajectory). ``reduce`` sums ``W†·r0`` over the
    site group of a site-sharded state."""
    C, k = st.W.shape[:2]
    Wf = st.W.reshape(C, k, -1).to(r0.dtype)
    rf = r0.reshape(C, -1, Wf.shape[-1])                     # [C, S, N·Lτ]
    c = torch.matmul(rf, Wf.conj().mT)                      # [C, S, k]: w_i†·r0
    if reduce is not None:
        c = reduce(c)
    y = cholesky_solve(c.mT, st.chol.to(r0.dtype))            # [C, k, S]
    return x0 + torch.matmul(y.mT, Wf).reshape(r0.shape)
