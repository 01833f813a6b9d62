"""Adaptive two-level near-null preconditioner for the deep-β solves.

Counterpart of ``elphdynamics_tpu/ops/nearnull.py`` (beyond the reference;
``[solver.nearnull]``). P⁻¹ = P⁻¹_KPM + W·G⁻¹·Wᵀ over a τ-chunked near-null
space: ``k`` test vectors per chain, smoothed by inverse iteration with the
KPM-preconditioned CG (at setup, and re-smoothed for ``refresh_iters``
iterations at every refresh), are cut into τ-chunks of ``c`` slices and
orthonormalised per chunk. The Galerkin matrix G = (MW)ᵀ(MW) is assembled
exactly from two ``mulM`` calls on chunk-parity-coloured column sums (M
spreads one τ slice, so chunks of the same parity have disjoint images); it
is block-tridiagonal over chunks with the antiperiodic corner, assembled
dense, ``[C, D, D]`` with D = (Lτ/c)·k.

G⁻¹ comes from a Cholesky factorisation in float64 of the Jacobi-scaled G
plus ``reg``·I, the matrix the JAX package inverts by a Newton–Schulz sweep
(a TPU workaround for its row-sequential factorisations); a chain whose
factorisation fails gets no coarse correction. Real hopping only: complex
hopping, a missing ``[solver.preconditioner]`` and a solver other than CG
are refused by the configuration.

Fields carry a leading chain axis: ``T`` ``[C, k, N, Lτ]``, the whitening
``C`` ``[C, Lτ/c, k, k]``, ``Ginv`` ``[C, D, D]``.

Setup and refresh are fixed sequences with no host read, so a graphed
sampler call (``dynamics/graphs.py``) captures them: the smoothing is a CG
start and ⌈iters / ``CG_SYNC_EVERY``⌉ masked blocks, the chunk Grams'
factorisation keeps its ``info`` in the state (:func:`check` raises
``torch.linalg.cholesky``'s error from it: at once on an eager call, at
the solve's next host read on a replayed one), and the test vectors sit on
the device from the first setup there.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from elphdynamics_tpu_torch import solvers
from elphdynamics_tpu_torch.ops import kpm
from elphdynamics_tpu_torch.utils.linalg import cholesky_solve


@dataclass(frozen=True)
class NearNullConfig:
    """``[solver.nearnull]`` settings."""

    k: int = 16             # test vectors
    c: int = 4              # τ slices per chunk
    setup_iters: int = 10   # smoothing CG iterations per pass at setup
    setup_passes: int = 2
    refresh_iters: int = 3  # re-smoothing iterations per refresh
    # "smooth": re-smooth T at the current field and re-assemble G;
    # "assemble": keep T, re-assemble G; "freeze": keep the setup's state
    refresh_mode: str = "smooth"
    reg: float = 1e-6       # relative jitter on the chunk Grams and on G
    seed: int = 777         # the test vectors' draw


@dataclass(frozen=True)
class NearNullState:
    T: torch.Tensor     # [C, k, N, Lτ] smoothed test vectors (unit norm)
    C: torch.Tensor     # [C, nt, k, k] per-chunk whitening: B_J = T|_J · C_J
    Ginv: torch.Tensor  # [C, D, D] inverse Galerkin matrix, D = nt·k
    # [C, nt] the chunk Grams' Cholesky info (0: factorised; :func:`check`)
    info: torch.Tensor | None = None
    # [C, k, N, Lτ] the setup's test vectors, which every refresh re-smooths
    T0: torch.Tensor | None = None


def _chunk_counts(Ltau: int, cfg: NearNullConfig) -> tuple[int, int]:
    """(slices per chunk, chunks): ``cfg.c`` when Lτ splits into an even
    number ≥ 4 of chunks of it, else the closest size that does."""
    c = cfg.c
    if Ltau % c or (Ltau // c) % 2 or Ltau // c < 3:
        cands = [cc for cc in range(1, Ltau // 4 + 1)
                 if Ltau % cc == 0 and (Ltau // cc) % 2 == 0 and Ltau // cc >= 4]
        if not cands:
            raise ValueError(f"no viable nearnull chunk size for Ltau={Ltau}")
        c = min(cands, key=lambda cc: abs(cc - cfg.c))
    return c, Ltau // c


def _smooth(ops, params, derived, kst, kcfg, T, iters: int):
    """Inverse-iteration smoothing T ← normalise(A⁻¹T) by ``iters``
    KPM-preconditioned CG iterations (``derived`` stacked for ``T``): the
    loop of ``solvers.cg`` at tol 0 without its host reads, ⌈iters /
    ``CG_SYNC_EVERY``⌉ masked blocks (an iteration past ``iters`` changes
    nothing, so the bits are the loop's)."""
    def A(v):
        return ops.mulMTM(params, derived, v)

    def P(v):
        return kpm.apply_symmetric(ops, kst, v, kcfg)

    st = solvers.cg_init(A, T, apply_P=P, tol=0.0)
    for _ in range(-(-iters // solvers.CG_SYNC_EVERY)):
        solvers.cg_block(A, st, apply_P=P, tol=0.0, maxiter=iters)
    W = st.x
    nrm = torch.sqrt((W * W).sum(dim=(-2, -1), keepdim=True))
    return W / torch.clamp(nrm, min=1e-30)


def _build(ops, params, derived, T, cfg: NearNullConfig) -> NearNullState:
    """Per-chunk orthonormalisation and the exact coloured Galerkin
    assembly; ``derived`` is stacked for ``[C, 2k, N, Lτ]`` fields."""
    Cn, k = T.shape[:2]
    N, Lt = ops.Nsites, ops.Ltau
    c, nt = _chunk_counts(Lt, cfg)
    dtype, device = T.dtype, T.device

    # per-chunk whitening C_J = L_J⁻ᵀ of the chunk Gram S_J = L_J·L_Jᵀ
    Tc = T.reshape(Cn, k, N, nt, c)
    S = torch.einsum("bknts,blnts->btkl", Tc, Tc)
    scale = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1).mean(dim=1) / k
    eye = torch.eye(k, dtype=dtype, device=device)
    S = S + (cfg.reg * scale)[:, None, None, None] * eye
    # torch.linalg.cholesky's factor; its error check (a host read) is check's
    L, info = torch.linalg.cholesky_ex(S)
    Linv = torch.linalg.solve_triangular(L, eye.expand(S.shape).contiguous(), upper=False)
    Cw = Linv.mT

    # M·W columns, two parity-coloured applies (M spreads one τ slice)
    W_all = torch.einsum("bmnL,bLmi->binL", T, Cw.repeat_interleave(c, dim=1))
    odd = ((torch.arange(Lt, device=device) // c) % 2 == 1).to(dtype)
    Y = ops.mulM(params, derived, torch.cat([W_all * (1 - odd), W_all * odd], dim=1))
    # chunk J's image patch: slices J·c .. J·c + c (wrapping) of the parity
    # J mod 2 image, as [C, nt, k, N, c+1]
    tau = ((torch.arange(nt, device=device)[:, None] * c
            + torch.arange(c + 1, device=device)[None, :]) % Lt).reshape(-1)
    Ys = Y.reshape(Cn, 2, k, N, Lt).index_select(-1, tau).reshape(Cn, 2, k, N, nt // 2, 2,
                                                                  c + 1)
    P = torch.diagonal(Ys, dim1=1, dim2=5).permute(0, 3, 5, 1, 2, 4).reshape(
        Cn, nt, k, N, c + 1)

    # the block-tridiagonal bands of G = (MW)ᵀ(MW), with the corner
    Gd = torch.einsum("bJins,bJjns->bJij", P, P)
    Go = torch.einsum("bJin,bJjn->bJij", P[..., -1], torch.roll(P, -1, dims=1)[..., 0])
    J = torch.arange(nt, device=device)
    J1 = (J + 1) % nt
    Z = torch.zeros((Cn, nt, nt, k, k), dtype=dtype, device=device)
    Z[:, J, J] = Gd
    Z[:, J, J1] += Go
    Z[:, J1, J] += Go.mT
    G = Z.permute(0, 1, 3, 2, 4).reshape(Cn, nt * k, nt * k)
    return NearNullState(T=T, C=Cw, Ginv=_spd_inverse(G, cfg), info=info)


def check(nn: NearNullState) -> None:
    """Raise ``torch.linalg.cholesky``'s error where a chunk Gram of ``nn``
    did not factorise (one host read)."""
    if nn.info is None:
        return
    info = nn.info.reshape(-1).cpu()
    bad = torch.nonzero(info).reshape(-1)
    if len(bad):
        b = int(bad[0])
        raise torch.linalg.LinAlgError(
            f"linalg.cholesky: (Batch element {b}): The factorization could not be completed "
            f"because the input is not positive-definite (the leading minor of order "
            f"{int(info[b])} is not positive-definite).")


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _spd_inverse(G: torch.Tensor, cfg: NearNullConfig) -> torch.Tensor:
    """(D⁻½GD⁻½ + reg·I)⁻¹ scaled back by D⁻½, D = diag(G), through a
    float64 Cholesky factorisation; zero for a chain whose factorisation
    fails (its coarse correction vanishes)."""
    G64 = G.to(torch.float64)
    s = torch.rsqrt(torch.clamp(torch.diagonal(G64, dim1=-2, dim2=-1), min=1e-30))
    eye = torch.eye(G.shape[-1], dtype=torch.float64, device=G.device)
    Gs = G64 * s[..., :, None] * s[..., None, :] + cfg.reg * eye
    L, info = torch.linalg.cholesky_ex(Gs)
    X = cholesky_solve(eye.expand(Gs.shape), L)
    X = 0.5 * (X + X.mT)
    X = torch.where((info == 0)[:, None, None], X, torch.zeros_like(X))
    return (X * s[..., :, None] * s[..., None, :]).to(G.dtype)


def apply_correction(ops, nn: NearNullState, r, cfg: NearNullConfig):
    """The coarse correction W·G⁻¹·Wᵀ·r on ``r`` ``[C, ..., N, Lτ]``."""
    N, Lt = ops.Nsites, ops.Ltau
    c, nt = _chunk_counts(Lt, cfg)
    Cn, k = nn.T.shape[:2]
    rc = r.reshape(Cn, -1, N, nt, c)
    Tc = nn.T.reshape(Cn, k, N, nt, c)
    raw = torch.einsum("bmnts,bSnts->bStm", Tc, rc)                 # Tᵀ|chunk · r
    u = torch.einsum("btmi,bStm->bSti", nn.C, raw)                  # whiten
    y = torch.einsum("bDE,bSE->bSD", nn.Ginv, u.reshape(Cn, -1, nt * k))
    w = torch.einsum("btmi,bSti->bStm", nn.C, y.reshape(Cn, -1, nt, k))  # un-whiten
    return torch.einsum("bmnts,bStm->bSnts", Tc, w).reshape(r.shape)


def make_nearnull_precond(ops, kcfg: kpm.KPMConfig, ncfg: NearNullConfig,
                          seed: int = 1234, test_vectors: torch.Tensor | None = None
                          ) -> kpm.Preconditioner:
    """The two-level :class:`..kpm.Preconditioner` (symmetric apply only;
    state ``(KPMState, NearNullState)``). Setup smooths the test vectors and
    assembles G at the update's starting field; each refresh re-smooths the
    setup's test vectors at the current field (``refresh_mode``) and
    re-assembles G, whichever state it is given of those the setup led to.
    The KPM power iteration starts from ``kpm.start_vectors(N, seed)``
    (the preconditioner's ``start``) unless setup is given others;
    ``test_vectors`` ``[k, N, Lτ]`` (default: normals drawn from
    ``ncfg.seed``) seed every chain's T, uploaded once per device and
    dtype. A failed chunk factorisation raises (:func:`check`) at once,
    unless a CUDA graph is capturing the call: the preconditioner's
    ``check`` then runs after a replay."""
    fixed = kpm.start_vectors(ops.Nsites, seed)
    tv0 = test_vectors
    if tv0 is None:
        tv0 = torch.randn((ncfg.k, ops.Nsites, ops.Ltau), dtype=torch.float64,
                          generator=torch.Generator().manual_seed(ncfg.seed))
    uploaded: dict = {}

    def test_vectors_on(device, dtype):
        key = (device, dtype)
        if key not in uploaded:
            if _capturing(device):
                raise RuntimeError("near-null test vectors uploaded during a CUDA graph "
                                   "capture: run the setup once before capturing it")
            uploaded[key] = tv0.to(device=device, dtype=dtype)
        return uploaded[key]

    def checked(nn, x):
        if not _capturing(x.device):
            check(nn)
        return nn

    def setup(params, x, start=None):
        kst = kpm.setup(ops, params, x, kcfg, fixed if start is None else start)
        derived = ops.stack(ops.derived(params, x))
        T = test_vectors_on(x.device, x.dtype).expand(
            (x.shape[0],) + tuple(tv0.shape)).contiguous()
        for _ in range(ncfg.setup_passes):
            T = _smooth(ops, params, derived, kst, kcfg, T, ncfg.setup_iters)
        nn = _build(ops, params, derived, T, ncfg)
        return kst, checked(replace(nn, T0=T.clone()), x)

    def refresh(st, params, x):
        kst = kpm.refresh(ops, st[0], params, x)
        if ncfg.refresh_mode == "freeze":
            return kst, st[1]
        derived = ops.stack(ops.derived(params, x))
        T = st[1].T0
        if ncfg.refresh_mode == "smooth" and ncfg.refresh_iters > 0:
            T = _smooth(ops, params, derived, kst, kcfg, T, ncfg.refresh_iters)
        return kst, checked(replace(_build(ops, params, derived, T, ncfg), T0=st[1].T0), x)

    def symmetric(st, v):
        return kpm.apply_symmetric(ops, st[0], v, kcfg) + apply_correction(ops, st[1], v, ncfg)

    return kpm.Preconditioner(setup=setup, refresh=refresh, symmetric=symmetric, start=fixed,
                              check=lambda st: check(st[1]))
