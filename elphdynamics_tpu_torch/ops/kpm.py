"""KPM (Chebyshev) preconditioner for the fermion-matrix solves.

Counterpart of ``elphdynamics_tpu/ops/kpm.py``. In the
Θ-twisted frequency basis the fermion matrix is block diagonal,
M[ω,ω] = I − e^{−iφ(ω)}·Ā, with Ā the time-averaged single-slice
propagator exp(−Δτ·K̄)·exp(−Δτ·V̄). The preconditioner approximates M⁻¹ per
frequency by a Chebyshev expansion of f(z) = (1 − e^{−iφ}z)⁻¹ over the
spectral window of Ā, run on the stacked-real half spectrum
``[..., N, 2Lω]``: the symmetric apply ≈ (MᵀM)⁻¹ is the transposed pass
then the forward one (CG), the left apply ≈ M⁻¹ the forward pass alone and
the right apply ≈ M⁻ᵀ the transposed pass alone (BiCGStab, GMRES).

Chains: the state carries a leading chain axis. ``expnV_bar`` is
``[C, N]``; ``lam_avg``, ``lam_mag`` and ``active`` are ``[C]``;
``coeff`` is ``[C, M, Lω]``. Fields are ``[C, ..., N, K]``. Holstein's Ā
has one hopping factor for every chain (``cosh_bar`` ``[Nb]``, dense
``expK`` ``[N, N]``); SSH's is τ-averaged from each chain's own field
(``cosh_bar`` ``[C, Nb]``, dense ``expK`` ``[C, N, N]``, rebuilt on every
refresh) with exp(+Δτ·μ) as its diagonal.

Ā is applied as a dense matmul up to ``_DENSE_ABAR_MAX_SITES`` sites, or
through the checkerboard fold: the CUDA kernel for CUDA tensors above
``_PALLAS_ABAR_MIN_SITES`` sites, the plain fold otherwise. Both gates are
the JAX package's TPU-tuned values. On the fold branch every Chebyshev step
is one fused fold (``csrc/ckb_fold_fused.cu`` on CUDA, its plain twin on
the CPU) that also adds its term of the per-ω coefficient sum; the power
iteration and Ā⁻¹ of the setup use the fold itself (``csrc/ckb_fold.cu`` on
CUDA), as does the densification of a dense Ā that the model does not
supply.
Every matmul runs in full precision of the field dtype (the JAX package ran
these at the TPU's DEFAULT precision); choosing a lower precision is a
later, measured change.

On a site-sharded model (``ops.shard``, :mod:`..parallel.lattice_shard`)
Ā stays a fold, the rank's halo fold on its block of sites, with the
composed recurrence; the power-iteration norms are summed over the ranks
and the start vectors are the whole model's, cut to the block.

Two options exist on the dense-Ā branch only, as in the JAX package:
``stacked`` precomputes the dense T_m(Ā′) stack per setup/refresh so that a
pass is one stacked matmul and a coefficient combine, and
``exact_lowfreq = k`` inverts the k lowest Matsubara blocks exactly once
per setup (a complex batched inverse, no host read, on cuSOLVER on a card:
:mod:`..utils.linalg`; the JAX package embeds them in real 2×2 blocks) and leaves the Chebyshev expansion
the rest. The
exact blocks enter the symmetric apply only; the left and right applies see
those frequencies' coefficients zeroed, as in the JAX package.

Complex hopping (twisted boundaries, Peierls phases): Ā is complex, so the
state runs the full-spectrum pipeline of the JAX package's
``_apply_complex``: power iteration on complex vectors, coefficients for all
Lτ frequencies (complex fields have no conjugate symmetry to fold onto a
half), τ→ω, the plain complex recurrence (Āᴴ for the adjoint pass), ω→τ
without a real projection. Ā goes through the same gates; on the fold
branch each step is the CUDA fold in its complex mode plus torch
elementwise passes (the fused step kernel is real-only). ``stacked`` and
``exact_lowfreq`` are ignored on a complex state, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from elphdynamics_tpu_torch.models.adapter import ModelOps
from elphdynamics_tpu_torch.ops import ckb_cuda
from elphdynamics_tpu_torch.ops.checkerboard import CheckerboardSpec, cmul_halves
from elphdynamics_tpu_torch.ops.timefreqfft import omega_to_tau, tau_to_omega
from elphdynamics_tpu_torch.utils import capture, spans
from elphdynamics_tpu_torch.utils.dtypes import complex_of, real_of
from elphdynamics_tpu_torch.utils.linalg import inv_ex

# Chebyshev steps of the complex-hopping pass (``_chebyshev_apply``) since
# import or ``reset_counts``; counted through ``utils/capture.count``, so a
# replayed graph counts its steps again
cheb_steps = {"complex": 0}


def _add_steps(recurrence: str, n: int) -> None:
    cheb_steps[recurrence] += n


def reset_counts() -> None:
    """Set the Chebyshev-step count to 0."""
    cheb_steps["complex"] = 0


@dataclass(frozen=True)
class KPMConfig:
    n_power: int = 20        # power-iteration steps for the spectral bounds
    buf: float = 0.05        # spectral buffer
    c1: float = 1.0          # order = (λhi−λlo)·(c1/φ + c2)
    c2: float = 1.0
    max_order: int = 64      # static cap on the expansion order
    stacked: bool = False    # dense T_m(Ā′) stack per setup/refresh (dense Ā only)
    # τ↔ω by precomputed real DFT matmuls instead of FFTs; None = Lτ <= 256
    dft_matmul: bool | None = None
    exact_lowfreq: int = 0   # exact inverses of the k lowest frequency blocks (dense Ā only)

    def use_dft(self, Ltau: int) -> bool:
        if self.dft_matmul is None:
            return Ltau <= 256
        return self.dft_matmul


@dataclass(frozen=True)
class KPMState:
    """Per-configuration preconditioner state for a batch of C chains."""

    expnV_bar: torch.Tensor  # [C, N] time-averaged exp(−Δτ·V̄)
    cosh_bar: torch.Tensor   # [Nbonds] or per chain [C, Nbonds] averaged coefficients
    sinh_bar: torch.Tensor
    lam_avg: torch.Tensor    # [C] (λhi+λlo)/2
    lam_mag: torch.Tensor    # [C] (λhi−λlo)/2
    coeff: torch.Tensor      # [C, max_order, Lω] complex Chebyshev coefficients
    active: torch.Tensor     # [C] bool
    expK: torch.Tensor | None = None      # dense exp(−Δτ·K̄) [N, N] or [C, N, N]
    expK_inv: torch.Tensor | None = None
    dft_f: torch.Tensor | None = None     # [Lτ, 2Lω] τ→ω DFT table
    dft_b: torch.Tensor | None = None     # [2Lω, Lτ] ω→τ DFT table
    # KPMConfig.stacked: [C, M, N, N] T_m(Ā′) and their transposes
    S_fwd: torch.Tensor | None = None
    S_tr: torch.Tensor | None = None
    # KPMConfig.exact_lowfreq: complex [C, k, N, N] (I − e^{−iφ_j}Ā)⁻¹
    G_low: torch.Tensor | None = None


def _avg_operator(ops: ModelOps, params, derived):
    """Time-averaged Ā pieces: (expnV̄ [C, N], cosh̄, sinh̄). Holstein:
    the τ-mean of exp(−Δτ·V), the model's [Nb] hopping coefficients. SSH:
    exp(+Δτ·μ) for every chain, each chain's τ-mean of its [C, Nb, Lτ]
    coefficient tables."""
    if ops.is_holstein:
        return derived.mean(dim=-1), params.cosht, params.sinht
    cosh_b, sinh_b = derived
    C = cosh_b.shape[0]
    expnV_bar = torch.exp(ops.dtau * params.mu).expand(C, ops.Nsites).contiguous()
    return expnV_bar, cosh_b.mean(dim=-1), sinh_b.mean(dim=-1)


# dense Ā up to this many sites; above _PALLAS_ABAR_MIN_SITES a CUDA field
# takes the kernel fold instead (TPU-tuned gates of the JAX package)
_DENSE_ABAR_MAX_SITES = 4096
_PALLAS_ABAR_MIN_SITES = 2048


def _kernel_fold_available(sinh_bar: torch.Tensor) -> bool:
    """True when Ā can run the CUDA fold kernel: the state is on CUDA."""
    return sinh_bar.is_cuda


def _dense_abar_gate(nsites: int, sinh_bar) -> bool:
    """Densify Ā below the gate; above it the kernel fold carries the
    Chebyshev recurrence."""
    if _kernel_fold_available(sinh_bar) and nsites > _PALLAS_ABAR_MIN_SITES:
        return False
    return nsites <= _DENSE_ABAR_MAX_SITES


def _dense_avg(ops: ModelOps, cosh_bar, sinh_bar):
    """exp(∓Δτ·K̄) as dense matrices, ``[N, N]`` or per chain ``[C, N, N]``
    for per-chain ``[C, Nb]`` coefficients: the identity folded through the
    groups (the CUDA kernel on the card)."""
    sc = ops.spec.ckb
    eye = torch.eye(ops.Nsites, dtype=cosh_bar.dtype, device=cosh_bar.device)
    if cosh_bar.ndim == 2:
        eye = eye.expand((cosh_bar.shape[0],) + tuple(eye.shape)).contiguous()
    return (ckb_cuda.ckb_mul(sc, cosh_bar, sinh_bar, eye),
            ckb_cuda.ckb_inverse_mul(sc, cosh_bar, sinh_bar, eye))


def _chain(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A per-chain scalar ``[C]`` shaped to broadcast against ``v``
    ``[C, ...]``."""
    return s.reshape(s.shape + (1,) * (v.ndim - s.ndim)).to(v.dtype)


def _site_diag(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A per-chain site diagonal ``[C, N]`` shaped against ``v``
    ``[C, ..., N, K]``."""
    return d.reshape(d.shape[:1] + (1,) * (v.ndim - 3) + d.shape[1:] + (1,))


def _dense(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A dense operator, ``[N, N]`` or per chain ``[C, N, N]``, shaped to
    multiply ``v`` ``[C, ..., N, K]``."""
    mat = mat.to(v.dtype)
    if mat.ndim == 2:
        return mat
    return mat.reshape(mat.shape[:1] + (1,) * (v.ndim - 3) + mat.shape[1:])


def _fold_target(ops: ModelOps):
    """What Ā's fold runs on: the model's checkerboard, or on a site-sharded
    model its shard (the halo fold on the rank's block)."""
    return ops.shard if ops.shard is not None else ops.spec.ckb


def _fold(st: KPMState, spec_ckb, v, reverse: bool, sign: float):
    """Ā's hopping factor without a dense matrix: the kernel on CUDA (the
    gate above leaves no other fold there), the plain twin on the CPU; the
    halo fold when ``spec_ckb`` is a site shard."""
    if not isinstance(spec_ckb, CheckerboardSpec):
        return spec_ckb.fold(st.cosh_bar, st.sinh_bar, v, reverse=reverse, sign=sign)
    return ckb_cuda.fold(spec_ckb, st.cosh_bar, st.sinh_bar, v.contiguous(),
                         reverse=reverse, sign=sign)


def _mulA(st: KPMState, spec_ckb, v):
    """Ā·v = exp(−Δτ·K̄)·exp(−Δτ·V̄)·v on ``[C, ..., N, K]`` blocks."""
    w = _site_diag(st.expnV_bar, v) * v
    if st.expK is not None:
        return torch.matmul(_dense(st.expK, v), w)
    return _fold(st, spec_ckb, w, reverse=False, sign=1.0)


def _mulA_T(st: KPMState, spec_ckb, v):
    """Āᵀ·v (the adjoint Āᴴ·v on a complex state: expnV̄ is real, and the
    reversed fold of Hermitian bond blocks is the adjoint)."""
    if st.expK is not None:
        w = torch.matmul(_dense(st.expK, v).mH, v)
    else:
        w = _fold(st, spec_ckb, v, reverse=True, sign=1.0)
    return _site_diag(st.expnV_bar, v) * w


def _mulA_inv(st: KPMState, spec_ckb, v):
    """Ā⁻¹·v."""
    if st.expK_inv is not None:
        w = torch.matmul(_dense(st.expK_inv, v), v)
    else:
        w = _fold(st, spec_ckb, v, reverse=True, sign=-1.0)
    return w / _site_diag(st.expnV_bar, v)


def _dense_A(st: KPMState) -> torch.Tensor:
    """Ā = exp(−Δτ·K̄)·diag(exp(−Δτ·V̄)) per chain, ``[C, N, N]``."""
    return st.expK * st.expnV_bar[:, None, :]


def _build_stack(st: KPMState, M: int):
    """The dense T_m(Ā′) stack ``[C, M, N, N]`` and its per-block transpose:
    Ā′ = (Ā − λavg)/λmag, T₀ = I, T₁ = Ā′, T_{m+1} = 2Ā′T_m − T_{m−1}."""
    A = _dense_A(st)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Ap = A / st.lam_mag[:, None, None] - (st.lam_avg / st.lam_mag)[:, None, None] * eye
    Ts = [eye.expand_as(Ap), Ap]
    for _ in range(M - 2):
        Ts.append(2.0 * torch.matmul(Ap, Ts[-1]) - Ts[-2])
    S = torch.stack(Ts[:M], dim=1)
    return S, S.mT.contiguous()


def _stacked_cheb(S2: torch.Tensor, coeff: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σₘ c_m(ω)·(block m of ``S2``)·w(ω) on the stacked-real layout: one
    stacked real matmul and a complex coefficient combine. Equals the
    recurrence of :func:`_chebyshev_apply_stacked` (``S2`` holds T_m or
    T_mᵀ)."""
    Lw = w.shape[-1] // 2
    mid = (1,) * (w.ndim - 3)
    S2 = S2.to(w.dtype).reshape(S2.shape[:1] + mid + S2.shape[1:])
    t = torch.matmul(S2, w.unsqueeze(-3))                      # [C, ..., M, N, 2Lω]
    tr, ti = t[..., :Lw], t[..., Lw:]
    cshape = coeff.shape[:1] + mid + (coeff.shape[1], 1, Lw)
    cr = coeff.real.to(w.dtype).reshape(cshape)
    ci = coeff.imag.to(w.dtype).reshape(cshape)
    return torch.cat([(cr * tr - ci * ti).sum(dim=-3), (cr * ti + ci * tr).sum(dim=-3)], dim=-1)


def _lowfreq_blocks(st: KPMState, k: int, Ltau: int) -> torch.Tensor:
    """G_j = (I − e^{−iφ_j}Ā)⁻¹ for the k lowest Matsubara frequencies,
    complex ``[C, k, N, N]``, by one batched complex inverse
    (:func:`..utils.linalg.inv_ex`: no error check's host read, its LU on
    cuSOLVER on a card, which a CUDA graph captures).
    Built once per full setup: the ``buf`` window that lets the bounds stay
    frozen along a trajectory covers these blocks equally. The φ_j are a
    kept table (:func:`_table`)."""
    A = _dense_A(st)
    phis = _table(f"phis{Ltau}", k, A.device, A.dtype, lambda n: _phis(n, Ltau))
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    blocks = eye - torch.exp(-1j * phis)[None, :, None, None] * A[:, None]
    return inv_ex(blocks)


def _lowfreq_apply_sym(st: KPMState, ur, ui):
    """Exact G·Gᴴ on the first k frequency columns, given and returned as
    their real and imaginary halves ``[C, ..., N, k]``."""
    G = st.G_low
    u = torch.complex(ur, ui).to(G.dtype)
    t = torch.einsum("ckmn,c...mk->c...nk", G.conj(), u)
    w = torch.einsum("cknm,c...mk->c...nk", G, t)
    return w.real.to(ur.dtype), w.imag.to(ur.dtype)


def _state_is_complex(st: KPMState) -> bool:
    """A complex-hopping state: its hopping factor is complex (expnV̄ is
    always real)."""
    if st.expK is not None:
        return st.expK.is_complex()
    return st.sinh_bar.is_complex()


def _spectral_radius(apply_fn, v0: torch.Tensor, n_chains: int, n_iter: int, shard=None):
    """Power-iteration estimate of the dominant |eigenvalue| per chain, from
    the start vector ``v0`` ``[N, 1]`` shared by all chains (on a site
    shard its block of rows, the norms summed over the ranks)."""
    def norm(a, dim=None):
        if shard is None:
            return torch.linalg.vector_norm(a, dim=dim)
        return torch.sqrt(shard.sum(torch.linalg.vector_norm(a, dim=dim) ** 2))

    v = v0 / norm(v0)
    v = v.expand((n_chains,) + tuple(v0.shape)).contiguous()
    lam = torch.ones(n_chains, dtype=real_of(v0.dtype), device=v0.device)
    for _ in range(n_iter):
        w = apply_fn(v)
        lam = norm(w, dim=(-2, -1))
        safe = torch.where(lam > 0, lam, torch.ones_like(lam))
        v = w / safe[:, None, None]
    return lam


def start_vectors(nsites: int, seed: int = 1234):
    """The two power-iteration start vectors ``[N, 1]`` (float64, CPU):
    fixed for a preconditioner (one generator seed), shared by all chains
    and updates; :func:`setup` moves them to the state's device and dtype."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn((nsites, 1), generator=g, dtype=torch.float64) for _ in range(2))


def _dft_tables(Ltau: int) -> tuple[np.ndarray, np.ndarray]:
    """Real [Lτ, 2Lω] / [2Lω, Lτ] DFT tables reproducing the τ→ω half
    spectrum map and its conjugate-symmetric inverse."""
    from elphdynamics_tpu_torch.ops.timefreqfft import theta

    Lw = (Ltau + 1) // 2
    th = theta(Ltau)
    T = np.fft.fft(th * np.eye(Ltau), axis=-1)
    Wf = np.concatenate([T[:, :Lw].real, T[:, :Lw].imag], axis=1)
    Wb = np.zeros((2 * Lw, Ltau))
    for k in range(2 * Lw):
        u = np.zeros(Lw, dtype=complex)
        if k < Lw:
            u[k] = 1.0
        else:
            u[k - Lw] = 1j
        full = np.concatenate([u, np.conj(u[::-1])[(2 * Lw - Ltau):]])
        Wb[k] = np.real(np.conj(th) * np.fft.ifft(full))
    return Wf, Wb


def _to_half_stacked(st: KPMState, v, Ltau: int, use_dft: bool):
    """[.., N, Lτ] real → stacked-real [.., N, 2Lω] (real then imaginary)."""
    Lw = (Ltau + 1) // 2
    if use_dft:
        return torch.matmul(v, st.dft_f.to(v.dtype))
    u_c = tau_to_omega(v)[..., :Lw]
    return torch.cat([u_c.real, u_c.imag], dim=-1)


def _from_half_stacked(st: KPMState, w, Ltau: int, dtype, use_dft: bool):
    """Stacked-real [.., N, 2Lω] → [.., N, Lτ] real."""
    Lw = (Ltau + 1) // 2
    if use_dft:
        return torch.matmul(w, st.dft_b.to(w.dtype)).to(dtype)
    u = torch.complex(w[..., :Lw], w[..., Lw:])
    full = torch.cat([u, torch.flip(u.conj_physical(), dims=(-1,))[..., (2 * Lw - Ltau):]], dim=-1)
    return omega_to_tau(full, real=True).to(dtype)


# host-built constant tables on a device, per (name, size, device, dtype)
_TABLES: dict = {}


def _table(name: str, n: int, device, dtype, make) -> torch.Tensor:
    """The table ``make(n)`` (float64 numpy) on ``device`` in ``dtype``,
    uploaded once and kept: a captured update (``dynamics/graphs.py``)
    reads the kept tensor and never uploads. A first upload during a
    capture raises."""
    device = torch.device(device)
    key = (name, n, str(device), dtype)
    t = _TABLES.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"KPM table {name!r} uploaded during a CUDA graph capture: "
                               "run the setup once before capturing it")
        t = _TABLES[key] = torch.as_tensor(make(n), device=device).to(dtype)
    return t


def _phis(Lw: int, Ltau: int) -> np.ndarray:
    return 2.0 * np.pi / Ltau * (np.arange(Lw) + 0.5)


def _cheb_nodes(M: int) -> np.ndarray:
    return (np.arange(2 * M) + 0.5) * np.pi / (2 * M)


def setup(ops: ModelOps, params, x, cfg: KPMConfig, start) -> KPMState:
    """Build the KPM state for phonon fields ``x`` ``[C, N, Lτ]``.
    ``start`` is the pair of power-iteration start vectors
    (:func:`start_vectors`; cast to the complex type on a complex state,
    where complex start vectors may be passed too)."""
    if x.ndim != 3:
        raise ValueError(f"x must be [C, N, Ltau], got {tuple(x.shape)}")
    C = x.shape[0]
    derived = ops.derived(params, x)
    expnV_bar, cosh_bar, sinh_bar = _avg_operator(ops, params, derived)
    sc = _fold_target(ops)
    dtype, device = expnV_bar.dtype, expnV_bar.device
    dense = ops.is_holstein and ops.spec.dense_ckb
    expK = params.expK if dense else None
    expK_inv = params.expK_inv if dense else None
    # a site-sharded Ā stays a halo fold: no rank holds a dense matrix
    if (expK is None and ops.shard is None and 0 < ops.spec.ckb.nbonds
            and _dense_abar_gate(ops.Nsites, sinh_bar)):
        expK, expK_inv = _dense_avg(ops, cosh_bar, sinh_bar)
    Ltau = ops.Ltau
    st0 = KPMState(expnV_bar=expnV_bar, cosh_bar=cosh_bar, sinh_bar=sinh_bar,
                   lam_avg=torch.ones(C, dtype=dtype, device=device),
                   lam_mag=torch.ones(C, dtype=dtype, device=device),
                   coeff=torch.zeros((C, 1, 1), dtype=dtype, device=device),
                   active=torch.ones(C, dtype=torch.bool, device=device),
                   expK=expK, expK_inv=expK_inv,
                   dft_f=_table("dft_f", Ltau, device, dtype, lambda n: _dft_tables(n)[0]),
                   dft_b=_table("dft_b", Ltau, device, dtype, lambda n: _dft_tables(n)[1]))

    cplx = _state_is_complex(st0)
    pdtype = complex_of(dtype) if cplx else dtype
    v1, v2 = (s.to(device=device, dtype=pdtype) for s in start)
    e_max = _spectral_radius(lambda v: _mulA(st0, sc, v), v1, C, cfg.n_power, ops.shard)
    e_min = 1.0 / _spectral_radius(lambda v: _mulA_inv(st0, sc, v), v2, C, cfg.n_power,
                                   ops.shard)
    active = (e_min > 0.0) & (e_min < 1.0) & (e_max > 1.0) & ((e_max - e_min) < 2.0)

    lam_lo = torch.clamp((1.0 - 2.0 * cfg.buf) * e_min, min=0.0)
    lam_hi = (1.0 + 2.0 * cfg.buf) * e_max
    lam_avg = (lam_hi + lam_lo) / 2
    lam_mag = (lam_hi - lam_lo) / 2

    # real fields use the lower half spectrum (conjugate symmetry supplies
    # the rest); complex fields need all Lτ frequencies
    Lw = Ltau if cplx else (Ltau + 1) // 2
    phis = _table(f"phis{Ltau}", Lw, device, dtype, lambda n: _phis(n, Ltau))
    M = cfg.max_order
    NM = 2 * M
    nodes = _table("cheb_nodes", M, device, dtype, lambda m: np.cos(_cheb_nodes(m)))   # [NM]
    xs = lam_mag[:, None] * nodes + lam_avg[:, None]                           # [C, NM]
    f = 1.0 / (1.0 - torch.exp(-1j * phis)[None, None, :] * xs[:, :, None])   # [C, NM, Lw]
    cosmat = _table("cheb_cos", M, device, dtype,
                    lambda m: np.cos(np.outer(np.arange(m), _cheb_nodes(m))))
    scale = _table("cheb_scale", M, device, dtype,
                   lambda m: np.where(np.arange(m) == 0, 1.0, 2.0))[:, None] / NM
    coeff = scale * torch.matmul(cosmat.to(f.dtype), f)                         # [C, M, Lw]

    # on the full spectrum the hard frequencies sit at both ends (e^{−iφ} → 1
    # as φ → 0 or 2π): the order follows the distance to the nearer pole
    phis_eff = torch.minimum(phis, 2.0 * np.pi - phis) if cplx else phis
    order = torch.floor((lam_hi - lam_lo)[:, None] * (cfg.c1 / phis_eff + cfg.c2))  # [C, Lw]
    order = torch.clamp(order, 1, M)
    morder = torch.arange(M, device=device)[None, :, None] < order[:, None, :]
    coeff = torch.where(morder, coeff, torch.zeros_like(coeff))
    st = replace(st0, lam_avg=lam_avg, lam_mag=lam_mag, coeff=coeff, active=active)
    # the dense stack and the exact blocks assume a real Ā: a complex state
    # keeps the plain complex recurrence (the JAX package ignores both there)
    if cfg.stacked and expK is not None and not cplx:
        S_fwd, S_tr = _build_stack(st, M)
        st = replace(st, S_fwd=S_fwd, S_tr=S_tr)
    if cfg.exact_lowfreq > 0 and expK is not None and not cplx:
        k = min(cfg.exact_lowfreq, Lw)
        # the exact blocks replace those columns: their Chebyshev
        # coefficients are zeroed so the polynomial adds nothing there
        low = torch.arange(Lw, device=device) < k
        coeff = torch.where(low, torch.zeros_like(st.coeff), st.coeff)
        st = replace(st, G_low=_lowfreq_blocks(st, k, Ltau), coeff=coeff)
    return st


def refresh(ops: ModelOps, st: KPMState, params, x) -> KPMState:
    """Recompute only the averaged operator for the current fields, reusing
    the bounds and coefficients of an earlier :func:`setup`; SSH's dense Ā
    (its hopping factor depends on the fields) is densified anew. The
    result's new tensors (SSH's per-chain τ-means and dense Ā) are what a
    graphed update copies into its kept state (``graphs.Workspace.load``)."""
    derived = ops.derived(params, x)
    expnV_bar, cosh_bar, sinh_bar = _avg_operator(ops, params, derived)
    st = replace(st, expnV_bar=expnV_bar, cosh_bar=cosh_bar, sinh_bar=sinh_bar)
    if not ops.is_holstein and st.expK is not None:
        expK, expK_inv = _dense_avg(ops, cosh_bar, sinh_bar)
        st = replace(st, expK=expK, expK_inv=expK_inv)
    if st.S_fwd is not None:
        S_fwd, S_tr = _build_stack(st, st.coeff.shape[1])
        st = replace(st, S_fwd=S_fwd, S_tr=S_tr)
    return st


def _coeff_halves(coeff, dtype):
    """The complex coefficients ``[C, M, Lω]`` as ``[M, C, 2Lω]``: order m's
    per-chain real | imaginary halves in the field's ``dtype``, each order's
    slice contiguous (built once per pass)."""
    return torch.cat([coeff.real, coeff.imag], dim=-1).to(dtype).transpose(0, 1).contiguous()


def _chebyshev_apply_stacked(ops: ModelOps, st: KPMState, w, coeff, transposed: bool):
    """Σₘ c_m(ω)·T_m(Ā′)·w on the stacked-real layout, Ā′ = (Ā − λavg)/λmag
    (Āᵀ when ``transposed``): the dense recurrence when Ā is dense, the
    fused-step recurrence on the fold branch."""
    if st.expK is None and ops.shard is None:
        return _chebyshev_apply_stacked_fused(ops, st, w, coeff, transposed)
    return _chebyshev_apply_stacked_composed(ops, st, w, coeff, transposed)


def _chebyshev_apply_stacked_composed(ops: ModelOps, st: KPMState, w, coeff,
                                      transposed: bool):
    """The recurrence written out: each step applies Ā (dense matmul or a
    fold) and then the spectral map and the combine as elementwise
    passes."""
    sc = _fold_target(ops)
    mul = _mulA_T if transposed else _mulA
    mag = _chain(st.lam_mag, w)
    shift = _chain(st.lam_avg / st.lam_mag, w)

    halves = _coeff_halves(coeff, w.dtype)

    def Ap(v):
        return mul(st, sc, v) / mag - shift * v

    out = cmul_halves(halves[0], w)
    u_nm1, u_n = w, Ap(w)
    for m in range(1, coeff.shape[1]):
        out = out + cmul_halves(halves[m], u_n)
        u_nm1, u_n = u_n, 2.0 * Ap(u_n) - u_nm1
    return out


def _chebyshev_apply_stacked_fused(ops: ModelOps, st: KPMState, w, coeff,
                                   transposed: bool):
    """The recurrence on the fold branch with each step one fused fold
    (:func:`..ckb_cuda.fold_fused`, the counterpart of the JAX package's
    ``_chebyshev_apply_stacked_pallas``): the exp(−Δτ·V̄) diagonal rides
    the step's ``pre`` (Ā) or ``post`` (Āᵀ), the spectral map its per-chain
    ``a = a_mul/λmag``, ``b = −a_mul·λavg/λmag``, the combine
    ``2·Ap(u) − u₋`` its ``c = −1`` with ``prev``, and the per-ω
    coefficient sum Σₘ c_m ⊙ u_m its ``acc``: step m reads u_m and adds
    c_m ⊙ u_m into the pass's sum (step 0 starts it from w = u_0). A pass is ``max_order`` launches and no other kernel but the
    coefficients' cast, once."""
    sc = ops.spec.ckb
    pre = None if transposed else st.expnV_bar
    post = st.expnV_bar if transposed else None
    inv_mag = (1.0 / st.lam_mag).to(w.dtype)
    shift = (st.lam_avg / st.lam_mag).to(w.dtype)
    halves = _coeff_halves(coeff, w.dtype)
    w = w.contiguous()
    out = torch.empty_like(w)

    def step(u, m: int, a_mul: float, prev=None):
        return ckb_cuda.fold_fused(sc, st.cosh_bar, st.sinh_bar, u, reverse=transposed,
                                   pre=pre, post=post, a=a_mul * inv_mag,
                                   b=-a_mul * shift, c=-1.0, prev=prev, acc=out,
                                   coeff=halves[m], init=m == 0)

    u_nm1, u_n = w, step(w, 0, 1.0)
    for m in range(1, coeff.shape[1]):
        u_nm1, u_n = u_n, step(u_n, m, 2.0, u_nm1)
    return out


def _pass(ops: ModelOps, st: KPMState, w, transposed: bool):
    """One Chebyshev pass on the stacked-real layout: the forward polynomial
    ≈ M⁻¹ per frequency, or the transposed one (conjugate coefficients, Āᵀ)
    ≈ M⁻ᵀ; by the dense stack when the state holds one."""
    coeff = st.coeff.conj_physical() if transposed else st.coeff
    if st.S_fwd is not None:
        return _stacked_cheb(st.S_tr if transposed else st.S_fwd, coeff, w)
    return _chebyshev_apply_stacked(ops, st, w, coeff, transposed)


def _chebyshev_apply(ops: ModelOps, st: KPMState, u, coeff, transposed: bool):
    """Σₘ c_m(ω)·T_m(Ā′)·u on a complex ``[C, ..., N, Lτ]`` frequency block
    (the complex-hopping pass; Āᴴ when ``transposed``): each step applies Ā
    (a dense matmul, or the fold: the CUDA kernel's complex mode on the
    card) and then the spectral map and the combine as elementwise
    passes. The pass is the mark ``kpm.cheb_complex`` in a captured graph
    (``utils/spans.py``)."""
    sc = _fold_target(ops)
    mul = _mulA_T if transposed else _mulA
    mag = _chain(st.lam_mag, u)
    shift = _chain(st.lam_avg / st.lam_mag, u)
    cshape = coeff.shape[:1] + (1,) * (u.ndim - 2) + coeff.shape[2:]

    def Ap(v):
        return mul(st, sc, v) / mag - shift * v

    def cm(m):
        return coeff[:, m].reshape(cshape).to(u.dtype)

    capture.count(_add_steps, "complex", coeff.shape[1])
    with spans.mark("kpm.cheb_complex"):
        out = cm(0) * u
        u_nm1, u_n = u, Ap(u)
        for m in range(1, coeff.shape[1]):
            out = out + cm(m) * u_n
            u_nm1, u_n = u_n, 2.0 * Ap(u_n) - u_nm1
    return out


def _apply_complex(ops: ModelOps, st: KPMState, v, passes):
    """The complex-hopping pipeline: τ→ω on the full spectrum, one complex
    Chebyshev pass per entry of ``passes`` (``transposed``: conjugate
    coefficients and Āᴴ), ω→τ without a real projection."""
    u = tau_to_omega(v)
    for transposed in passes:
        coeff = st.coeff.conj_physical() if transposed else st.coeff
        u = _chebyshev_apply(ops, st, u, coeff, transposed)
    out = omega_to_tau(u, real=False).to(v.dtype)
    active = st.active.reshape(st.active.shape + (1,) * (v.ndim - 1))
    return torch.where(active, out, v)


def _apply(ops: ModelOps, st: KPMState, v, cfg: KPMConfig | None, passes, exact: bool):
    """τ→ω, the Chebyshev ``passes`` (each ``transposed`` or not) on the
    half spectrum, the exact low-frequency blocks where the state holds
    them and ``exact`` asks, ω→τ. Chains whose spectral window is invalid
    get the identity. A complex state takes :func:`_apply_complex`."""
    if _state_is_complex(st):
        return _apply_complex(ops, st, v, passes)
    Ltau = ops.Ltau
    Lw = (Ltau + 1) // 2
    use_dft = cfg is not None and cfg.use_dft(Ltau)
    w_in = _to_half_stacked(st, v, Ltau, use_dft)
    w = w_in
    for transposed in passes:
        w = _pass(ops, st, w, transposed)
    if exact and st.G_low is not None:
        k = st.G_low.shape[1]
        lr, li = _lowfreq_apply_sym(st, w_in[..., :k], w_in[..., Lw:Lw + k])
        w = torch.cat([lr, w[..., k:Lw], li, w[..., Lw + k:]], dim=-1)
    out = _from_half_stacked(st, w, Ltau, v.dtype, use_dft)
    active = st.active.reshape(st.active.shape + (1,) * (v.ndim - 1))
    return torch.where(active, out, v)


def apply_symmetric(ops: ModelOps, st: KPMState, v, cfg: KPMConfig | None = None):
    """P⁻¹ ≈ (MᵀM)⁻¹ on a ``[C, ..., N, Lτ]`` field: the per-ω
    [M⁻ᵀ·M⁻¹] Chebyshev pair (the CG preconditioner; (M†M)⁻¹ = M⁻¹·M⁻ᴴ on
    a complex state)."""
    return _apply(ops, st, v, cfg, (True, False), exact=True)


def apply_left(ops: ModelOps, st: KPMState, v, cfg: KPMConfig | None = None):
    """P⁻¹ ≈ M⁻¹: the forward pass alone (BiCGStab / GMRES on M)."""
    return _apply(ops, st, v, cfg, (False,), exact=False)


def apply_right(ops: ModelOps, st: KPMState, v, cfg: KPMConfig | None = None):
    """P⁻¹ ≈ M⁻ᵀ: the transposed pass alone (BiCGStab / GMRES on Mᵀ)."""
    return _apply(ops, st, v, cfg, (True,), exact=False)


@dataclass(frozen=True)
class Preconditioner:
    """``setup(params, x, start=None)`` runs the full spectral-bounds and
    coefficient build; ``refresh(st, params, x)`` re-derives only the
    averaged operator; ``symmetric(st, v)``, ``left(st, v)`` and
    ``right(st, v)`` apply P⁻¹ (the last two None on a symmetric-only
    preconditioner). A preconditioner also carries its fixed
    power-iteration start vectors (``setup``'s default), which a graphed
    call keeps on the device, a KPM one its configuration, and one whose
    setup or refresh defers an error check (the near-null factorisations)
    ``check(st)``, which raises that error: a replayed call runs it at the
    solve's first host read."""

    setup: object
    refresh: object
    symmetric: object
    left: object = None
    right: object = None
    cfg: KPMConfig | None = None
    start: tuple | None = None
    check: object = None


def make_symmetric_precond(ops: ModelOps, cfg: KPMConfig, seed: int = 1234):
    """Symmetric :class:`Preconditioner` for the CG samplers: full setup once
    per update, cheap refresh and apply inside the solves. The power
    iteration starts from two fixed vectors drawn from ``seed``; a caller
    may pass others to ``setup``."""
    fixed = start_vectors(ops.Nsites if ops.shard is None else ops.shard.N, seed)
    if ops.shard is not None:
        fixed = tuple(ops.shard.local(v) for v in fixed)
    return Preconditioner(
        setup=lambda params, x, start=None: setup(ops, params, x, cfg,
                                                  fixed if start is None else start),
        refresh=lambda st, params, x: refresh(ops, st, params, x),
        symmetric=lambda st, v: apply_symmetric(ops, st, v, cfg),
        cfg=cfg, start=fixed,
    )


def make_precond(ops: ModelOps, cfg: KPMConfig, seed: int = 1234):
    """:class:`Preconditioner` for all three solver kinds: the symmetric
    apply for CG, the left and right ones for BiCGStab and GMRES."""
    return replace(make_symmetric_precond(ops, cfg, seed),
                   left=lambda st, v: apply_left(ops, st, v, cfg),
                   right=lambda st, v: apply_right(ops, st, v, cfg))
