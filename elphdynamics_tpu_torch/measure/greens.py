"""Stochastic Green's-function estimation.

Counterpart of ``elphdynamics_tpu/measure/greens.py``. Per measurement, nᵥ
Gaussian probes R and their solutions M⁻¹R estimate the
single-particle Green's function; every unordered pair (i, j) of probes
builds translation-averaged two- and four-point tensors by space-time FFT
convolution with an antiperiodic doubling of the τ axis. Only the pair sums
are formed (every measurement is linear in the per-pair tensors), and the
two-point sum uses the bilinearity identity
Σ_{i<j} conv(aᵢ+aⱼ, bᵢ+bⱼ)/2 = [(nᵥ−2)·Σᵢconv(aᵢ,bᵢ) + conv(Σa, Σb)]/2.

Chains: fields carry a leading chain axis. Probes and solutions are
``[C, nᵥ, N, Lτ]`` and the nᵥ·C systems are one batched solve (with
``[solver] block`` a block CG over each chain's nᵥ probes, which share its
operator); pair tensors are ``[C, nₒ, nₒ, L1, L2, L3, 2Lτ]``.

Complex hopping (the time-reversal-symmetric twist ensemble, G↓ = conj G↑):
the probes are circular complex normals, M⁻¹R ⊙ conj(R) estimates the
spin-↑ Green's function, and every pair tensor is the spin sum of its real
meaning, so the assembly downstream is unchanged (see :class:`PairTensors`).

The transforms are ``torch.fft`` (full precision of the field's complex
type, no TF32). The JAX package's DFT-matmul lowering of these transforms
was a TPU choice and is not carried over; whether a matmul form wins on the
card is left to a measurement.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics.solve import SolverConfig, resolve_precond, solve_minv
from elphdynamics_tpu_torch.models.adapter import ModelOps, global_sites, local_sites
from elphdynamics_tpu_torch.utils.dtypes import field_dtype, trace_noise

FFT_DIMS = (-4, -3, -2, -1)


@dataclass(frozen=True)
class GreensData:
    R: torch.Tensor       # [C, nv, N, Lτ] probes
    MinvR: torch.Tensor   # [C, nv, N, Lτ]
    iters: torch.Tensor   # [C] mean CG iterations per probe solve
    flag: torch.Tensor    # [C] max solver flag


def draw_probes(ops: ModelOps, params, x, nv: int,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """The nᵥ probes per chain of fields ``x`` ``[C, N, Lτ]``: unit normals,
    circular complex normals under complex hopping; a site-sharded model
    draws every site's and keeps its block."""
    return local_sites(ops, trace_noise((x.shape[0], nv, global_sites(ops), ops.Ltau),
                                        field_dtype(params, x.dtype), x.device, generator))


def sample_greens(ops: ModelOps, params, x, nv: int, scfg: SolverConfig, precond=None,
                  generator: torch.Generator | None = None, R=None) -> GreensData:
    """Draw nᵥ probes per chain (or take ``R`` ``[C, nᵥ, N, Lτ]``) and solve
    M·z = r for all of them at once by the configured solver kind, with the
    preconditioner set up at ``x`` ``[C, N, Lτ]``."""
    if R is None:
        R = draw_probes(ops, params, x, nv, generator)
    derived = ops.derived(params, x)
    pa = resolve_precond(precond, params, x)
    # a chain's nᵥ systems share its operator: eligible for block CG
    sol = solve_minv(ops, params, ops.stack(derived), R, scfg, pa, block=True)
    return GreensData(R=R, MinvR=sol.x, iters=sol.iters.sum(dim=1) // nv,
                      flag=sol.flag.amax(dim=1))


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def to_cell_layout(lattice, v: torch.Tensor) -> torch.Tensor:
    """``[..., N, T] -> [..., nₒ, L1, L2, L3, T]`` (sites run orbit fastest,
    then l1, l2, l3)."""
    no = lattice.unit_cell.norbits
    lead = tuple(v.shape[:-2])
    v = v.reshape(lead + (lattice.L3, lattice.L2, lattice.L1, no, v.shape[-1]))
    nd = v.ndim
    return v.permute(tuple(range(nd - 5)) + (nd - 2, nd - 3, nd - 4, nd - 5, nd - 1))


def antiperiodic_double(v: torch.Tensor) -> torch.Tensor:
    """τ axis L → 2L with a sign flip."""
    return torch.cat([v, -v], dim=-1)


def periodic_double(v: torch.Tensor) -> torch.Tensor:
    """τ axis L → 2L by repetition."""
    return torch.cat([v, v], dim=-1)


def _neg_index(A: torch.Tensor, dims) -> torch.Tensor:
    """``A[-k mod L]`` along ``dims``: reverse, then roll by one."""
    for d in dims:
        A = torch.roll(torch.flip(A, dims=(d,)), 1, dims=d)
    return A


def convolve(a: torch.Tensor, b: torch.Tensor, V: int) -> torch.Tensor:
    """Translation-averaged outer-orbital convolution: ``a``, ``b``
    ``[..., nₒ, L1, L2, L3, T]`` give ``[..., nₒ(a), nₒ(b), L1, L2, L3, T]``
    with ``out[s₂, s₁, Δ] = Σᵢ a[s₂, i+Δ]·b[s₁, i] / V``."""
    A = torch.fft.fftn(a, dim=FFT_DIMS)
    Bneg = _neg_index(torch.fft.fftn(b, dim=FFT_DIMS), FFT_DIMS)
    return torch.fft.ifftn(A.unsqueeze(-5) * Bneg.unsqueeze(-6) / V, dim=FFT_DIMS)


def translational_average(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``fg(Δ) = (1/V)·Σᵢ f(i+Δ)·g(i)`` over the trailing 4 axes."""
    V = f.shape[-1] * f.shape[-2] * f.shape[-3] * f.shape[-4]
    F = torch.fft.fftn(f, dim=FFT_DIMS)
    G = torch.fft.fftn(g, dim=FFT_DIMS)
    return torch.fft.ifftn(F * _neg_index(G, FFT_DIMS) / V, dim=FFT_DIMS)


# ---------------------------------------------------------------------------
# pair tensors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PairTensors:
    """Pair-summed estimator tensors ``[C, nₒ, nₒ, L1, L2, L3, 2Lτ]``
    (complex): sums over the C(nᵥ,2) unordered probe pairs.

    Under complex hopping each is the spin-averaged generalisation of its
    real meaning: G = Re G↑; GG = G↑·G↓; GDD_G00 = Re GΔΔ·Re G00;
    G0D_GD0 = Re[GΔ0·G0Δ]; GDD_minus = −Im GΔΔ·Im G00 (the Sz–Sz direct
    term, None for real hopping); G_up the per-spin complex G↑ (None for
    real hopping)."""

    G: torch.Tensor          # GΔ0
    GG: torch.Tensor         # GΔ0·GΔ0
    GDD_G00: torch.Tensor    # GΔΔ·G00
    G0D_GD0: torch.Tensor    # GΔ0·G0Δ
    n_pairs: int
    GDD_minus: torch.Tensor | None = None
    G_up: torch.Tensor | None = None


def pair_indices(nv: int):
    return np.triu_indices(nv, k=1)


def pair_tensor_sums(lattice, R: torch.Tensor, MinvR: torch.Tensor,
                     pairs=None) -> PairTensors:
    """The pair-summed tensors from ``[C, nᵥ, N, Lτ]`` probes and
    solutions. Complex probes (complex hopping): conj on every probe of a
    same-vector pairing (G↑ = E[M⁻¹R ⊙ conj R]); each unordered pair gives
    vector i to spin ↑ and j to spin ↓ = conj, and the spin sums become
    real parts (per factor for the direct products, of the whole
    convolution for the same-spin exchange). ``pairs``: :func:`pair_indices`
    as index tensors on the probes' device (uploaded here when None)."""
    nv, Ltau = R.shape[-3], R.shape[-1]
    V = 2 * Ltau * lattice.ncells
    cplx = R.is_complex()
    Rc = to_cell_layout(lattice, R)        # [C, nv, no, L1, L2, L3, L]
    Mc = to_cell_layout(lattice, MinvR)
    if cplx:
        Rc = Rc.conj()                      # the estimator's probe side
    Ra, Ma = antiperiodic_double(Rc), antiperiodic_double(Mc)
    V_AX = -6                               # the probe axis in cell layout

    # GΔ0 by the bilinearity identity
    diag_sum = convolve(Ma, Ra, V).sum(dim=V_AX - 1)
    tot = convolve(Ma.sum(dim=V_AX), Ra.sum(dim=V_AX), V)
    G = ((nv - 2) * diag_sum + tot) / 2.0
    G_up = None
    if cplx:
        # per spin, and the spin average (G↑+G↓)/2 = Re G↑ (kept in the
        # complex type, as every pair tensor is)
        G_up, G = G, G.real.to(G.dtype)

    iu, ju = (torch.as_tensor(i, device=R.device)
              for i in (pair_indices(nv) if pairs is None else pairs))
    Mi, Mj = Mc.index_select(V_AX, iu), Mc.index_select(V_AX, ju)
    Ri, Rj = Rc.index_select(V_AX, iu), Rc.index_select(V_AX, ju)

    def pair_sum(a, b):
        return convolve(periodic_double(a), periodic_double(b), V).sum(dim=V_AX - 1)

    if not cplx:
        return PairTensors(G=G, GG=pair_sum(Mi * Mj, Ri * Rj),
                           GDD_G00=pair_sum(Mj * Rj, Mi * Ri),
                           G0D_GD0=pair_sum(Mi * Rj, Mj * Ri), n_pairs=len(iu))
    # opposite spins: the j side is conjugated wholesale (M and probe)
    GG = pair_sum(Mi * Mj.conj(), Ri * Rj.conj())
    Di, Dj = Mi * Ri, Mj * Rj                # the density fields M⁻¹R ⊙ conj R
    dd_plus = pair_sum(Dj, Di)               # GΔΔ·G00
    dd_cross = pair_sum(Dj, Di.conj())       # GΔΔ·conj(G00)
    cdt = G.dtype
    return PairTensors(G=G, GG=GG, GDD_G00=((dd_plus + dd_cross).real / 2.0).to(cdt),
                       G0D_GD0=pair_sum(Mi * Rj, Mj * Ri).real.to(cdt), n_pairs=len(iu),
                       GDD_minus=((dd_plus - dd_cross).real / 2.0).to(cdt), G_up=G_up)
