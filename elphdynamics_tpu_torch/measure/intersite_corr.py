"""Inter-site (bond-pair) correlation functions, batched over chains.

Counterpart of ``elphdynamics_tpu/measure/intersite_corr.py``. For every
pair of bond definitions (n″, n′) — bond n′ runs
orbitals b→a displaced r′ cells, bond n″ runs d→c displaced r″ — the
estimators combine shifted single-orbital fields of the two probes of each
probe pair (i, j) into translational averages:

* BondBond: ⟨K[a,b,r′](τ,r)·K[c,d,r″](0,0)⟩ with
  K = Σ_σ a⁺σ(i+r+r′)·bσ(i+r) — two convolution terms and a δ(a,d) contact
  term;
* CurrentCurrent: the same contractions weighted by the hopping amplitudes
  (bare for Holstein, phonon-modulated per bond and τ for SSH) — eight
  convolution terms and four contact terms;
* BondPairGreens: ⟨Δ[a,b,r′](τ,r)·Δ⁺[c,d,r″](0,0)⟩ — one convolution term
  and the τ = β boundary identities.

The signs and placements are those of the JAX module, which derives them
from the Wick contractions (and documents where the reference code departs
from its own comments).

Fields carry a leading chain axis: the per-probe-pair fields are
``[C, P, nₒ, L1, L2, L3, Lτ]`` with P = nᵥ(nᵥ−1)/2, a result is
``[C, n_bond_pairs, L1, L2, L3, Lτ+1 | 1]``. Bond pairs run in a Python loop
(one pair's fields at a time); within a pair all P probe pairs go through
one batched FFT, and their sum is taken before the inverse transform. The
contact terms index single elements on the device.

Complex hopping (the time-reversal-symmetric twist ensemble, spin ↓ on the
conjugate phases): the probes are stored conjugated (the estimator pairing
is G↑ = E[M⁻¹R ⊙ conj R]); direct (cross-spin) terms take the real part of
each factor, same-spin exchange and contact terms the real part of the
whole product, and BondPairGreens conjugates its spin-↓ factor, with the
per-spin G↑ in its τ = β identities. All are identities for real hopping.
"""

from __future__ import annotations

import numpy as np
import torch

from elphdynamics_tpu_torch.measure import greens as G
from elphdynamics_tpu_torch.models import ssh as Sm

P_AX = 1    # the probe-pair axis of a [C, P, L1, L2, L3, Lτ] field


def _cshift(F, r):
    """F(i+r): a circular shift by −r over the spatial axes (-4, -3, -2)."""
    return torch.roll(F, shifts=(-int(r[0]), -int(r[1]), -int(r[2])), dims=(-4, -3, -2))


def _ta_sum(f, g):
    """Σ over the probe pairs of the translational average
    ``(1/V)·Σᵢ f(i+Δ)·g(i)`` over (L1, L2, L3, Lτ): the sum is taken in
    Fourier space, so one inverse transform serves all pairs."""
    V = f.shape[-1] * f.shape[-2] * f.shape[-3] * f.shape[-4]
    F = torch.fft.fftn(f, dim=G.FFT_DIMS)
    Gn = G._neg_index(torch.fft.fftn(g, dim=G.FFT_DIMS), G.FFT_DIMS)
    return torch.fft.ifftn((F * Gn).sum(dim=P_AX) / V, dim=G.FFT_DIMS)


def _wrap(lat, l):
    return (int(np.mod(l[0], lat.L1)), int(np.mod(l[1], lat.L2)), int(np.mod(l[2], lat.L3)))


def _bond(defs, n):
    """(from-orbital, to-orbital, displacement) of bond definition ``n``."""
    return defs[n][0], defs[n][1], tuple(defs[n][2])


class BondFields:
    """Cell-layout fields of every probe pair: r₁ / M⁻¹r₁ of probe i and
    r₂ / M⁻¹r₂ of probe j, each ``[C, P, nₒ, L1, L2, L3, Lτ]`` complex;
    complex probes (complex hopping) are stored conjugated. ``pair_idx``:
    the pairs' (i, j) indices, arrays (uploaded here) or index tensors on
    the probes' device."""

    def __init__(self, lattice, R, MinvR, pair_idx, cdtype: torch.dtype):
        self.cplx = R.is_complex()
        iu, ju = (torch.as_tensor(i, device=R.device) for i in pair_idx)
        Rc = G.to_cell_layout(lattice, R).to(cdtype)         # [C, nv, no, L1, L2, L3, Lτ]
        if self.cplx:
            Rc = Rc.conj()
        Mc = G.to_cell_layout(lattice, MinvR).to(cdtype)
        self.r1, self.M1 = Rc.index_select(1, iu), Mc.index_select(1, iu)
        self.r2, self.M2 = Rc.index_select(1, ju), Mc.index_select(1, ju)

    def f(self, which: str, orbital: int):
        return getattr(self, which)[:, :, orbital]

    def re(self, v):
        """The real part (kept complex) under complex hopping, else ``v``."""
        return v.real.to(v.dtype) if self.cplx else v


def _finalize_tau(arr, Lt: int, time_dependent: bool, beta_negated: bool):
    """``[..., L1, L2, L3, Lτ] -> [..., Lτ+1]`` (τ = β through
    C(β, r) = C(0, −r)) or ``[..., 1]``."""
    if not time_dependent:
        return arr[..., :1]
    beta = arr[..., 0]
    if beta_negated:
        beta = G._neg_index(beta, (-3, -2, -1))
    return torch.cat([arr, beta[..., None]], dim=-1)


def measure_bondbond(ops, pt, bf: BondFields, bond_pairs, time_dependent: bool):
    """``[C, n_bond_pairs, L1, L2, L3, Lτ+1 | 1]``."""
    spec, Lt, lat = ops.spec, ops.Ltau, ops.spec.lattice
    out = []
    for n2, n1 in bond_pairs:        # (n″, n′)
        d, c, r2v = _bond(spec.bond_defs, n2)
        b, a, r1v = _bond(spec.bond_defs, n1)
        # + 4·⟨b(i+r,τ)a⁺(i+r+r′,τ)⟩⟨d(i,0)c⁺(i+r″,0)⟩: the direct term
        bb = 4.0 * _ta_sum(bf.re(bf.f("M1", b) * _cshift(bf.f("r1", a), r1v)),
                           bf.re(bf.f("M2", d) * _cshift(bf.f("r2", c), r2v)))
        # − 2·⟨b(i+r,τ)c⁺(i+r″,0)⟩⟨d(i,0)a⁺(i+r+r′,τ)⟩: the same-spin exchange
        bb = bb - 2.0 * bf.re(_ta_sum(bf.f("M2", d) * _cshift(bf.f("r1", c), r2v),
                                      bf.f("M1", b) * _cshift(bf.f("r2", a), r1v)))
        # + 2·δ(a,d)·δ(r+r′)·⟨b(i+r−r″,τ)c⁺(i,0)⟩, recorded at l = −r′−r″
        if a == d:
            l = _wrap(lat, [-r1v[k] - r2v[k] for k in range(3)])
            bb[:, l[0], l[1], l[2], 0] += 2.0 * pt.G[:, b, c, l[0], l[1], l[2], 0]
        out.append(_finalize_tau(bb, Lt, time_dependent, beta_negated=True))
    return torch.stack(out, dim=1)


def hopping_cells(spec, device) -> list:
    """Each bond definition's base cells (its bonds' first-endpoint cells,
    in original bond order) as an index tensor on ``device``."""
    lat = spec.lattice
    return [torch.as_tensor(lat.calc_neighbor_table(d[0], d[1], d[2])[0]
                            // lat.unit_cell.norbits, device=device)
            for d in spec.bond_defs]


def _hopping_grids(ops, params, x, cdtype, cells=None):
    """The hopping amplitude of every bond definition on its base cell,
    ``[ndefs, (C,) L1, L2, L3, 1 | Lτ]``: bare and τ-independent for
    Holstein, modulated per chain, bond and τ for SSH. Bonds are scattered
    onto base cells, not reshaped: a pair that the periodic wrap duplicates
    is kept once, and the dropped copy's cell carries weight 0. ``cells``:
    :func:`hopping_cells` on the fields' device (made here when None)."""
    spec, lat = ops.spec, ops.spec.lattice
    if cells is None:
        cells = hopping_cells(spec, x.device)
    if ops.is_holstein:
        tvals = params.t[None, :, None]                          # [1, Nbonds, 1]
    else:
        tvals = Sm.hopping_t_prime(spec, params, x)              # [C, Nbonds, Lτ]
        if params.t_phase is not None:                           # twisted SSH
            tvals = params.t_phase[None, :, None] * tvals
    lead, tail = tvals.shape[0], tvals.shape[-1]
    grids, n0 = [], 0
    for base in cells:
        nnew = base.shape[0]
        g = torch.zeros((lead, lat.ncells, tail), dtype=tvals.dtype, device=tvals.device)
        g[:, base] = tvals[:, n0:n0 + nnew]
        n0 += nnew
        grids.append(g.reshape(lead, lat.L3, lat.L2, lat.L1, tail).permute(0, 3, 2, 1, 4))
    t = torch.stack(grids).to(cdtype)                            # [ndefs, lead, L1, L2, L3, tail]
    return t[:, 0] if ops.is_holstein else t


def measure_currentcurrent(ops, params, x, pt, bf: BondFields, bond_pairs,
                           time_dependent: bool, cells=None):
    """⟨J′(τ,r)·J″(0,0)⟩ with J = i·Σσ(t·c†c − t*·c†c) per bond:
    ``[C, n_bond_pairs, L1, L2, L3, Lτ+1 | 1]`` (``cells`` as in
    :func:`_hopping_grids`)."""
    spec, Lt, lat = ops.spec, ops.Ltau, ops.spec.lattice
    t = _hopping_grids(ops, params, x, bf.r1.dtype, cells)
    norm = lat.ncells * Lt

    def w(tn):
        """A definition's weights against a [C, P, L1, L2, L3, Lτ] field."""
        return tn[None, None] if ops.is_holstein else tn[:, None]

    def contact(G1, G2, l, w1, w2):
        """The lattice average pairing G₁ at cell y+l with G₂ at cell y,
        summed over the probe pairs: ``[C]`` (its real part under complex
        hopping)."""
        return bf.re((_cshift(w1 * G1, l) * (w2 * G2)).sum(dim=(1, 2, 3, 4, 5)) / norm)

    out = []
    for n2, n1 in bond_pairs:
        d, c, r2v = _bond(spec.bond_defs, n2)
        b, a, r1v = _bond(spec.bond_defs, n1)
        t1, t2 = w(t[n1]), w(t[n2])          # t′ (bond n′), t″ (bond n″)
        t1c, t2c = t1.conj(), t2.conj()

        def direct(G1, G2, w1, w2, coeff):
            """A cross-spin product: each factor spin-summed (its real
            part under complex hopping)."""
            return coeff * _ta_sum(bf.re(w1 * G1), bf.re(w2 * G2))

        def exch(G1, G2, w1, w2, coeff):
            """A same-spin contraction (its real part under complex
            hopping)."""
            return coeff * bf.re(_ta_sum(w1 * G1, w2 * G2))

        M1b_r1a = bf.f("M1", b) * _cshift(bf.f("r1", a), r1v)
        M1a_r1b = _cshift(bf.f("M1", a), r1v) * bf.f("r1", b)
        M2c_r2d = _cshift(bf.f("M2", c), r2v) * bf.f("r2", d)
        M2d_r2c = bf.f("M2", d) * _cshift(bf.f("r2", c), r2v)
        # the four direct terms: the per-configuration ⟨J′⟩⟨J″⟩ product
        cc = direct(M1b_r1a, M2c_r2d, t1, t2c, 4.0)
        cc = cc + direct(M1b_r1a, M2d_r2c, t1, t2, -4.0)
        cc = cc + direct(M1a_r1b, M2c_r2d, t1c, t2c, -4.0)
        cc = cc + direct(M1a_r1b, M2d_r2c, t1c, t2, 4.0)
        # the four exchange terms
        M1b_r2a = bf.f("M1", b) * _cshift(bf.f("r2", a), r1v)
        M1a_r2b = _cshift(bf.f("M1", a), r1v) * bf.f("r2", b)
        M2c_r1d = _cshift(bf.f("M2", c), r2v) * bf.f("r1", d)
        r1c_M2d = _cshift(bf.f("r1", c), r2v) * bf.f("M2", d)
        cc = cc + exch(M1b_r2a, M2c_r1d, t1, t2c, -2.0)
        cc = cc + exch(r1c_M2d, M1b_r2a, t2, t1, 2.0)
        cc = cc + exch(M1a_r2b, M2c_r1d, t1c, t2c, 2.0)
        cc = cc + exch(M1a_r2b, r1c_M2d, t1c, t2, -2.0)
        # the equal-time δ pieces of the exchange contractions, each a
        # lattice average placed at one displacement
        if a == c:      # +2·t′(i+l)t″(i)·⟨b(i+l,0)d⁺(i,0)⟩ at l = r″−r′
            l = _wrap(lat, [r2v[k] - r1v[k] for k in range(3)])
            cc[:, l[0], l[1], l[2], 0] += 2.0 * contact(bf.f("M1", b), bf.f("r1", d), l, t1, t2c)
        if a == d:      # −2·t′(i+l)t″(i)·⟨b(i+l,0)c⁺(r″+i,0)⟩ at l = −r′
            l = _wrap(lat, [-r1v[k] for k in range(3)])
            cc[:, l[0], l[1], l[2], 0] -= 2.0 * contact(
                bf.f("M1", b), _cshift(bf.f("r1", c), r2v), l, t1, t2)
        if b == c:      # −2·t′(i+l)t″(i)·⟨a(r′+i+l,0)d⁺(i,0)⟩ at l = r″
            l = _wrap(lat, r2v)
            cc[:, l[0], l[1], l[2], 0] -= 2.0 * contact(
                _cshift(bf.f("M1", a), r1v), bf.f("r1", d), l, t1c, t2c)
        if b == d:      # +2·t′t″·⟨a(r′+i,0)c⁺(r″+i,0)⟩ at l = 0
            cc[:, 0, 0, 0, 0] += 2.0 * contact(
                _cshift(bf.f("M1", a), r1v), _cshift(bf.f("r1", c), r2v), (0, 0, 0), t1c, t2)
        out.append(_finalize_tau(cc, Lt, time_dependent, beta_negated=True))
    return torch.stack(out, dim=1)


def measure_bondpairgreens(ops, pt, bf: BondFields, bond_pairs, time_dependent: bool,
                           n_pairs: int):
    """``[C, n_bond_pairs, L1, L2, L3, Lτ+1 | 1]``."""
    spec, Lt, lat = ops.spec, ops.Ltau, ops.spec.lattice
    # the τ = β identities are per spin: the (a↑c⁺↑) factor gives G↑, the
    # (b↓d⁺↓) factor its conjugate (both the real G for real hopping)
    Gup = pt.G if pt.G_up is None else pt.G_up
    Gdn = pt.G if pt.G_up is None else pt.G_up.conj()
    out = []
    for n2, n1 in bond_pairs:
        d, c, r2v = _bond(spec.bond_defs, n2)
        b, a, r1v = _bond(spec.bond_defs, n1)
        # ⟨a(r′+r+i,τ)c⁺(r″+i,0)⟩⟨b(r+i,τ)d⁺(i,0)⟩; under complex hopping
        # the spin-↓ factor is the conjugated estimate (M₂ and r₂ together)
        M2b, r2d = bf.f("M2", b), bf.f("r2", d)
        if bf.cplx:
            M2b, r2d = M2b.conj(), r2d.conj()
        pg = _ta_sum(_cshift(bf.f("M1", a), r1v) * M2b, _cshift(bf.f("r1", c), r2v) * r2d)
        if not time_dependent:
            out.append(pg[..., :1])
            continue
        # τ = β: the wrap identities of the two single-particle factors
        beta = pg[..., 0].clone()
        if a == c and b == d and r1v == r2v:
            beta[:, 0, 0, 0] += float(n_pairs)
        if b == d:      # − δ(r=0)·G(r′−r″; c,a; 0) placed at r = 0
            l = _wrap(lat, [r1v[k] - r2v[k] for k in range(3)])
            beta[:, 0, 0, 0] -= Gup[:, a, c, l[0], l[1], l[2], 0]
        if a == c:      # − δ(r″ = r′+r)·G(r; d,b; 0) at r = r″−r′
            l = _wrap(lat, [r2v[k] - r1v[k] for k in range(3)])
            beta[:, l[0], l[1], l[2]] -= Gdn[:, b, d, l[0], l[1], l[2], 0]
        out.append(torch.cat([pg, beta[..., None]], dim=-1))
    return torch.stack(out, dim=1)
