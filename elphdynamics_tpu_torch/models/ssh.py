"""Optical SSH model: bond phonons modulating the electron hopping.

Counterpart of ``elphdynamics_tpu/models/ssh.py``. The phonon ``x`` lives
on bonds and modulates the hopping
``t′ = t − (αx + sign(x)·α₂x²)``; the fermion matrix uses a time-dependent
checkerboard factorisation

    B(τ) = exp(−Δτ·K[x(τ)]) · exp(+Δτ·μ)

Phonon fields are ``[C, ..., Nph, Lτ]`` with a leading chain axis; the
derived state of a ``[C, Nph, Lτ]`` batch is the pair of per-(chain, bond,
τ) coefficient tables ``cosh``/``sinh`` ``[C, Nb, Lτ]`` in checkerboard
order. exp(−Δτ·K[x]) is the checkerboard fold with those tables
(:func:`..ops.ckb_cuda.fold`: the CUDA kernel on the card, its plain twin
on the CPU), which applies a chain's table to every row of that chain, so
the same derived state acts on spin-stacked ``[C, 2, N, Lτ]`` and probe
``[C, nᵥ, N, Lτ]`` fields.

``muldMdx`` walks the checkerboard groups with carried partial products,
in plain torch, as the JAX package does outside Pallas. Primary-field
aliasing: same-named phonons on different bond types share one degree of
freedom, through ``primary_phonon``.

A rank's block of a site-sharded model (``SSHSpec.shard``,
:func:`..parallel.lattice_shard.shard_ssh`) holds ``Nsites = B`` sites of
every fermion field and the whole bond field: exp(−Δτ·K) is the shard's
halo fold, exp(+Δτ·μ) the block's diagonal, and :func:`muldMdx` returns
the rank's share of the force (its sites' walk scattered onto the whole
``[.., Nph, Lτ]`` array), which the caller sums over the ranks once per
force evaluation (:func:`..models.adapter.force_sum`).

Twisted boundaries: ``t_phase`` holds each bond's complex Peierls phase, and
the physical hopping is t_phase·t′(x). The tables become c = cosh(Δτ·t′)
(carried complex) and s = t_phase·sinh(Δτ·t′), each bond block the
Hermitian ``[c s; s̄ c]`` (the kernel's complex mode on the card), so
:func:`mulMT` is the adjoint M† and :func:`muldMdx` gives the real part of
the adjoint pairing. The JAX package's dense per-τ
``dense_ckb`` mode is off there and not carried over (:func:`dense_K`
serves the tests and file output).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from elphdynamics_tpu_torch.lattice import Lattice, sort_neighbor_table
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.ops import ckb_cuda
from elphdynamics_tpu_torch.parallel.lattice_shard import ssh_group_phonons
from elphdynamics_tpu_torch.utils.device import require_device
from elphdynamics_tpu_torch.utils.dtypes import complex_of, fsum


@dataclass(frozen=True)
class SSHParams:
    """Model parameters as tensors on one device in one dtype."""

    mu: torch.Tensor      # [N] chemical potential
    t: torch.Tensor       # [Nbonds] bare hopping, original bond order
    omega: torch.Tensor   # [Nph] phonon frequency
    omega4: torch.Tensor  # [Nph] anharmonic coefficient
    alpha: torch.Tensor   # [Nph] linear el-ph coupling ([C, Nph]: one per chain, tempering)
    alpha2: torch.Tensor  # [Nph] quadratic el-ph coupling ([C, Nph] likewise)
    # [Nbonds] complex Peierls phases, original bond order (twisted
    # boundaries; None for real hopping)
    t_phase: torch.Tensor | None = None


@dataclass(frozen=True, eq=False)
class SSHSpec:
    """Static (host) model description. Bond parameters stay in the
    original bond order (appended per definition); ``ckb_to_bond`` /
    ``bond_to_ckb`` map to and from checkerboard order."""

    lattice: Lattice
    beta: float
    dtau: float
    Ltau: int
    Nsites: int
    Nbonds: int
    Nph: int
    Ndim: int
    Ndof: int
    ckb: ckb.CheckerboardSpec
    ckb_to_bond: np.ndarray      # [Nbonds] checkerboard position -> original bond
    bond_to_ckb: np.ndarray      # [Nbonds] original bond -> checkerboard position
    bond_to_phonon: np.ndarray   # [Nbonds] -1 where the bond carries no phonon
    phonon_to_bond: np.ndarray   # [Nph]
    primary_phonon: np.ndarray   # [Nph] phonon -> its primary alias
    bond_to_definition: np.ndarray  # [Nbonds] bond -> bond-definition index
    bond_defs: tuple = ()        # ((o1, o2, (dL...), has_phonon), ...)
    # per-device index tensors, built on first use
    _cache: dict = field(default_factory=dict, repr=False, compare=False)
    # a rank's block of a site-sharded model (parallel/lattice_shard.py):
    # fermion fields hold Nsites = B sites, the bond field stays whole, the
    # fold is the halo fold; None on one rank
    shard: object = None

    def cached(self, key, device, make):
        """``make()`` (tensors on ``device`` built from the spec), made on
        first use and kept under ``key``. A captured update
        (``dynamics/graphs.py``) reads the kept value: making it during a
        CUDA graph capture raises (the warm-up makes it)."""
        if key not in self._cache:
            if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"SSH table {key!r} made during a CUDA graph capture: run "
                                   "the update once before capturing it")
            self._cache[key] = make()
        return self._cache[key]

    def tensor(self, name: str, device, make=None) -> torch.Tensor:
        """``getattr(self, name)``, or the array ``make()`` builds from the
        spec, as a tensor on ``device``, uploaded once (:meth:`cached`)."""
        return self.cached((name, str(device)), device, lambda: torch.as_tensor(
            np.ascontiguousarray(getattr(self, name) if make is None else make()), device=device))


def build_ssh(
    lattice: Lattice,
    beta: float,
    dtau: float,
    *,
    hoppings=(),        # dicts: t, t_std, omega, omega_std, omega4, omega4_std,
                        #        alpha, alpha_std, alpha2, alpha2_std, o1, o2, dL, name
    mu_assignments=(),  # (mu, std, orbit or None for every orbit)
    twist=None,
    rng: np.random.Generator | None = None,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> tuple[SSHSpec, SSHParams]:
    """Construct the SSH model on ``device`` (the card unless the caller asks
    for the CPU). The disorder draws consume ``rng`` in the JAX package's
    order, so one seed builds the same model in both. A nonzero ``twist``
    (θ1, θ2[, θ3]) gives every bond of displacement dL the Peierls phase
    exp(i·Σ_d θ_d·dL_d/L_d) in ``t_phase``."""
    device = require_device(device)
    tw3 = None
    if twist is not None and np.any(np.asarray(twist)):
        tw3 = np.zeros(3)
        tw3[: len(tuple(twist))] = twist
        Ls = np.array([lattice.L1, lattice.L2, lattice.L3], dtype=float)
    rng = rng or np.random.default_rng(0)
    N = lattice.nsites
    Ltau = int(round(beta / dtau))

    mu_v = np.zeros(N)
    for (mu0, std, orbit) in mu_assignments:
        for i in range(N):
            if orbit is None or lattice.site_to_orbit[i] == orbit:
                mu_v[i] = mu0 + (std * rng.standard_normal() if std else 0.0)

    tables, tvals, bond_defs, phases = [], [], [], []
    om, om4, al, al2 = [], [], [], []
    phonon_to_bond, bond_to_phonon = [], []
    bond_count = 0
    ph_names = []
    for idef, h in enumerate(hoppings):
        tb = lattice.calc_neighbor_table(h["o1"], h["o2"], h["dL"])
        nnew = tb.shape[1]
        tval, tstd = h.get("t", 0.0), h.get("t_std", 0.0)
        phase = np.sign(tval) if tval != 0 else 1.0
        tvals.append(phase * (abs(tval) + (tstd * rng.standard_normal(nnew) if tstd
                                           else np.zeros(nnew))))
        tables.append(tb)
        if tw3 is not None:
            dL3 = np.zeros(3)
            dL3[: len(h["dL"])] = h["dL"]
            phases.append(np.full(nnew, np.exp(1j * float(np.sum(tw3 * dL3 / Ls)))))
        bond_defs.extend([idef] * nnew)
        has_phonon = (h.get("omega", 0.0) != 0.0) or (h.get("omega_std", 0.0) != 0.0)
        if has_phonon:
            ph_names.append(h.get("name") or f"__anon{idef}")

            def draw(key, std_key):
                v0, s0 = h.get(key, 0.0), h.get(std_key, 0.0)
                noise = s0 * rng.standard_normal(nnew) if s0 else np.zeros(nnew)
                if key.startswith("omega"):
                    return v0 + noise
                return (np.sign(v0) if v0 != 0 else 1.0) * (abs(v0) + noise)

            om.append(draw("omega", "omega_std"))
            om4.append(draw("omega4", "omega4_std"))
            al.append(draw("alpha", "alpha_std"))
            al2.append(draw("alpha2", "alpha2_std"))
            phonon_to_bond.extend(range(bond_count, bond_count + nnew))
            bond_to_phonon.extend(range(len(phonon_to_bond) - nnew, len(phonon_to_bond)))
        else:
            bond_to_phonon.extend([-1] * nnew)
        bond_count += nnew

    table = np.concatenate(tables, axis=1) if tables else np.zeros((2, 0), dtype=np.int64)
    t = np.concatenate(tvals) if tvals else np.zeros(0)
    nb = table.shape[1]
    table_sorted, perm = sort_neighbor_table(table)
    cspec = ckb.build_checkerboard_spec(N, table_sorted)
    ckb_to_bond = perm[cspec.order] if nb else np.zeros(0, dtype=np.int64)
    bond_to_ckb = np.argsort(ckb_to_bond) if nb else np.zeros(0, dtype=np.int64)
    Nph = len(phonon_to_bond)

    # same-named phonon types alias the earliest type of that name (phonons
    # are laid out contiguously per type)
    primary = np.arange(Nph, dtype=np.int64)
    sizes = [len(o) for o in om]
    starts = np.cumsum([0] + sizes[:-1]) if sizes else np.zeros(0, dtype=np.int64)
    for a in range(len(ph_names)):
        for b in range(a + 1, len(ph_names)):
            if ph_names[a] == ph_names[b] and sizes[a] == sizes[b]:
                sa, sb = int(starts[a]), int(starts[b])
                for k in range(sizes[b]):
                    if primary[sb + k] == sb + k:
                        primary[sb + k] = primary[sa + k]

    spec = SSHSpec(
        lattice=lattice, beta=float(beta), dtau=float(dtau), Ltau=Ltau, Nsites=N,
        Nbonds=nb, Nph=Nph, Ndim=N * Ltau, Ndof=Nph * Ltau, ckb=cspec,
        ckb_to_bond=ckb_to_bond, bond_to_ckb=bond_to_ckb,
        bond_to_phonon=np.asarray(bond_to_phonon, dtype=np.int64),
        phonon_to_bond=np.asarray(phonon_to_bond, dtype=np.int64), primary_phonon=primary,
        bond_to_definition=np.asarray(bond_defs, dtype=np.int64),
        bond_defs=tuple((h["o1"], h["o2"], tuple(h["dL"]),
                         (h.get("omega", 0.0) != 0.0) or (h.get("omega_std", 0.0) != 0.0))
                        for h in hoppings))

    def T(parts):
        a = np.concatenate(parts) if parts else np.zeros(0)
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)

    t_phase = None
    if tw3 is not None:
        a = np.concatenate(phases) if phases else np.zeros(0, dtype=np.complex128)
        t_phase = torch.as_tensor(a.astype(np.complex128), device=device).to(complex_of(dtype))
    params = SSHParams(mu=T([mu_v]), t=T([t]), omega=T(om), omega4=T(om4), alpha=T(al),
                       alpha2=T(al2), t_phase=t_phase)
    return spec, params


# ---------------------------------------------------------------------------
# derived quantities
# ---------------------------------------------------------------------------

def tie_fields(spec: SSHSpec, x):
    """Equalise aliased phonon worldlines: x ← x[primary]."""
    return x.index_select(-2, spec.tensor("primary_phonon", x.device))


def phonon_leaf(a, idx, like):
    """Entries ``idx`` of a per-phonon parameter against a field ``like``
    ``[C, ..., n, Lτ]``: ``[Nph]`` is shared by every chain; ``[C, Nph]``
    (parallel tempering's per-rung couplings) gives each chain its own, the
    chain axis leading."""
    a = a.index_select(-1, idx)
    if a.ndim == 1:
        return a[:, None]
    return a.reshape(a.shape[:1] + (1,) * (like.ndim - 3) + a.shape[1:] + (1,))


def hopping_t_prime(spec: SSHSpec, p: SSHParams, x):
    """Modulated hopping t′(bond, τ) = t − (αx + sign(x)·α₂x²) in original
    bond order, ``[..., Nbonds, Lτ]``."""
    btp = spec.tensor("bond_phonon_or_0", x.device, lambda: np.maximum(spec.bond_to_phonon, 0))
    has = spec.tensor("bond_has_phonon", x.device, lambda: (spec.bond_to_phonon >= 0)[:, None])
    xb = x.index_select(-2, btp)
    a = phonon_leaf(p.alpha, btp, x)
    a2 = phonon_leaf(p.alpha2, btp, x)
    v = a * xb + torch.sign(xb) * a2 * xb * xb
    return p.t[:, None] - torch.where(has, v, torch.zeros((), dtype=v.dtype, device=v.device))


class SSHDerived(NamedTuple):
    """The derived state of a configuration: cosh/sinh of Δτ·t′ in
    checkerboard order, ``[C, Nb, Lτ]`` each."""

    cosh: torch.Tensor
    sinh: torch.Tensor


def ckb_coeffs(spec: SSHSpec, p: SSHParams, x) -> SSHDerived:
    """(cosh, sinh) of Δτ·t′(x) in checkerboard order, ``[C, Nb, Lτ]`` for
    fields ``[C, Nph, Lτ]``. With ``t_phase`` the tables are complex:
    c = cosh(Δτ·t′), s = t_phase·sinh(Δτ·t′)."""
    tp = hopping_t_prime(spec, p, x)
    arg = spec.dtau * tp.index_select(-2, spec.tensor("ckb_to_bond", x.device))
    cosh_b, sinh_b = torch.cosh(arg), torch.sinh(arg)
    if p.t_phase is not None:
        ph = p.t_phase.index_select(-1, spec.tensor("ckb_to_bond", x.device))
        sinh_b = ph[:, None] * sinh_b
        cosh_b = cosh_b.to(sinh_b.dtype)
    return SSHDerived(cosh=cosh_b, sinh=sinh_b)


def exp_mu(spec: SSHSpec, p: SSHParams):
    """exp(+Δτ·μ) diagonal, ``[N, 1]`` (the block's ``[B, 1]`` on a shard,
    whose parameters hold the block's μ)."""
    return torch.exp(spec.dtau * p.mu)[:, None]


def dense_K(spec: SSHSpec, cosh_b, sinh_b):
    """The per-τ dense exp(−Δτ·K[x(τ)]) ``[Lτ, N, N]`` for one chain's
    ``[Nb, Lτ]`` coefficients: the identity folded through the groups with
    τ as the table's chain axis (plain torch; for the tests and file
    output)."""
    N, Lt = spec.Nsites, spec.Ltau
    eye = torch.eye(N, dtype=cosh_b.dtype, device=cosh_b.device).expand(Lt, N, N)
    return ckb.ckb_mul(spec.ckb, cosh_b.mT.contiguous(), sinh_b.mT.contiguous(), eye)


# ---------------------------------------------------------------------------
# fermion matrix multiplication routines
# ---------------------------------------------------------------------------

def _tau_sign(spec: SSHSpec, like, first: bool):
    """[+1, −1, ..., −1] (``first``: the wrap at τ=0) or [−1, ..., −1, +1]."""
    s = -torch.ones(spec.Ltau, dtype=like.dtype, device=like.device)
    (s[:1] if first else s[-1:]).fill_(1.0)   # a fill, not a host-to-device copy
    return s


def _apply_K(spec: SSHSpec, coeffs: SSHDerived, y, transpose: bool = False):
    """exp(−Δτ·K[x(τ)])·y (or its transpose, the adjoint for complex
    tables) on ``[C, ..., N, Lτ]``; a real field meeting complex tables is
    promoted."""
    cosh_b, sinh_b = coeffs
    if sinh_b.is_complex() and not y.is_complex():
        y = y.to(sinh_b.dtype)
    if spec.shard is not None:
        return spec.shard.fold(cosh_b, sinh_b, y, reverse=transpose)
    return ckb_cuda.fold(spec.ckb, cosh_b, sinh_b, y.contiguous(), reverse=transpose)


def mulM(spec: SSHSpec, p: SSHParams, coeffs, v):
    """y = M·v: y(τ) = v(τ) − B(τ)·v(τ−1), y(0) = v(0) + B(0)·v(Lτ−1)."""
    y = _apply_K(spec, coeffs, exp_mu(spec, p) * torch.roll(v, 1, dims=-1))
    return v + _tau_sign(spec, v, True) * y


def mulMT(spec: SSHSpec, p: SSHParams, coeffs, v):
    """y = Mᵀ·v (M† under twisted boundaries)."""
    w = exp_mu(spec, p) * _apply_K(spec, coeffs, v, transpose=True)
    return v + _tau_sign(spec, v, False) * torch.roll(w, -1, dims=-1)


def mulMTM(spec: SSHSpec, p: SSHParams, coeffs, v):
    return mulMT(spec, p, coeffs, mulM(spec, p, coeffs, v))


def mulMMT(spec: SSHSpec, p: SSHParams, coeffs, v):
    return mulM(spec, p, coeffs, mulMT(spec, p, coeffs, v))


def _site_bonds(spec: SSHSpec, g: int, device):
    """The sites of the block (the whole lattice on one rank) with a
    phonon-carrying bond in group ``g``, first endpoints first: (local rows,
    phonons, original bonds, first-endpoint mask ``[n, 1]``) as tensors on
    ``device`` and the count of first endpoints, cached; None when it has
    none."""
    def make():
        D, d = (spec.shard.D, spec.shard.d) if spec.shard is not None else (1, 0)
        ph, has, bond = (t[g][d] for t in ssh_group_phonons(spec, D))
        lo = spec.ckb.is_lo[g].reshape(D, -1)[d]
        first = np.nonzero(has & lo)[0]
        rows = np.concatenate([first, np.nonzero(has & ~lo)[0]])
        return None if rows.size == 0 else (tuple(
            torch.as_tensor(a, device=device)
            for a in (rows, ph[rows], bond[rows], lo[rows][:, None])), first.size)

    return spec.cached(("site_bonds", g, str(device)), device, make)


def _fold_walk(spec: SSHSpec, cosh_b, sinh_b, b, c):
    """:func:`muldMdx`'s group walk on the whole lattice: per group g in
    order, b ← G_g·b and c ← G_g⁻¹·c, yielding ``(g, b, cp)`` after the
    group, ``cp`` the partner's new c (on a shard
    :meth:`..parallel.lattice_shard.SiteShard.fold_walk`)."""
    partner = spec.ckb.torch_tables(b.device)[0]
    for g in range(spec.ckb.ngroups):
        cg, sg = ckb.group_coeffs(spec.ckb, g, cosh_b, sinh_b, b)
        b = cg * b + sg * b.index_select(-2, partner[g])
        c = cg * c - sg * c.index_select(-2, partner[g])
        yield g, b, c.index_select(-2, partner[g])


def _alias_groups(spec: SSHSpec, device):
    """Each phonon's alias group (its primary's), in ascending phonon order:
    ``members`` ``[k, Nph]``, row j the group's j-th member (the primary
    first, the earliest phonon of its name), and ``valid`` ``[k, Nph, 1]``
    where a group has fewer than k members; cached. None when no phonon is
    aliased."""
    def make():
        prim = spec.primary_phonon
        groups = [np.nonzero(prim == prim[q])[0] for q in range(spec.Nph)]
        k = max((g.size for g in groups), default=1)
        if k == 1:
            return None
        members = np.stack([[g[j] if j < g.size else g[0] for g in groups] for j in range(k)])
        valid = np.stack([[j < g.size for g in groups] for j in range(k)])
        return (torch.as_tensor(members, device=device),
                torch.as_tensor(valid[:, :, None], device=device))

    return spec.cached(("alias_groups", str(device)), device, make)


def _tie_sum(spec: SSHSpec, out):
    """Every phonon's force summed over its alias group, ``out`` itself
    where no phonon is aliased. The members are added in ascending phonon
    order by gathers, never by an atomic scatter, so the sum has the same
    bits on every run and every device, and on the CPU those of the
    ``index_add`` onto zeros that the JAX package's scatter-add mirrors."""
    groups = _alias_groups(spec, out.device)
    if groups is None:
        return out
    members, valid = groups
    acc = out.index_select(-2, members[0])
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    for j in range(1, members.shape[0]):
        acc = acc + torch.where(valid[j], out.index_select(-2, members[j]), zero)
    return acc


def muldMdx(spec: SSHSpec, p: SSHParams, coeffs, x, u, v):
    """uᵀ·[∂M/∂x_b(τ)]·v for every phonon and slice, ``[..., Nph, Lτ]``.

    The group walk: carry b ← G_g·b and c ← G_g⁻¹·c through the
    checkerboard groups (b starts as exp(Δτμ)·v(τ−1), c as exp(−Δτ·K)ᵀ·u);
    after group g each endpoint i of a phonon-carrying bond (i, j) of g
    contributes ±Δτ·(α + 2α₂x)·c_j·b_i, minus on the τ=0 slice, with the
    reference's α + 2α₂x: the bond's two endpoints give its two terms, in
    two passes (first endpoints, then second), so that no pass adds twice
    to one phonon. Aliased phonons sum their forces onto the primary, which
    every alias then carries. Under twisted boundaries the bond's vertex is
    [0, ph; p̄h, 0] (the phase on the i←j entry) and the force on the real
    field is Re[ph·c̄ᵢ·bⱼ + p̄h·c̄ⱼ·bᵢ]. On a site shard each site of the
    block pairs its b with its partner's c, on this rank or another, and
    the result is this rank's share, which the caller sums over the
    ranks."""
    cosh_b, sinh_b = coeffs
    cplx = sinh_b.is_complex()
    b = exp_mu(spec, p) * torch.roll(v, 1, dims=-1)
    c = _apply_K(spec, coeffs, u, transpose=True)
    if cplx:
        b = b.to(sinh_b.dtype)
    b, c = torch.broadcast_tensors(b, c)
    batch = torch.broadcast_shapes(x.shape[:-2], b.shape[:-2])
    out = torch.zeros(batch + (spec.Nph, spec.Ltau), dtype=x.dtype, device=x.device)
    sgn = -_tau_sign(spec, x, True)
    walk = (spec.shard.fold_walk(cosh_b, sinh_b, b, c) if spec.shard is not None
            else _fold_walk(spec, cosh_b, sinh_b, b, c))
    for g, b, cp in walk:
        sites = _site_bonds(spec, g, x.device)
        if sites is None:
            continue
        (rows, ph_s, bond_s, lo), n_lo = sites
        br, cpr = b.index_select(-2, rows), cp.index_select(-2, rows)
        if cplx:
            phb = p.t_phase.index_select(-1, bond_s)[:, None]
            pair = (torch.where(lo, phb.conj(), phb) * cpr.conj() * br).real
        else:
            pair = cpr * br
        dkdx = (phonon_leaf(p.alpha, ph_s, x)
                + 2.0 * phonon_leaf(p.alpha2, ph_s, x) * x.index_select(-2, ph_s))
        dmdx = (sgn * spec.dtau * dkdx * pair).expand(batch + pair.shape[-2:])
        for part in (slice(None, n_lo), slice(n_lo, None)):
            out = out.index_add(-2, ph_s[part], dmdx[..., part, :])
    return _tie_sum(spec, out)


# ---------------------------------------------------------------------------
# bosonic (phonon) action — primary fields only
# ---------------------------------------------------------------------------

def primary_mask(spec: SSHSpec, like) -> torch.Tensor:
    """``[Nph, 1]``: 1 on primary fields, 0 on their aliases."""
    mask = spec.tensor("primary_mask", like.device,
                       lambda: (spec.primary_phonon == np.arange(spec.Nph))[:, None])
    return mask.to(like.dtype)


def calc_Sb(spec: SSHSpec, p: SSHParams, x, shifted: bool = False):
    """Sb = Σ_primary Σ_τ [Δτω²x²/2 + Δτω₄x⁴ + (Δx)²/(2Δτ)], accumulated in
    float64."""
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    dx = x - torch.roll(x, 1, dims=-1)
    sb = spec.dtau * (om2 * x * x / 2 + om4 * x ** 4) + dx * dx / (2 * spec.dtau)
    return fsum(primary_mask(spec, x) * sb, dim=(-2, -1))


def calc_dSbdx(spec: SSHSpec, p: SSHParams, x, shifted: bool = False):
    """∂Sb/∂x for every field (aliased worldlines carry equal values)."""
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    lap = torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1) - 2.0 * x
    return spec.dtau * (om2 * x + 4.0 * om4 * x ** 3) - lap / spec.dtau
