"""Checkerboard decomposition of the hopping-matrix exponential.

Counterpart of ``elphdynamics_tpu/ops/checkerboard.py``. exp(−Δτ·K) is an
ordered product of 2×2 bond rotations ``[c s; s c]``; bonds are greedily
grouped into sweeps of mutually disjoint bonds, so one group acts on a
``[..., N, K]`` field as

    v  <-  c_site ⊙ v + s_site ⊙ v[partner]

with ``partner`` an involutive site permutation. The full product is a fold
over the groups:

* forward           = groups in order
* transpose         = reversed order
* inverse           = reversed order, −s
* inverse-transpose = forward order, −s

The host-side parts (grouping, spec, dense assembly) are numpy. The torch
fold :func:`fold` is the plain twin of the CUDA kernel in
``csrc/ckb_fold.cu``, and :func:`fold_fused` that of the fused Chebyshev
step in ``csrc/ckb_fold_fused.cu`` (:mod:`.ckb_cuda`): the tests compare
them with the JAX package, and the kernels are compared with them on the
card. Three coefficient forms: ``[Nb]`` shared by every row, ``[C, Nb]``
one table per chain (the SSH model's τ-averaged Ā) and ``[C, Nb, K]`` one
per chain, bond and column (the SSH fermion operator's per-(bond, τ)
coefficients).

Complex hopping (Peierls phases, twisted boundaries): complex tables make
each bond block the Hermitian ``[c s; s̄ c]``. The first endpoint of a bond
(``is_lo``) takes ``s``, the second ``conj(s)``, so the reversed-order fold
is the adjoint exp(−Δτ·K)† and the inverse still negates ``s``
(c² − |s|² = 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def checkerboard_groups(neighbor_table: np.ndarray) -> np.ndarray:
    """Greedy grouping of bonds into mutually disjoint sweeps: walk bonds in
    (sorted) order, assigning each to the first group in which it shares no
    site with an earlier member. Returns 0-based group ids per bond."""
    nb = neighbor_table.shape[1]
    groups = np.full(nb, -1, dtype=np.int64)
    group = -1
    nassigned = 0
    while nassigned < nb:
        group += 1
        occupied: set[int] = set()
        for n in range(nb):
            if groups[n] >= 0:
                continue
            i, j = int(neighbor_table[0, n]), int(neighbor_table[1, n])
            if i in occupied or j in occupied:
                continue
            groups[n] = group
            occupied.add(i)
            occupied.add(j)
            nassigned += 1
    return groups


@dataclass(frozen=True, eq=False)
class CheckerboardSpec:
    """Static (host, numpy) description of the checkerboard decomposition.

    ``partner[g]`` is the involutive site permutation of group ``g``;
    ``bond_of_site[g]`` maps each site to the bond supplying its
    coefficients (0 for untouched sites, which are masked); ``is_lo[g]``
    marks the first endpoint of each bond; ``order`` maps sorted-bond-order
    coefficient arrays into checkerboard order (``coeffs[order]``);
    ``neighbor_table``/``groups`` are in checkerboard (grouped) order, so the
    bonds of one group are contiguous.
    """

    nsites: int
    nbonds: int
    ngroups: int
    partner: np.ndarray
    bond_of_site: np.ndarray
    mask: np.ndarray
    is_lo: np.ndarray
    neighbor_table: np.ndarray
    order: np.ndarray
    groups: np.ndarray
    # per-device tensors derived from the arrays above, built on first use
    # (see :meth:`torch_tables` and ops/ckb_cuda.py)
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def group_offsets(self) -> np.ndarray:
        """[ngroups+1] start of each group's bonds in checkerboard order."""
        return np.searchsorted(self.groups, np.arange(self.ngroups + 1)).astype(np.int64)

    def torch_tables(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(partner, bond_of_site, mask) as tensors on ``device``, cached."""
        key = ("fold", str(device))
        out = self._cache.get(key)
        if out is None:
            out = (torch.as_tensor(self.partner, device=device),
                   torch.as_tensor(self.bond_of_site, device=device),
                   torch.as_tensor(self.mask, device=device))
            self._cache[key] = out
        return out


def build_checkerboard_spec(nsites: int, neighbor_table: np.ndarray) -> CheckerboardSpec:
    """Build the group/permutation representation from a canonically sorted
    (2, nbonds) neighbor table."""
    neighbor_table = np.asarray(neighbor_table, dtype=np.int64)
    nb = neighbor_table.shape[1]
    groups_sorted = checkerboard_groups(neighbor_table)
    order = np.argsort(groups_sorted, kind="stable")
    table = neighbor_table[:, order]
    groups = groups_sorted[order]
    ngroups = int(groups.max()) + 1 if nb > 0 else 0

    partner = np.tile(np.arange(nsites, dtype=np.int64), (max(ngroups, 1), 1))
    bond_of_site = np.zeros((max(ngroups, 1), nsites), dtype=np.int64)
    mask = np.zeros((max(ngroups, 1), nsites), dtype=bool)
    is_lo = np.zeros((max(ngroups, 1), nsites), dtype=bool)
    for n in range(nb):
        g = groups[n]
        i, j = table[0, n], table[1, n]
        if mask[g, i] or mask[g, j]:
            raise ValueError("bonds within a group must be disjoint")
        partner[g, i] = j
        partner[g, j] = i
        bond_of_site[g, i] = n
        bond_of_site[g, j] = n
        mask[g, i] = True
        mask[g, j] = True
        is_lo[g, i] = True
    return CheckerboardSpec(
        nsites=nsites, nbonds=nb, ngroups=ngroups, partner=partner,
        bond_of_site=bond_of_site, mask=mask, is_lo=is_lo,
        neighbor_table=table, order=order, groups=groups)


def check_coeffs(spec: CheckerboardSpec, cosh_b, sinh_b, v, per_column: bool = True) -> None:
    """Raise unless ``(cosh_b, sinh_b)`` is a coefficient form the fold
    takes for the field ``v`` ``[..., N, K]``: ``[Nb]`` shared by every
    row; ``[C, Nb]`` one table per chain, ``C = v.shape[0]`` of a
    ``[C, ..., N, K]`` field; or (with ``per_column``) ``[C, Nb, K]`` one
    coefficient per chain, bond and column. Complex tables (complex
    hopping) must be of the field's dtype."""
    if v.shape[-2] != spec.nsites:
        raise ValueError(f"site axis (-2) must have size {spec.nsites}, got {tuple(v.shape)}")
    for name, t in (("cosh_b", cosh_b), ("sinh_b", sinh_b)):
        if t.is_complex() and t.dtype != v.dtype:
            raise ValueError(f"complex {name} ({t.dtype}) must be of the field's dtype "
                             f"({v.dtype})")
    nb = spec.nbonds
    forms = [(nb,)]
    if v.ndim >= 3:
        forms.append((v.shape[0], nb))
        if per_column:
            forms.append((v.shape[0], nb, v.shape[-1]))
    for name, t in (("cosh_b", cosh_b), ("sinh_b", sinh_b)):
        if tuple(t.shape) not in forms:
            raise ValueError(f"{name} must be one of {[list(f) for f in forms]} for a "
                             f"{tuple(v.shape)} field, got {tuple(t.shape)}")
    if cosh_b.shape != sinh_b.shape:
        raise ValueError(f"cosh_b {tuple(cosh_b.shape)} and sinh_b {tuple(sinh_b.shape)} differ")


def _site_coeffs(t: torch.Tensor, bonds: torch.Tensor, keep: torch.Tensor, fill, v,
                 lo: torch.Tensor | None = None):
    """A coefficient table gathered onto the sites of one group and shaped
    against ``v``: ``[N, 1]`` from ``[Nb]``, ``[C, 1.., N, 1]`` from
    ``[C, Nb]``, ``[C, 1.., N, K]`` from ``[C, Nb, K]``. With ``lo`` (the
    group's first-endpoint mask) a complex table is conjugated on the second
    endpoints."""
    conj = lo is not None and t.is_complex()
    if t.ndim == 1:
        site = t[bonds]
        if conj:
            site = torch.where(lo, site, site.conj())
        return torch.where(keep, site, fill)[:, None]
    site = t.index_select(1, bonds)
    if conj:
        site = torch.where(lo.reshape((1, -1) + (1,) * (t.ndim - 2)), site, site.conj())
    site = torch.where(keep.reshape((1, -1) + (1,) * (t.ndim - 2)), site, fill)
    if t.ndim == 2:
        site = site[..., None]
    return site.reshape(site.shape[:1] + (1,) * (v.ndim - 3) + site.shape[1:])


def _apply_groups(spec: CheckerboardSpec, cosh_b: torch.Tensor,
                  sinh_b: torch.Tensor, v: torch.Tensor, group_order,
                  sign: float) -> torch.Tensor:
    """Fold the group rotations over ``v`` ``[..., N, K]`` (sites on axis
    −2) with coefficients in any form of :func:`check_coeffs`; ``sign=-1``
    applies each group's inverse. Plain torch: one gather + FMA pass per
    group."""
    check_coeffs(spec, cosh_b, sinh_b, v)
    partner = spec.torch_tables(v.device)[0]
    for g in group_order:
        c, s = group_coeffs(spec, g, cosh_b, sinh_b, v)
        if sign < 0:
            s = -s
        v = c * v + s * v.index_select(-2, partner[g])
    return v


def group_coeffs(spec: CheckerboardSpec, g: int, cosh_b: torch.Tensor, sinh_b: torch.Tensor, v):
    """Group ``g``'s per-site (c, s) shaped against ``v``
    (:func:`_site_coeffs`): 1 and 0 on untouched sites, ``conj(s)`` on the
    second endpoints of complex tables."""
    partner, bond_of_site, mask = spec.torch_tables(v.device)
    key = ("is_lo", str(v.device))
    lo = spec._cache.get(key)
    if lo is None:
        lo = spec._cache[key] = torch.as_tensor(spec.is_lo, device=v.device)
    one = torch.ones((), dtype=cosh_b.dtype, device=v.device)
    zero = torch.zeros((), dtype=sinh_b.dtype, device=v.device)
    return (_site_coeffs(cosh_b, bond_of_site[g], mask[g], one, v),
            _site_coeffs(sinh_b, bond_of_site[g], mask[g], zero, v, lo[g]))


def ckb_mul(spec, cosh_b, sinh_b, v):
    """``exp(−Δτ·K)·v``: groups in forward order."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups), +1)


def ckb_transpose_mul(spec, cosh_b, sinh_b, v):
    """``exp(−Δτ·K)ᵀ·v``: reversed group order."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups - 1, -1, -1), +1)


def ckb_inverse_mul(spec, cosh_b, sinh_b, v):
    """``exp(+Δτ·K)·v``: reversed order, −s."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups - 1, -1, -1), -1)


def ckb_inverse_transpose_mul(spec, cosh_b, sinh_b, v):
    """``exp(+Δτ·K)ᵀ·v``: forward order, −s."""
    return _apply_groups(spec, cosh_b, sinh_b, v, range(spec.ngroups), -1)


def fold(spec: CheckerboardSpec, cosh_b, sinh_b, v, *, reverse: bool = False,
         sign: float = 1.0):
    """The fold in direction ``(reverse, sign)``: the plain twin of the CUDA
    kernel, with the kernel's signature."""
    order = range(spec.ngroups - 1, -1, -1) if reverse else range(spec.ngroups)
    return _apply_groups(spec, cosh_b, sinh_b, v, order, sign)


def check_fused_operands(spec: CheckerboardSpec, cosh_b, sinh_b, v, pre, post, a, b,
                         prev, acc, coeff) -> None:
    """Raise unless the operands of a fused step are what the kernel and its
    twin take: ``v`` ``[C, ..., N, K]``; coefficients ``[Nb]`` or per-chain
    ``[C, Nb]``; ``a``, ``b`` ``[C]``; ``pre``, ``post`` ``[C, N]`` or None;
    ``prev`` of ``v``'s shape or None; ``acc`` of ``v``'s shape, sharing no
    storage with ``v`` or ``prev``; ``coeff`` ``[C, K]`` with K even; all of
    ``v``'s dtype and device."""
    if v.ndim < 3:
        raise ValueError(f"field must be [C, ..., N, K], got {tuple(v.shape)}")
    check_coeffs(spec, cosh_b, sinh_b, v, per_column=False)
    C, N, K = v.shape[0], v.shape[-2], v.shape[-1]
    if K % 2:
        raise ValueError(f"the fused step needs K = 2Lω even, got K = {K}")
    for name, t, shape in (("a", a, (C,)), ("b", b, (C,)), ("pre", pre, (C, N)),
                           ("post", post, (C, N)), ("prev", prev, tuple(v.shape)),
                           ("acc", acc, tuple(v.shape)), ("coeff", coeff, (C, K))):
        if t is None and name not in ("a", "b", "acc", "coeff"):
            continue
        if not (torch.is_tensor(t) and tuple(t.shape) == shape and t.dtype == v.dtype
                and t.device == v.device):
            got = (f"{tuple(t.shape)} {t.dtype} on {t.device}" if torch.is_tensor(t)
                   else type(t).__name__)
            raise ValueError(f"{name} must be a {list(shape)} {v.dtype} tensor on "
                             f"{v.device}, got {got}")
    for t in (v, prev):
        if t is not None and acc.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
            raise ValueError("acc must not share storage with v or prev")


def fold_fused(spec: CheckerboardSpec, cosh_b, sinh_b, v, *, reverse: bool = False,
               sign: float = 1.0, pre=None, post=None, a, b, c: float = 0.0,
               prev=None, acc, coeff, init: bool):
    """One Chebyshev step ``a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev``: the
    plain twin of the fused CUDA kernel (``csrc/ckb_fold_fused.cu``), with
    its signature. ``v`` is ``[C, ..., N, K]``; the coefficients ``[Nb]``
    or ``[C, Nb]``; ``a``, ``b`` are per-chain ``[C]``; ``pre``/``post``
    are per-chain site diagonals ``[C, N]`` or None; ``c`` is a number and
    ``prev`` a field of ``v``'s shape or None. ``acc`` (``v``'s shape) gets
    the step's term ``coeff ⊙ v`` of the Chebyshev sum added in place
    (``init``: set to it), ``coeff`` ``[C, K]`` being per-chain complex
    numbers on K = 2Lω as the real parts then the imaginary ones, ``v`` the
    stacked-real halves (:func:`cmul_halves`)."""
    check_fused_operands(spec, cosh_b, sinh_b, v, pre, post, a, b, prev, acc, coeff)
    term = cmul_halves(coeff, v)
    if init:
        acc.copy_(term)
    else:
        acc.add_(term)
    C = v.shape[0]
    v4 = v.reshape(C, -1, *v.shape[-2:])

    def diag(d):
        return d.reshape(C, 1, -1, 1)

    u = v4 if pre is None else diag(pre) * v4
    f = fold(spec, cosh_b, sinh_b, u, reverse=reverse, sign=sign)
    if post is not None:
        f = diag(post) * f
    o = a.reshape(C, 1, 1, 1) * f + b.reshape(C, 1, 1, 1) * v4
    if prev is not None:
        o = o + c * prev.reshape(v4.shape)
    return o.reshape(v.shape)


def cmul_halves(coeff, v):
    """Per-chain complex numbers ``coeff`` ``[C, 2Lω]`` (real parts, then
    imaginary ones) times a stacked-real field ``v`` ``[C, ..., N, 2Lω]``
    (real halves, then imaginary ones), in the same layout."""
    Lw = v.shape[-1] // 2
    t = coeff.reshape(coeff.shape[:1] + (1,) * (v.ndim - 2) + coeff.shape[1:])
    cr, ci = t[..., :Lw], t[..., Lw:]
    vr, vi = v[..., :Lw], v[..., Lw:]
    return torch.cat([cr * vr - ci * vi, cr * vi + ci * vr], dim=-1)


def dense_matrix(spec: CheckerboardSpec, cosh_b, sinh_b, inverse: bool = False) -> np.ndarray:
    """The exact dense [N, N] matrix of the checkerboard product (float64,
    complex128 for complex tables), assembled on the host from the same
    elementary 2×2 blocks (the dense-branch exp(−Δτ·K) of small
    lattices)."""
    ddtype = (np.complex128 if np.iscomplexobj(cosh_b) or np.iscomplexobj(sinh_b)
              else np.float64)
    cosh_b = np.asarray(cosh_b, dtype=ddtype)
    sinh_b = np.asarray(sinh_b, dtype=ddtype)
    N = spec.nsites
    D = np.eye(N, dtype=ddtype)
    order = range(spec.nbonds) if not inverse else range(spec.nbonds - 1, -1, -1)
    sgn = -1.0 if inverse else 1.0
    for n in order:
        i, j = spec.neighbor_table[0, n], spec.neighbor_table[1, n]
        c = cosh_b[n]
        s = sgn * sinh_b[n]
        ri = D[i].copy()
        rj = D[j].copy()
        D[i] = c * ri + s * rj
        D[j] = c * rj + np.conj(s) * ri   # the second endpoint takes conj(s)
    return D
