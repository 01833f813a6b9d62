"""Site (lattice) sharding of the Holstein and SSH models over ranks.

Counterpart of ``elphdynamics_tpu/parallel/lattice_shard.py``. The site
axis of every ``[..., N, Lτ]`` fermion field is cut into D equal contiguous
blocks, one per rank of a site group; τ stays whole on every rank, so the
τ-shift of M, the exp(−Δτ·V) and exp(+Δτ·μ) diagonals, the Fourier
acceleration and the KPM τ↔ω transforms are rank-local. What crosses
ranks:

* the checkerboard fold: within a group every site couples to one partner;
  a partner on a ring-adjacent rank arrives as a halo row, one exchange
  (:func:`..comm.halo_exchange`) per boundary-crossing group;
* the ωᵢⱼ dispersion pairs (Holstein), through the same kind of halo;
* sums over sites (CG dots, energies, KPM norms, block-CG Grams,
  deflation Grams): one all-reduce of the ranks' float64 (complex128 for
  block CG on complex fields) partial sums.

Holstein's phonons live on sites, so its phonon field is cut like the
fermion fields. SSH's live on bonds: the bond field x, its momenta, the
bosonic action and its force stay whole on every rank (each rank
integrates the same trajectory), and the fermionic force is the one
quantity over the bond field that is a sum over sites: each rank walks its
block's share (:meth:`SiteShard.fold_walk`) onto the whole ``[.., Nph,
Lτ]`` array, and one all-reduce per force evaluation assembles it.

Where the JAX package duplicates its samplers for the sharded case, the
port runs its ordinary ones on sharded operators: :func:`shard_model`
gives the rank a spec whose fold is the halo fold and whose fermion fields
hold its B = N/D sites, and the spec's :class:`SiteShard` is the one
collective hook the samplers consult (``ModelOps.shard``) for the sums
over sites. Without a shard the one-rank path is untouched.

The sharded fold is plain torch on the rank's block in any case (the JAX
package's is plain ``jnp`` too): the CUDA fold kernels take whole site
slabs, and a halo as deep as the group walk is not built yet (ROADMAP).

A sampler call on a shard is segmented like one rank's
(``dynamics/graphs.py``): on an NCCL site group, one card per rank, its
segments are captured as CUDA graphs with the all-reduces and halo
exchanges inside them. Every device table the fold and the ωᵢⱼ terms
read (:meth:`SiteShard._dev_tables`, :meth:`SiteShard._wij_tables`, the
ωᵢⱼ signs per device and dtype) is uploaded once, in a call's warm-up; a
capture that reaches a first upload raises. The counters count what ran:
a graph keeps what its capture counted, and each replay adds it again
(``utils/capture.py``).

The plans are host numpy, built once; a bond or ωᵢⱼ pair that reaches a
block that is not ring-adjacent is refused (order the sites so that bonds
cross at most one block boundary: the orbit-fastest row-major orderings of
the square, cubic and honeycomb lattices cut along their slowest axis).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

from elphdynamics_tpu_torch.ops.checkerboard import CheckerboardSpec, _site_coeffs
from elphdynamics_tpu_torch.parallel.comm import allreduce_sum, halo_exchange
from elphdynamics_tpu_torch.parallel.multihost import all_gather
from elphdynamics_tpu_torch.utils import capture
from elphdynamics_tpu_torch.utils.math import add_plan, ordered_add


@dataclass(frozen=True)
class ShardPlan:
    """Halo plan of one (CheckerboardSpec, D) pair. Per group ``g``, all
    numpy:

    * ``send_next[g]`` ``[D, Hp_g]``: local rows each block sends to its
      next ring neighbour (that neighbour's previous halo);
    * ``send_prev[g]`` ``[D, Hn_g]``: rows sent to the previous neighbour;
    * ``partner_local[g]`` ``[D, B]``: each local site's partner in the
      extended block ``[local B | previous halo Hp_g | next halo Hn_g]``;
    * ``bond_of_site[g]``, ``mask[g]``, ``is_lo[g]`` ``[D, B]``: the
      coefficient tables of the block (the second endpoint of a complex
      bond takes conj(s)).
    """

    D: int
    B: int
    ngroups: int
    hp: tuple
    hn: tuple
    send_next: tuple
    send_prev: tuple
    partner_local: tuple
    bond_of_site: tuple
    mask: tuple
    is_lo: tuple


def _ring_need(d: int, p: int, B: int, D: int, prev_need, next_need, what: str) -> None:
    """Record that block ``d`` needs site ``p`` of a neighbouring block."""
    sp = p // B
    if sp == d:
        return
    if sp == (d - 1) % D:
        prev_need[d].append(p)
    elif sp == (d + 1) % D:
        next_need[d].append(p)
    else:
        raise NotImplementedError(f"{what} reaches non-adjacent shard ({d}->{sp}); order sites "
                                  "so that they cross at most one block boundary")


def _send_tables(prev_need, next_need, B: int, D: int):
    """Pad the needs to a common depth (with the neighbour's first row, never
    read) and turn them into what each block sends: block d sends next what
    block d+1 needs from its previous neighbour."""
    Hp = max((len(x) for x in prev_need), default=0)
    Hn = max((len(x) for x in next_need), default=0)
    prev_pad = [x + [((d - 1) % D) * B] * (Hp - len(x)) for d, x in enumerate(prev_need)]
    next_pad = [x + [((d + 1) % D) * B] * (Hn - len(x)) for d, x in enumerate(next_need)]
    send_next = np.asarray([[p - d * B for p in prev_pad[(d + 1) % D]] for d in range(D)],
                           dtype=np.int64).reshape(D, Hp)
    send_prev = np.asarray([[p - d * B for p in next_pad[(d - 1) % D]] for d in range(D)],
                           dtype=np.int64).reshape(D, Hn)
    return Hp, Hn, send_next, send_prev


def _ext_index(d: int, p: int, B: int, Hp: int, prev_need, next_need) -> int:
    """Site ``p``'s row in block ``d``'s extended block."""
    if p // B == d:
        return p - d * B
    if p in prev_need[d]:
        return B + prev_need[d].index(p)
    return B + Hp + next_need[d].index(p)


def build_shard_plan(spec: CheckerboardSpec, D: int) -> ShardPlan:
    """Plan the halo exchanges of ``spec``'s groups over D site blocks."""
    N = spec.nsites
    if N % D != 0:
        raise ValueError(f"nsites={N} not divisible by n_shards={D}")
    B = N // D
    hp, hn, send_next, send_prev, partner_local = [], [], [], [], []
    for g in range(spec.ngroups):
        prev_need = [[] for _ in range(D)]
        next_need = [[] for _ in range(D)]
        for d in range(D):
            for i in range(d * B, (d + 1) * B):
                _ring_need(d, int(spec.partner[g][i]), B, D, prev_need, next_need, "bond")
        prev_need = [sorted(set(x)) for x in prev_need]
        next_need = [sorted(set(x)) for x in next_need]
        Hp, Hn, sn, sp = _send_tables(prev_need, next_need, B, D)
        pl = np.asarray([[_ext_index(d, int(spec.partner[g][i]), B, Hp, prev_need, next_need)
                          for i in range(d * B, (d + 1) * B)] for d in range(D)],
                        dtype=np.int64).reshape(D, B)
        hp.append(Hp)
        hn.append(Hn)
        send_next.append(sn)
        send_prev.append(sp)
        partner_local.append(pl)
    ng = spec.ngroups
    return ShardPlan(
        D=D, B=B, ngroups=ng, hp=tuple(hp), hn=tuple(hn), send_next=tuple(send_next),
        send_prev=tuple(send_prev), partner_local=tuple(partner_local),
        bond_of_site=tuple(spec.bond_of_site[g].reshape(D, B).copy() for g in range(ng)),
        mask=tuple(spec.mask[g].reshape(D, B).copy() for g in range(ng)),
        is_lo=tuple(spec.is_lo[g].reshape(D, B).copy() for g in range(ng)))


@dataclass(frozen=True)
class WijPlan:
    """Halo plan of the ωᵢⱼ dispersion pairs over D site blocks. Each pair
    k = (i, j) is evaluated on both sides: on i's block (its action term and
    ∂S/∂xᵢ) and on j's block (∂S/∂xⱼ), the remote endpoint arriving as a
    halo row. Tables are ``[D, Kmax]``, padded, with validity masks;
    ``row_*`` are local rows, ``ext_*`` rows of the extended block
    ``[local B | previous halo Hp | next halo Hn]``, ``k_*`` pair indices."""

    D: int
    B: int
    hp: int
    hn: int
    send_next: np.ndarray
    send_prev: np.ndarray
    row_i: np.ndarray
    ext_j: np.ndarray
    k_i: np.ndarray
    mask_i: np.ndarray
    row_j: np.ndarray
    ext_i: np.ndarray
    k_j: np.ndarray
    mask_j: np.ndarray


def build_wij_plan(wij_table: np.ndarray | None, N: int, D: int) -> WijPlan | None:
    """Plan the ωᵢⱼ halo for the ``[2, Nwij]`` pair table; None without
    dispersion (no table, or an empty one)."""
    if wij_table is None or wij_table.shape[1] == 0:
        return None
    nw = wij_table.shape[1]
    B = N // D
    prev_need = [[] for _ in range(D)]
    next_need = [[] for _ in range(D)]
    side_i = [[] for _ in range(D)]   # (local row, partner site, pair)
    side_j = [[] for _ in range(D)]
    for k in range(nw):
        i, j = int(wij_table[0, k]), int(wij_table[1, k])
        di, dj = i // B, j // B
        side_i[di].append((i - di * B, j, k))
        _ring_need(di, j, B, D, prev_need, next_need, "wij pair")
        side_j[dj].append((j - dj * B, i, k))
        _ring_need(dj, i, B, D, prev_need, next_need, "wij pair")
    prev_need = [sorted(set(x)) for x in prev_need]
    next_need = [sorted(set(x)) for x in next_need]
    Hp, Hn, send_next, send_prev = _send_tables(prev_need, next_need, B, D)

    def tables(side):
        K = max((len(x) for x in side), default=0)
        row, ext, kk = (np.zeros((D, K), dtype=np.int64) for _ in range(3))
        mask = np.zeros((D, K), dtype=bool)
        for d in range(D):
            for a, (r, p, k) in enumerate(side[d]):
                row[d, a] = r
                ext[d, a] = _ext_index(d, p, B, Hp, prev_need, next_need)
                kk[d, a] = k
                mask[d, a] = True
        return row, ext, kk, mask

    row_i, ext_j, k_i, mask_i = tables(side_i)
    row_j, ext_i, k_j, mask_j = tables(side_j)
    return WijPlan(D=D, B=B, hp=Hp, hn=Hn, send_next=send_next, send_prev=send_prev,
                   row_i=row_i, ext_j=ext_j, k_i=k_i, mask_i=mask_i,
                   row_j=row_j, ext_i=ext_i, k_j=k_j, mask_j=mask_j)


def ssh_group_phonons(spec, D: int):
    """Per (group, block) phonon tables of SSH's ``muldMdx`` over D site
    blocks (D = 1: the whole lattice on one rank), each a tuple over groups
    of ``[D, B]`` arrays: ``ph_of_site`` the phonon of the bond at a local
    site (0 where masked), ``ph_mask`` whether the site has a
    phonon-carrying bond in the group, ``bond_orig`` the bond in the
    original order (its Peierls phase)."""
    B = spec.ckb.nsites // D
    ph_of_site, ph_mask, bond_orig = [], [], []
    for g in range(spec.ckb.ngroups):
        orig = spec.ckb_to_bond[spec.ckb.bond_of_site[g]]
        ph = spec.bond_to_phonon[orig]
        ph_of_site.append(np.maximum(ph, 0).reshape(D, B).copy())
        ph_mask.append((spec.ckb.mask[g] & (ph >= 0)).reshape(D, B).copy())
        bond_orig.append(orig.reshape(D, B).copy())
    return tuple(ph_of_site), tuple(ph_mask), tuple(bond_orig)


# the shard counters (SiteShard's docstring)
COUNTERS = ("folds", "halo_msgs", "halo_bytes", "allreduces", "allreduce_bytes", "force_sums",
            "force_bytes")


class SiteShard:
    """One rank's block of sites and the collectives over its site group.

    ``d`` is this rank's block (its rank within the site group ``group``,
    whose global ranks are ``base .. base + D − 1``), ``N`` the global site
    count, ``B = N/D`` the block, ``lo`` its first site. The counters
    (``folds``, ``halo_msgs``, ``halo_bytes`` sent, ``allreduces``,
    ``allreduce_bytes``; ``force_sums`` and ``force_bytes`` of them SSH's
    force all-reduces) feed the PERF metrics; :meth:`reset_counts` zeroes
    them.
    """

    def __init__(self, ckb: CheckerboardSpec, wij_table: np.ndarray | None, D: int, d: int,
                 group=None, base: int = 0):
        self.plan = build_shard_plan(ckb, D)
        self.wplan = build_wij_plan(wij_table, ckb.nsites, D)
        self.N, self.D, self.d, self.B = ckb.nsites, D, d, self.plan.B
        self.lo = d * self.B
        self.group = group
        self.next_rank, self.prev_rank = base + (d + 1) % D, base + (d - 1) % D
        self._tables: dict = {}
        self.reset_counts()

    def reset_counts(self) -> None:
        for name in COUNTERS:
            setattr(self, name, 0)

    def _add(self, name: str, n: int) -> None:
        setattr(self, name, getattr(self, name) + n)

    def _count(self, **adds) -> None:
        """Add to the counters (to the records of the graphs being
        captured during a capture, :func:`..utils.capture.count`)."""
        for name, n in adds.items():
            capture.count(self._add, name, n)

    def backend(self) -> str:
        """The site group's backend (``nccl`` or ``gloo``)."""
        return dist.get_backend(self.group)

    # --- layout

    def local(self, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This rank's block of a global tensor's site axis ``dim``."""
        return t.narrow(dim, self.lo, self.B)

    def gather(self, t: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The global tensor from every rank's block along ``dim`` (a
        collective of the site group)."""
        return all_gather(t, dim, self.group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the site group of the partial sums ``t``."""
        self._count(allreduces=1, allreduce_bytes=t.numel() * t.element_size())
        return allreduce_sum(t, self.group)

    def sum_force(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`sum` of the ranks' shares of SSH's fermionic force on the
        whole bond field, counted apart."""
        self._count(force_sums=1, force_bytes=t.numel() * t.element_size())
        return self.sum(t)

    def row(self, x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Global row ``i[c]`` of chain c of the sharded ``[C, B, Lτ]``
        field, on every rank (one all-reduce of the owner's rows)."""
        has, r = self.owns(i)
        rows = x[torch.arange(x.shape[0], device=x.device), r]
        return self.sum(torch.where(has[:, None], rows, torch.zeros_like(rows)))

    def owns(self, i: torch.Tensor):
        """(whether this rank holds global site ``i``, its local row clamped
        into the block)."""
        has = (i >= self.lo) & (i < self.lo + self.B)
        return has, torch.clamp(i - self.lo, 0, self.B - 1)

    # --- the halo fold

    def _dev_tables(self, device):
        key = str(device)
        tabs = self._tables.get(key)
        if tabs is None:
            capture.refuse(device, "the shard's halo tables' upload")
            p, d = self.plan, self.d

            def T(a):
                return torch.as_tensor(a[d], device=device)
            tabs = self._tables[key] = dict(
                partner=[T(a) for a in p.partner_local], bos=[T(a) for a in p.bond_of_site],
                mask=[T(a) for a in p.mask], lo=[T(a) for a in p.is_lo],
                send_next=[T(a) for a in p.send_next], send_prev=[T(a) for a in p.send_prev])
        return tabs

    def _extend(self, v, send_next_rows, send_prev_rows, hp: int, hn: int):
        """``[local | previous halo | next halo]`` along the site axis."""
        if hp == 0 and hn == 0:
            return v
        sn = v.index_select(-2, send_next_rows) if hp else None
        sp = v.index_select(-2, send_prev_rows) if hn else None
        from_prev, from_next = halo_exchange(sn, sp, self.next_rank, self.prev_rank, self.group)
        self._count(halo_msgs=(hp > 0) + (hn > 0),
                    halo_bytes=sum(t.numel() * t.element_size() for t in (sn, sp)
                                   if t is not None))
        return torch.cat([v] + [t for t in (from_prev, from_next) if t is not None], dim=-2)

    def _group_coeffs(self, tabs, g: int, cosh_b, sinh_b, v):
        """Group ``g``'s (c, s) on the block's sites, shaped against ``v``."""
        one = torch.ones((), dtype=cosh_b.dtype, device=v.device)
        zero = torch.zeros((), dtype=sinh_b.dtype, device=v.device)
        return (_site_coeffs(cosh_b, tabs["bos"][g], tabs["mask"][g], one, v),
                _site_coeffs(sinh_b, tabs["bos"][g], tabs["mask"][g], zero, v, tabs["lo"][g]))

    def fold(self, cosh_b, sinh_b, v, *, reverse: bool = False, sign: float = 1.0):
        """The checkerboard fold of the local ``[..., B, K]`` block in
        direction ``(reverse, sign)`` (forward, transpose = reversed order,
        inverse = reversed with −s, inverse transpose = forward with −s),
        coefficients ``[Nb]``, per chain ``[C, Nb]`` or per chain and column
        ``[C, Nb, K]`` (SSH's fermion operator), real or complex; each
        site's update is the plain twin's (:func:`..ops.checkerboard.fold`)."""
        tabs = self._dev_tables(v.device)
        p = self.plan
        if sinh_b.is_complex() and not v.is_complex():
            v = v.to(sinh_b.dtype)
        self._count(folds=1)
        order = range(p.ngroups - 1, -1, -1) if reverse else range(p.ngroups)
        for g in order:
            c, s = self._group_coeffs(tabs, g, cosh_b, sinh_b, v)
            if sign < 0:
                s = -s
            ext = self._extend(v, tabs["send_next"][g], tabs["send_prev"][g], p.hp[g], p.hn[g])
            v = c * v + s * ext.index_select(-2, tabs["partner"][g])
        return v

    def fold_walk(self, cosh_b, sinh_b, b, c):
        """SSH's ``muldMdx`` group walk on the block: per group g in order,
        b ← G_g·b and c ← G_g⁻¹·c, yielding ``(g, b, cp)`` after the group,
        ``cp`` the partner's new c. One halo exchange per crossing group
        carries b and c together; the partner's new c is rebuilt locally
        from the shared bond rotation (the partner sits at the bond's other
        endpoint and takes conj(s)), with no second halo. The whole
        lattice's walk is ``models.ssh._fold_walk``."""
        tabs = self._dev_tables(b.device)
        p = self.plan
        K = b.shape[-1]
        self._count(folds=1)
        for g in range(p.ngroups):
            cg, sg = self._group_coeffs(tabs, g, cosh_b, sinh_b, b)
            ext = self._extend(torch.cat([b, c], dim=-1), tabs["send_next"][g],
                               tabs["send_prev"][g], p.hp[g], p.hn[g])
            bp, cp_old = ext.index_select(-2, tabs["partner"][g]).split(K, dim=-1)
            cp = cg * cp_old - (sg.conj() if sg.is_complex() else sg) * c
            b, c = cg * b + sg * bp, cg * c - sg * cp_old
            yield g, b, cp

    # --- ωᵢⱼ dispersion

    def _wij_tables(self, device):
        key = ("wij", str(device))
        tabs = self._tables.get(key)
        if tabs is None:
            capture.refuse(device, "the shard's wij tables' upload")
            w, d = self.wplan, self.d
            tabs = self._tables[key] = {
                name: torch.as_tensor(getattr(w, name)[d], device=device)
                for name in ("send_next", "send_prev", "row_i", "ext_j", "k_i", "mask_i",
                             "row_j", "ext_i", "k_j", "mask_j")}
            # the fixed order of the force's adds onto this rank's rows: the
            # i side's pairs, then the j side's
            members, valid = add_plan(np.concatenate([w.row_i[d], w.row_j[d]]), self.B,
                                      np.concatenate([w.mask_i[d], w.mask_j[d]]))
            tabs["members"] = torch.as_tensor(members, device=device)
            tabs["valid"] = torch.as_tensor(valid[:, :, None], device=device)
        return tabs

    def _wij_sign(self, wij_sign, like):
        """The pairs' signs ``wij_sign`` (host numpy) on ``like``'s device in
        its dtype, uploaded once per device and dtype."""
        key = ("wij_sign", str(like.device), like.dtype)
        sgn = self._tables.get(key)
        if sgn is None:
            capture.refuse(like.device, "the shard's wij signs' upload")
            sgn = self._tables[key] = torch.as_tensor(wij_sign, dtype=like.dtype,
                                                      device=like.device)
        return sgn

    def _wij_sides(self, wij, wij_sign, x):
        """The i side and the j side of the pairs this rank holds, each as
        (local rows, validity mask, pair indices, signs, xᵢ ± xⱼ)."""
        t = self._wij_tables(x.device)
        ext = self._extend(x, t["send_next"], t["send_prev"], self.wplan.hp, self.wplan.hn)
        sgn_all = self._wij_sign(wij_sign, x)
        out = []
        for rows, exts, kk, m, from_j in ((t["row_i"], t["ext_j"], t["k_i"], t["mask_i"], False),
                                          (t["row_j"], t["ext_i"], t["k_j"], t["mask_j"], True)):
            sgn = sgn_all[kk][:, None]
            mine, theirs = x.index_select(-2, rows), ext.index_select(-2, exts)
            pair = (theirs + sgn * mine) if from_j else (mine + sgn * theirs)
            out.append((rows, m[:, None], kk, sgn, pair))
        return out

    def wij_sb(self, wij, wij_sign, x):
        """Σ over this rank's pairs (i side) of ωᵢⱼ²(xᵢ ± xⱼ)²/2, per leading
        index (a partial sum: the caller all-reduces)."""
        rows, m, kk, _, pair = self._wij_sides(wij, wij_sign, x)[0]
        w2 = (wij ** 2)[kk][:, None]
        return torch.where(m, w2 * pair * pair / 2, torch.zeros_like(pair)).sum(dim=(-2, -1))

    def wij_dsb(self, wij, wij_sign, dtau: float, x, d):
        """``d`` plus the ωᵢⱼ force on this rank's rows: Δτ·ω²·(xᵢ ± xⱼ) on
        the i side, ±Δτ·ω²·(xᵢ ± xⱼ) on the j side, each row's terms added
        in a fixed order (:func:`..utils.math.ordered_add`)."""
        terms = []
        for side, (rows, m, kk, sgn, pair) in enumerate(self._wij_sides(wij, wij_sign, x)):
            g = dtau * (wij ** 2)[kk][:, None] * pair
            terms.append(sgn * g if side == 1 else g)
        t = self._wij_tables(x.device)
        return ordered_add(d, torch.cat(terms, dim=-2), t["members"], t["valid"])


def shard_holstein(spec, params, shard: SiteShard):
    """The rank's Holstein model: a spec with ``Nsites = Nph = B`` whose
    fold is ``shard``'s halo fold, and parameters with the site tables cut
    to the block (per-chain ``[C, N]`` couplings along their site axis).
    The hopping tables, ωᵢⱼ and the lattice stay global."""
    if spec.Nsites != shard.N:
        raise ValueError(f"the shard is for {shard.N} sites, the model has {spec.Nsites}")
    B, Lt = shard.B, spec.Ltau
    lspec = replace(spec, Nsites=B, Nph=B, Ndim=B * Lt, Ndof=B * Lt, dense_ckb=False,
                    kernel_fold=False, shard=shard)
    return lspec, shard_params(params, shard)


def shard_ssh(spec, params, shard: SiteShard):
    """The rank's SSH model: a spec with ``Nsites = B`` whose fold is
    ``shard``'s halo fold (the fermion fields hold the block), and
    parameters with the chemical potential cut to the block. The bond field
    (``Nph``), the hopping, the couplings and every bond table stay whole."""
    if spec.Nsites != shard.N:
        raise ValueError(f"the shard is for {shard.N} sites, the model has {spec.Nsites}")
    B = shard.B
    lspec = replace(spec, Nsites=B, Ndim=B * spec.Ltau, shard=shard, _cache={})
    return lspec, shard_params(params, shard)


def shard_model(spec, params, shard: SiteShard):
    """The rank's model of either family (:func:`shard_holstein`,
    :func:`shard_ssh`)."""
    if hasattr(params, "lam"):
        return shard_holstein(spec, params, shard)
    return shard_ssh(spec, params, shard)


def shard_params(params, shard: SiteShard):
    """Parameters with the site tables cut to ``shard``'s block (views:
    cheap to take again after the chemical potential moves): Holstein's
    μ, ω, ω₄, λ, λ₂, SSH's μ (its other tables are per bond)."""
    if not hasattr(params, "lam"):
        return replace(params, mu=shard.local(params.mu, -1))
    return replace(params, **{k: shard.local(getattr(params, k), -1)
                              for k in ("mu", "omega", "omega4", "lam", "lam2")},
                   expK=None, expK_inv=None)
