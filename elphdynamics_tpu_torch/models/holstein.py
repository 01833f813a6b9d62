"""Holstein model: fermion matrix M, derivatives, and bosonic action.

Counterpart of ``elphdynamics_tpu/models/holstein.py``.

    M[τ,τ'] = I δ(τ,τ') − B(τ) δ(τ,τ'+1)   (+B(0) at the (0,Lτ−1) corner)
    B(τ)    = exp(−Δτ·K) · exp(−Δτ·V[x(τ)])
    exp(−Δτ·V)ᵢᵢ(τ) = exp(−Δτ·(λᵢxᵢ(τ) + λ₂ᵢxᵢ(τ)² − μᵢ))

Fields are ``[..., N, Lτ]`` with τ last; leading axes (chains, spins)
broadcast. exp(−Δτ·K) is routed by :func:`apply_expK`:

* dense ``[N, N]`` matmul when ``N <= dense_threshold``;
* else the CUDA checkerboard kernel when the field is on CUDA and
  ``N >= pallas_threshold``;
* else the plain torch fold (the only fold branch on the CPU).

Complex hopping (complex ``t`` or a twist of the boundaries) makes the
hopping tables, ``t`` and ``expK`` complex (``complex64``/``complex128``):
each bond block is the Hermitian ``[c s; s̄ c]`` with c = cosh(Δτ|t|),
s = (t/|t|)·sinh(Δτ|t|), :func:`mulMT` is then the adjoint M†, and the
forces on the real phonon field take the real part of the adjoint pairing.
The CUDA kernel folds complex fields in its complex mode.

Both thresholds default to 2048, values tuned on a TPU; an H100
measurement has to set them anew. ``precision`` (``[solver]
loop_precision``, passed only by the in-loop CG operator) selects the dense
matmul's arithmetic: ``None`` / ``"highest"`` the full precision of the
field dtype; ``"high"`` three bf16 products (hi·hi + hi·lo + lo·hi, the
bf16×3 of the JAX package's TPU matmul) and ``"default"`` one, accumulated
and returned in float32. The cheaper forms run only on a real float32 CUDA
field on the dense branch: on the CPU, in float64, under complex hopping
and on the fold branch every apply is full precision.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from elphdynamics_tpu_torch.lattice import Lattice, sort_neighbor_table
from elphdynamics_tpu_torch.ops import checkerboard as ckb
from elphdynamics_tpu_torch.ops import ckb_cuda
from elphdynamics_tpu_torch.utils.device import require_device
from elphdynamics_tpu_torch.utils.dtypes import complex_of, fsum
from elphdynamics_tpu_torch.utils.math import add_plan, ordered_add


@dataclass(frozen=True)
class HolsteinParams:
    """Model parameters as tensors on one device in one dtype."""

    mu: torch.Tensor      # [N] chemical potential
    omega: torch.Tensor   # [N] phonon frequency
    omega4: torch.Tensor  # [N] anharmonic X⁴ coefficient
    lam: torch.Tensor     # [N] linear el-ph coupling λ ([C, N]: one per chain, tempering)
    lam2: torch.Tensor    # [N] quadratic el-ph coupling λ₂ ([C, N] likewise)
    cosht: torch.Tensor   # [Nbonds] cosh(Δτ·|t|), checkerboard order (complex under complex t)
    sinht: torch.Tensor   # [Nbonds] (t/|t|)·sinh(Δτ·|t|), checkerboard order
    wij: torch.Tensor     # [Nwij] dispersive phonon coupling ωᵢⱼ (may be empty)
    t: torch.Tensor | None = None         # [Nbonds] bare hoppings, original order
    expK: torch.Tensor | None = None      # dense exp(−Δτ·K) (dense branch)
    expK_inv: torch.Tensor | None = None  # dense exp(+Δτ·K)


@dataclass(frozen=True, eq=False)
class HolsteinSpec:
    """Static (host) model description."""

    lattice: Lattice
    beta: float
    dtau: float
    Ltau: int
    Nsites: int
    Nph: int
    Nbonds: int
    Ndim: int
    Ndof: int
    ckb: ckb.CheckerboardSpec
    # exp(−Δτ·K) as a dense [N, N] matmul instead of the group fold
    dense_ckb: bool = False
    # fold branch at N >= pallas_threshold: the CUDA kernel for CUDA fields
    kernel_fold: bool = False
    wij_table: np.ndarray = field(default_factory=lambda: np.zeros((2, 0), dtype=np.int64))
    wij_sign: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    bond_defs: tuple = ()
    bond_def_of_bond: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    ckb_to_bond: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    bond_to_ckb: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    # a rank's block of a site-sharded model (parallel/lattice_shard.py):
    # fields hold Nsites = B sites, the fold is the halo fold, sums over
    # sites are all-reduced; None on one rank
    shard: object = None


def build_holstein(
    lattice: Lattice,
    beta: float,
    dtau: float,
    *,
    t_assignments=(),      # iterable of (t, stddev, o1, o2, (dL1,dL2,dL3))
    mu=0.0, mu_std=0.0,
    omega=1.0, omega_std=0.0,
    lam=0.0, lam_std=0.0,
    lam2=0.0, lam2_std=0.0,
    omega4=0.0, omega4_std=0.0,
    wij_assignments=(),    # iterable of (w, stddev, sign, o1, o2, (dL,))
    per_orbit: dict | None = None,
    rng: np.random.Generator | None = None,
    dtype: torch.dtype = torch.float64,
    device="cuda",
    # TPU-tuned defaults; to be re-set from H100 measurements
    dense_threshold: int = 2048,
    pallas_threshold: int = 2048,
    twist=None,            # (θ1, θ2[, θ3]) twisted-boundary flux angles, radians
) -> tuple[HolsteinSpec, HolsteinParams]:
    """Construct a Holstein model spec and parameters on ``device`` (the
    card unless the caller asks for the CPU).

    The disorder draws consume ``rng`` in the same order as the JAX
    package's ``build_holstein``, so one seed builds the same model in both.
    Complex ``t`` values, or a nonzero ``twist`` (every bond of displacement
    dL times the Peierls phase exp(i·Σ_d θ_d·dL_d/L_d)), make the hopping
    complex: the tables, ``t`` and ``expK`` then carry the complex type of
    ``dtype``.
    """
    device = require_device(device)
    rng = rng or np.random.default_rng(0)
    N = lattice.nsites
    Ltau = int(round(beta / dtau))

    def _assign(base, std, name):
        vals = base + std * rng.standard_normal(N) if std else np.full(N, float(base))
        if per_orbit and name in per_orbit:
            for orbit, (v, s) in per_orbit[name].items():
                sel = lattice.site_to_orbit == orbit
                vals = np.where(sel, v + (s * rng.standard_normal(N) if s else 0.0), vals)
        return vals

    mu_v = _assign(mu, mu_std, "mu")
    om_v = _assign(omega, omega_std, "omega")
    om4_v = _assign(omega4, omega4_std, "omega4")
    lam_v = _assign(lam, lam_std, "lambda")
    lam2_v = _assign(lam2, lam2_std, "lambda2")

    tw3 = None
    if twist is not None and np.any(np.asarray(twist)):
        tw3 = np.zeros(3)
        tw3[: len(tuple(twist))] = twist
    t_dtype = (np.complex128 if tw3 is not None
               or any(np.iscomplexobj(a[0]) for a in t_assignments) else np.float64)
    Ls = np.asarray([lattice.L1, lattice.L2, lattice.L3], np.float64)
    tables, tvals, bond_defs, bond_def_of_bond = [], [], [], []
    for idef, (tval, tstd, o1, o2, dL) in enumerate(t_assignments):
        tb = lattice.calc_neighbor_table(o1, o2, dL)
        nnew = tb.shape[1]
        phase = np.sign(tval) if tval != 0 else 1.0
        tv = phase * (abs(tval) + (tstd * rng.standard_normal(nnew) if tstd else 0.0))
        if tw3 is not None:
            dL3 = np.zeros(3)
            dL3[: len(dL)] = dL
            tv = tv * np.exp(1j * float(np.sum(tw3 * dL3 / Ls)))
        tables.append(tb)
        tvals.append(np.broadcast_to(tv, (nnew,)).astype(t_dtype))
        bond_defs.append((o1, o2, tuple(dL)))
        bond_def_of_bond.extend([idef] * nnew)
    if tables:
        table = np.concatenate(tables, axis=1)
        t = np.concatenate(tvals)
    else:
        table = np.zeros((2, 0), dtype=np.int64)
        t = np.zeros(0, dtype=t_dtype)
    table_sorted, perm = sort_neighbor_table(table)
    t_sorted = t[perm]
    cspec = ckb.build_checkerboard_spec(N, table_sorted)
    t_ckb = t_sorted[cspec.order]
    ckb_to_bond = perm[cspec.order] if table.shape[1] else np.zeros(0, dtype=np.int64)
    bond_to_ckb = np.argsort(ckb_to_bond) if table.shape[1] else np.zeros(0, dtype=np.int64)

    wtabs, wvals, wsigns = [], [], []
    for (wval, wstd, sgn, o1, o2, dL) in wij_assignments:
        tb = lattice.calc_neighbor_table(o1, o2, dL)
        nnew = tb.shape[1]
        wtabs.append(tb)
        wvals.append(wval + (wstd * rng.standard_normal(nnew) if wstd else np.zeros(nnew)))
        wsigns.append(np.full(nnew, int(sgn)))
    if wtabs:
        wij_table = np.concatenate(wtabs, axis=1)
        wij = np.concatenate(wvals)
        wij_sign = np.concatenate(wsigns)
    else:
        wij_table = np.zeros((2, 0), dtype=np.int64)
        wij = np.zeros(0)
        wij_sign = np.zeros(0, dtype=np.int64)

    dense_ckb = 0 < cspec.nbonds and N <= dense_threshold
    kernel_fold = not dense_ckb and cspec.nbonds > 0 and N >= pallas_threshold
    spec = HolsteinSpec(
        lattice=lattice, beta=float(beta), dtau=float(dtau), Ltau=Ltau,
        Nsites=N, Nph=N, Nbonds=cspec.nbonds, Ndim=N * Ltau, Ndof=N * Ltau,
        ckb=cspec, dense_ckb=dense_ckb, kernel_fold=kernel_fold,
        wij_table=wij_table, wij_sign=wij_sign, bond_defs=tuple(bond_defs),
        bond_def_of_bond=np.asarray(bond_def_of_bond, dtype=np.int64),
        ckb_to_bond=ckb_to_bond, bond_to_ckb=bond_to_ckb)
    cosh_v, sinh_v = _ckb_tables(dtau, t_ckb)
    cdtype = complex_of(dtype) if np.iscomplexobj(t) else dtype

    def T(a, to=dtype):
        a = np.asarray(a)
        return torch.as_tensor(a.astype(np.complex128 if np.iscomplexobj(a) else np.float64),
                               device=device).to(to)

    params = HolsteinParams(
        mu=T(mu_v), omega=T(om_v), omega4=T(om4_v), lam=T(lam_v), lam2=T(lam2_v),
        cosht=T(cosh_v, cdtype), sinht=T(sinh_v, cdtype), wij=T(wij), t=T(t, cdtype),
        expK=T(ckb.dense_matrix(cspec, cosh_v, sinh_v), cdtype) if dense_ckb else None,
        expK_inv=(T(ckb.dense_matrix(cspec, cosh_v, sinh_v, inverse=True), cdtype)
                  if dense_ckb else None),
    )
    return spec, params


def _ckb_tables(dtau: float, t_ckb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cosh, sinh) checkerboard coefficient tables: cosh/sinh(Δτ·t) for real
    t; for complex t the Hermitian bond-block convention c = cosh(Δτ|t|),
    s = (t/|t|)·sinh(Δτ|t|) (c complex128 with zero imaginary part), which
    is the real formula for real t (the sign rides the phase)."""
    if np.iscomplexobj(t_ckb):
        at = np.abs(t_ckb)
        phase = np.where(at > 0, t_ckb / np.where(at > 0, at, 1.0), 1.0)
        return np.cosh(dtau * at).astype(np.complex128), phase * np.sinh(dtau * at)
    return np.cosh(dtau * t_ckb), np.sinh(dtau * t_ckb)


# ---------------------------------------------------------------------------
# derived quantities
# ---------------------------------------------------------------------------

def site_leaf(a, like):
    """A per-site parameter against a field ``like`` ``[C, ..., N, Lτ]``:
    ``[N]`` is shared by every chain; ``[C, N]`` (parallel tempering's
    per-rung couplings) gives each chain its own, the chain axis leading."""
    if a.ndim == 1:
        return a[:, None]
    return a.reshape(a.shape[:1] + (1,) * (like.ndim - 3) + a.shape[1:] + (1,))


def expnV(spec: HolsteinSpec, p: HolsteinParams, x):
    """exp(−Δτ·V[x])ᵢᵢ(τ) = exp(−Δτ·(λx + λ₂x² − μ)), shape ``[..., N, Lτ]``."""
    lam = site_leaf(p.lam, x)
    lam2 = site_leaf(p.lam2, x)
    mu = p.mu[:, None]
    return torch.exp(-spec.dtau * (lam * x + lam2 * x * x - mu))


def _tau_sign_first(spec: HolsteinSpec, like):
    """[+1, −1, ..., −1]: the antiperiodic wrap at τ=0."""
    s = -torch.ones(spec.Ltau, dtype=like.dtype, device=like.device)
    s[:1].fill_(1.0)   # a fill, not a host-to-device copy (a CUDA graph captures it)
    return s


def _tau_sign_last(spec: HolsteinSpec, like):
    """[−1, ..., −1, +1]: the wrap at τ=Lτ−1 (Mᵀ)."""
    s = -torch.ones(spec.Ltau, dtype=like.dtype, device=like.device)
    s[-1:].fill_(1.0)
    return s


# ---------------------------------------------------------------------------
# fermion matrix multiplication routines
# ---------------------------------------------------------------------------

def _promote(p: HolsteinParams, y):
    """A real field meeting complex hopping becomes complex (as JAX promotes)."""
    if p.cosht.is_complex() and not y.is_complex():
        return y.to(p.cosht.dtype)
    return y


def _fold(spec: HolsteinSpec, p: HolsteinParams, y, *, reverse: bool):
    y = _promote(p, y)
    if spec.shard is not None:
        return spec.shard.fold(p.cosht, p.sinht, y, reverse=reverse)
    if spec.kernel_fold and y.is_cuda:
        return ckb_cuda.fold(spec.ckb, p.cosht, p.sinht, y.contiguous(), reverse=reverse)
    return ckb.fold(spec.ckb, p.cosht, p.sinht, y, reverse=reverse)


# bf16 products per dense matmul for each cheaper ``loop_precision``
# (``dynamics.solve.LOOP_PRECISIONS``); any other value runs full precision
BF16_PASSES = {"high": 3, "default": 1}


def _split_bf16(a):
    """a ≈ hi + lo, both bfloat16 (hi carries a's leading 8 bits, lo the next 8)."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(a.dtype)).to(torch.bfloat16)


def _bf16_operand(spec: HolsteinSpec, A, passes: int, adjoint: bool):
    """The bf16 operand of :func:`bf16_matmul` for the fixed matrix ``A``
    (for Aᵀ with ``adjoint``): [hi | hi | lo] along the inner axis for 3
    passes, hi for 1. Split once per matrix and kept in the checkerboard
    spec's cache for as long as the matrix lives: a CUDA graph that
    captured an apply (``dynamics/graphs.py``) reads the kept operand (its
    workspace keeps the matrix), so an apply of another matrix on the same
    spec must not free it, and a matrix that is dropped (a workspace built
    anew clones its own) takes its operand with it."""
    cache = spec.ckb._cache
    key = ("bf16_operand", passes, adjoint, id(A))
    hit = cache.get(key)
    if hit is None or hit[0]() is not A:
        hi, lo = _split_bf16(A.mT if adjoint else A)
        op = torch.cat([hi, hi, lo], dim=1) if passes == 3 else hi.contiguous()
        hit = cache[key] = (weakref.ref(A), op)
        weakref.finalize(A, cache.pop, key, None)
    return hit[1]


def _bf16_stack(y3, passes: int):
    """The bf16 operand of :func:`bf16_matmul` for a ``[B, N, Lτ]`` field:
    [hi; lo; hi] along the inner axis for 3 passes, hi for 1, written into
    one buffer (three launches, where splitting and concatenating takes
    five). lo is y − hi, exact in float32, rounded to bf16 on its write."""
    if passes == 1:
        return y3.to(torch.bfloat16)
    B, N, L = y3.shape
    buf = torch.empty((B, 3 * N, L), dtype=torch.bfloat16, device=y3.device)
    hi = buf[:, :N]
    hi.copy_(y3)
    torch.sub(y3, hi, out=buf[:, N:2 * N])
    buf[:, 2 * N:].copy_(hi)
    return buf


def bf16_matmul(A_op, y, passes: int):
    """A·y for a float32 ``[..., N, Lτ]`` y on CUDA, with A given as its
    bf16 operand (:func:`_bf16_operand`): ``passes`` bf16 products (3:
    hi·hi + hi·lo + lo·hi; 1: hi·hi), summed inside one cuBLAS bf16 GEMM
    over the concatenated inner axis and accumulated and returned in
    float32 (a bf16 ``torch.matmul`` would round its output to bf16)."""
    N, L = y.shape[-2], y.shape[-1]
    y3 = y.reshape(-1, N, L)
    out = torch.bmm(A_op.expand(y3.shape[0], -1, -1), _bf16_stack(y3, passes),
                    out_dtype=torch.float32)
    return out.reshape(y.shape)


def _dense(spec: HolsteinSpec, A, y, precision, adjoint: bool = False):
    """A·y (A†·y with ``adjoint``) over the site axis at ``precision``
    (module docstring)."""
    passes = BF16_PASSES.get(precision)
    if passes and y.is_cuda and y.dtype == torch.float32 and A.dtype == torch.float32:
        return bf16_matmul(_bf16_operand(spec, A, passes, adjoint), y, passes)
    return torch.matmul(A.mH if adjoint else A, y)


def apply_expK(spec: HolsteinSpec, p: HolsteinParams, y, precision=None):
    """exp(−Δτ·K)·y over the site axis (dense matmul at ``precision``, or
    the checkerboard fold)."""
    if spec.dense_ckb:
        return _dense(spec, p.expK, _promote(p, y), precision)
    return _fold(spec, p, y, reverse=False)


def apply_expK_T(spec: HolsteinSpec, p: HolsteinParams, y, precision=None):
    """exp(−Δτ·K)ᵀ·y: the adjoint exp(−Δτ·K)†·y under complex hopping
    (the reversed fold of Hermitian bond blocks is the adjoint; the dense
    branch conjugates)."""
    if spec.dense_ckb:
        return _dense(spec, p.expK, _promote(p, y), precision, adjoint=True)
    return _fold(spec, p, y, reverse=True)


def mulM(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = M·v: y(τ) = v(τ) − B(τ)·v(τ−1) for τ>0, y(0) = v(0) + B(0)·v(Lτ−1).
    ``env`` is :func:`expnV` of the phonon field."""
    y = env * torch.roll(v, 1, dims=-1)
    y = apply_expK(spec, p, y, precision)
    return v + _tau_sign_first(spec, v) * y


def mulMT(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = Mᵀ·v (M† under complex hopping): y(τ) = v(τ) − Bᵀ(τ+1)·v(τ+1),
    y(Lτ−1) = v(Lτ−1) + Bᵀ(0)·v(0)."""
    z = apply_expK_T(spec, p, v, precision)
    w = env * z
    return v + _tau_sign_last(spec, v) * torch.roll(w, -1, dims=-1)


def mulMTM(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = MᵀM·v."""
    return mulMT(spec, p, env, mulM(spec, p, env, v, precision), precision)


def mulMMT(spec: HolsteinSpec, p: HolsteinParams, env, v, precision=None):
    """y = MMᵀ·v."""
    return mulM(spec, p, env, mulMT(spec, p, env, v, precision), precision)


def muldMdx(spec: HolsteinSpec, p: HolsteinParams, env, x, u, v):
    """uᵀ·[∂M/∂xᵢ(τ)]·v for every dof:
    ±Δτ·(λᵢ + 2λ₂ᵢxᵢ(τ))·expnV(i,τ)·v(i,τ−1)·[exp(−ΔτK)ᵀu](i,τ),
    with the minus sign on the τ=0 slice. Complex fields give the force on
    the real field, Re[u†·∂M/∂x·v]."""
    lam = site_leaf(p.lam, x)
    lam2 = site_leaf(p.lam2, x)
    sgn = -_tau_sign_first(spec, x)
    d = sgn * spec.dtau * (lam + 2.0 * lam2 * x) * env * torch.roll(v, 1, dims=-1)
    y = apply_expK_T(spec, p, u)
    if y.is_complex() or d.is_complex():
        return (y.conj() * d).real
    return y * d


# ---------------------------------------------------------------------------
# bosonic (phonon) action
# ---------------------------------------------------------------------------

def _wij_tables(spec: HolsteinSpec, like):
    """The dispersive pairs' site indices ``i``, ``j``, signs ``[Nwij, 1]``
    and the fixed-order plan of their force sum (:func:`..utils.math.add_plan`
    of the sources ``[i side; j side]``) on ``like``'s device, uploaded once
    per device and dtype and kept in the checkerboard spec's cache (a
    captured update reads them, never uploads)."""
    key = ("wij_tables", str(like.device), like.dtype)
    hit = spec.ckb._cache.get(key)
    if hit is None:
        members, valid = add_plan(np.concatenate(spec.wij_table[:2]), spec.Nsites)
        hit = spec.ckb._cache[key] = (
            torch.as_tensor(spec.wij_table[0], device=like.device),
            torch.as_tensor(spec.wij_table[1], device=like.device),
            torch.as_tensor(spec.wij_sign, dtype=like.dtype, device=like.device)[:, None],
            torch.as_tensor(members, device=like.device),
            torch.as_tensor(valid[:, :, None], device=like.device))
    return hit


def calc_Sb(spec: HolsteinSpec, p: HolsteinParams, x, shifted: bool = False):
    """Phonon action Sb = Δτ·Σ[ω²x²/2 + ω₄x⁴ − λx·shifted + (Δx/Δτ)²/2
    + ωᵢⱼ²(xᵢ±xⱼ)²/2], summed over the last two axes in float64 (over every
    rank's sites on a site-sharded model)."""
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    lam = site_leaf(p.lam, x)
    dx = x - torch.roll(x, 1, dims=-1)
    sb = om2 * x * x / 2 + om4 * x ** 4 + dx * dx / (2 * spec.dtau ** 2)
    if shifted:
        sb = sb - lam * x
    total = fsum(sb, dim=(-2, -1))
    if spec.shard is not None:
        if spec.wij_table.shape[1] > 0:
            total = total + spec.shard.wij_sb(p.wij, spec.wij_sign, x)
        return spec.dtau * spec.shard.sum(total)
    if spec.wij_table.shape[1] > 0:
        i, j, sgn = _wij_tables(spec, x)[:3]
        pair = x.index_select(-2, i) + sgn * x.index_select(-2, j)
        total = total + ((p.wij ** 2)[:, None] * pair * pair / 2).sum(dim=(-2, -1))
    return spec.dtau * total


def calc_dSbdx(spec: HolsteinSpec, p: HolsteinParams, x, shifted: bool = False):
    """∂Sb/∂xᵢ(τ)."""
    om2 = (p.omega ** 2)[:, None]
    om4 = p.omega4[:, None]
    lam = site_leaf(p.lam, x)
    lap = torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1) - 2.0 * x
    d = spec.dtau * (om2 * x + 4.0 * om4 * x ** 3) - lap / spec.dtau
    if shifted:
        d = d - spec.dtau * lam
    if spec.shard is not None and spec.wij_table.shape[1] > 0:
        return spec.shard.wij_dsb(p.wij, spec.wij_sign, spec.dtau, x, d)
    if spec.wij_table.shape[1] > 0:
        # each site adds its pairs' terms in a fixed order (its i-side pairs,
        # then its j-side ones): a site that ends several pairs would make an
        # index_add an atomic sum in no fixed order on the card
        i, j, sgn, members, valid = _wij_tables(spec, x)
        w2 = (p.wij ** 2)[:, None]
        pair = spec.dtau * w2 * (x.index_select(-2, i) + sgn * x.index_select(-2, j))
        d = ordered_add(d, torch.cat([pair, sgn * pair], dim=-2), members, valid)
    return d


# ---------------------------------------------------------------------------
# Λ operators for the HMC exponential-shift trick
# ---------------------------------------------------------------------------

def calc_Lambda(spec: HolsteinSpec, p: HolsteinParams, x):
    """Λ(i,τ) = exp(−Δτ·(λx + λ₂x²)/2)."""
    lam = site_leaf(p.lam, x)
    lam2 = site_leaf(p.lam2, x)
    return torch.exp(-spec.dtau * (lam * x + lam2 * x * x) / 2.0)


def mulLambda(spec: HolsteinSpec, Lam, v):
    """v' = Λ·v: v'(τ) = −Λ(τ+1)v(τ+1), v'(Lτ−1) = Λ(0)v(0)."""
    w = Lam * v
    return _tau_sign_last(spec, w) * torch.roll(w, -1, dims=-1)


def mulLambdaInv(spec: HolsteinSpec, Lam, v):
    """v' = Λ⁻¹·v: v'(τ) = −v(τ−1)/Λ(τ), v'(0) = v(Lτ−1)/Λ(0)."""
    return _tau_sign_first(spec, v) * torch.roll(v, 1, dims=-1) / Lam


def muldLambdadx(spec: HolsteinSpec, p: HolsteinParams, x, Lam, vl, vr):
    """⟨vₗ|∂Λ/∂x(τ)|vᵣ⟩ per dof, to be added to a force:
    ±vₗ(i,τ)·Δτ·(λᵢ/2 + λ₂ᵢxᵢ(τ))·Λ(i,τ)·vᵣ(i,τ−1), minus on τ=0
    (Re[vₗ†·∂Λ/∂x·vᵣ] for complex fields; Λ itself is real)."""
    lam = site_leaf(p.lam, x)
    lam2 = site_leaf(p.lam2, x)
    sgn = -_tau_sign_first(spec, Lam)
    base = sgn * spec.dtau * (lam / 2.0 + lam2 * x) * Lam * torch.roll(vr, 1, dims=-1)
    if vl.is_complex() or base.is_complex():
        return (vl.conj() * base).real
    return vl * base
