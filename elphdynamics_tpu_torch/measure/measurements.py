"""Observable measurements, binning and post-processing.

Counterpart of ``elphdynamics_tpu/measure/measurements.py`` for the
Holstein and optical SSH models, real or complex hopping. The measurement
step accumulates per sampler sweep:

* global: density, ⟨N̂²⟩, μ;
* on-site per orbital: density, double occupancy, μ, and for Holstein ⟨x⟩,
  ⟨x²⟩, ⟨x⁴⟩, phonon kinetic and potential energy, electron-phonon energy;
* inter-site per bond definition: electron kinetic energy (with the
  modulated hopping t′ for SSH), and for SSH the bond-phonon statistics
  and the fraction of sign-switched bonds, over each definition's own bond
  count;
* on-site correlations: Greens, DenDen, SpinSpin, PairGreens, and
  PhononGreens for Holstein's site phonons, with their τ=β boundary
  identities;
* inter-site correlations over pairs of bond definitions: BondBond,
  CurrentCurrent and BondPairGreens (:mod:`.intersite_corr`), and for SSH
  the bond-phonon PhononGreens over pairs of phonon types;
* snapshots: density, double occupancy, phonon position.

Every accumulated quantity is linear in the pair-summed estimator tensors
(:mod:`.greens`), so the step assembles everything once from those and from
per-probe sums:

    Σ_{i<j}(aᵢ + aⱼ) = (nᵥ−1)·Σᵢaᵢ,
    Σ_{i<j} aᵢ·bⱼ + aⱼ·bᵢ = (Σa)(Σb) − Σᵢaᵢbᵢ.

Complex hopping (the time-reversal-symmetric twist ensemble, spin ↓ on the
conjugate phases): the per-probe estimates pair M⁻¹r with conj(r), the
scalars run on their real parts (the spin-summed density is 2 − 2·Re G),
the bond kinetic energy is the Hermitian pair 2·Re[t·G↑(1,2) + t̄·G↑(2,1)],
and SpinSpin gains the direct term 4·GDD_minus.

Chains: the step measures every chain of a ``[C, N, Lτ]`` batch, the
probe solves on all of them at once and the estimators on equal blocks of
chains sized by :func:`analyze_chains` (their memory grows with the chains);
:func:`mean_over_chains` then averages the increments over the chains whose
probe solves succeeded. Per bin, :func:`process_bin` normalises, moves the
correlations to momentum space and integrates the susceptibilities
(PairSusc, ChargeSusc, SpinSusc, BondPairSusc).

A site-sharded run measures in two halves: the probe solves on each rank's
block of sites (:func:`make_probe_solve`, segmented like the measurement
step: replayed as CUDA graphs with the site group's all-reduces and halos
inside them on NCCL ranks, eager on a gloo site group on a card), then the
estimators of the whole model on the gathered probes
(``step.analyze``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from elphdynamics_tpu_torch.dynamics import graphs
from elphdynamics_tpu_torch.dynamics.solve import SolverConfig
from elphdynamics_tpu_torch.measure import greens as G
from elphdynamics_tpu_torch.measure import intersite_corr as IC
from elphdynamics_tpu_torch.models import ssh as Sm
from elphdynamics_tpu_torch.models.adapter import ModelOps
from elphdynamics_tpu_torch.utils.dtypes import complex_of
from elphdynamics_tpu_torch.utils.math import simpson

ONSITE_CORR_KINDS = ("Greens", "DenDen", "SpinSpin", "PairGreens", "PhononGreens")
INTERSITE_CORR_KINDS = ("BondBond", "CurrentCurrent", "BondPairGreens", "PhononGreens")
SUSC_MAP = {"PairGreens": "PairSusc", "DenDen": "ChargeSusc", "SpinSpin": "SpinSusc",
            "BondPairGreens": "BondPairSusc"}


@dataclass(frozen=True)
class MeasurementSpec:
    """Static measurement configuration (the ``[measurements]`` table).
    ``onsite_corr`` / ``intersite_corr`` hold ``(kind, time_dependent[,
    pairs])`` entries."""

    nv: int = 10
    onsite_corr: tuple = ()
    intersite_corr: tuple = ()
    onsite_pairs: tuple | None = None      # orbital pairs; None = all
    intersite_pairs: tuple | None = None
    snapshots: tuple = ()        # subset of (density, double_occupancy, phonon_position)

    def check(self) -> None:
        """Raise for a correlation kind that does not exist."""
        for entries, known, where in ((self.onsite_corr, ONSITE_CORR_KINDS, "on-site"),
                                      (self.intersite_corr, INTERSITE_CORR_KINDS, "inter-site")):
            unknown = [e[0] for e in entries if e[0] not in known]
            if unknown:
                raise ValueError(f"unknown {where} correlation kinds {unknown}")


# the bytes of pair-summed tensors that one pass of the estimators
# (``analyze``) may hold, counted as :func:`analyze_chains` counts them. A
# pass peaks at 10–15 times that count (1.2–1.8 GB per chain at 64×64, Lτ =
# 40, nᵥ = 10, float32; PERF.md §6): a batch of every chain, 64 of them at
# ``--chains 0`` for SSH at N = 4096, does not fit on an 80 GB card, and
# this budget gives such a batch blocks of 8 chains, while the small
# lattices' thousands of chains stay in one or a few passes
ANALYZE_BYTES = 10 ** 9


def analyze_chains(n_chains: int, nv: int, n_sites: int, ltau: int,
                   dtype: torch.dtype) -> int:
    """Chains per pass of the estimators for a batch of ``n_chains``: as
    many as keep one pair-summed tensor per probe pair (nᵥ(nᵥ−1)/2 of them,
    each 2·N·Lτ complex elements of ``dtype``'s precision per chain) within
    ``ANALYZE_BYTES``, the batch then cut into equal blocks (the last may
    be smaller)."""
    pairs = max(nv * (nv - 1) // 2, 1)
    per_chain = pairs * 2 * n_sites * ltau * complex_of(dtype).itemsize
    most = max(1, ANALYZE_BYTES // per_chain)
    blocks = -(-n_chains // most)
    return -(-n_chains // blocks)


def _join_chains(blocks: list):
    """Nested dicts and tuples of per-chain tensors, one per block of chains,
    joined along the chain axis."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _join_chains([b[k] for b in blocks]) for k in first}
    if isinstance(first, tuple):
        return tuple(_join_chains(list(parts)) for parts in zip(*blocks))
    return torch.cat(blocks, dim=0)


def _unit(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The first unit vector of length ``n``, made on ``device`` (a
    segmented measurement's graph holds no copy of host data)."""
    return (torch.arange(n, device=device) == 0).to(dtype)


def _corr_pairs(n, explicit):
    if explicit is not None:
        return np.asarray(explicit, dtype=np.int64).reshape(-1, 2)
    return np.asarray([(i, j) for i in range(n) for j in range(n)], dtype=np.int64)


def _normalize_kinds(entries):
    """(kind, td[, pairs]) tuples -> {kind: (td, pairs_or_None)}."""
    return {e[0]: (e[1], e[2] if len(e) > 2 else None) for e in entries}


PHONON_STATS = ("x", "x2", "x4", "phonon_ke", "phonon_pe", "elph_energy")


def _phonon_types(spec) -> int:
    """SSH phonon types: the bond definitions that carry a phonon (at least 1)."""
    return max(sum(1 for d in spec.bond_defs if d[3]), 1)


def _container_shapes(ops: ModelOps, mspec: MeasurementSpec) -> dict:
    lat = ops.spec.lattice
    no = lat.unit_cell.norbits
    ndefs = len(ops.spec.bond_defs)
    T = ops.Ltau + 1
    shapes: dict[str, Any] = {"global": {"density": (), "Nsqr": (), "mu": ()}}
    onsite = ("density", "double_occ", "mu") + (PHONON_STATS if ops.is_holstein else ())
    shapes["onsite"] = {k: (no,) for k in onsite}
    inter = ("el_ke",) + (() if ops.is_holstein else PHONON_STATS + ("sign_switch",))
    shapes["intersite"] = {k: (ndefs,) for k in inter}
    shapes["onsite_corr"] = {
        kind: (len(_corr_pairs(no, kp if kp is not None else mspec.onsite_pairs)),
               lat.L1, lat.L2, lat.L3, T if td else 1)
        for kind, (td, kp) in _normalize_kinds(mspec.onsite_corr).items()}
    # pairs of bond definitions; SSH's bond PhononGreens: pairs of phonon types
    shapes["intersite_corr"] = {
        kind: (len(_corr_pairs(_phonon_types(ops.spec), kp) if kind == "PhononGreens" else
                   _corr_pairs(ndefs, kp if kp is not None else mspec.intersite_pairs)),
               lat.L1, lat.L2, lat.L3, T if td else 1)
        for kind, (td, kp) in _normalize_kinds(mspec.intersite_corr).items()}
    return shapes


def zero_container(ops: ModelOps, mspec: MeasurementSpec, dtype: torch.dtype, device) -> dict:
    """The bin accumulator: real groups in ``dtype``, correlations in its
    complex type, on ``device``."""
    out = {}
    for group, shapes in _container_shapes(ops, mspec).items():
        dt = complex_of(dtype) if group.endswith("_corr") else dtype
        out[group] = {k: torch.zeros(v, dtype=dt, device=device) for k, v in shapes.items()}
    return out


# ---------------------------------------------------------------------------
# the measurement step
# ---------------------------------------------------------------------------

def make_measurement_step(ops: ModelOps, mspec: MeasurementSpec,
                          scfg: SolverConfig = SolverConfig(), precond=None,
                          eager: bool = False, chain_block: int | None = None):
    """Build ``step(params, x, generator=None, R=None) -> (increments,
    stats, snapshots)`` for fields ``x`` ``[C, N, Lτ]``: every increment
    and snapshot has a leading chain axis; ``stats`` holds the per-chain
    ``iters`` and ``flag`` of the probe solves. ``R`` injects the probes
    (``step.draw(params, x, generator)`` draws them as a call does).
    ``step.analyze(params, x, gd)`` is everything after the solves.

    On one rank or a chain rank (its block, or the gathered rung-0 chains
    under tempering), with CG or block CG over the nᵥ probes
    (``scfg.block``) or BiCGStab / GMRES on M, on a real field or under
    complex hopping, and with any preconditioner (KPM, with or without the
    exact low-frequency blocks, or the near-null one), a call is a fixed
    sequence of segments over one workspace (``dynamics/graphs.py``),
    as the HMC update is: ``probe_start`` (the derived state, the full
    preconditioner setup at x, CG's b = MᵀR and the solve's start from
    zero), the solve's segments (:class:`..dynamics.graphs.CGSolve` or
    :class:`..dynamics.graphs.NonsymSolve`), and ``analyze`` (the
    pair tensors, every estimator,
    the snapshots). The probes are drawn eagerly, in the eager order, and
    copied into the workspace. On a CUDA field each segment is captured
    once as a CUDA graph and replayed, the host keeping the eager solve's
    reads; on the CPU the segments run directly, doing the eager
    measurement's arithmetic in its order. ``eager`` asks for the eager
    call where the segmented one would run; ``step.segmented`` says whether
    the configuration takes it (on a site shard where
    :func:`..dynamics.graphs.graphable` lets the call's device),
    ``step.workspace()`` is its
    workspace (None before the first segmented call). ``chain_block``: the
    chains per pass of the estimators (None: :func:`analyze_chains` of the
    batch)."""
    mspec.check()
    if ops.is_holstein and any(e[0] == "PhononGreens" for e in mspec.intersite_corr):
        raise ValueError("PhononGreens is an on-site correlation for the Holstein model "
                         "(site phonons); the inter-site one is SSH's bond phonons")
    lat = ops.spec.lattice
    spec = ops.spec
    no = lat.unit_cell.norbits
    Lt = ops.Ltau
    nv = mspec.nv
    n_pairs = nv * (nv - 1) // 2
    norm_site = lat.ncells * Lt
    ndefs = len(spec.bond_defs)
    onsite_pairs = _corr_pairs(no, mspec.onsite_pairs)
    onsite_kinds = _normalize_kinds(mspec.onsite_corr)
    inter_kinds = _normalize_kinds(mspec.intersite_corr)
    inter_pairs = _corr_pairs(ndefs, mspec.intersite_pairs)
    bond_kinds = [k for k in inter_kinds if k != "PhononGreens"]

    # the static index tables: arrays here, tensors on a device made once
    # there (:func:`tables`), so that a measurement uploads nothing
    arrays = {}
    arrays["iu"], arrays["ju"] = G.pair_indices(nv)
    if spec.Nbonds:
        arrays["s1"] = spec.ckb.neighbor_table[0][spec.bond_to_ckb]
        arrays["s2"] = spec.ckb.neighbor_table[1][spec.bond_to_ckb]
        bdef = spec.bond_def_of_bond if ops.is_holstein else spec.bond_to_definition
        arrays["bdef_mask"] = np.asarray(bdef)[:, None] == np.arange(ndefs)[None, :]
        if not ops.is_holstein:
            # per-definition volume: each definition's own bond count times Lτ
            def_counts = np.bincount(spec.bond_to_definition, minlength=ndefs)
            arrays["Vb"] = np.maximum(def_counts, 1) * Lt
            arrays["has_ph"] = (spec.bond_to_phonon >= 0)[:, None]
            arrays["php"] = np.maximum(spec.bond_to_phonon, 0)
    for kind, (_, kp) in onsite_kinds.items():
        kp = _corr_pairs(no, kp) if kp is not None else onsite_pairs
        arrays[f"o1/{kind}"], arrays[f"o2/{kind}"] = kp[:, 0], kp[:, 1]
        arrays[f"same/{kind}"] = kp[:, 0] == kp[:, 1]
    if "PhononGreens" in inter_kinds:
        ph_pairs = _corr_pairs(_phonon_types(spec), inter_kinds["PhononGreens"][1])
        arrays["ph0"], arrays["ph1"] = ph_pairs[:, 0], ph_pairs[:, 1]
    # each bond-pair correlation's pairs of bond definitions, as ints
    bond_pair_lists = {
        kind: [tuple(int(i) for i in p) for p in
               (_corr_pairs(ndefs, inter_kinds[kind][1]) if inter_kinds[kind][1] is not None
                else inter_pairs)]
        for kind in bond_kinds}
    dev_tables: dict = {}

    def tables(dev) -> dict:
        """``arrays`` as tensors on ``dev`` (and the bond definitions' base
        cells for CurrentCurrent), made on first use there
        (:func:`..dynamics.graphs.made_once`)."""
        def make():
            t = {k: torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for k, a in arrays.items()}
            t["pairs"] = (t.pop("iu"), t.pop("ju"))
            if "CurrentCurrent" in inter_kinds:
                t["cells"] = IC.hopping_cells(spec, dev)
            return t
        return graphs.made_once(dev_tables, dev, make, "the measurement's index tables")

    def analyze_block(params, x, gd: G.GreensData):
        """:func:`analyze` on one block of chains."""
        dev, dt = x.device, x.dtype
        C = x.shape[0]
        T = tables(dev)

        def orbit_sum(f):
            """[C, N, Lτ] -> per-orbital totals [C, nₒ] (sites run orbit
            fastest; a sum, where an atomic scatter would add in a varying
            order on a card)."""
            return f.sum(dim=-1).reshape(C, lat.ncells, no).sum(dim=1)

        def chains(v):
            return v.expand((C,) + tuple(v.shape))

        R, MinvR = gd.R, gd.MinvR
        pt = G.pair_tensor_sums(lat, R, MinvR, T["pairs"])
        out: dict[str, Any] = {"global": {}, "onsite": {}, "intersite": {},
                               "onsite_corr": {}, "intersite_corr": {}}

        # per-probe diagonal estimates Gᵢ(s, τ) = (M⁻¹rᵢ ⊙ conj rᵢ)(s, τ).
        # Complex hopping: the spin-summed density is 2 − 2·Re G (the Im
        # parts of ↑ and ↓ = conj cancel), so the scalars run on Re G, and
        # the double occupancy keeps the complex field
        cplx = R.is_complex()
        Rp = R.conj() if cplx else R
        Gdiag_c = MinvR * Rp                          # [C, nv, N, Lt]
        Gdiag = Gdiag_c.real if cplx else Gdiag_c
        TrG = Gdiag.sum(dim=(-2, -1)) / Lt            # [C, nv]
        N_per_vec = 2.0 * (spec.Nsites - TrG)

        # ---- global
        out["global"]["density"] = (nv - 1) / 2.0 * N_per_vec.sum(dim=-1) / spec.Nsites
        sumN = N_per_vec.sum(dim=-1)
        NN = (sumN ** 2 - (N_per_vec ** 2).sum(dim=-1)) / 2.0
        g0d_sum = pt.G0D_GD0[..., 0].real.sum(dim=tuple(range(1, pt.G0D_GD0.ndim - 1)))
        out["global"]["Nsqr"] = (NN + (nv - 1) * TrG.sum(dim=-1)
                                 - 2.0 * (spec.Nsites / no) * g0d_sum)
        out["global"]["mu"] = chains(n_pairs * params.mu.mean())

        # ---- on-site
        sum1mG = (1.0 - Gdiag).sum(dim=1)             # [C, N, Lt]
        dens_site = (nv - 1) * sum1mG
        # ⟨n↑n↓⟩ = Σpairs Re[(1−G₁)(1−conj G₂)] = (|Σ(1−G)|² − Σ|1−Gᵢ|²)/2
        omg_c = 1.0 - Gdiag_c
        docc_site = (omg_c.sum(dim=1).abs() ** 2 - (omg_c.abs() ** 2).sum(dim=1)) / 2.0
        out["onsite"]["density"] = orbit_sum(dens_site) / norm_site
        out["onsite"]["double_occ"] = orbit_sum(docc_site) / norm_site
        out["onsite"]["mu"] = n_pairs * orbit_sum(chains(params.mu[:, None].expand(-1, Lt))) / norm_site
        dtau = spec.dtau
        if ops.is_holstein:
            dx = torch.roll(x, -1, dims=-1) - x
            ke = 0.5 / dtau - dx ** 2 / (2 * dtau ** 2)
            pe = (params.omega ** 2)[:, None] * x ** 2 / 2 + params.omega4[:, None] * x ** 4
            out["onsite"]["x"] = n_pairs * orbit_sum(x) / norm_site
            out["onsite"]["x2"] = n_pairs * orbit_sum(x ** 2) / norm_site
            out["onsite"]["x4"] = n_pairs * orbit_sum(x ** 4) / norm_site
            out["onsite"]["phonon_ke"] = n_pairs * orbit_sum(ke) / norm_site
            out["onsite"]["phonon_pe"] = n_pairs * orbit_sum(pe) / norm_site
            # λ⟨x(n₊+n₋)⟩: Σpairs λx(2−G₁−G₂) = λx[2·n_pairs − (nv−1)ΣᵢGᵢ]
            elph = params.lam[:, None] * x * (2.0 * n_pairs - (nv - 1) * Gdiag.sum(dim=1))
            out["onsite"]["elph_energy"] = orbit_sum(elph) / norm_site

        # ---- inter-site: bond kinetic energy per definition (+ SSH phonons)
        if spec.Nbonds == 0:
            out["intersite"] = {k: torch.zeros((C, ndefs), dtype=dt, device=dev)
                                for k in _container_shapes(ops, mspec)["intersite"]}
        else:
            s1, s2, bdef_mask = T["s1"], T["s2"], T["bdef_mask"]
            # complex hopping: conj probe and Re (each pair's ↑/↓ assignment
            # symmetrises to the spin-summed 2·Re G per vector)
            est_12c = MinvR.index_select(-2, s1) * Rp.index_select(-2, s2)
            est_21c = MinvR.index_select(-2, s2) * Rp.index_select(-2, s1)
            est_12 = est_12c.real if cplx else est_12c
            est_21 = est_21c.real if cplx else est_21c
            h = -(nv - 1) * (est_12 + est_21).sum(dim=1)          # [C, Nbonds, Lt]

            def ke_pairs(tf):
                """Σpairs of the bond kinetic energy for the hoppings ``tf``:
                −tf·h, or under complex hopping the Hermitian pair
                −t·c†₂c₁ − t̄·c†₁c₂ per spin, spin-summed to
                2·Re[t·G↑(1,2) + t̄·G↑(2,1)]."""
                if not cplx:
                    return -tf * h
                w = tf.unsqueeze(1) if tf.ndim == 3 else tf    # SSH's [C, Nb, Lt] per probe
                return (nv - 1) * (w * est_12c + w.conj() * est_21c).real.sum(dim=1)

            def per_def(v, V):
                """Per-bond values summed per bond definition (a masked sum,
                in a fixed order), over the volumes ``V``."""
                zero = torch.zeros((), dtype=dt, device=dev)
                return torch.where(bdef_mask, v.sum(dim=-1)[:, :, None], zero).sum(dim=1) / V

            if ops.is_holstein:
                out["intersite"]["el_ke"] = per_def(ke_pairs(params.t[:, None]),
                                                    lat.ncells * Lt)
            else:
                Vb = T["Vb"].to(dt)
                tp = Sm.hopping_t_prime(spec, params, x)          # [C, Nbonds, Lt]
                tf = tp if params.t_phase is None else params.t_phase[:, None] * tp
                out["intersite"]["el_ke"] = per_def(ke_pairs(tf), Vb)
                # the phonon-carrying bonds
                has_ph, php = T["has_ph"], T["php"]
                xb = x.index_select(-2, php)
                om = params.omega[php][:, None]
                al = params.alpha[php][:, None]
                dxb = torch.roll(xb, -1, dims=-1) - xb
                zero = torch.zeros((), dtype=dt, device=dev)

                def acc(v):
                    return per_def(torch.where(has_ph, v, zero), Vb)

                out["intersite"]["x"] = n_pairs * acc(xb)
                out["intersite"]["x2"] = n_pairs * acc(xb ** 2)
                out["intersite"]["x4"] = n_pairs * acc(xb ** 4)
                out["intersite"]["phonon_ke"] = n_pairs * acc(0.5 / dtau - dxb ** 2 / (2 * dtau ** 2))
                out["intersite"]["phonon_pe"] = n_pairs * acc(om ** 2 * xb ** 2 / 2)
                out["intersite"]["elph_energy"] = acc(al * h * xb)
                switch = (torch.sign(params.t[:, None]) != torch.sign(tp)).to(dt)
                out["intersite"]["sign_switch"] = n_pairs * acc(switch)

        # ---- on-site correlations
        def oslices(kind):
            o1, o2 = T[f"o1/{kind}"], T[f"o2/{kind}"]

            def at0(A, a, b):
                return A[:, a, b, 0, 0, 0, 0][:, :, None, None, None]

            dims = pt.G.shape[3:6]
            delta_r = _unit(math.prod(dims), dt, dev).reshape(dims)
            same = T[f"same/{kind}"]
            return {"o1": o1, "o2": o2, "Gp": pt.G[:, o2, o1], "GGp": pt.GG[:, o2, o1],
                    "GDDp": pt.GDD_G00[:, o2, o1], "G0Dp": pt.G0D_GD0[:, o2, o1],
                    "G_o2o2_00": at0(pt.G, o2, o2), "G_o1o1_00": at0(pt.G, o1, o1),
                    "G_o2o1_00": at0(pt.G, o2, o1),
                    "delta": same[:, None, None, None].to(dt) * delta_r[None]}

        def tslice(A, td):
            """[C, np, l..., 2Lt] -> [C, np, l..., Lt(+1)] with τ=β = τ=0."""
            return torch.cat([A[..., :Lt], A[..., :1]], dim=-1) if td else A[..., :1]

        delta_t0 = _unit(2 * Lt, dt, dev)
        if "Greens" in onsite_kinds:
            td = onsite_kinds["Greens"][0]
            sl = oslices("Greens")
            main = sl["Gp"][..., :Lt] if td else sl["Gp"][..., :1]
            if td:
                # G(β) = δᵣ − G(0), per-pair sum: δ → n_pairs·δ
                beta = (n_pairs * sl["delta"] - sl["Gp"][..., 0])[..., None]
                main = torch.cat([main, beta], dim=-1)
            out["onsite_corr"]["Greens"] = main
        if "DenDen" in onsite_kinds:
            td = onsite_kinds["DenDen"][0]
            sl = oslices("DenDen")
            dd = 4.0 * (n_pairs - sl["G_o2o2_00"][..., None] - sl["G_o1o1_00"][..., None]
                        + sl["GDDp"]
                        + 0.5 * (sl["delta"][..., None] * delta_t0
                                 * sl["G_o2o1_00"][..., None] - sl["G0Dp"]))
            out["onsite_corr"]["DenDen"] = tslice(dd, td)
        if "SpinSpin" in onsite_kinds:
            td = onsite_kinds["SpinSpin"][0]
            sl = oslices("SpinSpin")
            ss = (-2.0 * sl["G0Dp"]
                  + 2.0 * sl["delta"][..., None] * delta_t0 * sl["G_o2o1_00"][..., None])
            if pt.GDD_minus is not None:
                # twisted direct term: n↑ − n↓ = −2i·Im G↑ per configuration,
                # so ⟨SzΔSz0⟩ gains −4·⟨Im GΔΔ·Im G00⟩ = +4·GDD_minus
                ss = ss + 4.0 * pt.GDD_minus[:, sl["o2"], sl["o1"]]
            if td:
                # τ=β: swapped orbitals, negated displacement
                o1, o2 = sl["o1"], sl["o2"]
                neg = G._neg_index(pt.G0D_GD0[:, o1, o2][..., 0], (-3, -2, -1))
                G_sw_00 = pt.G[:, o1, o2, 0, 0, 0, 0][:, :, None, None, None]
                beta = -2.0 * neg + 2.0 * sl["delta"] * G_sw_00
                if pt.GDD_minus is not None:
                    beta = beta + 4.0 * G._neg_index(pt.GDD_minus[:, o1, o2][..., 0],
                                                     (-3, -2, -1))
                ss = torch.cat([ss[..., :Lt], beta[..., None]], dim=-1)
            else:
                ss = ss[..., :1]
            out["onsite_corr"]["SpinSpin"] = ss
        if "PairGreens" in onsite_kinds:
            td = onsite_kinds["PairGreens"][0]
            sl = oslices("PairGreens")
            pg = sl["GGp"]
            if td:
                beta = pg[..., 0] + sl["delta"] * (n_pairs - 2.0 * sl["G_o1o1_00"].real)
                pg = torch.cat([pg[..., :Lt], beta[..., None]], dim=-1)
            else:
                pg = pg[..., :1]
            out["onsite_corr"]["PairGreens"] = pg
        if "PhononGreens" in onsite_kinds:
            td = onsite_kinds["PhononGreens"][0]
            xc = G.to_cell_layout(lat, x).to(complex_of(dt))     # [C, no, L1, L2, L3, Lt]
            xx = n_pairs * G.translational_average(xc[:, T["o1/PhononGreens"]],
                                                   xc[:, T["o2/PhononGreens"]])
            out["onsite_corr"]["PhononGreens"] = (torch.cat([xx, xx[..., :1]], dim=-1)
                                                  if td else xx[..., :1])

        # ---- inter-site correlations: SSH's bond-phonon Green's function
        if "PhononGreens" in inter_kinds:
            ntypes = _phonon_types(spec)
            td = inter_kinds["PhononGreens"][0]
            per_type = ops.Nph // ntypes
            if per_type != lat.ncells:
                raise ValueError("SSH PhononGreens needs one phonon per unit cell per type "
                                 "(bond deduplication on tiny lattices breaks this)")
            xt = x.reshape(C, ntypes, lat.L3, lat.L2, lat.L1, Lt).permute(0, 1, 4, 3, 2, 5)
            xt = xt.to(complex_of(dt))
            xx = n_pairs * G.translational_average(xt[:, T["ph1"]], xt[:, T["ph0"]])
            out["intersite_corr"]["PhononGreens"] = (torch.cat([xx, xx[..., :1]], dim=-1)
                                                     if td else xx[..., :1])

        # ---- inter-site correlations over pairs of bond definitions
        if bond_kinds:
            bf = IC.BondFields(lat, R, MinvR, T["pairs"], complex_of(dt))

            def bond_pairs(kind):
                return inter_kinds[kind][0], bond_pair_lists[kind]

            if "BondBond" in inter_kinds:
                td, bp = bond_pairs("BondBond")
                out["intersite_corr"]["BondBond"] = IC.measure_bondbond(ops, pt, bf, bp, td)
            if "CurrentCurrent" in inter_kinds:
                td, bp = bond_pairs("CurrentCurrent")
                out["intersite_corr"]["CurrentCurrent"] = IC.measure_currentcurrent(
                    ops, params, x, pt, bf, bp, td, T["cells"])
            if "BondPairGreens" in inter_kinds:
                td, bp = bond_pairs("BondPairGreens")
                out["intersite_corr"]["BondPairGreens"] = IC.measure_bondpairgreens(
                    ops, pt, bf, bp, td, n_pairs)

        # ---- snapshots: per-site instantaneous estimates
        snaps = {}
        if "density" in mspec.snapshots or "double_occupancy" in mspec.snapshots:
            Gsite = Gdiag_c.mean(dim=(1, -1))        # [C, N] per-site ⟨c c†⟩
            if "density" in mspec.snapshots:
                snaps["density"] = 2.0 * (1.0 - (Gsite.real if cplx else Gsite))
            if "double_occupancy" in mspec.snapshots:
                snaps["double_occupancy"] = (1.0 - Gsite).abs() ** 2
        if "phonon_position" in mspec.snapshots:
            snaps["phonon_position"] = x.mean(dim=-1)
        return out, {"iters": gd.iters, "flag": gd.flag}, snaps

    def analyze(params, x, gd: G.GreensData):
        """Everything after the probe solves, a block of chains at a time
        (``chain_block``; each chain's estimators are its own), the blocks'
        results joined along the chain axis."""
        C = x.shape[0]
        block = chain_block or analyze_chains(C, nv, spec.Nsites, Lt, x.dtype)
        if C <= block:
            return analyze_block(params, x, gd)
        blocks = []
        for lo in range(0, C, block):
            cut = slice(lo, lo + block)
            blocks.append(analyze_block(params, x[cut], G.GreensData(
                R=gd.R[cut], MinvR=gd.MinvR[cut], iters=gd.iters[cut], flag=gd.flag[cut])))
        return _join_chains(blocks)

    # --- the segmented measurement: the eager one's arithmetic in its order
    segmented = not eager
    box: dict = {}
    probes = _ProbeSegments(ops, nv, scfg, precond)

    def seg_analyze(ws):
        """The solve's per-chain statistics and :func:`analyze`, every
        result copied into the workspace (``ws.results``)."""
        inc, stats, snaps = analyze(ws.params, ws.x, probes.result(ws))
        ws.results = ({g: {k: ws.put(f"inc.{g}.{k}", v) for k, v in vals.items()}
                       for g, vals in inc.items()},
                      {k: ws.put(f"stats.{k}", v) for k, v in stats.items()},
                      {k: ws.put(f"snap.{k}", v) for k, v in snaps.items()})

    def segmented_step(params, x, R):
        ws = probes.run(box, params, x, R, "analyze", seg_analyze)
        inc, stats, snaps = ws.results
        return ({g: {k: v.clone() for k, v in vals.items()} for g, vals in inc.items()},
                {k: v.clone() for k, v in stats.items()}, {k: v.clone() for k, v in snaps.items()})

    def draw(params, x, generator: torch.Generator | None = None):
        return G.draw_probes(ops, params, x, nv, generator)

    def step(params, x, generator: torch.Generator | None = None, R=None):
        if segmented and graphs.graphable(ops.shard, x.device):
            return segmented_step(params, x, draw(params, x, generator) if R is None else R)
        gd = G.sample_greens(ops, params, x, nv, scfg, precond, generator, R)
        return analyze(params, x, gd)

    step.analyze = analyze
    step.draw = draw
    step.segmented = segmented
    step.workspace = lambda: box.get("ws")
    return step


class _ProbeSegments:
    """The probe solves of a measurement (:func:`.greens.sample_greens`) as
    segments over a workspace: ``probe_start`` (the derived state, the full
    preconditioner setup at x, CG's b = MᵀR and the solve's start from
    zero) and the solve's segments (:class:`..dynamics.graphs.CGSolve`,
    block CG over the nᵥ probes of a chain with ``scfg.block``, or
    :class:`..dynamics.graphs.NonsymSolve` on M), then the caller's last
    segment."""

    def __init__(self, ops: ModelOps, nv: int, scfg: SolverConfig, precond):
        self.ops, self.nv, self.scfg, self.precond = ops, nv, scfg, precond
        self.cg_kind = scfg.kind == "cg"
        self.solve = graphs.make_solve(ops, precond, scfg, rhs="b" if self.cg_kind else "R",
                                       stacked=True, block=scfg.block)

    def start(self, ws) -> None:
        ops, p = self.ops, ws.params
        env = ws.put("env", ops.derived(p, ws.x))
        if self.precond is not None:
            ws.load("kpm", self.precond.setup(p, ws.x, ws.kpm_start))
        if self.cg_kind:
            ws.put("b", ops.mulMT(p, ops.stack(env), ws.R))
        self.solve.start(ws, self.scfg.tol)

    def result(self, ws) -> G.GreensData:
        """The finished solve as the probes' :class:`.greens.GreensData`."""
        z, iters, flag = self.solve.result(ws)
        return G.GreensData(R=ws.R, MinvR=z, iters=iters.sum(dim=1) // self.nv,
                            flag=flag.amax(dim=1))

    def run(self, box: dict, params, x, R, last: str, fn):
        """One call on the workspace kept in ``box``: x and the probes ``R``
        copied in, the start, the solve's host loop, then segment ``last``
        (``fn(ws)``); returns the workspace."""
        ws = graphs.step_workspace(box, params, x)
        ws.put("x", x)
        ws.put("R", R)
        if self.precond is not None:
            ws.put_start(self.precond.start)
        tol = self.scfg.tol
        ws.capture_once(lambda: [("probe_start", lambda: self.start(ws)),
                                 *self.solve.segments(ws, tol), (last, lambda: fn(ws))])
        ws.run("probe_start", lambda: self.start(ws))
        self.solve.solve(ws, tol)
        ws.run(last, lambda: fn(ws))
        return ws


def make_probe_solve(ops: ModelOps, nv: int, scfg: SolverConfig = SolverConfig(),
                     precond=None, eager: bool = False):
    """Build ``solve(params, x, generator=None, R=None) -> GreensData``:
    :func:`.greens.sample_greens` of ``nv`` probes per chain as segments
    (``probe_start``, the solve's, ``probes``), replayed as CUDA graphs on
    a card and called directly on the CPU. It is the site-sharded
    measurement's first half: on a rank's block of sites (``ops.shard``)
    the probes are the block's and the solve's dots sum over the site
    group inside the segments (captured on NCCL ranks; a gloo site group on
    a card runs :func:`.greens.sample_greens` eagerly,
    :func:`..dynamics.graphs.graphable`); the estimators then run on the
    gathered probes. ``eager`` asks for the eager solve; ``.segmented`` and
    ``.workspace()`` as for the measurement step."""
    box: dict = {}
    probes = _ProbeSegments(ops, nv, scfg, precond)

    def keep(ws):
        """The probes' per-chain statistics into the workspace (the solution
        is the solve's own workspace tensor)."""
        gd = probes.result(ws)
        ws.gd = G.GreensData(R=ws.R, MinvR=gd.MinvR, iters=ws.put("probe_iters", gd.iters),
                             flag=ws.put("probe_flag", gd.flag))

    def solve(params, x, generator: torch.Generator | None = None, R=None) -> G.GreensData:
        if R is None:
            R = G.draw_probes(ops, params, x, nv, generator)
        if eager or not graphs.graphable(ops.shard, x.device):
            return G.sample_greens(ops, params, x, nv, scfg, precond, R=R)
        gd = probes.run(box, params, x, R, "probes", keep).gd
        return G.GreensData(R=R, MinvR=gd.MinvR.clone(), iters=gd.iters.clone(),
                            flag=gd.flag.clone())

    solve.segmented = not eager
    solve.workspace = lambda: box.get("ws")
    return solve


def mean_over_chains(inc: dict, snaps: dict, flag: torch.Tensor):
    """Average per-chain increments over the chains whose probe solves
    succeeded (all chains when none did), and take the snapshots of the
    first such chain. Stays on the device."""
    ok = flag == 0
    any_ok = ok.any()
    w = ok.to(torch.float64)
    denom = torch.clamp(w.sum(), min=1.0)
    first_ok = torch.argmax(ok.to(torch.int32))

    def chain_mean(a):
        wa = w.reshape((-1,) + (1,) * (a.ndim - 1)).to(a.dtype)
        return torch.where(any_ok, (a * wa).sum(dim=0) / denom.to(a.dtype), a.mean(dim=0))

    mean = {group: {k: chain_mean(v) for k, v in vals.items()} for group, vals in inc.items()}
    return mean, {k: v[first_ok] for k, v in snaps.items()}


# ---------------------------------------------------------------------------
# bin post-processing
# ---------------------------------------------------------------------------

def process_bin(ops: ModelOps, mspec: MeasurementSpec, container: dict, bin_size: int) -> dict:
    """Normalise by bin_size·C(nᵥ,2), transform the correlations to
    momentum space and Simpson-integrate the susceptibilities over τ."""
    nv = mspec.nv
    V = bin_size * (nv * (nv - 1) // 2)
    out = {group: {k: v / V for k, v in container[group].items()}
           for group in ("global", "onsite", "intersite")}
    out.update(onsite_corr={}, intersite_corr={}, onsite_susc={}, intersite_susc={})
    for group, sgroup in (("onsite_corr", "onsite_susc"), ("intersite_corr", "intersite_susc")):
        for kind, pos in container[group].items():
            pos = pos / V
            mom = torch.fft.fftn(pos, dim=(1, 2, 3))
            out[group][kind] = {"position": pos, "momentum": mom}
            if kind in SUSC_MAP and pos.shape[-1] > 1:
                out[sgroup][SUSC_MAP[kind]] = {
                    "position": simpson(torch.movedim(pos, -1, 0), ops.dtau),
                    "momentum": simpson(torch.movedim(mom, -1, 0), ops.dtau)}
    return out
