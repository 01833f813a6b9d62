"""Uniform functional interface over the model families.

Counterpart of ``elphdynamics_tpu/models/adapter.py``: the samplers and
preconditioners are written against :class:`ModelOps`, a bundle of
closures over the static spec with the parameters passed explicitly.
``derived(params, x)`` is the per-configuration cache of a ``[C, Nph,
Lτ]`` batch: ``expnV`` ``[C, N, Lτ]`` for Holstein, the ``(cosh, sinh)``
coefficient tables ``[C, Nb, Lτ]`` for SSH. ``stack(derived)`` makes it act
on ``[C, S, N, Lτ]`` stacks of fields (the two spins, the nᵥ probes): the
Holstein diagonal gains an axis, the SSH tables stay as they are (the fold
applies a chain's table to every row of that chain). SSH has no Λ shift.
Under complex hopping the SSH tables are complex and the fields the
operators act on are of the parameters' complex type
(:func:`..utils.dtypes.field_dtype`); ``stack`` is unchanged.

A site-sharded model (:mod:`..parallel.lattice_shard`) has the same
operators on the rank's block of sites and carries its ``shard``, the hook
through which the samplers sum over sites (:func:`site_sum`). Holstein's
phonon field is cut with the sites; SSH's bond field stays whole on every
rank, so a sum over it is already global (:func:`phonon_sum` leaves it
alone: summing it over the ranks would count it D times), while SSH's
fermionic force is the one bond-field quantity that each rank holds only a
share of (:func:`force_sum`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from elphdynamics_tpu_torch.models import holstein as Hm
from elphdynamics_tpu_torch.models import ssh as Sm


@dataclass(frozen=True)
class ModelOps:
    spec: Any
    Nsites: int
    Nph: int
    Ltau: int
    dtau: float
    beta: float
    is_holstein: bool
    derived: Callable          # (params, x) -> env / (cosh, sinh)
    stack: Callable            # derived -> derived acting on [C, S, N, Lτ] fields
    mulM: Callable             # (params, derived, v, precision=None) -> v
    mulMT: Callable
    mulMTM: Callable
    mulMMT: Callable
    muldMdx: Callable          # (params, derived, x, u, v) -> [..., Nph, Lτ]
    calc_Sb: Callable          # (params, x, shifted=False) -> [...]
    calc_dSbdx: Callable       # (params, x, shifted=False) -> [..., Nph, Lτ]
    tie: Callable              # (v) -> v (identity for Holstein)
    calc_Lambda: Callable | None = None
    mulLambda: Callable | None = None
    mulLambdaInv: Callable | None = None
    muldLambdadx: Callable | None = None
    # the site shard of a site-sharded model (parallel/lattice_shard.SiteShard):
    # fields hold its block of Nsites sites and every sum over sites goes
    # through shard.sum; None on one rank
    shard: object = None


def make_model_ops(spec) -> ModelOps:
    if isinstance(spec, Sm.SSHSpec):
        return ModelOps(
            spec=spec,
            Nsites=spec.Nsites,
            Nph=spec.Nph,
            Ltau=spec.Ltau,
            dtau=spec.dtau,
            beta=spec.beta,
            is_holstein=False,
            derived=lambda p, x: Sm.ckb_coeffs(spec, p, x),
            stack=lambda d: d,
            mulM=lambda p, d, v, precision=None: Sm.mulM(spec, p, d, v),
            mulMT=lambda p, d, v, precision=None: Sm.mulMT(spec, p, d, v),
            mulMTM=lambda p, d, v, precision=None: Sm.mulMTM(spec, p, d, v),
            mulMMT=lambda p, d, v, precision=None: Sm.mulMMT(spec, p, d, v),
            muldMdx=lambda p, d, x, u, v: Sm.muldMdx(spec, p, d, x, u, v),
            calc_Sb=lambda p, x, shifted=False: Sm.calc_Sb(spec, p, x, shifted),
            calc_dSbdx=lambda p, x, shifted=False: Sm.calc_dSbdx(spec, p, x, shifted),
            tie=lambda v: Sm.tie_fields(spec, v),
            shard=spec.shard,
        )
    if not isinstance(spec, Hm.HolsteinSpec):
        raise TypeError(f"unknown model spec {type(spec).__name__}")
    return ModelOps(
        spec=spec,
        Nsites=spec.Nsites,
        Nph=spec.Nph,
        Ltau=spec.Ltau,
        dtau=spec.dtau,
        beta=spec.beta,
        is_holstein=True,
        derived=lambda p, x: Hm.expnV(spec, p, x),
        stack=lambda d: d[:, None],
        mulM=lambda p, d, v, precision=None: Hm.mulM(spec, p, d, v, precision),
        mulMT=lambda p, d, v, precision=None: Hm.mulMT(spec, p, d, v, precision),
        mulMTM=lambda p, d, v, precision=None: Hm.mulMTM(spec, p, d, v, precision),
        mulMMT=lambda p, d, v, precision=None: Hm.mulMMT(spec, p, d, v, precision),
        muldMdx=lambda p, d, x, u, v: Hm.muldMdx(spec, p, d, x, u, v),
        calc_Sb=lambda p, x, shifted=False: Hm.calc_Sb(spec, p, x, shifted),
        calc_dSbdx=lambda p, x, shifted=False: Hm.calc_dSbdx(spec, p, x, shifted),
        tie=lambda v: v,
        calc_Lambda=lambda p, x: Hm.calc_Lambda(spec, p, x),
        mulLambda=lambda Lam, v: Hm.mulLambda(spec, Lam, v),
        mulLambdaInv=lambda Lam, v: Hm.mulLambdaInv(spec, Lam, v),
        muldLambdadx=lambda p, x, Lam, vl, vr: Hm.muldLambdadx(spec, p, x, Lam, vl, vr),
        shard=spec.shard,
    )


def site_sum(ops: ModelOps, partial):
    """A per-chain sum over sites: ``partial`` itself on one rank, the sum
    of every rank's ``partial`` on a site-sharded model."""
    return partial if ops.shard is None else ops.shard.sum(partial)


def global_sites(ops: ModelOps) -> int:
    """The model's site count over every rank (``ops.Nsites`` on one rank):
    random draws are made at this size, so that a site-sharded run sees
    the one-rank run's numbers."""
    return ops.Nsites if ops.shard is None else ops.shard.N


def phonons_cut(ops: ModelOps) -> bool:
    """Whether a rank holds only its block of the phonon field: a
    site-sharded Holstein model (one phonon per site). A site-sharded SSH
    model keeps the whole bond field on every rank."""
    return ops.shard is not None and ops.is_holstein


def global_phonons(ops: ModelOps) -> int:
    """The phonon-field count over every rank (``ops.Nph`` on one rank and
    for SSH; a site-sharded Holstein model has one phonon per site)."""
    return ops.shard.N if phonons_cut(ops) else ops.Nph


def phonon_sum(ops: ModelOps, partial):
    """A per-chain sum over the phonon field (the kinetic energy): summed
    over the ranks where each holds a block of it (Holstein), ``partial``
    itself where it is whole on every rank (one rank, SSH)."""
    return site_sum(ops, partial) if phonons_cut(ops) else partial


def force_sum(ops: ModelOps, partial):
    """The fermionic force on the phonon field from the rank's ``partial``
    of ``muldMdx``: on a site-sharded SSH model the sum of every rank's
    share of the whole bond field (one all-reduce per force evaluation);
    elsewhere ``partial`` itself (Holstein's force on a site is local)."""
    if ops.shard is None or ops.is_holstein:
        return partial
    return ops.shard.sum_force(partial)


def local_phonons(ops: ModelOps, a, dim: int = -2):
    """This rank's part of the phonon axis ``dim`` of a whole tensor or
    numpy table: the block where the phonons are cut (Holstein), else
    ``a`` itself."""
    return local_sites(ops, a, dim) if phonons_cut(ops) else a


def local_sites(ops: ModelOps, a, dim: int = -2):
    """This rank's block of the site axis ``dim`` of a global tensor or
    numpy table (``a`` itself on one rank)."""
    if ops.shard is None:
        return a
    if torch.is_tensor(a):
        return ops.shard.local(a, dim)
    idx = [slice(None)] * np.ndim(a)
    idx[dim] = slice(ops.shard.lo, ops.shard.lo + ops.shard.B)
    return np.asarray(a)[tuple(idx)]
