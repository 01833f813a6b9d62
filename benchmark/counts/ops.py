"""Frozen counts of bytes and float32 operations, from shapes alone.

These are the yardstick of the roofline and MFU metrics: they count what the
algorithm needs for its inputs, never what a kernel launches, so fusing or
splitting kernels leaves them as they are. An operation is one add, one
multiply or one compare-free elementwise arithmetic op on one element.

Checkerboard fold of a field of F elements over N sites: each group rotates
its bonds, 3 operations (c·v, s·v[partner], the sum) per element of each
site a bond touches; every bond touches 2 sites, so a fold is
3·2·Nb·F/N operations.

K1 (``ckb_fold``): reads the field once, writes it once and reads its two
coefficient tables once. K2 (``ckb_fold_fused``, one Chebyshev step
a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev): reads v and prev, writes the
result, reads the tables, the diagonal and a, b once.
"""

from __future__ import annotations

import math


def numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def fold_flops(shape, nbonds: int, nsites: int) -> float:
    return 3.0 * 2 * nbonds * numel(shape) / nsites


def table_elems(form: str, shape, nbonds: int) -> int:
    """Elements of one coefficient table: ``shared`` [Nb], ``chain``
    [C, Nb], ``column`` [C, Nb, K] for a field [C, ..., N, K]."""
    C, K = int(shape[0]), int(shape[-1])
    return {"shared": nbonds, "chain": C * nbonds, "column": C * nbonds * K}[form]


def k1_bytes(shape, form: str, nbonds: int, itemsize: int) -> float:
    return (2 * numel(shape) + 2 * table_elems(form, shape, nbonds)) * itemsize


def k1_flops(shape, nbonds: int, nsites: int) -> float:
    return fold_flops(shape, nbonds, nsites)


def k2_bytes(shape, form: str, nbonds: int, itemsize: int, diag: bool = True) -> float:
    """v and prev read, the result written, the tables, the [C, N]
    diagonal and a, b ([C] each) read once."""
    C, N = int(shape[0]), int(shape[-2])
    return (3 * numel(shape) + 2 * table_elems(form, shape, nbonds)
            + (C * N if diag else 0) + 2 * C) * itemsize


def k2_flops(shape, nbonds: int, nsites: int, diag: bool = True) -> float:
    """The diagonal (1), the fold, a·f (1), + b·v (2), + c·prev (2) per element."""
    return fold_flops(shape, nbonds, nsites) + (5.0 + (1.0 if diag else 0.0)) * numel(shape)


# --- the HMC update, per chain --------------------------------------------

def mtm_flops(F: int, nbonds: int, nsites: int) -> float:
    """One MᵀM apply on F elements: M is a diagonal (1), a fold, the sign of
    the wrap (1) and a subtraction (1) per element; Mᵀ the same."""
    return 2 * (3.0 * F + fold_flops((F,), nbonds, nsites))


def fft_flops(F: int, Ltau: int) -> float:
    """One real transform along τ of F elements: 2.5·log₂Lτ per element
    (half of a complex radix-2 transform's 5·n·log₂n)."""
    return 2.5 * math.log2(Ltau) * F


def kpm_flops(F: int, Ltau: int, max_order: int, nbonds: int, nsites: int) -> float:
    """One symmetric KPM apply (the transposed pass, then the forward one)
    on F elements: per pass a transform to the half spectrum and back, and
    ``max_order`` Chebyshev steps on the stacked-real field of
    2·⌈Lτ/2⌉ columns, each a K2 step (without its operand reads) and the
    coefficient's complex multiply-add (4 per element)."""
    Fk = F // Ltau * 2 * ((Ltau + 1) // 2)
    step = k2_flops((Fk,), nbonds, nsites) + 4.0 * Fk
    return 2 * (2 * fft_flops(F, Ltau) + max_order * step)


CG_VECTOR_FLOPS = 12.0   # per element and iteration: 3 updates and 3 dots, 2 each


def cg_iteration_flops(F: int, Ltau: int, max_order: int, nbonds: int, nsites: int) -> float:
    """One CG iteration on one chain's F fermion elements (both spins)."""
    return (mtm_flops(F, nbonds, nsites) + kpm_flops(F, Ltau, max_order, nbonds, nsites)
            + CG_VECTOR_FLOPS * F)


def force_flops(F: int, Nph: int, Ltau: int, nbonds: int, nsites: int) -> float:
    """One fermion force on one chain: M·z (3 + fold), the transposed fold
    against ∂M/∂x (fold + 6), the Λ term (5), per fermion element, and the
    Fourier acceleration, a dense Lτ×Lτ circulant on each phonon row."""
    fold = fold_flops((F,), nbonds, nsites)
    return 2 * fold + 14.0 * F + 2.0 * Ltau * Nph * Ltau


def update_flops(iterations: float, forces: int, F: int, Nph: int, Ltau: int, max_order: int,
                 nbonds: int, nsites: int) -> float:
    """A chain's update: its CG iterations (over all its solves) and its
    fermion forces. Left out, so the count is a lower bound: the KPM
    set-up, the bosonic sub-steps, the momenta and pseudofermions, the
    energies."""
    return (iterations * cg_iteration_flops(F, Ltau, max_order, nbonds, nsites)
            + forces * force_flops(F, Nph, Ltau, nbonds, nsites))
