"""Frozen counts of bytes and real float32 operations on complex fields,
from shapes alone (complex hopping: the twisted configurations).

As :mod:`.ops`, they count what the algorithm needs for its inputs. A
field's element is complex; its real operations are

* an add or a subtraction of two complex numbers: 2;
* a real number times a complex one: 2;
* a complex multiply-add a + b·c: 8 (the product's 4 multiplies and 2
  adds, the sum's 2);
* a complex product's real part accumulated, Re(a)·Re(b) + Im(a)·Im(b)
  into a real sum (the Hermitian inner product): 4.

Checkerboard fold of a complex field of F elements over N sites with
Hermitian bond blocks [c s; s̄ c] (c real): each group's touched element
takes c·v (2) and the multiply-add of s·v[partner] (8); every bond touches
2 sites, so a fold is 10·2·Nb·F/N operations.

K1 (``ckb_fold``) in its complex mode: reads the field once, writes it once
and reads its two coefficient tables once, each element of the complex
type's size (the port keeps c as a complex number too).
"""

from __future__ import annotations

import math

from counts.ops import numel, table_elems

FOLD_OPS = 10.0     # per touched element: c·v (2) and the multiply-add s·v[partner] (8)


def fold_flops(shape, nbonds: int, nsites: int) -> float:
    return FOLD_OPS * 2 * nbonds * numel(shape) / nsites


def k1_bytes(shape, form: str, nbonds: int, itemsize: int) -> float:
    """``itemsize``: the complex element's bytes (8 for complex64)."""
    return (2 * numel(shape) + 2 * table_elems(form, shape, nbonds)) * itemsize


def k1_flops(shape, nbonds: int, nsites: int) -> float:
    return fold_flops(shape, nbonds, nsites)


# --- the HMC update of one chain: F = N·Lτ complex fermion elements (the
# two spins packed as R↑ + i·R↓) ------------------------------------------

def mtm_flops(F: int, nbonds: int, nsites: int) -> float:
    """One M†M apply: M is a real diagonal (2), a fold, the wrap's sign (2)
    and a subtraction (2) per element; M† the same."""
    return 2 * (6.0 * F + fold_flops((F,), nbonds, nsites))


def fft_flops(F: int, Ltau: int) -> float:
    """One complex transform along τ of F elements: 5·log₂Lτ per element
    (a radix-2 transform's 5·n·log₂n)."""
    return 5.0 * math.log2(Ltau) * F


def cheb_step_flops(F: int, nbonds: int, nsites: int) -> float:
    """One step of the complex Chebyshev recurrence on F elements of the
    full spectrum: Ā (the real diagonal, 2, and a fold), the spectral map
    (÷λmag 2, − shift·v 4), the combine 2·Ap − u₋ (4) and the coefficient's
    multiply-add into the pass's sum (8)."""
    return fold_flops((F,), nbonds, nsites) + 20.0 * F


def kpm_flops(F: int, Ltau: int, max_order: int, nbonds: int, nsites: int) -> float:
    """One symmetric KPM apply on a complex field: a transform to the full
    spectrum, two passes of ``max_order`` steps (the adjoint, then the
    forward one) and the transform back."""
    return 2 * fft_flops(F, Ltau) + 2 * max_order * cheb_step_flops(F, nbonds, nsites)


CG_VECTOR_FLOPS = 24.0   # per element and iteration: 3 updates (4 each), 3 inner products (4)


def cg_iteration_flops(F: int, Ltau: int, max_order: int, nbonds: int, nsites: int) -> float:
    """One Hermitian CG iteration on one chain's F complex elements."""
    return (mtm_flops(F, nbonds, nsites) + kpm_flops(F, Ltau, max_order, nbonds, nsites)
            + CG_VECTOR_FLOPS * F)


def force_flops(F: int, Nph: int, Ltau: int, nbonds: int, nsites: int) -> float:
    """One fermion force on one chain: :func:`.ops.force_flops`' 14
    elementwise operations per fermion element, each on a complex element
    (2: an add, a real-by-complex multiply, or one half of a Re(a†b)
    pair), its two folds complex, and the Fourier acceleration, a dense
    Lτ×Lτ circulant on each phonon row."""
    fold = fold_flops((F,), nbonds, nsites)
    return 2 * fold + 28.0 * F + 2.0 * Ltau * Nph * Ltau


def update_flops(iterations: float, forces: int, F: int, Nph: int, Ltau: int, max_order: int,
                 nbonds: int, nsites: int) -> float:
    """A chain's update: its CG iterations (over all its solves) and its
    fermion forces; a lower bound as :func:`.ops.update_flops` is."""
    return (iterations * cg_iteration_flops(F, Ltau, max_order, nbonds, nsites)
            + forces * force_flops(F, Nph, Ltau, nbonds, nsites))
