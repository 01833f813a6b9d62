"""Bonds of a periodic lattice and their checkerboard groups, in numpy.

A plain restatement of the upstream decomposition of exp(−Δτ·K): every bond
rule of the input file pairs the ``o1`` site of each cell with the ``o2``
site ``dL`` cells away; duplicate pairs keep their first occurrence; the
pairs are put in canonical order (smaller site first, then sorted) and
walked greedily into groups of bonds that share no site. exp(−Δτ·K) is the
product of the groups' 2×2 bond rotations, the first group applied first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Bonds:
    """The bonds of the model in the order the input file defines them
    (``pairs`` ``[2, Nb]``, ``definition`` ``[Nb]``) and their checkerboard
    groups: ``groups[g]`` is the list of original bond indices of group g."""

    nsites: int
    pairs: np.ndarray
    definition: np.ndarray
    groups: tuple


def site_index(L: int, norbits: int, orbit: int, l1, l2):
    """Site of ``orbit`` in cell (l1, l2) of an L×L periodic lattice (cell
    index runs l1 fastest)."""
    return norbits * ((np.mod(l1, L) + np.mod(l2, L) * L)) + orbit


def bond_pairs(L: int, norbits: int, rules) -> tuple[np.ndarray, np.ndarray]:
    """Every rule ``(o1, o2, dL)`` (orbits 0-based) expanded over the cells,
    duplicates within a rule removed; returns (pairs ``[2, Nb]``, the rule
    of each bond)."""
    l1, l2 = np.meshgrid(np.arange(L), np.arange(L), indexing="xy")
    l1, l2 = l1.reshape(-1), l2.reshape(-1)          # cell c = l1 + L·l2, in order
    pairs, definition = [], []
    for r, (o1, o2, dL) in enumerate(rules):
        i = site_index(L, norbits, o1, l1, l2)
        j = site_index(L, norbits, o2, l1 + dL[0], l2 + dL[1])
        key = np.minimum(i, j) * (L * L * norbits + 1) + np.maximum(i, j)
        _, first = np.unique(key, return_index=True)
        keep = np.sort(first)
        pairs.append(np.stack([i[keep], j[keep]]))
        definition.append(np.full(keep.size, r))
    return np.concatenate(pairs, axis=1), np.concatenate(definition)


def checkerboard(nsites: int, pairs: np.ndarray, definition: np.ndarray) -> Bonds:
    """Canonical order, then greedy groups of site-disjoint bonds."""
    lo, hi = np.minimum(pairs[0], pairs[1]), np.maximum(pairs[0], pairs[1])
    order = np.argsort(lo * (hi.max() + 1) + hi, kind="stable")
    left = list(order)
    groups = []
    while left:
        used, group, rest = set(), [], []
        for b in left:
            i, j = int(lo[b]), int(hi[b])
            if i in used or j in used:
                rest.append(b)
                continue
            used.update((i, j))
            group.append(int(b))
        groups.append(group)
        left = rest
    return Bonds(nsites=nsites, pairs=np.stack([lo, hi]), definition=definition,
                 groups=tuple(groups))


def square_bonds(L: int, rules) -> Bonds:
    """The bonds of an L×L square lattice with one orbital per cell."""
    pairs, definition = bond_pairs(L, 1, rules)
    return checkerboard(L * L, pairs, definition)
