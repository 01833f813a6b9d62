"""Lattice geometry: unit cells, finite lattices, neighbor tables.

Counterpart of ``elphdynamics_tpu/lattice.py`` (host-side numpy, computed
once when a model is built). The logic is the same; the one change is the
duplicate-pair removal of :meth:`Lattice.calc_neighbor_table`, which keeps
the first occurrence of every unordered pair with a vectorised
``np.unique`` instead of the O(n²) loop (or its C++ twin) — the same kept
set, at 64×64 in milliseconds. All indices are 0-based.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class UnitCell:
    """Lattice geometry of a unit cell (vectors stored as columns, embedded
    in 3D padded with the identity)."""

    ndim: int
    norbits: int
    lvecs: np.ndarray  # (3, 3), columns are lattice vectors
    rlvecs: np.ndarray  # (3, 3), columns are reciprocal lattice vectors
    bvecs: np.ndarray  # (3, norbits), columns are basis vectors

    @staticmethod
    def create(ndim: int, norbits: int, lattice_vectors, basis_vectors) -> "UnitCell":
        lv = np.eye(3)
        for i, vec in enumerate(np.atleast_2d(np.asarray(lattice_vectors, dtype=np.float64))):
            lv[: len(vec), i] = vec
        rlv = 2.0 * np.pi * np.linalg.inv(lv)
        bv = np.zeros((3, norbits))
        for i, vec in enumerate(np.atleast_2d(np.asarray(basis_vectors, dtype=np.float64))):
            bv[: len(vec), i] = vec
        return UnitCell(ndim=ndim, norbits=norbits, lvecs=lv, rlvecs=rlv, bvecs=bv)


@dataclass(frozen=True)
class Lattice:
    """A finite L1×L2×L3 lattice of unit cells with periodic boundaries.

    ``site = cell*norbits + orbit`` with ``cell = l1 + L1*(l2 + L2*l3)``.
    """

    unit_cell: UnitCell
    L1: int
    L2: int
    L3: int
    nsites: int
    ncells: int
    cell_loc: np.ndarray  # (3, ncells) int
    site_to_orbit: np.ndarray  # (nsites,) int
    site_to_cell: np.ndarray  # (nsites,) int

    @staticmethod
    def create(unit_cell: UnitCell, L1: int, L2: int | None = None, L3: int | None = None) -> "Lattice":
        if L2 is None:
            L2 = L1 if unit_cell.ndim >= 2 else 1
        if L3 is None:
            L3 = L1 if unit_cell.ndim >= 3 else 1
        if min(L1, L2, L3) < 1:
            raise ValueError(f"lattice extents must be >= 1, got {(L1, L2, L3)}")
        ncells = L1 * L2 * L3
        norbits = unit_cell.norbits
        nsites = ncells * norbits
        l1, l2, l3 = np.meshgrid(np.arange(L1), np.arange(L2), np.arange(L3),
                                 indexing="ij")
        # cell index runs l1 fastest, then l2, then l3
        cell_loc = np.stack([l1.transpose(2, 1, 0).reshape(-1),
                             l2.transpose(2, 1, 0).reshape(-1),
                             l3.transpose(2, 1, 0).reshape(-1)]).astype(np.int64)
        site_to_orbit = np.tile(np.arange(norbits, dtype=np.int64), ncells)
        site_to_cell = np.repeat(np.arange(ncells, dtype=np.int64), norbits)
        return Lattice(unit_cell, L1, L2, L3, nsites, ncells, cell_loc,
                       site_to_orbit, site_to_cell)

    @property
    def dims(self) -> tuple[int, int, int]:
        return (self.L1, self.L2, self.L3)

    def loc_to_cell(self, l1, l2=0, l3=0):
        """Periodic (l1,l2,l3) -> cell index (scalars or integer arrays)."""
        return (np.mod(l1, self.L1) + np.mod(l2, self.L2) * self.L1
                + np.mod(l3, self.L3) * self.L1 * self.L2)

    def loc_to_site(self, orbit, l1, l2=0, l3=0):
        return self.unit_cell.norbits * self.loc_to_cell(l1, l2, l3) + orbit

    def site_to_site(self, isite, displacement, orbit: int):
        """Site after a unit-cell displacement (scalar or array ``isite``)."""
        l1, l2, l3 = self.cell_loc[:, self.site_to_cell[isite]]
        return self.loc_to_site(orbit, l1 + displacement[0], l2 + displacement[1],
                                l3 + displacement[2])

    def calc_neighbor_table(self, orbit1: int, orbit2: int, displacement,
                            remove_duplicates: bool = True) -> np.ndarray:
        """Neighbor table (2, Npairs) for a bond rule: the ``orbit1`` site of
        every cell paired with the ``orbit2`` site ``displacement`` cells
        away. Duplicates (same unordered pair) keep their first occurrence."""
        norbits = self.unit_cell.norbits
        if not (0 <= orbit1 < norbits and 0 <= orbit2 < norbits):
            raise ValueError(f"orbits {(orbit1, orbit2)} outside 0..{norbits - 1}")
        disp = tuple(displacement) + (0,) * (3 - len(tuple(displacement)))
        isites = np.arange(orbit1, self.nsites, norbits, dtype=np.int64)
        fsites = np.asarray(self.site_to_site(isites, disp, orbit2), dtype=np.int64)
        table = np.stack([isites, fsites]).reshape(2, -1)
        if remove_duplicates and table.shape[1] > 0:
            lo = np.minimum(table[0], table[1])
            hi = np.maximum(table[0], table[1])
            _, first = np.unique(lo * (self.nsites + 1) + hi, return_index=True)
            keep = np.zeros(table.shape[1], dtype=bool)
            keep[first] = True
            table = table[:, keep]
        return table


def sort_neighbor_table(neighbor_table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonical ordering of a neighbor table: ``(sorted_table, perm)`` with
    the smaller site first in each pair and pairs sorted lexicographically."""
    table = neighbor_table.copy()
    if table.shape[1] == 0:
        return table, np.zeros(0, dtype=np.int64)
    swap = table[0] > table[1]
    table[0, swap], table[1, swap] = neighbor_table[1, swap], neighbor_table[0, swap]
    vals = (table.max() + 1) * table[0] + table[1]
    perm = np.argsort(vals, kind="stable")
    return table[:, perm], perm
