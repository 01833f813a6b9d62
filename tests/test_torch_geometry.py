"""Host-side geometry of the PyTorch port against the JAX package: lattice
maps, neighbor tables, the checkerboard spec arrays and the dense
checkerboard matrix, on the square, honeycomb and triangular lattices of
the examples."""

import numpy as np
import pytest
import torch

from elphdynamics_tpu import lattice as jlat
from elphdynamics_tpu.ops import checkerboard as jckb
from elphdynamics_tpu_torch import lattice as tlat
from elphdynamics_tpu_torch.ops import checkerboard as tckb

torch.set_num_threads(1)

# (unit cell args, bond rules (o1, o2, dL)) — examples/holstein_hmc_*.toml
LATTICES = {
    "square": ((2, 1, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]]),
               [(0, 0, (1, 0, 0)), (0, 0, (0, 1, 0))]),
    "honeycomb": ((2, 2, [[1.5, 0.8660254037844386], [1.5, -0.8660254037844386]],
                   [[0.0, 0.0], [1.0, 0.0]]),
                  [(0, 1, (0, 0, 0)), (1, 0, (1, 0, 0)), (1, 0, (0, 1, 0))]),
    "triangular": ((2, 1, [[1.0, 0.0], [0.5, 0.8660254037844386]], [[0.0, 0.0]]),
                   [(0, 0, (1, 0, 0)), (0, 0, (0, 1, 0)), (0, 0, (1, -1, 0))]),
}
CASES = [(name, L) for name in LATTICES for L in (2, 3, 4)]


def _both(name, L):
    uc_args, bonds = LATTICES[name]
    return (jlat.Lattice.create(jlat.UnitCell.create(*uc_args), L),
            tlat.Lattice.create(tlat.UnitCell.create(*uc_args), L), bonds)


def _tables(lat, bonds):
    return np.concatenate([lat.calc_neighbor_table(o1, o2, dL) for o1, o2, dL in bonds], axis=1)


@pytest.mark.parametrize("name,L", CASES)
def test_lattice_and_neighbor_tables_equal(name, L):
    jl, tl, bonds = _both(name, L)
    for f in ("nsites", "ncells", "L1", "L2", "L3"):
        assert getattr(jl, f) == getattr(tl, f)
    for f in ("cell_loc", "site_to_orbit", "site_to_cell"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    np.testing.assert_array_equal(tl.unit_cell.lvecs, jl.unit_cell.lvecs)
    np.testing.assert_array_equal(tl.unit_cell.bvecs, jl.unit_cell.bvecs)
    for o1, o2, dL in bonds:
        np.testing.assert_array_equal(tl.calc_neighbor_table(o1, o2, dL),
                                      jl.calc_neighbor_table(o1, o2, dL))
        np.testing.assert_array_equal(
            tl.calc_neighbor_table(o1, o2, dL, remove_duplicates=False),
            jl.calc_neighbor_table(o1, o2, dL, remove_duplicates=False))
    jt, jp = jlat.sort_neighbor_table(_tables(jl, bonds))
    tt, tp = tlat.sort_neighbor_table(_tables(tl, bonds))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("name,L", CASES)
def test_checkerboard_spec_equal(name, L):
    jl, tl, bonds = _both(name, L)
    table, _ = jlat.sort_neighbor_table(_tables(jl, bonds))
    js = jckb.build_checkerboard_spec(jl.nsites, table)
    ts = tckb.build_checkerboard_spec(tl.nsites, table)
    assert (ts.nsites, ts.nbonds, ts.ngroups) == (js.nsites, js.nbonds, js.ngroups)
    for f in ("partner", "bond_of_site", "mask", "is_lo", "neighbor_table", "order", "groups"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    np.testing.assert_array_equal(tckb.checkerboard_groups(table), jckb.checkerboard_groups(table))
    offs = ts.group_offsets
    assert offs[0] == 0 and offs[-1] == ts.nbonds
    for g in range(ts.ngroups):
        assert np.all(ts.groups[offs[g]:offs[g + 1]] == g)


@pytest.mark.parametrize("name,L", [(n, 4) for n in LATTICES])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_dense_matrix_equal(name, L, inverse):
    jl, _, bonds = _both(name, L)
    table, _ = jlat.sort_neighbor_table(_tables(jl, bonds))
    spec = jckb.build_checkerboard_spec(jl.nsites, table)
    rng = np.random.default_rng(4)
    t = 1.0 + 0.1 * rng.standard_normal(spec.nbonds)
    c, s = np.cosh(0.1 * t), np.sinh(0.1 * t)
    tspec = tckb.build_checkerboard_spec(jl.nsites, table)
    want = jckb.dense_matrix(spec, c, s, inverse=inverse)
    got = tckb.dense_matrix(tspec, c, s, inverse=inverse)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_greedy_grouping_small_case():
    table = np.array([[0, 0, 1, 2], [1, 2, 3, 3]])
    np.testing.assert_array_equal(tckb.checkerboard_groups(table), [0, 1, 1, 0])
